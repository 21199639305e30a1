"""Production inference: fixed-shape batched encoding/decoding of arbitrary
datasets (counterpart of ``rankaae_tpu/serve.py``).

:class:`BatchedInference` pads and chunks any row count into one fixed
(batch, dim) shape, so every chunk runs the same kernels at the same sizes.

CLI: ``python -m rankaae_tpu_torch.serve bundle.mpk data.csv out_prefix``
writes ``<out_prefix>_styles.txt`` and ``<out_prefix>_recon.txt`` for the
whole CSV (all splits); ``--bench`` prints the device-resident encode+decode
throughput, ``--bench-host`` the transfer-inclusive one, each as one JSON
line.  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from rankaae_tpu_torch.models.inference import InferenceModel


class BatchedInference:
    """Fixed-shape, pad-and-chunk wrapper over an :class:`InferenceModel`.

    On the card, chunks run through a three-stage pipeline: the next
    chunk's upload (from pinned host memory, on a copy stream) overlaps the
    current chunk's compute, and each result is downloaded into pinned host
    memory on a second copy stream, behind an ``in_flight``-deep window that
    bounds how far the host runs ahead of the device.  On the CPU the chunks
    simply run in turn.  The device is the model's (``InferenceModel``
    defaults to CUDA)."""

    def __init__(self, model: InferenceModel, batch_size: int = 1024, in_flight: int = 4):
        self.device = model.device
        self.model = model
        self.batch_size = batch_size
        self.in_flight = max(1, in_flight)

    def _chunk_apply(self, fn, x: np.ndarray) -> np.ndarray:
        n, b = x.shape[0], self.batch_size
        if n == 0:
            raise ValueError("no rows to serve")
        n_pad = -(-n // b) * b
        host = torch.zeros((n_pad, x.shape[1]), dtype=torch.float32)
        host.numpy()[:n] = x
        if self.device.type == "cpu":
            return torch.cat([fn(host[i:i + b]) for i in range(0, n_pad, b)]).numpy()[:n]
        return self._pipeline(fn, host.pin_memory(), n)

    def _pipeline(self, fn, host: torch.Tensor, n: int) -> np.ndarray:
        dev, b = self.device, self.batch_size
        compute = torch.cuda.current_stream(dev)
        up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        starts = list(range(0, host.shape[0], b))

        def upload(i):
            with torch.cuda.stream(up):
                chunk = host[i:i + b].to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(up)
            return chunk, ready

        result = None
        pending = []
        nxt = upload(starts[0])
        for j, i in enumerate(starts):
            chunk, ready = nxt
            if j + 1 < len(starts):
                nxt = upload(starts[j + 1])            # overlaps this chunk's compute
            compute.wait_event(ready)
            chunk.record_stream(compute)               # allocated on `up`, used here
            y = fn(chunk)
            if result is None:
                result = torch.empty((host.shape[0], y.shape[1]), dtype=y.dtype,
                                     pin_memory=True)
            done = torch.cuda.Event()
            done.record(compute)
            down.wait_event(done)
            with torch.cuda.stream(down):
                result[i:i + b].copy_(y, non_blocking=True)
            y.record_stream(down)                      # allocated on `compute`, read here
            copied = torch.cuda.Event()
            copied.record(down)
            pending.append(copied)
            if len(pending) > self.in_flight:
                pending.pop(0).synchronize()
        for e in pending:
            e.synchronize()
        return result[:n].numpy().copy()

    def encode(self, spec: np.ndarray) -> np.ndarray:
        return self._chunk_apply(self.model._encode, np.asarray(spec, np.float32))

    def decode(self, styles: np.ndarray) -> np.ndarray:
        return self._chunk_apply(self.model._decode, np.asarray(styles, np.float32))

    def reconstruct(self, spec: np.ndarray) -> np.ndarray:
        """Fused encode->decode per chunk (no styles round trip through the
        host)."""
        return self._chunk_apply(self.model._reconstruct, np.asarray(spec, np.float32))


def _need_cuda(model: InferenceModel, what: str) -> None:
    if model.device.type != "cuda":
        raise RuntimeError(f"{what} measures the card; the model is on {model.device}")


def serve_rounds(model: InferenceModel, x0: torch.Tensor, rounds: int) -> torch.Tensor:
    """``rounds`` encode->decode rounds on the device, each one's input
    depending on the previous one's output (so none can be skipped)."""
    c = x0
    for _ in range(rounds):
        c = x0 * 0.9 + model._decode(model._encode(c)) * 0.1
    return c


def device_benchmark(model: InferenceModel, batch_size: int = 4096, iters: int = 200) -> dict:
    """Device-resident encode+decode throughput: ``iters``
    :func:`serve_rounds` on data that lives on the card, timed with CUDA
    events after one warm-up round."""
    _need_cuda(model, "device_benchmark")
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn((batch_size, model.cfg.dim_in), generator=gen, device=dev)
    serve_rounds(model, x0, 1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = serve_rounds(model, x0, iters)
    end.record()
    torch.cuda.synchronize(dev)
    if not torch.isfinite(out).all():
        raise RuntimeError("device_benchmark produced non-finite values")
    ms = start.elapsed_time(end)
    return {
        "metric": "serve_spectra_per_sec_device",
        "value": batch_size * iters / (ms / 1e3),
        "unit": "spectra/s/device",
        "batch_size": batch_size,
        "iters": iters,
        "ms_per_batch": ms / iters,
        "ae_form": model.cfg.ae_form,
        "device": torch.cuda.get_device_name(dev),
    }


def host_benchmark(model: InferenceModel, batch_size: int = 4096, n_batches: int = 64) -> dict:
    """Transfer-inclusive serving throughput: host numpy in -> encode+decode
    -> host numpy out, through :class:`BatchedInference`'s pipeline, after
    one warm-up call."""
    _need_cuda(model, "host_benchmark")
    rng = np.random.default_rng(0)
    spec = rng.standard_normal((batch_size * n_batches, model.cfg.dim_in)).astype(np.float32)
    serve = BatchedInference(model, batch_size=batch_size)
    serve.reconstruct(spec[:batch_size * 2])
    t0 = time.perf_counter()
    out = serve.reconstruct(spec)
    wall = time.perf_counter() - t0
    if out.shape != spec.shape:
        raise RuntimeError(f"host_benchmark: output {out.shape} for input {spec.shape}")
    return {
        "metric": "serve_spectra_per_sec_host_pipelined",
        "value": spec.shape[0] / wall,
        "unit": "spectra/s (incl. host<->device transfers)",
        "batch_size": batch_size,
        "n_batches": n_batches,
        "transfer_MBps": (spec.nbytes + out.nbytes) / wall / 1e6,
        "device": torch.cuda.get_device_name(model.device),
    }


def main(argv: Optional[list] = None):
    from rankaae_tpu_torch.data.dataset import read_csv

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("bundle", help="model bundle (.mpk)")
    parser.add_argument("csv", nargs="?", help="spectra CSV (reference schema)")
    parser.add_argument("out_prefix", nargs="?", help="output file prefix")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="default: 4096 for --bench/--bench-host, 1024 for the CSV "
                             "path (an explicit value always wins)")
    parser.add_argument("--n-aux", type=int, default=5)
    parser.add_argument("--bench", action="store_true",
                        help="print the device-resident encode+decode throughput as "
                             "one JSON line")
    parser.add_argument("--bench-host", action="store_true",
                        help="also print the transfer-inclusive throughput through "
                             "the pipelined chunks")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    if args.bench or args.bench_host:
        model = InferenceModel.from_bundle(args.bundle, device=args.device)
        if args.bench:
            print(json.dumps(device_benchmark(model, batch_size=args.batch_size or 4096)))
        if args.bench_host:
            print(json.dumps(host_benchmark(model, batch_size=args.batch_size or 4096)))
        return
    if not args.csv or not args.out_prefix:
        parser.error("csv and out_prefix are required unless --bench")

    _, data, _ = read_csv(args.csv, np.float32)
    spec = data[:, args.n_aux:]
    model = InferenceModel.from_bundle(args.bundle, device=args.device)
    serve = BatchedInference(model, batch_size=args.batch_size or 1024)
    styles = serve.encode(spec)
    recon = serve.decode(styles)
    np.savetxt(args.out_prefix + "_styles.txt", styles)
    np.savetxt(args.out_prefix + "_recon.txt", recon)
    print(f"encoded {spec.shape[0]} spectra -> {args.out_prefix}_styles.txt, "
          f"{args.out_prefix}_recon.txt")


if __name__ == "__main__":
    main()
