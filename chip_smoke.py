#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rankaae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build — compile ``rankaae_tpu_torch/csrc/kendall.cu`` with nvcc;
2. kernels — hold the Kendall kernels K1 (pair sums) and K2 (gradient rows)
   against their plain PyTorch versions on the card, over the batch sizes
   the main path gives them, T in {1, 8} stacked trials, activation off and
   on, and a discrete descriptor column (exact ties); then time them at the
   main-path shape (T=1, B=1024, K=5);
3. main path — write the 7,000-row synthetic dataset of
   ``example/make_data.py``, load ``example/fix_config.yaml`` at full width
   (only ``max_epoch`` cut) and run ``Trainer.from_data(...).train()`` on the
   card; check finite losses, the 12-column ``losses.csv`` and that every
   Kendall loss of the run went through the kernels;
4. parity — one faithful training batch on the card against the same batch
   on the CPU (same weights, same draws), at the config's widths and batch
   size with the depth cut to 3 layers.

Output: the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Tolerances: loss rtol 1e-5 (atol
1e-7), counts exact, styles gradient atol 1e-6 (sums taken in another
order); phase 4 atol 1e-4 on the six losses (as the CPU parity test
against the JAX package), and per leaf of the weights after the batch a max
difference of 1e-3 and a relative norm of 1e-3 (see ``LEAF_ATOL``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): HBM bytes/s and fp32 non-tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# fp32 operations per (i, j, k) pair: K1 = d-diff, sign, s-diff, product,
# accumulate; K2 = the same five plus the weight select
OPS_PER_PAIR = {"kendall_pair_sums": 5, "kendall_grad_rows": 6}

LOSS_RTOL, LOSS_ATOL, GRAD_ATOL, PARITY_ATOL = 1e-5, 1e-7, 1e-6, 1e-4
# phase 4, per parameter/stat leaf after the batch: max |card - CPU| and
# |card - CPU| / |CPU| (Frobenius).  A PReLU kink or a near-tied Kendall pair
# that falls on the other side on the card moves a few weights by ~1e-4
# (measured: 2 of 16384 first-layer weights at 1.2e-4, every leaf's relative
# norm <= 8.4e-5), while a wrong update moves the weights by ~1e-2 (the step
# changes them by 1e-3..1e-2 at lr 1e-2).
LEAF_ATOL, LEAF_RTOL = 1e-3, 1e-3
EPOCHS = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def make_pair(torch, np, seed, t, b, k=5, device="cuda"):
    """Descriptors with a discrete {4,5,6} column (exact ties) and styles
    rank-correlated with them, as training produces."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(t, b, k)).astype(np.float32)
    d[..., 1] = rng.choice([4.0, 5.0, 6.0], size=(t, b))
    dz = (d - d.mean(axis=1, keepdims=True)) / d.std(axis=1, keepdims=True)
    s = (0.6 * dz + rng.normal(size=(t, b, k))).astype(np.float32)
    g = rng.uniform(0.5, 1.5, size=(t,)).astype(np.float32)
    return (torch.tensor(d, device=device), torch.tensor(s, device=device),
            torch.tensor(g, device=device))


def time_ms(torch, fn, reps=200, warmup=20):
    """Mean time per call: CUDA events around ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=200):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so host launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, reps=5, warmup=2) / reps


def bound(name, t, b, k):
    """Least time (ms) for the work of one call, and what bounds it."""
    f32 = 4
    inputs = 2 * t * b * k * f32
    if name == "kendall_pair_sums":
        moved = inputs + t * k * (2 + 2 + 1) * f32 + t * f32      # sums, cnts, w, loss
    else:
        moved = inputs + t * k * f32 + t * f32 + t * b * k * f32   # w, g in; grad out
    ops = OPS_PER_PAIR[name] * t * b * b * k
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(torch, np, kc, tk, batch_sizes):
    """Phase 2: every case against the plain versions; returns the
    main-shape errors."""
    errs = {}
    n_cases = 0
    for b in batch_sizes:
        for t in (1, 8):
            for activate in (False, True):
                d, s, g = make_pair(torch, np, 1000 * b + 10 * t + activate, t, b)
                # K1 wrapper vs its plain version: counts exact, sums, loss
                sums, cnts, w, loss = kc.pair_sums(d, s, activate)
                sums_p, cnts_p, w_p, loss_p = kc.pair_sums_plain(d, s, activate)
                assert torch.equal(cnts, cnts_p), (b, t, activate, cnts, cnts_p)
                torch.testing.assert_close(w, w_p, rtol=0, atol=0)
                torch.testing.assert_close(sums, sums_p, rtol=LOSS_RTOL, atol=LOSS_ATOL)
                torch.testing.assert_close(loss, loss_p, rtol=LOSS_RTOL, atol=LOSS_ATOL)
                # K2 wrapper vs its plain version
                rows = kc.grad_rows(d, s, w, g)
                rows_p = kc.grad_rows_plain(d, s, w_p, g)
                torch.testing.assert_close(rows, rows_p, rtol=0, atol=GRAD_ATOL)
                # the autograd Function vs the plain loss of ops/kendall.py
                s1 = s.clone().requires_grad_(True)
                s2 = s.clone().requires_grad_(True)
                l1 = kc.KendallFunction.apply(d, s1, activate)
                l2 = tk.kendall_constraint(d, s2, activate=activate)
                l1.backward(g)
                l2.backward(g)
                torch.testing.assert_close(l1, l2, rtol=LOSS_RTOL, atol=LOSS_ATOL)
                torch.testing.assert_close(s1.grad, s2.grad, rtol=0, atol=GRAD_ATOL)
                if (b, t, activate) == (1024, 1, True):
                    errs["kendall_pair_sums"] = (l1 - l2).abs().max().item()
                    errs["kendall_grad_rows"] = (s1.grad - s2.grad).abs().max().item()
                n_cases += 1
    torch.cuda.synchronize()
    print(f"kernels: {n_cases} cases agree with the plain versions "
          f"(B in {sorted(batch_sizes)}, T in (1, 8), activate off/on, tied column)")
    return errs


def time_kernels(torch, np, kc):
    d, s, g = make_pair(torch, np, 7, 1, 1024)
    _, _, w, _ = kc.pair_sums(d, s, True)
    calls = {
        "kendall_pair_sums": (lambda: kc.pair_sums(d, s, True),
                              lambda: kc.pair_sums_plain(d, s, True)),
        "kendall_grad_rows": (lambda: kc.grad_rows(d, s, w, g),
                              lambda: kc.grad_rows_plain(d, s, w, g)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        # plain, kernel, kernel, plain: take the mean of each pair
        p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kernel, kernel, plain))
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "device_ms": graph_ms(torch, kernel)}
    return out


class FixedDraws:
    """Sampler stand-in that hands out the given arrays for the named draws."""

    def __init__(self, torch, draws, device):
        self.draws = {k: torch.tensor(v, device=device) for k, v in draws.items()}

    def normal(self, name, shape):
        x = self.draws.pop(name)
        assert tuple(x.shape) == tuple(shape), (name, tuple(x.shape), tuple(shape))
        return x


def batch_parity(torch, np, cfg_path):
    """Phase 4: one faithful batch, card against CPU, at the config's widths
    with the depth cut to 3 layers.  At depth 5 this batch is ill-conditioned:
    a 1e-7 relative perturbation of the weights moves its MI loss by 8.7e-4
    on the CPU alone, so no pointwise bound near rounding can hold; at depth
    3 the same perturbation moves every loss by under 1e-6."""
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
    from rankaae_tpu_torch.train.trainer import RankAAETrainer
    from rankaae_tpu_torch.utils.config import TrainConfig

    b = 1024
    cfg = TrainConfig.from_yaml(cfg_path).replace(
        dropout_rate=0.0, dis_dropout_rate=0.0, dis_noise=0.0, n_layers=3)
    aux, spec, _ = make_synthetic_xanes(n_rows=b, dim=cfg.dim_in, seed=11)
    rng = np.random.default_rng(12)
    draws = {"spec_noise": rng.normal(size=spec.shape).astype(np.float32),
             "z_real": rng.normal(size=(cfg.batch_size, cfg.nstyle)).astype(np.float32),
             "z_sample": rng.normal(size=(b, cfg.nstyle)).astype(np.float32)}
    results = {}
    weights = None
    for dev in ("cpu", "cuda"):
        tr = RankAAETrainer(cfg, n_train=b, n_val=b, device=dev)
        state = tr.init_state(0)
        if weights is None:
            weights = {k: {n: v.clone() for n, v in m.state_dict().items()}
                       for k, m in tr.models.items()}
        for k, m in tr.models.items():
            m.load_state_dict(weights[k])
        for o in state.opt.values():      # non-zero second moments: see
            for v in o.nu:                # tests/test_torch_trainer.py
                v.fill_(1e-8)
        _, losses = tr._train_batch(
            state, torch.tensor(spec.astype(np.float32), device=dev),
            torch.tensor(aux.astype(np.float32), device=dev), 0.3, 0,
            FixedDraws(torch, draws, dev))
        results[dev] = ({k: v.item() for k, v in losses.items()},
                        {k: {n: v.detach().cpu() for n, v in m.state_dict().items()}
                         for k, m in tr.models.items()})
    (l_cpu, w_cpu), (l_gpu, w_gpu) = results["cpu"], results["cuda"]
    for name in l_cpu:
        assert abs(l_cpu[name] - l_gpu[name]) <= PARITY_ATOL, (name, l_cpu[name], l_gpu[name])
    worst_abs = worst_rel = 0.0
    for k in w_cpu:
        for n in w_cpu[k]:
            if w_cpu[k][n].is_floating_point():
                d = (w_cpu[k][n] - w_gpu[k][n]).abs()
                rel = (d.norm() / w_cpu[k][n].norm()).item()
                assert d.max().item() <= LEAF_ATOL and rel <= LEAF_RTOL, (k, n, d.max(), rel)
                worst_abs, worst_rel = max(worst_abs, d.max().item()), max(worst_rel, rel)
    loss_err = max(abs(l_cpu[n] - l_gpu[n]) for n in l_cpu)
    print(f"parity: one faithful batch (B={b}, n_layers 3), card vs CPU: max loss "
          f"difference {loss_err:.3g}; parameters/stats max {worst_abs:.3g}, "
          f"worst per-leaf relative norm {worst_rel:.3g}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.data.dataset import split_sizes
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
    from rankaae_tpu_torch.ops import kendall as tk
    from rankaae_tpu_torch.ops import kendall_cuda as kc
    from rankaae_tpu_torch.train.facade import Trainer
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----------------------------------------------------- #
    t0 = time.perf_counter()
    kc.build()
    print(f"build: {kc.SOURCE.name} in {time.perf_counter() - t0:.2f} s")
    for line in kc.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernels against their plain versions ----------------------- #
    cfg_path = os.path.join(HERE, "example", "fix_config.yaml")
    cfg = TrainConfig.from_yaml(cfg_path)
    n_rows = 7000
    n_train, n_val, _ = split_sizes(n_rows, (cfg.train_ratio, cfg.validation_ratio,
                                             cfg.test_ratio))
    n_full, trailing = divmod(n_train, cfg.batch_size)
    errs = check_kernels(torch, np, kc, tk, {cfg.batch_size, trailing, n_val, 300, 100})
    times = time_kernels(torch, np, kc)

    # ---- 3. main path -------------------------------------------------- #
    n_batch = n_full + (trailing > 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        csv = make_synthetic_xanes_csv(os.path.join(tmp, "synthetic_xanes_7000.csv"),
                                       n_rows=n_rows, dim=cfg.dim_in, seed=0)
        params = Parameters.from_yaml(cfg_path)
        params.update({"max_epoch": EPOCHS})
        print(f"main path: example/fix_config.yaml at full width; cut: max_epoch "
              f"{cfg.max_epoch} -> {EPOCHS}; n_train {n_train} ({n_full} x "
              f"{cfg.batch_size} + {trailing}), n_val {n_val}")
        trainer = Trainer.from_data(csv, config_parameters=params, device="cuda",
                                    work_dir=tmp, verbose=False)
        kc.fwd_launches = kc.bwd_launches = 0
        metrics = trainer.train()
        launches = {"kendall_pair_sums": kc.fwd_launches,
                    "kendall_grad_rows": kc.bwd_launches}
        with open(os.path.join(tmp, "losses.csv")) as f:
            header = f.readline().strip().split(",")
    assert header[0] == "Epoch" and len(header) == 13, header
    for key, values in trainer.logs.items():
        assert np.all(np.isfinite(values)), (key, values)
    assert np.all(np.isfinite(metrics)), metrics
    expect = {"kendall_pair_sums": EPOCHS * (n_batch + 1),    # + validation
              "kendall_grad_rows": EPOCHS * n_batch}
    assert launches == expect, (launches, expect)
    for e, sec in enumerate(trainer.epoch_seconds):
        print(f"epoch {e}: {sec:.4f} s, {n_train / sec:.1f} spectra/s "
              f"(val_recon {trainer.logs['val_recon'][e]:.6f}) [{card}]")
    print(f"final metrics {metrics}; Kendall launches {launches} (expected {expect})")

    # ---- 4. card vs CPU on one batch ----------------------------------- #
    batch_parity(torch, np, cfg_path)

    rows = []
    for name, line in (("kendall_pair_sums", 49), ("kendall_grad_rows", 91)):
        b_ms, b_by = bound(name, 1, cfg.batch_size, cfg.n_aux)
        rows.append({
            "name": name, "route": "cuda",
            "source": "rankaae_tpu_torch/csrc/kendall.cu",
            "replaces": f"rankaae_tpu/ops/kendall_pallas.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": times[name]["device_ms"],
        })
    print("library_ms: null — no single PyTorch call computes the Kendall pair sums "
          "or their gradient rows")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
