#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rankaae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build — compile ``rankaae_tpu_torch/csrc/kendall.cu`` and
   ``csrc/fused_block.cu`` with nvcc, one process per source, in parallel;
2. kernels — hold the Kendall kernels K1 (pair sums, with and without the
   row sums P and N) and K2 (the gradient from P, N, w and g) against their
   plain PyTorch versions on the card, over the batch sizes the main path
   gives them and B 2 and 33 (K1's last-block finish at one tile and at
   several), T in {1, 8} stacked trials, activation off and on, and a
   discrete descriptor column (exact ties); check that the loss and the
   gradient are bit-identical over three calls, and that a CUDA graph of K1
   replays it exactly and leaves its tickets at 0; then time both at the
   main-path shape (T=1, B=1024, K=5), and on the card at T 8 and 32;
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
1e-7), counts, weights and row sums exact (integers), styles gradient atol
1e-6 (sums taken in another order); phase 4 atol 1e-4 on the six losses
(as the CPU parity test against the JAX package), and per leaf of the
weights after the batch a max difference of 1e-3 and a relative norm of
1e-3 (see ``LEAF_ATOL``); phase 5
max |kernel - plain| <= 1e-5 * max |plain| (the same float32 operations,
summed in another order); phase 6 ``reconstruct`` vs ``decode(encode)``
atol 1e-5 and card vs CPU atol 1e-4 on styles and reconstructions.
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
# K1's operations per unordered pair {a, j} of one (t, k): the two
# differences, the sign of their product and its compare.  p_aj = p_ja and
# tgt_ja = -tgt_aj, so one evaluation serves both rows
OPS_PER_PAIR = 4
# and per unordered pair with tgt != 0: the sum and count adds and the
# row-sum add of each of its two rows (a tied pair adds nothing)
OPS_PER_UNTIED_PAIR = 4
# K2's operations per (t, a, k) element: w * P, + N, * scale
OPS_PER_ELEMENT = 3

LOSS_RTOL, LOSS_ATOL, GRAD_ATOL, PARITY_ATOL = 1e-5, 1e-7, 1e-6, 1e-4
# phase 4, per parameter/stat leaf after the batch: max |card - CPU| and
# |card - CPU| / |CPU| (Frobenius).  A PReLU kink or a near-tied Kendall pair
# that falls on the other side on the card moves a few weights by ~1e-4
# (measured: 2 of 16384 first-layer weights at 1.2e-4, every leaf's relative
# norm <= 8.4e-5), while a wrong update moves the weights by ~1e-2 (the step
# changes them by 1e-3..1e-2 at lr 1e-2).
LEAF_ATOL, LEAF_RTOL = 1e-3, 1e-3
EPOCHS = 3
K3_RTOL, RECON_ATOL, SERVE_ATOL = 1e-5, 1e-5, 1e-4
BENCH_B, BENCH_ITERS = 4096, 50


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
    # (a tied column of B 2 may have no spread)
    dz = (d - d.mean(axis=1, keepdims=True)) / np.maximum(d.std(axis=1, keepdims=True), 1e-6)
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
    replayed, so host launch overhead is not in the number.  The warm-up
    runs on the capture stream (K1's tickets are kept per stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    return time_ms(torch, graph.replay, reps=5, warmup=2) / reps


def untied_pairs(d):
    """Unordered pairs {a, j} of one (t, k) with d_a != d_j, over all (t, k)
    of the descriptors d (T, B, K)."""
    return int((d[:, :, None, :] != d[:, None, :, :]).sum().item()) // 2


def bound(name, t, b, k, untied):
    """Least time (ms) for the work of one call, and what bounds it.

    K1 (a training call, with the row sums): reads d and s (2 T B K words),
    writes sums, cnts (2 T K each), w (T K), loss (T) and P, N (2 T B K);
    does OPS_PER_PAIR operations on each of the T K (B^2 - B) / 2 unordered
    pairs and OPS_PER_UNTIED_PAIR more on each of the ``untied`` ones whose
    descriptors differ (this run's data).  One evaluation of a pair serves
    both orders: p_aj = p_ja, tgt_ja = -tgt_aj, so it gives both rows' P/N
    terms (the kernel, which evaluates every ordered pair, does twice this
    work).
    K2: reads P, N (2 T B K), w (T K) and g (T), writes grad (T B K), and
    does OPS_PER_ELEMENT operations per element: bound by bytes."""
    f32 = 4
    if name == "kendall_pair_sums":
        moved = (2 * t * b * k + t * k * (2 + 2 + 1) + t + 2 * t * b * k) * f32
        pairs = t * k * (b * b - b) // 2
        ops = OPS_PER_PAIR * pairs + OPS_PER_UNTIED_PAIR * untied
    else:
        moved = (2 * t * b * k + t * k + t + t * b * k) * f32
        ops = OPS_PER_ELEMENT * t * b * k
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_bound(b, c, fb):
    """Least time (ms) of one K3 call, and what bounds it: x read once and
    out written once (plus the block's weights), and per sample two
    C x C x 11-tap convs (2 operations a tap) and ~(15 + 4E) elementwise
    operations per (channel, position) (two BNs, biases, three PReLUs, the
    excitation's two layers, the final adds)."""
    f32 = 4
    weights = 2 * c * c * fb.K + 10 * c + 2 * fb.E * fb.L + fb.L + fb.E
    moved = (2 * b * c * fb.L + weights) * f32
    ops = b * (2 * 2 * c * c * fb.K * fb.L + (15 + 4 * fb.E) * c * fb.L)
    t_bytes, t_ops = moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_inputs(torch, np, fb, b, c, seed):
    """The probe's ``make_inputs`` (normal * 0.3, variances |.| + 0.5, PReLU
    slopes 0.01) in the wrapper's argument order and the port's layouts."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32) * 0.3, device="cuda")

    def slope():
        return torch.full((c,), 0.01, device="cuda")

    x = f32(b, c, fb.L)
    args = (f32(c), f32(c).abs() + 0.5, f32(c, c, fb.K), f32(c), slope(),
            f32(c), f32(c).abs() + 0.5, f32(c, c, fb.K), f32(c), slope(),
            f32(fb.E, fb.L), f32(fb.E), slope(), f32(fb.L, fb.E), f32(fb.L), slope())
    return x, args


def check_k3(torch, np, fb):
    """Phase 5: K3 against its plain version over batch sizes and channel
    counts; returns the max error at the serving shape (C 4, B 1024)."""
    err_main = None
    for c in (4, 2):
        for b in (1, 77, 1024, 4096):
            x, args = k3_inputs(torch, np, fb, b, c, 100 * c + b)
            y = fb.fused_block(x, *args)
            y_plain = fb.fused_block_plain(x, *args)
            err = (y - y_plain).abs().max().item()
            scale = y_plain.abs().max().item()
            assert err <= K3_RTOL * scale, (c, b, err, scale)
            if (c, b) == (4, 1024):
                err_main = err
    torch.cuda.synchronize()
    print(f"K3: 8 cases agree with the plain version (C in (4, 2), B in (1, 77, 1024, "
          f"4096), max |kernel - plain| <= {K3_RTOL} * max |plain|); error at C 4, "
          f"B 1024: {err_main:.3g}")
    times = {}
    for c, b in ((4, 1024), (4, 4096), (2, 1024)):
        x, args = k3_inputs(torch, np, fb, b, c, 7)
        kernel = lambda: fb.fused_block(x, *args)          # noqa: E731
        plain = lambda: fb.fused_block_plain(x, *args)     # noqa: E731
        p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kernel, kernel, plain))
        b_ms, b_by = k3_bound(b, c, fb)
        times[(c, b)] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                         "device_ms": graph_ms(torch, kernel), "bound_ms": b_ms, "bound_by": b_by}
        print(f"K3 time C={c} B={b}: " + json.dumps(times[(c, b)]))
    return err_main, times


def seeded_models(torch, cfg, seed, device):
    """The autoencoder and discriminator of ``cfg``, torch-default
    initialised from ``seed``, on ``device``."""
    from rankaae_tpu_torch.models.primitives import reset_parameters
    from rankaae_tpu_torch.models.registry import build_autoencoder, build_discriminator

    encoder, decoder = build_autoencoder(cfg)
    models = {"enc": encoder, "dec": decoder, "dis": build_discriminator(cfg)}
    gen = torch.Generator().manual_seed(seed)
    for m in models.values():
        reset_parameters(m, gen)
        m.to(device)
    return models


def serve_normal(torch, np, fb, cfg_path, tmp, card):
    """Phase 6: the serving path of the conv forms; returns the K3 launches
    of the CLI run."""
    from rankaae_tpu_torch import serve
    from rankaae_tpu_torch.data.dataset import read_csv
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
    from rankaae_tpu_torch.models.inference import InferenceModel
    from rankaae_tpu_torch.models.primitives import set_matmul_precision
    from rankaae_tpu_torch.utils.checkpoint import save_model_bundle
    from rankaae_tpu_torch.utils.config import TrainConfig
    from rankaae_tpu_torch.utils.weights import to_jax

    cfg = TrainConfig.from_yaml(cfg_path).replace(ae_form="normal", dropout_rate=0.0,
                                                  dis_dropout_rate=0.0)
    set_matmul_precision(cfg.matmul_precision)
    csv = make_synthetic_xanes_csv(os.path.join(tmp, "serve_7000.csv"), n_rows=7000,
                                   dim=cfg.dim_in, seed=0)
    spec = read_csv(csv)[1][:, cfg.n_aux:]
    models = seeded_models(torch, cfg, 1, "cuda")
    x_all = torch.tensor(spec, device="cuda")
    with torch.no_grad():             # BN running statistics: train-mode forwards only
        for m in models.values():
            m.train()
        for _ in range(3):
            for i in range(0, x_all.shape[0], 1024):
                models["dec"](models["enc"](x_all[i:i + 1024]))
    bundle = save_model_bundle(os.path.join(tmp, "normal.mpk"), *to_jax(models), cfg)
    out = os.path.join(tmp, "served")

    fb.launches = 0
    t0 = time.perf_counter()
    serve.main([bundle, csv, out, "--batch-size", "1024"])
    cli_s = time.perf_counter() - t0
    launches = fb.launches
    styles = np.loadtxt(out + "_styles.txt")
    recon = np.loadtxt(out + "_recon.txt")
    assert styles.shape == (7000, cfg.nstyle) and recon.shape == (7000, 256), \
        (styles.shape, recon.shape)
    assert np.all(np.isfinite(styles)) and np.all(np.isfinite(recon))
    assert launches == 7 * 4, launches     # 7 decode chunks x eblock0, 1, 3, 4
    print(f"serve CLI: normal form, 7000 spectra, batch 1024: {cli_s:.3f} s wall (CSV "
          f"parse, bundle load and text output included); K3 launches {launches} "
          f"(expected 28) [{card}]")

    model = InferenceModel.from_bundle(bundle)
    x = spec[:1024]
    y = model.reconstruct(x)
    fused_err = np.abs(y - model.decode(model.encode(x))).max()
    assert fused_err <= RECON_ATOL, fused_err
    cpu = InferenceModel.from_bundle(bundle, device="cpu")
    z_err = np.abs(model.encode(x) - cpu.encode(x)).max()
    y_err = np.abs(y - cpu.reconstruct(x)).max()
    assert z_err <= SERVE_ATOL and y_err <= SERVE_ATOL, (z_err, y_err)
    assert np.abs(styles[:1024] - cpu.encode(x)).max() <= SERVE_ATOL
    print(f"serve: reconstruct vs decode(encode) {fused_err:.3g}; card vs CPU on 1024 "
          f"rows: styles {z_err:.3g}, reconstructions {y_err:.3g} (atol {SERVE_ATOL})")

    for form, per_round in (("normal", 4), ("compact", 1)):
        if form == "normal":
            bench_model = model
        else:
            ccfg = cfg.replace(ae_form="compact")
            bench_model = InferenceModel(*to_jax(seeded_models(torch, ccfg, 2, "cpu")), ccfg)
        fb.launches = 0
        res = serve.device_benchmark(bench_model, batch_size=BENCH_B, iters=BENCH_ITERS)
        assert fb.launches == per_round * (BENCH_ITERS + 1), (form, fb.launches)
        res["k3_launches"] = fb.launches
        print(f"serve bench ({form}): {json.dumps(res)} [{card}]")
    res = serve.host_benchmark(model, batch_size=BENCH_B, n_batches=16)
    print(f"serve host bench (normal): {json.dumps(res)} [{card}]")
    return launches


def check_kernels(torch, np, kc, tk, batch_sizes):
    """Phase 2: every case against the plain versions, and three repeated
    calls bit-identical; returns the main-shape errors."""
    errs = {}
    n_cases = 0
    for b in batch_sizes:
        for t in (1, 8):
            for activate in (False, True):
                d, s, g = make_pair(torch, np, 1000 * b + 10 * t + activate, t, b)
                # K1 wrapper vs its plain version: counts, weights and row
                # sums exact; sums and loss
                sums, cnts, w, loss, pos, neg = kc.pair_sums(d, s, activate, rows=True)
                sums_p, cnts_p, w_p, loss_p, pos_p, neg_p = kc.pair_sums_plain(
                    d, s, activate, rows=True)
                assert torch.equal(cnts, cnts_p), (b, t, activate, cnts, cnts_p)
                assert torch.equal(pos, pos_p) and torch.equal(neg, neg_p), (b, t, activate)
                torch.testing.assert_close(w, w_p, rtol=0, atol=0)
                torch.testing.assert_close(sums, sums_p, rtol=LOSS_RTOL, atol=LOSS_ATOL)
                torch.testing.assert_close(loss, loss_p, rtol=LOSS_RTOL, atol=LOSS_ATOL)
                # without the row sums (validation): the same values
                sums_v, cnts_v, w_v, loss_v = kc.pair_sums(d, s, activate)
                assert torch.equal(sums_v, sums) and torch.equal(cnts_v, cnts) \
                    and torch.equal(w_v, w) and torch.equal(loss_v, loss), (b, t, activate)
                # K2 wrapper vs its plain version
                rows = kc.grad_rows(pos, neg, w, g)
                rows_p = kc.grad_rows_plain(pos_p, neg_p, w_p, g)
                torch.testing.assert_close(rows, rows_p, rtol=0, atol=GRAD_ATOL)
                # the autograd Function vs the plain loss of ops/kendall.py,
                # and bit-identical over three calls
                s2 = s.clone().requires_grad_(True)
                l2 = tk.kendall_constraint(d, s2, activate=activate)
                l2.backward(g)
                runs = []
                for _ in range(3):
                    s1 = s.clone().requires_grad_(True)
                    l1 = kc.KendallFunction.apply(d, s1, activate)
                    l1.backward(g)
                    runs.append((l1.detach(), s1.grad))
                torch.testing.assert_close(l1, l2, rtol=LOSS_RTOL, atol=LOSS_ATOL)
                torch.testing.assert_close(s1.grad, s2.grad, rtol=0, atol=GRAD_ATOL)
                for l_r, g_r in runs[1:]:
                    assert torch.equal(l_r, runs[0][0]) and torch.equal(g_r, runs[0][1]), \
                        ("not bit-identical", b, t, activate)
                if (b, t, activate) == (1024, 1, True):
                    errs["kendall_pair_sums"] = (l1 - l2).abs().max().item()
                    errs["kendall_grad_rows"] = (s1.grad - s2.grad).abs().max().item()
                n_cases += 1
    torch.cuda.synchronize()
    print(f"kernels: {n_cases} cases agree with the plain versions "
          f"(B in {sorted(batch_sizes)}, T in (1, 8), activate off/on, tied column; "
          f"P, N exact; loss and gradient bit-identical over 3 calls)")
    return errs


def assert_tickets_clear(kc, where):
    """Every K1 ticket buffer (one per device and stream) is back at 0."""
    for key, tickets in kc._tickets.items():
        assert tickets.count_nonzero().item() == 0, f"K1 tickets {key} not reset {where}"


def check_graph(torch, np, kc):
    """K1 (with the row sums) captured in a CUDA graph once its tickets exist
    (warm-up on the capture stream): with its outputs poisoned, each replay
    must rewrite them exactly as an eager call computes them, and leave
    every ticket at 0."""
    d, s, _ = make_pair(torch, np, 5, 8, 1024)
    eager = kc.pair_sums(d, s, True, rows=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kc.pair_sums(d, s, True, rows=True)            # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = kc.pair_sums(d, s, True, rows=True)
    for _ in range(3):
        for x in out:
            x.fill_(float("nan") if x.is_floating_point() else -1)
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(out, eager):
            assert torch.equal(x, y), "graph replay differs from the eager call"
        assert_tickets_clear(kc, "after a graph replay")
    print("graph: K1 captured at T 8, B 1024; 3 replays equal the eager call, tickets at 0")


def time_kernels(torch, np, kc, b, k):
    """Wrapper, device (CUDA graph) and plain times at the main-path shape
    (T 1, B ``b``, K ``k``): K1 as training calls it (with the row sums) and
    as validation does (without), and K2; with the bound of K1 (training
    call) and K2 on these inputs."""
    d, s, g = make_pair(torch, np, 7, 1, b, k)
    _, _, w, _, pos, neg = kc.pair_sums(d, s, True, rows=True)
    calls = {
        "kendall_pair_sums": (lambda: kc.pair_sums(d, s, True, rows=True),
                              lambda: kc.pair_sums_plain(d, s, True, rows=True)),
        "kendall_pair_sums_no_rows": (lambda: kc.pair_sums(d, s, True),
                                      lambda: kc.pair_sums_plain(d, s, True)),
        "kendall_grad_rows": (lambda: kc.grad_rows(pos, neg, w, g),
                              lambda: kc.grad_rows_plain(pos, neg, w, g)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        # plain, kernel, kernel, plain: take the mean of each pair
        p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kernel, kernel, plain))
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                     "device_ms": graph_ms(torch, kernel)}
        print(f"time {name} (T 1, B {b}, K {k}, activate): {json.dumps(out[name])}")
    untied = untied_pairs(d)
    for name in ("kendall_pair_sums", "kendall_grad_rows"):
        out[name]["bound_ms"], out[name]["bound_by"] = bound(name, 1, b, k, untied)
    print(f"bound: K1 {untied} of {k * (b * b - b) // 2} unordered pairs untied; "
          f"K1 {out['kendall_pair_sums']['bound_ms']:.6f} ms "
          f"({out['kendall_pair_sums']['bound_by']}), K2 "
          f"{out['kendall_grad_rows']['bound_ms']:.6f} ms "
          f"({out['kendall_grad_rows']['bound_by']})")
    step = out["kendall_pair_sums"]["device_ms"] + out["kendall_grad_rows"]["device_ms"]
    print(f"Kendall device time of one training step (K1 with rows + K2): {step:.5f} ms")
    for t in (8, 32):                     # stacked trials: the pair work grows with T
        d, s, g = make_pair(torch, np, 8, t, 1024)
        _, _, w, _, pos, neg = kc.pair_sums(d, s, True, rows=True)
        k1 = graph_ms(torch, lambda: kc.pair_sums(d, s, True, rows=True))
        k2 = graph_ms(torch, lambda: kc.grad_rows(pos, neg, w, g))
        print(f"time T={t} B=1024 K=5 device ms: K1 {k1:.5f} ({k1 / t:.5f} a trial), "
              f"K2 {k2:.5f}")
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
    from rankaae_tpu_torch.models.primitives import set_matmul_precision
    from rankaae_tpu_torch.ops import _nvcc
    from rankaae_tpu_torch.ops import fused_block_cuda as fb
    from rankaae_tpu_torch.ops import kendall as tk
    from rankaae_tpu_torch.ops import kendall_cuda as kc
    from rankaae_tpu_torch.train.facade import Trainer
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----------------------------------------------------- #
    t_start = t0 = time.perf_counter()
    _nvcc.compile_all([kc.SOURCE, fb.SOURCE])
    kc.build()
    fb.build()
    print(f"build: {kc.SOURCE.name}, {fb.SOURCE.name} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for source in (kc.SOURCE, fb.SOURCE):     # kept beside the library, built or cached
        for line in _nvcc.build_log(source).splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {source.name}: {line.strip()}")

    # ---- 2. kernels against their plain versions ----------------------- #
    cfg_path = os.path.join(HERE, "example", "fix_config.yaml")
    cfg = TrainConfig.from_yaml(cfg_path)
    n_rows = 7000
    n_train, n_val, _ = split_sizes(n_rows, (cfg.train_ratio, cfg.validation_ratio,
                                             cfg.test_ratio))
    n_full, trailing = divmod(n_train, cfg.batch_size)
    errs = check_kernels(torch, np, kc, tk, {cfg.batch_size, trailing, n_val, 300, 100, 33, 2})
    check_graph(torch, np, kc)
    times = time_kernels(torch, np, kc, cfg.batch_size, cfg.n_aux)

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
        torch.cuda.synchronize()
        assert_tickets_clear(kc, "after training")
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
    print(f"phases 1-4: {time.perf_counter() - t_start:.1f} s")

    # ---- 5. K3 against its plain version ------------------------------- #
    set_matmul_precision("highest")       # TF32 off for the plain version's convs
    k3_err, k3_times = check_k3(torch, np, fb)

    # ---- 6. serving the conv forms -------------------------------------- #
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        k3_launches = serve_normal(torch, np, fb, cfg_path, tmp, card)
    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, line in (("kendall_pair_sums", 49), ("kendall_grad_rows", 91)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "rankaae_tpu_torch/csrc/kendall.cu",
            "replaces": f"rankaae_tpu/ops/kendall_pallas.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
            "library_ms": None, "device_ms": times[name]["device_ms"],
        })
    k3 = k3_times[(4, 1024)]
    rows.append({
        "name": "fused_block", "route": "cuda",
        "source": "rankaae_tpu_torch/csrc/fused_block.cu",
        "replaces": "scripts/fused_block_probe.py:50",
        "launches": k3_launches, "max_abs_err": k3_err,
        "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None, "device_ms": k3["device_ms"],
    })
    print("library_ms: null — no single PyTorch call computes the Kendall pair sums "
          "or their gradient rows, nor the fused EncodingBlock (two convs, BNs, PReLUs, "
          "residual and excitation MLP); K3's row is at the serving shape C 4, B 1024")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
