#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``rankaae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build — compile ``rankaae_tpu_torch/csrc/kendall.cu``,
   ``csrc/fused_block.cu`` and ``csrc/conv1d.cu`` with nvcc, one process
   per source, in parallel; print each kernel's registers and spills from
   the ptxas report (for ``conv1d.cu``'s 97 kernels their count and the
   most registers one uses), and fail if any kernel spills;
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
   size with the depth cut to 3 layers;
5. K3 — the fused EncodingBlock kernel against its plain version, C in
   {4, 2} x B in ``K3_BATCHES`` and twice one wave of its persistent grid
   + 5; bit-identical over three calls and a CUDA graph replay equal to the
   eager call; then wrapper, device and plain times and the bound at
   ``K3_TIMED``;
6. serving — the normal form served by the CLI from a seeded bundle (28 K3
   launches, card vs CPU), then device-resident throughput of the normal
   and compact forms and transfer-inclusive throughput of the normal form;
7. conv training — (a) the main path of the conv forms: phase 3's dataset
   and config with ``ae_form: normal`` (widths as published, only
   ``max_epoch`` cut) trained by ``Trainer.from_data(...).train()`` on the
   card; finite losses, the 13-column ``losses.csv``, the three bundles
   written and reloadable, exact K1, K2 and K3 launch counts (K3 runs in
   each validation's two eval-mode decodes), epoch seconds and spectra/s;
   then ``final.mpk`` served by the CLI on the card (28 K3 launches) and on
   the CPU; (b) the other branches, short: compact with the CNN
   discriminator and GRL (2 epochs), compact with the CNN discriminator
   without GRL (1 epoch; the D and G optimizers both step), and RAdam and
   AdaBound (1 epoch each, compact); (c) one faithful batch of the normal
   form with the CNN discriminator at the config's batch size, card vs
   CPU from the same weights and draws;
8. trials — (a) the main path of several trials: ``python -m
   rankaae_tpu_torch.cli.train_sc`` (its ``main``) on ``example/
   fix_config.yaml`` at full width with its ``trials: 8`` (only
   ``max_epoch`` cut, 2000 -> 3) and phase 3's dataset; the whole artifact
   tree (``main_process_message.txt``, every ``training/job_<i>/`` and every
   file in it), every bundle reloaded, and K1 and K2 launched exactly as
   often as in phase 3's one-trial run of the same epochs: one launch
   carries all 8 trials; (b) trial independence on the card: trial 2 of a
   4-trial run (at ``INDEPENDENCE_LR``) over 2 epochs against the 1-trial
   run with seed + 2, from the same second moments of 1e-8 as phase 4,
   beside the spread a 1e-7 weight perturbation makes; once at phase 4's
   config (no draws but the permutations, spectrum noise and priors; both
   again at ``CHAOTIC_LR``, not held) and once with the config's dropout
   rates and discriminator noise as well, so that every per-trial draw of
   the main path is held; (c)
   steady-epoch spectra/s per GPU (T * n_train / epoch seconds) of
   ``example/fix_config.yaml`` at T 1, 8 and 32 (the launches, device
   time and idle share of a profiled epoch at T 1 and 32 are 11e's
   faithful rows);
9. the rest of the user's pipeline — (a) resume: ``train_sc`` of
   ``example/fix_config.yaml`` (its 8 trials, full width, ``alpha_flat_step``
   ~ 0 so that the GRL ramp does not depend on ``max_epoch``) uncut for 4
   epochs, and cut at 2 (``--checkpoint-every 2``, ``max_epoch`` 2) then
   ``--resume``d to 4: every ``losses.csv`` and every final, best and
   best-recon bundle with its manifest bit-identical, K1 and K2 launched
   once a step in each run, the seconds of each checkpoint write and of the
   resume's load; (b) recalibration: ``train_sc`` of the normal form (2
   trials in one wave, 3 epochs) with ``bn_recalibrate`` and
   ``amp_recalibrate``: every manifest's ``amp_gain`` in [0.5, 2], exact
   K1, K2 and K3 launches (K3 once a trial in the validations and in each
   bundle's ``amplitude_gain``), and
   ``recalibrate_batch_stats`` (at dropout 0) and ``amplitude_gain`` of one
   bundle card vs CPU; (c) the report: ``generate`` over 8a's tree (FC, 8
   trials) and 9b's (normal form, through K3) on the card, then on the CPU
   over copies: every score of ``report.json``, the ranks and the spectra
   dumps, the wall time of each report and its exact K3 launches.  Where
   matplotlib is not installed the reports draw no figure and say so;
10. every form stacked on the trial axis — (a) ``train_sc`` of
   ``example/fix_config.yaml`` with ``ae_form: normal`` at full width,
   batch 1024, its 8 trials in one wave, EPOCHS epochs: the whole tree and
   every bundle reloaded, K1 and K2 launched exactly as often as phase 3's
   one-trial run (one launch carries the 8 trials), K3 once a trial and
   fused block in each validation's two eval-mode decodes (8 x 3 x 2 x 4 =
   192); then the normal form's steady-epoch spectra/s per GPU at T 1 and
   8, and a profiled epoch (launches, device time, idle share) at T 1
   (at T 8 it is 11e's faithful row); (b)
   trial independence of a stacked conv run: trial 2 of a 4-trial
   normal-form run (the config's dropout and noise, ``INDEPENDENCE_LR``, 2
   epochs) against the 1-trial run of seed + 2 under cuDNN's deterministic
   algorithms (their cost printed), held to phase 4's tolerances or twice
   the 1e-7 perturbation spread where that is larger; (c) the qved form:
   ``train_sc`` of its 8 trials (EPOCHS epochs) on a seeded 7,000-row
   12-dim dataset, the tree and bundles, K1 and K2 as phase 3's; one
   faithful qved batch with the plain MSE target and one with the
   config's flex target (which divides by input means near 0 on these
   q-vectors), card vs CPU, each at phase 4's tolerances, or twice the
   larger of that batch's 1e-7 weight and input perturbation spreads on
   the CPU (measured in the run) where that is larger; a qved bundle
   served by the CLI card vs CPU (atol 1e-4);
11. the trainer's remaining options — (a) ``train_sc`` of
   ``example/fix_config.yaml`` (full width, batch 1024, its 8 trials in one
   wave, EPOCHS epochs) with ``protocol: fused`` and with ``protocol:
   joint``, each for the FC and the normal form: the tree, every bundle
   reloaded, K1 and K2 launched as phase 3's one-trial run and K3 as 10a's
   (192) for the normal form; (b) one batch card vs CPU from the same
   weights and draws: fused FC (phase 4's depth 3), fused compact with the
   CNN discriminator without GRL, joint FC (depth 3) and joint normal
   form; (c) ``flat_optim``: the FC and the normal form (8 trials,
   EPOCHS epochs; the normal form under cuDNN's deterministic algorithms)
   with and without the knob, every ``losses.csv`` and bundle
   bit-identical (where two runs without the knob are not bit-identical
   either, their difference is printed and bounds the pair), and an
   8-trial checkpoint written without the knob refused by a ``--resume``
   with it; (d) bfloat16 activations: the FC and the normal form (8
   trials, EPOCHS epochs): finite losses, the launches as (a), the tree,
   every bundle's leaves float32, job_1's final bundle served by the CLI
   card vs CPU (float32 inference), and one bfloat16 FC batch card vs CPU
   (at ``lr_base`` 1e-4);
   (e) each of faithful, faithful + ``flat_optim``, fused, joint and
   bfloat16 at FC T 1, FC T 32 and normal T 8, each through one
   ``tools/profile_epoch.py`` call: the median spectra/s per GPU of three
   steady epochs and a profiled epoch's launches, device time (summed and
   busy) and idle share;
12. the rest of the JAX package — (a) ``remat``: ``train_sc`` of the
   normal form and of the compact form with the CNN discriminator (the
   config's 8 trials, EPOCHS epochs) with ``remat: true`` and without,
   under cuDNN's deterministic algorithms: every ``losses.csv`` and bundle
   bit-identical (where not, held to phase 4's tolerances and printed), K1
   and K2 as phase 3's one-trial run, K3 once a trial and fused block in
   each validation's two decodes; then the normal form's peak device memory
   and median steady-epoch seconds at T 8 and 32, with and without; (b)
   trials over ranks: ``train_sc`` of the config's 8 FC trials at
   ``INDEPENDENCE_LR`` over 2 ranks on the one card (``python -m
   torch.distributed.run``, each rank ``--device cuda:0``): the tree file
   for file as 8a's, every ``losses.csv`` and bundle bit-identical to one
   process training the same stacks (waves of 4), the training losses
   within phase 4's loss tolerance (8b's) of one process in one wave (whose
   batched products sum in another order; the largest leaf difference
   printed), each rank's K1 and K2 as phase 3's one-trial run, and the wall
   times beside 8a's; (c) the trial x
   dp layout (2 trials at dp 2, one rank a card, NCCL) against dp 1, only
   where the machine has two cards, else one line saying why not; (d) the
   native CSV loader against pandas on the 7,000-row CSV: equal, and the
   median time of each;
13. the JAX package's public surface — (a) ``RankAAETrainer.run`` of
   ``example/fix_config.yaml``'s 8 trials (full width, EPOCHS epochs)
   against ``run_epochs`` over [0, RUN_CUT), its train state saved with
   ``save_train_state``, reloaded into a fresh trainer and resumed by
   ``run(start_epoch=RUN_CUT)``: every log and every train-state leaf
   bit-identical, K1 and K2 twice phase 3's one-trial run; (b)
   ``get_dataloaders`` over the 7,000-row CSV at B 1024 feeding a seeded
   ``DualAAE`` of the normal form with ``DiscriminatorFC`` on the card,
   against the same module carried to the CPU by the weight bridge, K3 four
   launches a batch; (c) ``native_available()`` printed;
14. the training-quality harness — ``python -m
   rankaae_tpu_torch.tools.parity_experiment --mode ours`` (its ``main``) at
   FC, 4 seeds x 6 epochs on 2,000 rows, once with ``--segment-epochs 3``
   and once without: (a) every stat of the two records equal; (b) the
   record's keys the JAX package's (``artifacts/parity_fused/
   fc300_faithful/ours.json``) plus ``stack``, ``device``, ``seed_scheme``
   and ``command``, every number finite, every trace 6 epochs long; (c) the
   final weights of two seeds scored by ``_final_stats`` on the card and on
   the CPU; (d) ``--mode aggregate`` against ``artifacts/parity_fc300``'s
   reference seeds and ``tools/parity_gate.py`` against the JAX record
   render; K1 and K2 as 6 epochs of 4 and 3 batches' worth a run.
15. the grouped conv kernels C1–C3 (``ops/conv1d_cuda.py``) — (a) every
   per-group shape of ``SHAPES`` as a convolution with no, zero and
   replicate padding and, where kernel == stride, as a transposed one, over
   ``CONV_LENGTHS`` x ``CONV_ROWS``, then ``CONV_LARGE`` at the main path's
   B 1024, T 32 (several tiles a block): C1, C2 and C3 against their plain
   versions, C3 bit-identical over two calls, C1 with its bias equal to C1
   without it plus the bias, bit for bit; (b) their times at
   ``CONV_TIMED`` (B 1024, T 32) beside the byte bound, the plain versions'
   and cuDNN's (``library_ms``, a yardstick the port never calls); (c) in a
   process of its own, one traced training epoch of the normal and of the
   compact form at T 32: the ``conv.*`` counters equal to the calls the
   epoch's protocol makes and to the conv kernels the device trace shows,
   and no cuDNN convolution kernel; (d) the first epoch from a seeded state,
   run twice: every weight, statistic, moment and log bit-identical.
16. the trial sampler's draws D1 (``ops/draws_cuda.py``) — (a) against its
   plain version, at small shapes, the T 256 cells' largest and every call
   of a T 8 epoch; (b) ``TrialSampler`` on the card; (c) a traced epoch in
   a process of its own: D1's launches = spans = trace; (d) its times.
17. the channel PReLUs and branch sums P1 (``ops/prelu_cuda.py``) — (a)
   every P1 call of a T 8 training epoch of the normal, compact and compact
   + CNN forms held to the plain version as called (forward and each dy bit
   for bit, slope gradients within ``PRELU_DW_RTOL`` and bit-identical over
   two calls), then each distinct call again at the cells' T 256; (b) its
   times at ``PRELU_TIMED`` (a normal block's end at T 256, and the
   one-channel excitation laid out (C, B, L)) beside the byte bound, the
   plain version's and ``F.prelu`` and the adds' (``library_ms``); (c) in a
   process of its own, a traced T 8 epoch of compact and normal: the P1
   kernels of the trace = the ``prelu.*`` counters, the tail launches = the
   block forwards run module by module, no PyTorch PReLU kernel.

Output: the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  Tolerances: loss rtol 1e-5 (atol
1e-7), counts, weights and row sums exact (integers), styles gradient atol
1e-6 (sums taken in another order); phase 15a max |kernel - plain| over
max |plain| at ``CONV_RTOL`` (C1 and C2 sum at most 8 x 17 products an
output, C3 up to N x L); phase 4 atol 1e-4 on the six losses (as the CPU
parity test against the JAX package), and per leaf of the
weights after the batch a max difference of 1e-3 and a relative norm of
1e-3 (see ``LEAF_ATOL``); phase 5
max |kernel - plain| <= 1e-5 * max |plain| (the same float32 operations,
summed in another order); phase 6 ``reconstruct`` vs ``decode(encode)``
atol 1e-5 and card vs CPU atol 1e-4 on styles and reconstructions; phase 7
serving card vs CPU atol 1e-4, and phase 7c the tolerances of
``CONV_BATCH_LOSS_ATOL`` and ``CONV_BATCH_LEAF_ATOL``: that batch is
ill-conditioned, so they are twice the spread a 1e-7 weight perturbation
shows on the CPU alone (``rankaae_tpu_torch/tools/batch_spread.py``), and
phase 4's where that is larger; phase 8b phase 4's tolerances, on the six
training losses of both epochs and on every leaf, and every leaf within 1%
of how far the weights moved; phase 9a bit-identical; 9b the recalibrated
statistics within 1e-4 relative to max(1, |CPU|) and the gain within 1e-4;
9c every score of the report within 1e-3 and ``Reconstruct Err`` (rounded
to 4 decimals) within 1e-4 and one rounding unit, the ranks identical unless
two trials' scores lie within 1e-3 (they are printed then), and the best
model's styles and reconstructions within 1e-4, as phase 6; 11b phase
4's tolerances, or twice the spread 4 perturbations of the weights by 1e-7
relative make on the CPU (measured in the run) where a difference exceeds
them; 11c bit-identical; 11d serving 1e-4 as phase 6, and the bfloat16
batch twice the CPU spread of 4 perturbations of the weights by 2^-9
relative (half a bfloat16 unit), never under phase 4's tolerances; 12a
bit-identical, or phase 4's tolerances; 12b bit-identical to the same
stacks, and phase 4's loss tolerance on the training losses against one
wave (8b's); 12c
phase 4's loss tolerance on every log; 12d exact; 13a bit-identical; 13b
serving's atol 1e-4 on the reconstructions and discriminator outputs; 14a
equal; 14c the MSEs within 1e-4 relative, the Spearmans, Shapiro-W and the
amplitude statistics within 1e-3 (a near-tied rank may flip).
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: the port's launch counters (``rankaae_tpu_torch/utils/tracing.py``) by the
#: kernel names this script prints
LAUNCH_COUNTERS = {"kendall_pair_sums": "kendall.fwd_launches",
                   "kendall_grad_rows": "kendall.bwd_launches", "fused_block": "k3.launches",
                   "prelu_sum_fwd": "prelu.fwd_launches", "prelu_sum_bwd": "prelu.bwd_launches",
                   "prelu_sum_tail": "prelu.tail_launches"}
#: the kernels zero_launches() and read_launches() take where none is named
MAIN_KERNELS = ("kendall_pair_sums", "kendall_grad_rows", "fused_block")
#: P1's counters (forward launches, backward launches: two a call, and the
#: forward launches that summed a block's branches)
P1_KERNELS = ("prelu_sum_fwd", "prelu_sum_bwd", "prelu_sum_tail")


def zero_launches(*kernels):
    """Zero the launch counters of ``kernels`` (MAIN_KERNELS where none is
    named)."""
    from rankaae_tpu_torch.utils import tracing

    tracing.reset_counters(*(LAUNCH_COUNTERS[k] for k in kernels or MAIN_KERNELS))


def read_launches(*kernels):
    """The launches of ``kernels`` (MAIN_KERNELS where none is named) since
    their counters were last zeroed."""
    from rankaae_tpu_torch.utils import tracing

    return {k: tracing.counter(LAUNCH_COUNTERS[k]) for k in kernels or MAIN_KERNELS}

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
# 1050: the validation split, which training's eval-mode decodes give K3
K3_BATCHES = (1, 2, 31, 33, 77, 129, 1023, 1024, 1050, 4096)
# (C, B): the serving shape of the 4-channel blocks, and the 4096 rounds of
# device_benchmark's normal form (its 4- and 2-channel blocks)
K3_TIMED = ((4, 1024), (4, 4096), (2, 1024), (2, 4096))
BENCH_B, BENCH_ITERS = 4096, 50
# phase 7c: the largest change over 16 perturbations of the weights by
# 1e-7 relative, on the CPU alone, of this batch (normal form, CNN
# discriminator, B 1024, data seed 11, draws seed 12, weights of seed 0):
# ``python -m rankaae_tpu_torch.tools.batch_spread --ae-form normal
# --cnn-discriminator --samples 16`` (4 samples gave a tenth of the aux
# spread: the tail is long, 8 and 16 agree).  The tolerance is twice it,
# and never under phase 4's.  The adversarial step is well conditioned;
# from there on rounding differences grow to percents.
CONV_BATCH_SPREAD = {"dis": 2.4e-7, "gen": 0.0, "aux": 2.31e-3, "recon": 2.34e-4,
                     "smooth": 2.11e-2, "mi": 5.74e-2}
CONV_BATCH_LOSS_ATOL = {k: max(PARITY_ATOL, 2 * v) for k, v in CONV_BATCH_SPREAD.items()}
CONV_BATCH_LEAF_ATOL = {"params": 2 * 3.51e-2, "stats": 2 * 7.82e-2}
# the compact-form branch runs of phase 7b: (label, overrides, epochs)
BRANCH_RUNS = (
    ("compact, CNN discriminator, GRL", {"use_cnn_discriminator": True}, 2),
    ("compact, CNN discriminator, no GRL", {"use_cnn_discriminator": True,
                                            "gradient_reversal": False}, 1),
    ("compact, RAdam", {"optimizer_name": "RAdam"}, 1),
    ("compact, AdaBound", {"optimizer_name": "AdaBound"}, 1),
)


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


def check_k3(torch, fb):
    """Phase 5: K3 against its plain version over channel counts and batch
    sizes (the ragged edges of the warp-per-sample tiling and, past one wave
    of the persistent grid, of its loop), bit-identical over three calls,
    and replayed exactly from a CUDA graph; then its times.  Inputs are
    drawn as the probe's ``make_inputs`` draws them.  Returns the max error
    at the serving shape (C 4, B 1024) and the times."""
    from rankaae_tpu_torch.tools.time_fused_block import inputs

    err_main = None
    n_cases = 0
    for c in (4, 2):
        wave = fb.wave(c)
        for b in (*K3_BATCHES, 2 * wave + 5):
            x, args = inputs(fb, b, c, 100 * c + b)
            y = fb.fused_block(x, *args)
            y_plain = fb.fused_block_plain(x, *args)
            err = (y - y_plain).abs().max().item()
            scale = y_plain.abs().max().item()
            assert err <= K3_RTOL * scale, (c, b, err, scale)
            if (c, b) == (4, 1024):
                err_main = err
            n_cases += 1
        print(f"K3 C={c}: one wave of the persistent grid holds {wave} samples")
    torch.cuda.synchronize()
    print(f"K3: {n_cases} cases agree with the plain version (C in (4, 2), B in "
          f"{K3_BATCHES} and twice a wave + 5, max |kernel - plain| <= {K3_RTOL} * "
          f"max |plain|); error at C 4, B 1024: {err_main:.3g}")
    for c in (4, 2):
        x, args = inputs(fb, 4096, c, 11)
        eager = [fb.fused_block(x, *args) for _ in range(3)]
        assert all(torch.equal(y, eager[0]) for y in eager[1:]), ("not bit-identical", c)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fb.fused_block(x, *args)                     # warm-up
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            y = fb.fused_block(x, *args)
        for _ in range(2):
            y.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(y, eager[0]), ("graph replay differs from the eager call", c)
    print("K3: bit-identical over 3 calls and a CUDA graph replay equals the eager call "
          "(C 4 and 2, B 4096)")
    times = {}
    for c, b in K3_TIMED:
        x, args = inputs(fb, b, c, 7)
        kernel = lambda: fb.fused_block(x, *args)          # noqa: E731
        plain = lambda: fb.fused_block_plain(x, *args)     # noqa: E731
        p1, k1, k2, p2 = (time_ms(torch, f) for f in (plain, kernel, kernel, plain))
        b_ms, b_by = k3_bound(b, c, fb)
        times[(c, b)] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                         "device_ms": graph_ms(torch, kernel), "bound_ms": b_ms, "bound_by": b_by}
        times[(c, b)]["host_share_ms"] = times[(c, b)]["ms"] - times[(c, b)]["device_ms"]
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

    zero_launches("fused_block")
    t0 = time.perf_counter()
    serve.main([bundle, csv, out, "--batch-size", "1024"])
    cli_s = time.perf_counter() - t0
    launches = read_launches()["fused_block"]
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
        zero_launches("fused_block")
        res = serve.device_benchmark(bench_model, batch_size=BENCH_B, iters=BENCH_ITERS)
        k3 = read_launches()["fused_block"]
        assert k3 == per_round * (BENCH_ITERS + 1), (form, k3)
        res["k3_launches"] = k3
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
        b1, by1 = bound("kendall_pair_sums", t, 1024, k, untied_pairs(d))
        b2, by2 = bound("kendall_grad_rows", t, 1024, k, 0)
        print(f"time T={t} B=1024 K=5 device ms: K1 {k1:.5f} ({k1 / t:.5f} a trial; bound "
              f"{b1:.6f}, {by1}), K2 {k2:.5f} (bound {b2:.7f}, {by2})")
    return out


def batch_pair(torch, np, cfg, data=None):
    """One batch of ``cfg`` (dropout and discriminator noise at 0, any
    protocol), on the CPU and on the card, from the same weights (carried
    through the weight bridge) and the same draws, at the config's batch
    size, on ``data`` ((spec, aux), default the synthetic spectra of seed
    11).  Returns ((losses, leaves) on the CPU, the same on the card, the
    names of the parameter leaves)."""
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
    from rankaae_tpu_torch.train.trainer import RankAAETrainer
    from rankaae_tpu_torch.utils.sampler import FixedDraws

    b = cfg.batch_size
    if data is None:
        aux, spec, _ = make_synthetic_xanes(n_rows=b, dim=cfg.dim_in, seed=11)
    else:
        spec, aux = data
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
            weights = {k: {n: v.detach().clone() for n, v in sd.items()}
                       for k, sd in tr.trial_state_dicts(0).items()}
        tr.load_trial_state_dicts(0, weights)
        for o in state.opt.values():      # non-zero second moments: see
            for v in o.nu:                # tests/torch_parity.py
                v.fill_(1e-8)
        _, losses = tr._train_batch(
            state, torch.tensor(spec.astype(np.float32), device=dev)[None],
            torch.tensor(aux.astype(np.float32), device=dev)[None], 0.3, 0,
            FixedDraws({k: v[None] for k, v in draws.items()}, device=dev))
        params = {f"{k}.{n}" for k, m in tr.models.items() for n, _ in m.named_parameters()}
        results[dev] = ({k: v.item() for k, v in losses.items()},
                        {f"{k}.{n}": v.detach().cpu() for k, m in tr.models.items()
                         for n, v in m.state_dict().items() if v.is_floating_point()})
    return results["cpu"], results["cuda"], params


def pair_errors(pair):
    """|card - CPU| of each loss, and of each leaf (kind, max, relative
    Frobenius norm), of a :func:`batch_pair`."""
    (l_cpu, w_cpu), (l_gpu, w_gpu), params = pair
    leaves = {}
    for n in w_cpu:
        d = (w_cpu[n] - w_gpu[n]).abs()
        leaves[n] = ("params" if n in params else "stats", d.max().item(),
                     (d.norm() / w_cpu[n].norm()).item())
    return {n: abs(l_cpu[n] - l_gpu[n]) for n in l_cpu}, leaves


def batch_parity(torch, np, cfg, loss_atol, leaf_atol, leaf_rtol=None, data=None):
    """One batch of ``cfg`` card against CPU (:func:`batch_pair`).  Asserts
    each loss within ``loss_atol[name]`` and each parameter/statistic leaf
    after the batch within ``leaf_atol["params"|"stats"]`` (max |card -
    CPU|) and, if given, ``leaf_rtol`` (|card - CPU| / |CPU|, Frobenius).
    Returns the largest loss difference and the worst leaf differences."""
    pair = batch_pair(torch, np, cfg, data)
    (l_cpu, _), (l_gpu, _), _ = pair
    loss, leaves = pair_errors(pair)
    for name in loss:
        assert loss[name] <= loss_atol[name], (name, l_cpu[name], l_gpu[name], loss_atol[name])
    worst = {"params": 0.0, "stats": 0.0, "rel": 0.0}
    for n, (kind, d, rel) in leaves.items():
        assert d <= leaf_atol[kind], (n, d, leaf_atol[kind])
        assert leaf_rtol is None or rel <= leaf_rtol, (n, rel)
        worst[kind] = max(worst[kind], d)
        worst["rel"] = max(worst["rel"], rel)
    return max(loss.values()), worst, l_cpu, l_gpu


def train_conv(torch, np, kc, fb, cfg_path, tmp, card, n_batch):
    """Phase 7a and 7b: the conv forms trained on the card through the
    facade, the trained normal-form bundle served card vs CPU.  Returns the
    launches of the main path (7a: training, then serving) and P1's by path
    ({"normal": 7a's training, "compact": 7b's runs summed})."""
    from rankaae_tpu_torch import serve
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
    from rankaae_tpu_torch.models.inference import InferenceModel
    from rankaae_tpu_torch.train.facade import Trainer
    from rankaae_tpu_torch.utils.checkpoint import load_model_bundle
    from rankaae_tpu_torch.utils.config import Parameters

    csv = make_synthetic_xanes_csv(os.path.join(tmp, "synthetic_xanes_7000.csv"),
                                   n_rows=7000, dim=256, seed=0)

    def train(overrides, epochs, work_dir):
        params = Parameters.from_yaml(cfg_path)
        params.update({**overrides, "max_epoch": epochs})
        trainer = Trainer.from_data(csv, config_parameters=params, device="cuda",
                                    work_dir=work_dir, verbose=False)
        zero_launches()
        zero_launches(*P1_KERNELS)
        metrics = trainer.train()
        torch.cuda.synchronize()
        launches, p1 = read_launches(), read_launches(*P1_KERNELS)
        for key, values in trainer.logs.items():
            assert np.all(np.isfinite(values)), (overrides, key, values)
        assert np.all(np.isfinite(metrics)), (overrides, metrics)
        # every block ends in P1; a backward call is two launches
        assert p1["prelu_sum_tail"] > 0 and p1["prelu_sum_bwd"] % 2 == 0, (overrides, p1)
        return trainer, launches, p1

    # ---- 7a: the normal form, the slice's main path ---------------------- #
    t0 = time.perf_counter()
    work = os.path.join(tmp, "normal")
    trainer, launches, p1_normal = train({"ae_form": "normal"}, EPOCHS, work)
    assert_tickets_clear(kc, "after conv training")
    with open(os.path.join(work, "losses.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[0] == "Epoch" and len(header) == 13, header
    # K3: the two eval-mode decodes of each validation (z and z_sample) x the
    # normal decoder's four c_in == c_out stride-1 blocks (eblock0, 1, 3, 4)
    expect = {"kendall_pair_sums": EPOCHS * (n_batch + 1),
              "kendall_grad_rows": EPOCHS * n_batch, "fused_block": EPOCHS * 2 * 4}
    assert launches == expect, (launches, expect)
    for name in ("final", "best_tracked", "best_recon"):
        path = os.path.join(work, f"{name}.mpk")
        _, _, bcfg, extra = load_model_bundle(path)
        assert bcfg.ae_form == "normal", (name, bcfg.ae_form)
        assert set(extra) == {"final": set(), "best_tracked": {"best_epoch", "best_combined"},
                              "best_recon": {"best_recon_epoch", "best_recon_mse"}}[name]
        InferenceModel.from_bundle(path, device="cpu")
    n_train = trainer.core.n_train
    for e, sec in enumerate(trainer.epoch_seconds):
        print(f"conv epoch {e} (normal): {sec:.4f} s, {n_train / sec:.1f} spectra/s "
              f"(val_recon {trainer.logs['val_recon'][e]:.6f}) [{card}]")
    print(f"7a train: normal form, {EPOCHS} epochs, launches {launches} (expected "
          f"{expect}), P1 {json.dumps(p1_normal)}; three bundles written and reloaded; final "
          f"metrics "
          f"{[float(m) for m in trainer.logs['metrics'][-1]]}")

    final = os.path.join(work, "final.mpk")
    out = {}
    for dev in ("cuda", "cpu"):
        zero_launches("fused_block")
        serve.main([final, csv, os.path.join(tmp, f"served_{dev}"), "--batch-size", "1024",
                    "--device", dev])
        if dev == "cuda":
            launches["fused_block_serve"] = read_launches()["fused_block"]
        out[dev] = [np.loadtxt(os.path.join(tmp, f"served_{dev}_{k}.txt"))
                    for k in ("styles", "recon")]
    assert launches["fused_block_serve"] == 7 * 4, launches     # 7 chunks x 4 blocks
    (z_gpu, y_gpu), (z_cpu, y_cpu) = out["cuda"], out["cpu"]
    assert z_gpu.shape == (7000, 6) and y_gpu.shape == (7000, 256), (z_gpu.shape, y_gpu.shape)
    z_err, y_err = np.abs(z_gpu - z_cpu).max(), np.abs(y_gpu - y_cpu).max()
    assert z_err <= SERVE_ATOL and y_err <= SERVE_ATOL, (z_err, y_err)
    print(f"7a serve: the trained final.mpk by the CLI, 7000 spectra: card vs CPU styles "
          f"{z_err:.3g}, reconstructions {y_err:.3g} (atol {SERVE_ATOL}); K3 launches "
          f"{launches['fused_block_serve']} (expected 28); 7a {time.perf_counter() - t0:.1f} s")

    # ---- 7b: the other branches, short ----------------------------------- #
    t0 = time.perf_counter()
    p1_compact = dict.fromkeys(P1_KERNELS, 0)
    for i, (label, overrides, epochs) in enumerate(BRANCH_RUNS):
        tr, counts, p1 = train({"ae_form": "compact", **overrides}, epochs,
                               os.path.join(tmp, f"branch{i}"))
        p1_compact = {k: p1_compact[k] + p1[k] for k in P1_KERNELS}
        opt = tr.state.opt
        steps = epochs * n_batch
        if overrides.get("gradient_reversal", True):
            assert opt["adversarial"].count == steps and opt["generator"].count == 0, label
        else:
            assert opt["discriminator"].count == opt["generator"].count == steps, label
            assert opt["adversarial"].count == 0, label
            assert np.all(tr.logs["train_gen"] > 0) and np.all(tr.logs["val_gen"] > 0), label
        # compact decoder: one fused block, two eval-mode decodes a validation
        assert counts["fused_block"] == epochs * 2, (label, counts)
        print(f"7b {label}: {epochs} epoch(s) finite, val_recon "
              f"{float(tr.logs['val_recon'][-1]):.6f}, train_dis "
              f"{float(tr.logs['train_dis'][-1]):.4f}, train_gen "
              f"{float(tr.logs['train_gen'][-1]):.4f}, epoch s "
              f"{[round(x, 4) for x in tr.epoch_seconds]}, P1 {json.dumps(p1)} [{card}]")
    print(f"7b: {len(BRANCH_RUNS)} runs in {time.perf_counter() - t0:.1f} s")
    return launches, {"normal": p1_normal, "compact": p1_compact}


# phase 8b: over two epochs phase 4's config is chaotic at its own learning
# rate and still at 1e-5 (8b prints, at 1e-5 too, the spread that a 1e-7
# relative perturbation of the weights makes on the card: larger than the
# difference between the two runs, and than phase 4's tolerances); at
# INDEPENDENCE_LR it is not, and the check means something.
INDEPENDENCE_LR, CHAOTIC_LR = 1e-6, 1e-5
JOB_FILES = ("messages.txt", "losses.csv", "final.mpk", "final.mpk.json", "best_tracked.mpk",
             "best_tracked.mpk.json", "best_recon.mpk", "best_recon.mpk.json")
THROUGHPUT_TRIALS = (1, 8, 32)


def train_trials(torch, np, kc, cfg_path, tmp, card, expect):
    """Phase 8a: ``train_sc`` on the card with the config's trials, the
    artifact tree and its bundles; returns the Kendall launches, which must
    equal ``expect`` (phase 3's one-trial run of the same epochs), and the
    run's wall seconds."""
    import yaml

    from rankaae_tpu_torch.cli import train_sc
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
    from rankaae_tpu_torch.models.inference import InferenceModel
    from rankaae_tpu_torch.utils.checkpoint import load_model_bundle

    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    make_synthetic_xanes_csv(os.path.join(tmp, raw["data_file"]), n_rows=7000, dim=256, seed=0)
    raw["max_epoch"] = EPOCHS
    with open(os.path.join(tmp, "cfg.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    trials = raw["trials"]
    zero_launches("kendall_pair_sums", "kendall_grad_rows")
    t0 = time.perf_counter()
    train_sc.main(["-c", "cfg.yaml", "-w", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("kendall_pair_sums", "kendall_grad_rows")
    assert_tickets_clear(kc, "after train_sc")
    assert launches == expect, (launches, expect)
    assert os.path.isfile(os.path.join(tmp, "main_process_message.txt"))
    jobs = sorted(os.listdir(os.path.join(tmp, "training")))
    assert jobs == sorted(f"job_{i + 1}" for i in range(trials)), jobs
    metrics = []
    for job in jobs:
        job_dir = os.path.join(tmp, "training", job)
        files = set(os.listdir(job_dir))
        assert files == set(JOB_FILES) | {"checkpoints"}, (job, files)
        chk = os.listdir(os.path.join(job_dir, "checkpoints"))
        assert len(chk) == 2 and all(re.fullmatch(r"epoch_\d{6}_loss_.+\.mpk(\.json)?", c)
                                     for c in chk), chk
        bundles = [os.path.join(job_dir, n) for n in JOB_FILES if n.endswith(".mpk")] + \
            [os.path.join(job_dir, "checkpoints", c) for c in chk if c.endswith(".mpk")]
        for path in bundles:
            _, _, bcfg, extra = load_model_bundle(path)
            assert bcfg.trials == trials and bcfg.ae_form == "FC", path
        _, _, _, extra = load_model_bundle(os.path.join(job_dir, "final.mpk"))
        metrics.append(extra["final_metrics"])
        model = InferenceModel.from_bundle(os.path.join(job_dir, "final.mpk"), device="cpu")
        z = model.encode(np.ones((4, 256), np.float32))
        assert np.all(np.isfinite(z)), job
        with open(os.path.join(job_dir, "losses.csv")) as f:
            rows = f.read().splitlines()
        assert rows[0].startswith("Epoch,") and len(rows) == 2, rows      # epoch 0 only
    metrics = np.asarray(metrics)
    assert np.all(np.isfinite(metrics)) and len({tuple(m) for m in metrics}) == trials
    print(f"8a train_sc: {trials} trials of example/fix_config.yaml at full width, {EPOCHS} "
          f"epochs, in {wall:.2f} s wall (data load, training, {trials * 4} bundles); tree "
          f"and bundles checked; K1/K2 launches {launches} (expected {expect}: one launch "
          f"carries all {trials} trials) [{card}]")
    return launches, wall


TRAIN_LOSSES = ("train_dis", "train_gen", "train_aux", "train_recon", "train_smooth",
                "train_mi")


def trial_independence(torch, np, cfg, splits):
    """Phase 8b: trial 2 of a 4-trial run against the 1-trial run with seed
    + 2 on the card (2 epochs of ``cfg``, all from second moments of 1e-8),
    and, for scale, that 1-trial run against itself with its weights
    perturbed by 1e-7 relative.  Returns the largest differences of each
    comparison: training losses, validation logs, leaves, worst relative
    norm and the leaf that has it, and how far the weights moved."""
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData

    data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
    runs = []
    for trials, seed, perturb in ((4, 10, False), (1, 12, False), (1, 12, True)):
        tr = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]), trials=trials,
                            device="cuda")
        state = tr.init_state(seed)
        if perturb:
            gen = torch.Generator(device="cuda").manual_seed(1)
            with torch.no_grad():
                for m in tr.models.values():
                    for p in m.parameters():
                        p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen, device="cuda"))
        for o in state.opt.values():
            for v in o.nu:
                v.fill_(1e-8)
        if (trials, perturb) == (1, False):
            start = {k: v.clone() for k, v in tr.trial_state_dicts(0)["enc"].items()}
        logs = []
        for epoch in range(2):
            state, log = tr.epoch_step(state, epoch, data)
            logs.append(log)
        runs.append((tr, logs, 2 if trials == 4 else 0))
    # how far the 1-trial run moved its encoder's parameters
    moved = max((runs[1][0].trial_state_dicts(0)["enc"][k] - v).abs().max().item()
                for k, v in start.items() if v.is_floating_point() and "running" not in k)

    def compare(a, b):
        (tr_a, logs_a, i), (tr_b, logs_b, j) = a, b
        err = {"train": 0.0, "val": 0.0, "leaf": 0.0, "rel": 0.0, "rel_leaf": None}
        for e in range(2):
            for k in logs_b[e]:
                if k != "epoch":
                    d = (logs_a[e][k][i] - logs_b[e][k][j]).abs().max().item()
                    kind = "train" if k in TRAIN_LOSSES else "val"
                    err[kind] = max(err[kind], d)
        got, ref = tr_a.trial_state_dicts(i), tr_b.trial_state_dicts(j)
        for role in ref:
            for name, r in ref[role].items():
                if r.is_floating_point():
                    d = (got[role][name] - r).abs()
                    err["leaf"] = max(err["leaf"], d.max().item())
                    rel = (d.norm() / r.norm()).item()
                    if rel >= err["rel"]:
                        err["rel"], err["rel_leaf"] = rel, f"{role}.{name}"
        return err

    err = compare(runs[0], runs[1])
    err["moved"] = moved
    return err, compare(runs[2], runs[1])


def trial_throughput(torch, cfg, splits, card, trial_counts=THROUGHPUT_TRIALS, label="8c",
                     profiled=()):
    """Phase 8c (and 10a): steady-epoch spectra/s per GPU of ``cfg`` at each
    T of ``trial_counts`` (3 epochs, the last two timed, each ending in a
    device sync), then a profiled epoch of its form at each T of
    ``profiled``."""
    from rankaae_tpu_torch.tools.profile_epoch import profile_epoch
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData

    data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
    for trials in trial_counts:
        tr = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]), trials=trials,
                            device="cuda")
        state = tr.init_state(0)
        seconds = []
        for epoch in range(EPOCHS):
            t0 = time.perf_counter()
            state, log = tr.epoch_step(state, epoch, data)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        assert torch.isfinite(log["metrics"]).all(), trials
        rates = [trials * tr.n_train / sec for sec in seconds[1:]]
        print(f"{label} {cfg.ae_form} T={trials}: epoch seconds "
              f"{[round(x, 4) for x in seconds]}, steady spectra/s per GPU "
              f"{[round(x, 1) for x in rates]} "
              f"({[round(x / trials, 1) for x in rates]} a trial) [{card}]")
        del tr, state, log
        torch.cuda.empty_cache()
    for trials in profiled:
        prof = profile_epoch(ae_form=cfg.ae_form, trials=trials, splits=splits)
        top = prof.pop("top_kernels")
        print(f"{label} profile {cfg.ae_form} T={trials}: " + json.dumps(prof))
        print(f"{label} profile {cfg.ae_form} T={trials}, top kernels: " + json.dumps(
            [(k["name"][:70], k["launches"], round(k["ms"], 3)) for k in top[:8]]))


# phase 9: resume (9a), recalibration (9b) and the report (9c)
RESUME_EPOCHS, RESUME_CUT = 4, 2
RECAL_TRIALS, RECAL_EPOCHS = 2, 3
NORMAL_FUSED_BLOCKS = 4          # the normal decoder's stride-1 c_in == c_out blocks
RECAL_ATOL = SERVE_ATOL          # card vs CPU, relative to max(1, |CPU|) for the statistics
REPORT_ATOL = 1e-3               # card vs CPU on every score of <output_name>.json
# Reconstruct Err is rounded to 4 decimals: 1e-4 and one unit in the last place
RECON_ERR_ATOL = 2e-4 + 1e-9
BUNDLES = ("final.mpk", "best_tracked.mpk", "best_recon.mpk")


def work_dir(root, name, csv, cfg_path, **overrides):
    """``root/name`` holding ``cfg.yaml`` (``cfg_path`` with ``overrides``)
    and a copy of the data ``csv`` under the config's ``data_file``."""
    import shutil

    import yaml

    work = os.path.join(root, name)
    os.makedirs(work, exist_ok=True)
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw.update(overrides)
    with open(os.path.join(work, "cfg.yaml"), "w") as f:
        yaml.safe_dump(raw, f)
    if not os.path.exists(os.path.join(work, raw["data_file"])):
        shutil.copy(csv, os.path.join(work, raw["data_file"]))
    return work


def run_train_sc(torch, kc, fb, work, device, *flags):
    """``train_sc`` on ``work``: its wall seconds and launches (counts set
    to 0 just before)."""
    from rankaae_tpu_torch.cli import train_sc

    zero_launches()
    t0 = time.perf_counter()
    train_sc.main(["-c", "cfg.yaml", "-w", work, "--device", device, *flags])
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0, read_launches()


def bundle_diff(np, a, b, where=False):
    """Largest |difference| over the leaves of two bundles (with
    ``where``, and the leaf's path)."""
    from rankaae_tpu_torch.utils.checkpoint import load_model_bundle

    def leaves(tree, path=""):
        return [x for k, v in tree.items() for x in (
            leaves(v, f"{path}/{k}") if isinstance(v, dict) else [(f"{path}/{k}", v)])]

    pa, sa, _, _ = load_model_bundle(a)
    pb, sb, _, _ = load_model_bundle(b)
    d, leaf = max((float(np.max(np.abs(x - y))), name) for (name, x), (_, y) in zip(
        leaves({"params": pa, "stats": sa}), leaves({"params": pb, "stats": sb})))
    return (d, leaf) if where else d


def resume_on_card(torch, np, kc, fb, root, csv, cfg_path, card, device="cuda"):
    """Phase 9a: ``train_sc`` of ``cfg_path`` (its 8 trials, full width,
    ``alpha_flat_step`` ~ 0 so that the GRL ramp does not depend on
    ``max_epoch``) uncut for RESUME_EPOCHS epochs, and cut at RESUME_CUT
    (``--checkpoint-every``, ``max_epoch`` RESUME_CUT) then resumed
    (``--resume``) to RESUME_EPOCHS.  Every ``losses.csv`` and every bundle
    must be bit-identical.  Returns the launches of the three runs and the
    seconds of each checkpoint write and of the resume's load."""
    from rankaae_tpu_torch.parallel import trials as port_trials

    flat = {"alpha_flat_step": 1e-9}
    whole = work_dir(root, "whole", csv, cfg_path, max_epoch=RESUME_EPOCHS, **flat)
    cut = work_dir(root, "cut", csv, cfg_path, max_epoch=RESUME_CUT, **flat)
    seconds = {"write": [], "load": []}
    real_write, real_load = port_trials._checkpoint, port_trials._resume

    def timed(kind, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            seconds[kind].append(time.perf_counter() - t0)
            return out
        return wrapper

    port_trials._checkpoint = timed("write", real_write)
    port_trials._resume = timed("load", real_load)
    try:
        runs = {"uncut": run_train_sc(torch, kc, fb, whole, device)}
        runs["cut"] = run_train_sc(torch, kc, fb, cut, device, "--checkpoint-every",
                                   str(RESUME_CUT))
        work_dir(root, "cut", csv, cfg_path, max_epoch=RESUME_EPOCHS, **flat)
        runs["resumed"] = run_train_sc(torch, kc, fb, cut, device, "--resume")
    finally:
        port_trials._checkpoint, port_trials._resume = real_write, real_load
    state_mb = os.path.getsize(os.path.join(cut, "train_state", "trial_state.mpk")) / 2 ** 20
    jobs = sorted(os.listdir(os.path.join(whole, "training")))
    diffs = {}
    for job in jobs:
        a, b = (os.path.join(w, "training", job) for w in (whole, cut))
        for name in ("losses.csv",) + BUNDLES + tuple(n + ".json" for n in BUNDLES):
            with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb_:
                if fa.read() != fb_.read():
                    diffs[f"{job}/{name}"] = bundle_diff(
                        np, os.path.join(a, name), os.path.join(b, name)) \
                        if name.endswith(".mpk") else "differs"
    for name, (sec, launches) in runs.items():
        print(f"9a {name}: {sec:.2f} s wall, K1/K2 launches {launches['kendall_pair_sums']}/"
              f"{launches['kendall_grad_rows']} [{card}]")
    print(f"9a: {len(jobs)} trials, uncut {RESUME_EPOCHS} epochs vs cut at {RESUME_CUT} and "
          f"resumed: {'bit-identical' if not diffs else 'DIFFERENT ' + json.dumps(diffs)} "
          f"(losses.csv and {len(BUNDLES)} bundles with their manifests, every trial); "
          f"checkpoint writes {[round(x, 4) for x in seconds['write']]} s, resume load "
          f"{[round(x, 4) for x in seconds['load']]} s, trial_state.mpk {state_mb:.2f} MiB "
          f"[{card}]")
    assert not diffs, diffs
    return runs, seconds


def recalibrated_trials(torch, np, kc, fb, root, csv, cfg_path, card, device="cuda"):
    """Phase 9b: ``train_sc`` of the normal form (RECAL_TRIALS trials,
    RECAL_EPOCHS epochs) with ``bn_recalibrate`` and ``amp_recalibrate``:
    every manifest's ``amp_gain`` in [0.5, 2], and both functions on one
    bundle card vs CPU (the recalibration at dropout 0: the card's and the
    CPU's generators draw different masks).  Returns the work dir and the
    run's launches."""
    from rankaae_tpu_torch.data.dataset import load_split_arrays
    from rankaae_tpu_torch.models.recalibrate import (amplitude_gain, amplitude_ratio,
                                                      recalibrate_batch_stats)
    from rankaae_tpu_torch.utils.checkpoint import load_model_bundle

    work = work_dir(root, "recal", csv, cfg_path, ae_form="normal", trials=RECAL_TRIALS,
                    max_epoch=RECAL_EPOCHS, bn_recalibrate=True, amp_recalibrate=True)
    sec, launches = run_train_sc(torch, kc, fb, work, device)
    gains = []
    for job in sorted(os.listdir(os.path.join(work, "training"))):
        job_dir = os.path.join(work, "training", job)
        paths = [os.path.join(job_dir, n) for n in BUNDLES] + [
            os.path.join(job_dir, "checkpoints", n)
            for n in os.listdir(os.path.join(job_dir, "checkpoints")) if n.endswith(".mpk")]
        for path in paths:
            gain = load_model_bundle(path)[3]["amp_gain"]
            assert 0.5 <= gain <= 2.0, (path, gain)
            gains.append(gain)
    params, stats, cfg, _ = load_model_bundle(os.path.join(work, "training", "job_1",
                                                           "final.mpk"))
    train = load_split_arrays(csv, (cfg.train_ratio, cfg.validation_ratio, cfg.test_ratio),
                              cfg.n_aux)["train"].spec
    devices = (device, "cpu")
    recal = dict(zip(("card", "cpu"), (
        recalibrate_batch_stats(cfg.replace(dropout_rate=0.0), params, stats, train, device=d)
        for d in devices)))
    gain = dict(zip(("card", "cpu"), (amplitude_gain(cfg, params, stats, train, device=d)
                                      for d in devices)))
    # the unclipped ratio: a gain at a clip bound says nothing of agreement
    ratio = dict(zip(("card", "cpu"), (amplitude_ratio(cfg, params, stats, train, device=d)
                                       for d in devices)))

    def leaves(tree):
        return [x for v in tree.values() for x in (leaves(v) if isinstance(v, dict) else [v])]

    pairs = list(zip(leaves(recal["card"]), leaves(recal["cpu"])))
    stat_abs = max(float(np.max(np.abs(a - b))) for a, b in pairs)
    stat_rel = max(float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))) for a, b in pairs)
    gain_err = max(abs(gain["card"] - gain["cpu"]), abs(ratio["card"] - ratio["cpu"]))
    print(f"9b: normal form, {RECAL_TRIALS} trials, {RECAL_EPOCHS} epochs, bn_recalibrate and "
          f"amp_recalibrate, {sec:.2f} s wall; amp_gain of {len(gains)} bundles in "
          f"[{min(gains):.4f}, {max(gains):.4f}]; launches {launches}; job_1 final.mpk card vs "
          f"CPU: recalibrated statistics max {stat_abs:.3g} (relative to max(1, |CPU|) "
          f"{stat_rel:.3g}, atol {RECAL_ATOL}), amp_gain {gain['card']:.6f} vs "
          f"{gain['cpu']:.6f}, unclipped ratio {ratio['card']:.6f} vs {ratio['cpu']:.6f} "
          f"({gain_err:.3g}, atol {RECAL_ATOL}) [{card}]")
    assert stat_rel <= RECAL_ATOL and gain_err <= RECAL_ATOL, (stat_rel, gain_err)
    return work, launches


def report_scores(report):
    """Every number of a report's JSON by path, and its jobs in rank order."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            out[path] = float(node)

    walk(report, "")
    return out, list(report)


def report_card_vs_cpu(torch, np, fb, work, cpu_work, label, card, figures, device="cuda"):
    """Phase 9c on one tree: ``generate`` on the card, then on the CPU over a
    copy at ``cpu_work``; every score of the JSON within REPORT_ATOL
    (Reconstruct Err within RECON_ERR_ATOL) and the same ranks, unless two
    trials' scores lie within the tolerance.  Returns the card run's K3
    launches and both walls."""
    import shutil

    from rankaae_tpu_torch.report.generate_report import generate
    from rankaae_tpu_torch.utils.config import Parameters

    shutil.copytree(work, cpu_work)
    walls, reports = {}, {}
    for side, d, w in (("card", device, work), ("cpu", "cpu", cpu_work)):
        zero_launches("fused_block")
        t0 = time.perf_counter()
        generate(w, Parameters.from_yaml(os.path.join(w, "cfg.yaml")), device=d,
                 figures=figures and side == "card")
        if side == "card":
            if d == "cuda":
                torch.cuda.synchronize()
            k3 = read_launches()["fused_block"]
        walls[side] = time.perf_counter() - t0
        with open(os.path.join(w, "report.json")) as f:
            reports[side] = json.load(f)
    (got, ranked), (ref, ref_ranked) = (report_scores(reports[d]) for d in ("card", "cpu"))
    assert sorted(got) == sorted(ref), (label, sorted(set(got) ^ set(ref)))
    worst = {"score": 0.0, "recon_err": 0.0}
    for path, value in ref.items():
        kind = "recon_err" if "/Reconstruct Err" in path else "score"
        err = abs(got[path] - value)
        if not (np.isnan(err) and np.isnan(value)):
            worst[kind] = max(worst[kind], err)
            assert err <= (RECON_ERR_ATOL if kind == "recon_err" else REPORT_ATOL), \
                (label, path, got[path], value)
    near = []
    if ranked != ref_ranked:
        scores = {j: reports["cpu"][j]["Score"] for j in ref_ranked}
        for a, b in zip(ranked, ref_ranked):
            if a != b:
                near.append((a, b, scores[a], scores[b]))
                assert abs(scores[a] - scores[b]) <= REPORT_ATOL, (label, ranked, ref_ranked)
    for ext in (".in", ".out", "_spec_in.txt", "_spec_out.txt", "_styles.txt"):
        a, b = (np.loadtxt(os.path.join(w, "report" + ext)) for w in (work, cpu_work))
        if ranked[0] == ref_ranked[0]:
            assert np.abs(a - b).max() <= SERVE_ATOL, (label, ext, np.abs(a - b).max())
    print(f"9c report of {label}: card {walls['card']:.2f} s wall, CPU {walls['cpu']:.2f} s; "
          f"K3 launches {k3}; card vs CPU: scores max {worst['score']:.3g} (atol "
          f"{REPORT_ATOL}), Reconstruct Err max {worst['recon_err']:.3g} (atol 1e-4 + one "
          f"rounding unit); ranks {'identical' if not near else 'swapped within tolerance ' + json.dumps(near)}: "
          f"{ranked} [{card}]")
    return k3, walls

# phase 10: every form stacked on the trial axis
NORMAL_TRIALS_T = (1, 8)         # 10a: the normal form's throughput, T 1 beside T 8
QVED_DIM = 12
QVED_SPREAD_SAMPLES = 8


def check_tree(np, work, trials, ae_form, dim):
    """The artifact tree of a ``train_sc`` run: every job's files, every
    bundle reloaded with the run's form and trials, each final model
    encoding finitely on the CPU; the final metrics differ between trials."""
    from rankaae_tpu_torch.models.inference import InferenceModel
    from rankaae_tpu_torch.utils.checkpoint import load_model_bundle

    assert os.path.isfile(os.path.join(work, "main_process_message.txt"))
    jobs = sorted(os.listdir(os.path.join(work, "training")))
    assert jobs == sorted(f"job_{i + 1}" for i in range(trials)), jobs
    metrics = []
    for job in jobs:
        job_dir = os.path.join(work, "training", job)
        assert set(os.listdir(job_dir)) == set(JOB_FILES) | {"checkpoints"}, job
        chk = [c for c in os.listdir(os.path.join(job_dir, "checkpoints")) if c.endswith(".mpk")]
        assert chk, job
        for path in [os.path.join(job_dir, n) for n in BUNDLES] + \
                [os.path.join(job_dir, "checkpoints", c) for c in chk]:
            _, _, bcfg, _ = load_model_bundle(path)
            assert bcfg.trials == trials and bcfg.ae_form == ae_form, path
        _, _, _, extra = load_model_bundle(os.path.join(job_dir, "final.mpk"))
        metrics.append(extra["final_metrics"])
        z = InferenceModel.from_bundle(os.path.join(job_dir, "final.mpk"),
                                       device="cpu").encode(np.ones((4, dim), np.float32))
        assert np.all(np.isfinite(z)), job
    metrics = np.asarray(metrics)
    assert np.all(np.isfinite(metrics)) and len({tuple(m) for m in metrics}) == trials


def normal_trials(torch, np, kc, fb, root, csv, cfg_path, card, expect):
    """Phase 10a: ``train_sc`` of the normal form with the config's trials
    in one wave (full width, batch 1024, EPOCHS epochs): the tree and its
    bundles; K1 and K2 launched as often as phase 3's one-trial run, K3
    once per trial in each of the EPOCHS validations' two eval-mode decodes
    of the normal decoder's four fused blocks.  Returns the launches."""
    from rankaae_tpu_torch.parallel import trials as port_trials
    from rankaae_tpu_torch.utils.config import Parameters

    trials = Parameters.from_yaml(cfg_path).get("trials")
    work = work_dir(root, "normal_trials", csv, cfg_path, ae_form="normal", max_epoch=EPOCHS)
    waves = []
    real = port_trials._run_wave

    def run_wave(cfg, data, n_trials, *args, **kw):
        waves.append(n_trials)
        return real(cfg, data, n_trials, *args, **kw)

    port_trials._run_wave = run_wave
    try:
        sec, launches = run_train_sc(torch, kc, fb, work, "cuda")
    finally:
        port_trials._run_wave = real
    assert_tickets_clear(kc, "after the normal form's train_sc")
    want = {**expect, "fused_block": trials * EPOCHS * 2 * NORMAL_FUSED_BLOCKS}
    assert waves == [trials], waves
    assert launches == want, (launches, want)
    check_tree(np, work, trials, "normal", 256)
    print(f"10a train_sc: normal form, {trials} trials in one wave (waves {waves}), full "
          f"width, batch 1024, {EPOCHS} epochs, {sec:.2f} s wall (data load, training, "
          f"{trials * 4}+ bundles); tree and bundles checked; launches {launches} (expected "
          f"{want}: one K1/K2 launch for all {trials} trials, K3 once a trial) [{card}]")
    return launches


def deterministic_cost(torch, cfg, splits, card, trials=4):
    """Seconds of a steady normal-form epoch at ``trials`` with cuDNN's
    deterministic algorithms off and on (two epochs each, the second
    timed)."""
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData

    data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
    out = {}
    for det in (False, True, False):
        torch.backends.cudnn.deterministic = det
        tr = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]), trials=trials,
                            device="cuda")
        state = tr.init_state(0)
        for epoch in range(2):
            t0 = time.perf_counter()
            state, _ = tr.epoch_step(state, epoch, data)
            torch.cuda.synchronize()
        out.setdefault(det, []).append(time.perf_counter() - t0)
    torch.backends.cudnn.deterministic = False
    print(f"10b cuDNN deterministic: a steady normal-form epoch at T {trials} "
          f"{[round(x, 4) for x in out[True]]} s against {[round(x, 4) for x in out[False]]} "
          f"s without [{card}]")
    return out


def make_qvec_csv(np, path, n_rows, seed):
    """A qved dataset in the reference CSV's schema: 5 descriptors and 12
    q-vector columns, the q-vectors the descriptors times a random 5 x 12
    map plus noise (``tests/test_conv_forms_training.py:71-78``)."""
    import pandas as pd

    from rankaae_tpu_torch.data.synthetic import DESCRIPTOR_NAMES

    rng = np.random.default_rng(seed)
    aux = rng.normal(size=(n_rows, 5)).astype(np.float32)
    qvec = (aux @ rng.normal(size=(5, QVED_DIM)).astype(np.float32)
            + rng.normal(size=(n_rows, QVED_DIM)).astype(np.float32) * 0.1)
    cols = [f"AUX_{n}" for n in DESCRIPTOR_NAMES] + [f"ENE_{i}.00" for i in range(QVED_DIM)]
    idx = pd.MultiIndex.from_arrays([[f"mp-{i // 10}" for i in range(n_rows)],
                                     list(range(n_rows))], names=["material", "site"])
    pd.DataFrame(np.concatenate([aux, qvec], axis=1), columns=cols, index=idx).to_csv(path)
    return aux, qvec


def qved_trials(torch, np, kc, fb, root, cfg_path, card, expect, n_rows):
    """Phase 10c: ``train_sc`` of the qved form (the config's trials, one
    wave, EPOCHS epochs) on a seeded 12-dim dataset of ``n_rows`` rows: the
    tree and its bundles, K1 and K2 launched as often as phase 3's; then
    one faithful qved batch with each reconstruction target card vs CPU,
    and ``job_1``'s final bundle served
    by the CLI on the card and the CPU.  Returns the training launches."""
    from rankaae_tpu_torch import serve
    from rankaae_tpu_torch.tools.batch_spread import batch_spread
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    params = Parameters.from_yaml(cfg_path)
    trials = params.get("trials")
    csv = os.path.join(root, "qvec.csv")
    aux, qvec = make_qvec_csv(np, csv, n_rows, seed=3)
    work = work_dir(root, "qved", csv, cfg_path, ae_form="qved", dim_in=QVED_DIM,
                    dim_out=QVED_DIM, max_epoch=EPOCHS)
    sec, launches = run_train_sc(torch, kc, fb, work, "cuda")
    assert_tickets_clear(kc, "after the qved train_sc")
    want = {**expect, "fused_block": 0}
    assert launches == want, (launches, want)
    check_tree(np, work, trials, "qved", QVED_DIM)
    print(f"10c train_sc: qved form, {trials} trials in one wave, {n_rows} rows, {EPOCHS} "
          f"epochs, {sec:.2f} s wall; tree and bundles checked; launches {launches} "
          f"(expected {want}) [{card}]")

    # one faithful batch, card vs CPU, with the plain MSE target and with
    # the config's flex target.  The flex target divides each row's output
    # mean by its input mean, and rows of these zero-mean q-vectors have
    # input means down to ~2e-4: there float32 rounding of the inputs' sum
    # moves the reconstruction loss (~70) by ~1e-2, which a perturbation of
    # the weights does not show.  So each batch is held to phase 4's
    # tolerances or twice the larger of its 1e-7 weight and input
    # perturbation spreads on the CPU (tools/batch_spread.py), measured here
    b = params.get("batch_size")
    batch = (qvec[:b], aux[:b])
    for flex in (False, True):
        params.update({"ae_form": "qved", "dim_in": QVED_DIM, "dim_out": QVED_DIM,
                       "dropout_rate": 0.0, "dis_dropout_rate": 0.0, "dis_noise": 0.0,
                       "use_flex_spec_target": flex})
        qcfg = TrainConfig.from_parameters(params)
        spreads = [batch_spread(qcfg, b, samples=QVED_SPREAD_SAMPLES, data=batch, perturb=p)
                   for p in ("weights", "inputs")]
        loss_atol = {k: max(PARITY_ATOL, 2 * max(sp["losses"][k] for sp in spreads))
                     for k in spreads[0]["losses"]}
        leaf_atol = {k: max(LEAF_ATOL, 2 * max(sp["leaves"][k]["max_abs"] for sp in spreads))
                     for k in spreads[0]["leaves"]}
        leaf_rtol = max(LEAF_RTOL, 2 * max(v["max_rel"] for sp in spreads
                                           for v in sp["leaves"].values()))
        loss_err, worst, l_cpu, l_gpu = batch_parity(torch, np, qcfg, loss_atol, leaf_atol,
                                                     leaf_rtol, data=batch)
        target = "flex target" if flex else "plain MSE target"
        print(f"10c parity: one faithful qved batch (B={b}, {target}), card vs CPU: per loss "
              + json.dumps({n: abs(l_cpu[n] - l_gpu[n]) for n in l_cpu})
              + f"; CPU spread over {QVED_SPREAD_SAMPLES} 1e-7 perturbations of the weights "
              + json.dumps(spreads[0]["losses"]) + ", of the inputs "
              + json.dumps(spreads[1]["losses"])
              + f" (atol {json.dumps(loss_atol)}: phase 4's, or twice the larger spread); "
              f"leaves max params {worst['params']:.3g}, stats {worst['stats']:.3g} (atol "
              f"{json.dumps(leaf_atol)}), worst per-leaf relative norm {worst['rel']:.3g} "
              f"(rtol {leaf_rtol:.3g}) [{card}]")

    final = os.path.join(work, "training", "job_1", "final.mpk")
    out = {}
    for dev in ("cuda", "cpu"):
        serve.main([final, csv, os.path.join(root, f"qved_{dev}"), "--batch-size", "1024",
                    "--device", dev])
        out[dev] = [np.loadtxt(os.path.join(root, f"qved_{dev}_{k}.txt"))
                    for k in ("styles", "recon")]
    (z_gpu, y_gpu), (z_cpu, y_cpu) = out["cuda"], out["cpu"]
    assert z_gpu.shape == (n_rows, 6) and y_gpu.shape == (n_rows, QVED_DIM), \
        (z_gpu.shape, y_gpu.shape)
    z_err, y_err = np.abs(z_gpu - z_cpu).max(), np.abs(y_gpu - y_cpu).max()
    print(f"10c serve: job_1's final qved bundle by the CLI, {n_rows} q-vectors: card vs CPU "
          f"styles {z_err:.3g}, reconstructions {y_err:.3g} (atol {SERVE_ATOL}) [{card}]")
    assert z_err <= SERVE_ATOL and y_err <= SERVE_ATOL, (z_err, y_err)
    return launches


# phase 11: the trainer's remaining options
OPTION_PROTOCOLS = ("fused", "joint")
OPTION_FORMS = ("FC", "normal")
OPTION_SPREAD_SAMPLES = 4
# 11d: a bfloat16 batch card vs CPU is held to twice its CPU spread under a
# perturbation of the weights by half a bfloat16 unit (2^-9 relative), and
# never under phase 4's tolerances: bfloat16 rounds each activation to 8
# significant bits, and a value that rounds the other way on the card (its
# sums are taken in another order) moves the batch as such a perturbation does
BF16_PERTURBATION = 2.0 ** -9
# at the config's learning rates that spread reaches the size of the update
# (a leaf's relative spread 0.51, measured by this phase on the CPU of the
# machine of an NVIDIA H100 80GB HBM3 at 700 W): held at lr_base 1e-4, as
# tests/test_torch_bf16.py holds the bfloat16 batch against the JAX package
BF16_LR = 1e-4
# 11e: each option beside faithful, at each (form, T)
OPTIONS = (("faithful", {}), ("faithful + flat_optim", {"flat_optim": True}),
           ("fused", {"protocol": "fused"}), ("joint", {"protocol": "joint"}),
           ("bfloat16", {"activation_dtype": "bfloat16"}))
OPTION_SHAPES = (("FC", 1), ("FC", 32), ("normal", 8))
#: steady epochs timed for each option (after one warm-up epoch)
OPTION_STEADY = 3
LAUNCH_KEYS = ("kendall_pair_sums", "kendall_grad_rows", "fused_block")


def add_launches(total, launches):
    for k in LAUNCH_KEYS:
        total[k] = total.get(k, 0) + launches.get(k, 0)


def expected_launches(expect, trials, form):
    """A ``train_sc`` run's launches: K1 and K2 as phase 3's one-trial run
    (``expect``), K3 once a trial and fused block in each validation's two
    eval-mode decodes of the normal form."""
    return {**expect, "fused_block": trials * EPOCHS * 2 * NORMAL_FUSED_BLOCKS
            if form == "normal" else 0}


def option_trials(torch, np, kc, fb, root, csv, cfg_path, card, expect):
    """Phase 11a: ``train_sc`` of the fused and the joint protocol, each of
    the FC and the normal form, the config's trials in one wave at full
    width, EPOCHS epochs: the tree and every bundle, K1 and K2 launched as
    phase 3's one-trial run, K3 as 10a's.  Returns the launches."""
    from rankaae_tpu_torch.utils.config import Parameters

    trials = Parameters.from_yaml(cfg_path).get("trials")
    total = {}
    for protocol in OPTION_PROTOCOLS:
        for form in OPTION_FORMS:
            work = work_dir(root, f"{protocol}_{form}", csv, cfg_path, ae_form=form,
                            protocol=protocol, max_epoch=EPOCHS)
            sec, launches = run_train_sc(torch, kc, fb, work, "cuda")
            assert_tickets_clear(kc, f"after the {protocol} {form} train_sc")
            want = expected_launches(expect, trials, form)
            assert launches == want, (protocol, form, launches, want)
            check_tree(np, work, trials, form, 256)
            print(f"11a train_sc: protocol {protocol}, {form} form, {trials} trials in one "
                  f"wave, {EPOCHS} epochs, {sec:.2f} s wall; tree and bundles checked; "
                  f"launches {launches} (expected {want}) [{card}]")
            add_launches(total, launches)
    return total


def held_batch(torch, np, cfg, label, card, perturbation=None):
    """One batch of ``cfg`` card vs CPU (:func:`batch_pair`), held to phase
    4's tolerances or, where a difference exceeds them, or always when
    ``perturbation`` is given, to twice the spread OPTION_SPREAD_SAMPLES
    perturbations of the weights by ``perturbation`` (default 1e-7)
    relative make on the CPU, measured here, where that is larger."""
    from rankaae_tpu_torch.tools.batch_spread import PERTURBATION, batch_spread

    pair = batch_pair(torch, np, cfg)
    loss, leaves = pair_errors(pair)
    loss_atol = dict.fromkeys(loss, PARITY_ATOL)
    leaf_atol = {"params": LEAF_ATOL, "stats": LEAF_ATOL}
    leaf_rtol = LEAF_RTOL
    within = all(loss[n] <= loss_atol[n] for n in loss) and all(
        d <= leaf_atol[kind] and rel <= leaf_rtol for kind, d, rel in leaves.values())
    spread = None
    if perturbation is not None or not within:
        spread = batch_spread(cfg, cfg.batch_size, samples=OPTION_SPREAD_SAMPLES,
                              perturbation=perturbation or PERTURBATION)
        loss_atol = {k: max(PARITY_ATOL, 2 * v) for k, v in spread["losses"].items()}
        leaf_atol = {k: max(LEAF_ATOL, 2 * v["max_abs"]) for k, v in spread["leaves"].items()}
        leaf_rtol = max(LEAF_RTOL, 2 * max(v["max_rel"] for v in spread["leaves"].values()))
    worst = {kind: max(d for k, d, _ in leaves.values() if k == kind) for kind in leaf_atol}
    worst_rel = max(rel for _, _, rel in leaves.values())
    print(f"{label}, B {cfg.batch_size}, card vs CPU: per loss {json.dumps(loss)}; leaves max "
          f"{json.dumps(worst)}, worst relative norm {worst_rel:.3g}; held to loss atol "
          f"{json.dumps(loss_atol)}, leaf atol {json.dumps(leaf_atol)}, rtol {leaf_rtol:.3g} ("
          + ("phase 4's" if spread is None else
             f"phase 4's or twice the CPU spread of {OPTION_SPREAD_SAMPLES} perturbations by "
             f"{spread['perturbation']:.3g}: losses {json.dumps(spread['losses'])}, leaves "
             f"{json.dumps(spread['leaves'])}") + f") [{card}]")
    for n in loss:
        assert loss[n] <= loss_atol[n], (label, n, loss[n], loss_atol[n])
    for n, (kind, d, rel) in leaves.items():
        assert d <= leaf_atol[kind], (label, n, d, leaf_atol[kind])
        assert rel <= leaf_rtol, (label, n, rel, leaf_rtol)


def option_batches(torch, np, pcfg, cfg, card):
    """Phase 11b: one batch of each protocol card vs CPU from the same
    weights and draws (:func:`held_batch`)."""
    quiet = {"dropout_rate": 0.0, "dis_dropout_rate": 0.0, "dis_noise": 0.0}
    for label, bcfg in (
            ("11b fused FC batch (n_layers 3)", pcfg.replace(protocol="fused")),
            ("11b fused compact batch, CNN discriminator, no GRL",
             cfg.replace(ae_form="compact", use_cnn_discriminator=True,
                         gradient_reversal=False, protocol="fused", **quiet)),
            ("11b joint FC batch (n_layers 3)", pcfg.replace(protocol="joint")),
            ("11b joint normal-form batch", cfg.replace(ae_form="normal", protocol="joint",
                                                        **quiet))):
        held_batch(torch, np, bcfg, label, card)


def tree_diff(np, a, b):
    """The largest |difference| of each job's ``losses.csv`` values and of
    each bundle's leaves between two ``train_sc`` trees (only those that
    differ)."""
    diffs = {}
    for job in sorted(os.listdir(os.path.join(a, "training"))):
        ja, jb = (os.path.join(w, "training", job) for w in (a, b))
        for name in ("losses.csv",) + BUNDLES:
            fa, fb_ = os.path.join(ja, name), os.path.join(jb, name)
            with open(fa, "rb") as x, open(fb_, "rb") as y:
                same = x.read() == y.read()
            if name.endswith(".mpk"):
                d = bundle_diff(np, fa, fb_)      # the manifests differ in the knob
            elif same:
                d = 0.0
            else:
                va, vb = (np.genfromtxt(f, delimiter=",", skip_header=1) for f in (fa, fb_))
                d = float(np.nanmax(np.abs(va - vb))) if va.shape == vb.shape else float("inf")
            if d:
                diffs[f"{job}/{name}"] = d
    return diffs


def flat_optim_on_card(torch, np, kc, fb, root, csv, cfg_path, card, expect, spread10b):
    """Phase 11c: ``train_sc`` of the FC and the normal form (the config's
    trials, EPOCHS epochs) with ``flat_optim`` and without: every
    ``losses.csv`` and bundle bit-identical (the normal form under cuDNN's
    deterministic algorithms; where two runs without the knob are not
    bit-identical there either, the pair is held to that difference and
    to twice 10b's perturbation spread); then a checkpoint written without
    the knob must be refused by a resume with it.  Returns the launches."""
    from rankaae_tpu_torch.utils.config import Parameters

    trials = Parameters.from_yaml(cfg_path).get("trials")
    total = {}
    for form in OPTION_FORMS:
        torch.backends.cudnn.deterministic = form == "normal"
        try:
            works = {}
            for flat in (False, True):
                works[flat] = work_dir(root, f"flat_{form}_{flat}", csv, cfg_path, ae_form=form,
                                       flat_optim=flat, max_epoch=EPOCHS)
                sec, launches = run_train_sc(torch, kc, fb, works[flat], "cuda")
                want = expected_launches(expect, trials, form)
                assert launches == want, (form, flat, launches, want)
                add_launches(total, launches)
                print(f"11c train_sc: {form} form, flat_optim {flat}, {trials} trials, "
                      f"{EPOCHS} epochs, {sec:.2f} s wall, launches {launches} [{card}]")
            diffs = tree_diff(np, works[False], works[True])
            if not diffs:
                print(f"11c: {form} form with flat_optim bit-identical to without (every "
                      f"losses.csv and bundle of {trials} trials) [{card}]")
                continue
            assert form != "FC", diffs
            again = work_dir(root, f"flat_{form}_again", csv, cfg_path, ae_form=form,
                             max_epoch=EPOCHS)
            _, launches = run_train_sc(torch, kc, fb, again, "cuda")
            add_launches(total, launches)
            noise = tree_diff(np, works[False], again)
            bound = max(max(noise.values(), default=0.0),
                        2 * max(spread10b["train"], spread10b["leaf"]))
            print(f"11c: {form} form with flat_optim against without: largest differences "
                  f"{json.dumps(diffs)}; two runs without the knob differ by "
                  f"{json.dumps(noise)} (not bit-identical on the card under cuDNN's "
                  f"deterministic algorithms either); held to {bound:.3g} (that difference, "
                  f"or twice 10b's perturbation spread) [{card}]")
            assert max(diffs.values()) <= bound, (diffs, noise, bound)
        finally:
            torch.backends.cudnn.deterministic = False
    work = work_dir(root, "flat_resume", csv, cfg_path, max_epoch=1)
    _, launches = run_train_sc(torch, kc, fb, work, "cuda", "--checkpoint-every", "1")
    add_launches(total, launches)
    work_dir(root, "flat_resume", csv, cfg_path, max_epoch=2, flat_optim=True)
    try:
        run_train_sc(torch, kc, fb, work, "cuda", "--resume")
    except ValueError as exc:
        if "another config" not in str(exc):    # the load_state_tree refusal, not another fault
            raise
        print(f"11c: a {trials}-trial checkpoint written without flat_optim, resumed with it: "
              f"refused ({exc}) [{card}]")
    else:
        raise AssertionError("a resume across flat_optim loaded another moment layout")
    return total


def bf16_on_card(torch, np, kc, fb, root, csv, cfg_path, card, expect, pcfg):
    """Phase 11d: ``train_sc`` of the FC and the normal form with bfloat16
    activations (the config's trials, EPOCHS epochs): finite losses, the
    tree, the launches as 11a's, every bundle's leaves float32, job_1's
    final bundle served by the CLI card vs CPU (float32 inference); then
    one bfloat16 FC batch card vs CPU (:func:`held_batch` at
    BF16_PERTURBATION).  Returns the launches."""
    from rankaae_tpu_torch import serve
    from rankaae_tpu_torch.utils.checkpoint import load_model_bundle
    from rankaae_tpu_torch.utils.config import Parameters

    trials = Parameters.from_yaml(cfg_path).get("trials")
    total = {}
    for form in OPTION_FORMS:
        work = work_dir(root, f"bf16_{form}", csv, cfg_path, ae_form=form,
                        activation_dtype="bfloat16", max_epoch=EPOCHS)
        sec, launches = run_train_sc(torch, kc, fb, work, "cuda")
        want = expected_launches(expect, trials, form)
        assert launches == want, (form, launches, want)
        add_launches(total, launches)
        check_tree(np, work, trials, form, 256)
        for job in sorted(os.listdir(os.path.join(work, "training"))):
            job_dir = os.path.join(work, "training", job)
            rows = np.genfromtxt(os.path.join(job_dir, "losses.csv"), delimiter=",",
                                 skip_header=1, usecols=range(13))    # a trailing comma
            assert rows.size and np.all(np.isfinite(rows)), (form, job)
            for name in BUNDLES:
                params, stats, bcfg, _ = load_model_bundle(os.path.join(job_dir, name))
                assert bcfg.activation_dtype == "bfloat16"
                leaves = [params, stats]
                while leaves:
                    node = leaves.pop()
                    if isinstance(node, dict):
                        leaves.extend(node.values())
                    else:
                        assert np.asarray(node).dtype == np.float32, (form, job, name)
        final = os.path.join(work, "training", "job_1", "final.mpk")
        out = {}
        for dev in ("cuda", "cpu"):
            zero_launches("fused_block")
            serve.main([final, csv, os.path.join(root, f"bf16_{form}_{dev}"),
                        "--batch-size", "1024", "--device", dev])
            if dev == "cuda":
                total["fused_block"] += read_launches()["fused_block"]
            out[dev] = [np.loadtxt(os.path.join(root, f"bf16_{form}_{dev}_{k}.txt"))
                        for k in ("styles", "recon")]
        z_err = np.abs(out["cuda"][0] - out["cpu"][0]).max()
        y_err = np.abs(out["cuda"][1] - out["cpu"][1]).max()
        print(f"11d train_sc: {form} form, bfloat16 activations, {trials} trials, {EPOCHS} "
              f"epochs, {sec:.2f} s wall; losses finite, tree checked, bundles float32, "
              f"launches {launches} (expected {want}); job_1's final bundle served by the "
              f"CLI (float32) card vs CPU: styles {z_err:.3g}, reconstructions {y_err:.3g} "
              f"(atol {SERVE_ATOL}) [{card}]")
        assert z_err <= SERVE_ATOL and y_err <= SERVE_ATOL, (form, z_err, y_err)
    held_batch(torch, np, pcfg.replace(activation_dtype="bfloat16", lr_base=BF16_LR),
               f"11d bfloat16 FC batch (n_layers 3, lr_base {BF16_LR})", card,
               perturbation=BF16_PERTURBATION)
    return total


def option_profiles(torch, card, splits):
    """Phase 11e: each option, faithful included, at each (form, T) of
    OPTION_SHAPES, all through one ``tools/profile_epoch.py`` call apiece:
    the spectra/s per GPU of its OPTION_STEADY steady epochs (the warm-up
    epochs after the first) and their median, then a profiled epoch's
    launches, device time (summed, and busy) and idle share."""
    from rankaae_tpu_torch.tools.profile_epoch import profile_epoch

    rows = []
    for form, trials in OPTION_SHAPES:
        for label, kw in OPTIONS:
            prof = profile_epoch(ae_form=form, trials=trials, splits=splits,
                                 warmup=1 + OPTION_STEADY, protocol=kw.get("protocol"),
                                 flat_optim=kw.get("flat_optim", False),
                                 activation_dtype=kw.get("activation_dtype"))
            top = prof.pop("top_kernels")
            rates = [trials * prof["n_train"] / sec for sec in prof["warmup_seconds"][1:]]
            row = {"form": form, "trials": trials, "option": label,
                   "spectra_per_s_per_gpu": statistics.median(rates),
                   "steady_epochs_spectra_per_s_per_gpu": rates,
                   "profiled_wall_ms": prof["wall_ms"],
                   "device_ms": prof["device_kernel_ms"],
                   "device_busy_ms": prof["device_busy_ms"],
                   "idle_share": prof["device_idle_share"],
                   "launches": prof["kernel_launches"]}
            rows.append(row)
            print(f"11e {form} T={trials} {label}: " + json.dumps(row)
                  + " top kernels " + json.dumps([(k["name"][:60], k["launches"],
                                                   round(k["ms"], 3)) for k in top[:5]])
                  + f" [{card}]")
            torch.cuda.empty_cache()
    print("11e: " + json.dumps(rows))
    return rows


# phase 12: remat (12a), trials over two ranks (12b), the trial x dp layout
# (12c) and the native CSV loader (12d)
REMAT_RUNS = (("normal", {"ae_form": "normal"}),
              ("compact + CNN", {"ae_form": "compact", "use_cnn_discriminator": True}))
REMAT_FUSED_BLOCKS = {"normal": NORMAL_FUSED_BLOCKS, "compact": 1}
REMAT_TRIALS = (8, 32)
REMAT_EPOCHS = 3                 # a warm-up epoch, then the median of the steady ones
RANKS = 2
LOADER_READS = 5


def remat_trials(torch, np, kc, fb, root, csv, cfg_path, card, expect):
    """Phase 12a: ``train_sc`` of the normal form and of the compact form
    with the CNN discriminator (the config's trials, EPOCHS epochs) with
    ``remat`` and without, under cuDNN's deterministic algorithms: every
    ``losses.csv`` and bundle bit-identical (or, where not, held to phase
    4's tolerances and printed), K1 and K2 launched as phase 3's one-trial
    run and K3 once a trial and fused block in each validation's two
    decodes.  Returns the launches."""
    from rankaae_tpu_torch.utils.config import Parameters

    trials = Parameters.from_yaml(cfg_path).get("trials")
    total = {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, overrides in REMAT_RUNS:
            works = {}
            for remat in (False, True):
                works[remat] = work_dir(root, f"remat_{overrides['ae_form']}_{remat}", csv,
                                        cfg_path, remat=remat, max_epoch=EPOCHS, **overrides)
                sec, launches = run_train_sc(torch, kc, fb, works[remat], "cuda")
                assert_tickets_clear(kc, f"after the {label} remat {remat} train_sc")
                want = {**expect, "fused_block": trials * EPOCHS * 2
                        * REMAT_FUSED_BLOCKS[overrides["ae_form"]]}
                assert launches == want, (label, remat, launches, want)
                check_tree(np, works[remat], trials, overrides["ae_form"], 256)
                add_launches(total, launches)
                print(f"12a train_sc: {label}, remat {remat}, {trials} trials, {EPOCHS} "
                      f"epochs, {sec:.2f} s wall, launches {launches} (expected {want}) "
                      f"[{card}]")
            diffs = tree_diff(np, works[False], works[True])
            if not diffs:
                print(f"12a: {label} with remat bit-identical to without (every losses.csv "
                      f"and bundle of {trials} trials, cuDNN deterministic) [{card}]")
                continue
            print(f"12a: {label} with remat against without, NOT bit-identical: largest "
                  f"differences {json.dumps(diffs)}; held to phase 4's tolerances [{card}]")
            for name, d in diffs.items():
                assert d <= (PARITY_ATOL if name.endswith(".csv") else LEAF_ATOL), (name, d)
    finally:
        torch.backends.cudnn.deterministic = False
    return total


def remat_cost(torch, cfg, splits, card):
    """Phase 12a: peak device memory (``max_memory_allocated`` from just
    before the first epoch) and the median steady-epoch seconds of the
    normal form at each T of REMAT_TRIALS, with ``remat`` and without."""
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData

    data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
    rows = {}
    for trials in REMAT_TRIALS:
        for remat in (False, True):
            tr = RankAAETrainer(cfg.replace(ae_form="normal", remat=remat),
                                n_train=len(splits[0]), n_val=len(splits[2]), trials=trials,
                                device="cuda")
            state = tr.init_state(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seconds = []
            for epoch in range(REMAT_EPOCHS):
                t0 = time.perf_counter()
                state, log = tr.epoch_step(state, epoch, data)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            assert torch.isfinite(log["metrics"]).all(), (trials, remat)
            steady = statistics.median(seconds[1:])
            rows[f"T {trials}, remat {remat}"] = {
                "peak_MiB": torch.cuda.max_memory_allocated() / 2 ** 20,
                "epoch_s": [round(x, 4) for x in seconds], "steady_median_s": steady,
                "spectra_per_s": trials * tr.n_train / steady}
            del tr, state, log
            torch.cuda.empty_cache()
    print("12a remat cost, normal form at full width, B 1024: " + json.dumps(rows)
          + f" [{card}]")
    return rows


def job_files(root):
    """The relative paths of a ``train_sc`` tree's artifacts: its message
    file and every file under ``training/``, checkpoint names by pattern
    (they hold each run's best loss)."""
    out = ["main_process_message.txt"]
    for d, _, names in os.walk(os.path.join(root, "training")):
        for name in names:
            rel = os.path.relpath(os.path.join(d, name), root)
            out.append(re.sub(r"epoch_\d{6}_loss_[^/]+?\.mpk", "epoch_*_loss_*.mpk", rel))
    return sorted(out)


def rank_main(argv) -> int:
    """One rank of phase 12b (``chip_smoke.py --train-sc-rank WORK OUT``
    under torchrun): ``train_sc`` of WORK on ``cuda:0`` (the ranks share
    the card), then its wall seconds and launch counts into OUT."""
    import torch

    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.cli import train_sc
    from rankaae_tpu_torch.ops import fused_block_cuda as fb
    from rankaae_tpu_torch.ops import kendall_cuda as kc

    work, out = argv
    kc.build()
    fb.build()
    zero_launches()
    t0 = time.perf_counter()
    train_sc.main(["-c", "cfg.yaml", "-w", work, "--device", "cuda:0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rank = int(os.environ["RANK"])
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump({"wall": wall, "launches": read_launches()}, f)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def trials_over_ranks(torch, np, kc, fb, root, csv, cfg_path, card, expect, work_8a, wall_8a):
    """Phase 12b: ``train_sc`` of the config's FC trials at INDEPENDENCE_LR
    (EPOCHS epochs) over RANKS ranks on the one card (``python -m
    torch.distributed.run``): the same tree file for file as 8a's; every
    ``losses.csv`` and bundle bit-identical to one process training the
    same stacks (waves of trials / RANKS: each rank stacks its block so);
    against one process in one wave (T 8 stacked, whose batched products
    may sum in another order) the training losses within phase 4's loss
    tolerance, 8b's, and the largest leaf difference printed; each rank
    launching K1 and K2 as phase 3's one-trial run.  Returns the launches
    of the three runs."""
    import functools

    from rankaae_tpu_torch.cli import train_sc
    from rankaae_tpu_torch.utils.config import Parameters

    trials = Parameters.from_yaml(cfg_path).get("trials")
    per_rank = -(-trials // RANKS)
    total = {}
    runs = {}
    for name, resident in (("one wave", None), (f"waves of {per_rank}", per_rank)):
        runs[name] = work_dir(root, f"ranks_{resident}", csv, cfg_path, lr_base=INDEPENDENCE_LR,
                              max_epoch=EPOCHS)
        real = train_sc.run_trials
        if resident:
            train_sc.run_trials = functools.partial(real, max_resident=resident)
        try:
            sec, launches = run_train_sc(torch, kc, fb, runs[name], "cuda")
        finally:
            train_sc.run_trials = real
        waves = -(-trials // (resident or trials))
        assert launches == {**{k: waves * v for k, v in expect.items()}, "fused_block": 0}, \
            (name, launches)
        add_launches(total, launches)
        runs[name] = (runs[name], sec)
    two = work_dir(root, "ranks_two", csv, cfg_path, lr_base=INDEPENDENCE_LR, max_epoch=EPOCHS)
    out = os.path.join(root, "ranks_out")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                          "--nproc-per-node", str(RANKS), "--master-port", str(free_port()),
                          os.path.join(HERE, "chip_smoke.py"), "--train-sc-rank", two, out],
                         capture_output=True, text=True, timeout=600, cwd=HERE)
    wall_two = time.perf_counter() - t0
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    ranks = []
    for rank in range(RANKS):
        with open(os.path.join(out, f"rank_{rank}.json")) as f:
            ranks.append(json.load(f))
        assert ranks[-1]["launches"] == {**expect, "fused_block": 0}, (rank, ranks[-1])
        add_launches(total, ranks[-1]["launches"])
    (one, sec_one), (stacks, sec_stacks) = runs.values()
    tree = job_files(two)
    assert tree == job_files(one) == job_files(stacks) == job_files(work_8a), \
        (tree, job_files(work_8a))
    assert not os.path.exists(os.path.join(two, "train_state")), "rank 1 wrote files"
    check_tree(np, two, trials, "FC", 256)
    same = tree_diff(np, stacks, two)
    worst = {"train": 0.0, "val": 0.0, "leaf": 0.0, "leaf_at": None}
    for job in sorted(os.listdir(os.path.join(one, "training"))):
        a, b = (np.genfromtxt(os.path.join(w, "training", job, "losses.csv"), delimiter=",",
                              skip_header=1, usecols=range(13), ndmin=2) for w in (one, two))
        assert a.shape == b.shape, job
        d = np.abs(a - b).max(axis=0)
        worst["train"] = max(worst["train"], float(d[1::2].max()))    # Train_* columns
        worst["val"] = max(worst["val"], float(d[2::2].max()))
        for name in BUNDLES:
            d, leaf = bundle_diff(np, os.path.join(one, "training", job, name),
                                  os.path.join(two, "training", job, name), where=True)
            if d >= worst["leaf"]:
                worst["leaf"], worst["leaf_at"] = d, f"{job}/{name}{leaf}"
    print(f"12b train_sc over {RANKS} ranks on one card: {trials} FC trials, lr_base "
          f"{INDEPENDENCE_LR}, {EPOCHS} epochs: command {wall_two:.2f} s wall (each rank's "
          f"train_sc {[round(r['wall'], 2) for r in ranks]} s, in a fresh process) against "
          f"one process {sec_one:.2f} s (one wave) and {sec_stacks:.2f} s (waves of "
          f"{per_rank}), and 8a's {wall_8a:.2f} s (its first train_sc); tree equal to 8a's; "
          f"against the waves of {per_rank}: "
          + ("bit-identical" if not same else f"differences {json.dumps(same)}")
          + f"; against one wave: largest differences {json.dumps(worst)} (the training "
          f"losses held to {PARITY_ATOL}); launches per rank "
          f"{[r['launches'] for r in ranks]} [{card}]")
    assert not same, same
    assert worst["train"] <= PARITY_ATOL, worst
    return total


def dp_main(argv) -> int:
    """One rank of phase 12c (``chip_smoke.py --dp-rank CFG DATA OUT``
    under torchrun, one card a rank): ``run_trials`` of 2 trials at dp 2
    (the train rows sharded over the two cards, NCCL), its logs into OUT."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.parallel import multihost
    from rankaae_tpu_torch.parallel.trials import run_trials
    from rankaae_tpu_torch.train.trainer import TrialData
    from rankaae_tpu_torch.utils.config import TrainConfig

    cfg_json, data_npz, out = argv
    multihost.initialize()
    with open(cfg_json) as f:
        cfg = TrainConfig(**json.load(f))
    with np.load(data_npz) as z:
        data = TrialData(*(torch.from_numpy(z[k]) for k in ("a", "b", "c", "d")))
    res = run_trials(cfg, data, n_trials=2, device=multihost.rank_device(), dp=2)
    rank = multihost.world()[0]
    np.savez(os.path.join(out, f"dp_rank_{rank}.npz"), **res.logs)
    torch.distributed.destroy_process_group()
    return 0


def dp_layout(torch, np, root, cfg, splits, card):
    """Phase 12c: where the machine has two cards, 2 trials at dp 2 (one
    rank a card, the train rows sharded, NCCL) against one process at dp 1:
    every log within phase 4's loss tolerance.  With one card it does not
    run: NCCL refuses two ranks on one GPU."""
    from rankaae_tpu_torch.parallel.trials import run_trials
    from rankaae_tpu_torch.train.trainer import TrialData

    n = torch.cuda.device_count()
    if n < 2:
        print(f"12c: the trial x dp layout did not run: it needs two cards (NCCL refuses two "
              f"ranks on one GPU) and this machine has {n}; the CPU test "
              f"tests/test_torch_multihost.py holds it with gloo [{card}]")
        return
    import dataclasses

    dcfg = cfg.replace(max_epoch=2)
    ref = run_trials(dcfg, TrialData(*(torch.from_numpy(a) for a in splits)), n_trials=2,
                     device="cuda")
    cfg_json, data_npz = os.path.join(root, "dp_cfg.json"), os.path.join(root, "dp_data.npz")
    with open(cfg_json, "w") as f:
        json.dump(dataclasses.asdict(dcfg), f)
    np.savez(data_npz, a=splits[0], b=splits[1], c=splits[2], d=splits[3])
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                          "--nproc-per-node", "2", "--master-port", str(free_port()),
                          os.path.join(HERE, "chip_smoke.py"), "--dp-rank", cfg_json, data_npz,
                          root], capture_output=True, text=True, timeout=600, cwd=HERE)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    worst = 0.0
    for rank in range(2):
        with np.load(os.path.join(root, f"dp_rank_{rank}.npz")) as z:
            for k in z.files:
                worst = max(worst, float(np.abs(z[k] - ref.logs[k]).max()))
    print(f"12c: 2 trials at dp 2 over two cards (train rows sharded, NCCL) against dp 1: "
          f"largest log difference {worst:.3g} (held to {PARITY_ATOL}) [{card}]")
    assert worst <= PARITY_ATOL, worst


def loader_times(np, csv, card):
    """Phase 12d: the native loader against pandas on the 7,000-row CSV:
    every float, column and index entry equal; the median of LOADER_READS
    reads of each (after one untimed read: the native library is built or
    loaded, the file cached)."""
    from rankaae_tpu_torch.data import native
    from rankaae_tpu_torch.data.dataset import read_csv

    t0 = time.perf_counter()
    native.load()
    build = time.perf_counter() - t0
    out, times = {}, {}
    for engine in ("native", "pandas"):
        out[engine] = read_csv(csv, engine=engine)
        times[engine] = []
        for _ in range(LOADER_READS):
            t0 = time.perf_counter()
            read_csv(csv, engine=engine)
            times[engine].append(time.perf_counter() - t0)
    (cn, dn, inn), (cp, dp_, ip) = out["native"], out["pandas"]
    assert cn == cp and inn == ip and dn.dtype == dp_.dtype and np.array_equal(dn, dp_)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"12d loader: {dn.shape[0]} rows x {dn.shape[1]} columns, native equal to pandas "
          f"(every float, column and index entry); median of {LOADER_READS} reads: native "
          f"{med['native'] * 1e3:.2f} ms, pandas {med['pandas'] * 1e3:.2f} ms "
          f"({med['pandas'] / med['native']:.2f}x); build or load of the native library "
          f"{build:.2f} s [{card}]")
    return med


# ---------------------------------------------------------------------------
# phase 13: the JAX package's public surface (RankAAETrainer.run and
# run_epochs, get_dataloaders, DualAAE, native_available)
# ---------------------------------------------------------------------------

RUN_CUT = 1                      # 13a: run_epochs over [0, RUN_CUT), then run(start_epoch=)
DUAL_B = 1024                    # 13b: get_dataloaders' batch size
DUAL_SEED = 13


def state_leaves(np, tree, prefix=""):
    """``RankAAETrainer.state_tree``'s leaves by path, as numpy arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in state_leaves(np, sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in state_leaves(np, sub, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree)}


def run_resumed_on_card(torch, np, kc, cfg, splits, tmp, card, expect):
    """Phase 13a: ``RankAAETrainer.run`` of the config's trials (full width,
    EPOCHS epochs) against ``run_epochs`` over [0, RUN_CUT), its train state
    saved (``save_train_state``), reloaded into a fresh trainer and resumed
    by ``run(start_epoch=RUN_CUT)``: every log and every leaf of the train
    state (weights, moments, trackers, schedulers, generators)
    bit-identical.  K1 and K2 launch as phase 3's one-trial run, twice over
    (the uncut run and the cut one, one launch for all trials).  Returns
    the launches."""
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils.checkpoint import load_train_state, save_train_state

    rcfg = cfg.replace(max_epoch=EPOCHS)
    data = TrialData(*(torch.tensor(a, device="cuda") for a in splits))

    def trainer():
        return RankAAETrainer(rcfg, n_train=splits[0].shape[0], n_val=splits[2].shape[0],
                              trials=rcfg.trials, device="cuda")

    zero_launches("kendall_pair_sums", "kendall_grad_rows")
    t0 = time.perf_counter()
    uncut = trainer()
    s_uncut, logs = uncut.run(uncut.init_state(0), data)
    cut = trainer()
    s_cut, first = cut.run_epochs(cut.init_state(0), data, range(RUN_CUT))
    path = save_train_state(os.path.join(tmp, "run_13a.mpk"), cut.state_tree(s_cut),
                            extra={"epoch": RUN_CUT})
    tree, extra = load_train_state(path)
    resumed = trainer()
    s_res = resumed.load_state_tree(resumed.init_state(0), tree)
    s_res, rest = resumed.run(s_res, data, start_epoch=extra["epoch"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("kendall_pair_sums", "kendall_grad_rows")
    assert_tickets_clear(kc, "after 13a")
    want = {k: 2 * v for k, v in expect.items()}
    assert launches == want, (launches, want)
    t = rcfg.trials
    assert logs["metrics"].shape == (EPOCHS, t, 5) and logs["epoch"].shape == (EPOCHS, t)
    assert torch.equal(RankAAETrainer.final_metrics(logs), logs["metrics"][-1])
    for k, v in logs.items():
        assert torch.isfinite(v.float()).all(), k
        assert torch.equal(torch.cat([first[k], rest[k]]), v), k
    a, b = (state_leaves(np, tr.state_tree(st)) for tr, st in ((uncut, s_uncut),
                                                                (resumed, s_res)))
    assert sorted(a) == sorted(b)
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not differ, differ
    print(f"13a run/run_epochs: {t} trials of example/fix_config.yaml at full width, "
          f"{EPOCHS} epochs: run() against run_epochs over [0, {RUN_CUT}), the train state "
          f"saved, reloaded into a fresh trainer and run(start_epoch={RUN_CUT}): all "
          f"{len(logs)} logs and {len(a)} train-state leaves bit-identical; {wall:.2f} s for "
          f"the three trainers; K1/K2 launches {launches} (expected {want}) [{card}]")
    return launches


def dual_aae_on_card(torch, np, fb, csv, card):
    """Phase 13b: ``get_dataloaders`` over the CSV, its train batches (B
    DUAL_B, the last one ragged) through a seeded ``DualAAE`` of the normal
    form with ``DiscriminatorFC`` on the card, against the same module
    carried to the CPU through the weight bridge (``to_jax`` then
    ``load_jax``), at phase 6's serving tolerance; K3 launches
    NORMAL_FUSED_BLOCKS times a batch.  Returns the K3 launches."""
    from rankaae_tpu_torch.data.dataset import get_dataloaders
    from rankaae_tpu_torch.models.decoders import Decoder
    from rankaae_tpu_torch.models.encoders import Encoder
    from rankaae_tpu_torch.models.registry import DualAAE
    from rankaae_tpu_torch.utils.weights import to_jax

    train, _, _ = get_dataloaders(csv, batch_size=DUAL_B, n_aux=5)
    torch.manual_seed(DUAL_SEED)
    model = DualAAE(False, Encoder, Decoder)          # on the card by default
    gen = torch.Generator().manual_seed(DUAL_SEED)
    with torch.no_grad():                             # running statistics away from 0 and 1
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=gen) + 0.5)
    params, stats = to_jax({"enc": model.encoder, "dec": model.decoder,
                            "dis": model.discriminator})
    cpu = DualAAE(False, Encoder, Decoder, device="cpu").load_jax(
        {r: {"params": params[r], "batch_stats": stats[r]} for r in params})
    batches = list(train)
    zero_launches("fused_block")
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = [model(spec.to("cuda")) for spec, _ in batches]
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_launches()["fused_block"]
    want = NORMAL_FUSED_BLOCKS * len(batches)
    assert launches == want, (launches, want)
    err = {"reconstruction": 0.0, "discriminator": 0.0}
    with torch.no_grad():
        for (spec, _), (x2, gau) in zip(batches, outs):
            c2, cgau = cpu(spec)
            assert x2.shape == c2.shape == spec.shape and gau.shape == cgau.shape == (
                spec.shape[0], 1)
            assert torch.isfinite(x2).all() and torch.isfinite(gau).all()
            err["reconstruction"] = max(err["reconstruction"],
                                        (x2.cpu() - c2).abs().max().item())
            err["discriminator"] = max(err["discriminator"], (gau.cpu() - cgau).abs().max().item())
    assert all(v <= SERVE_ATOL for v in err.values()), err
    print(f"13b DualAAE: get_dataloaders' {len(batches)} train batches (B {DUAL_B}, rows "
          f"{[b[0].shape[0] for b in batches]}) through the normal form with DiscriminatorFC: "
          f"card vs CPU max |difference| {json.dumps(err)} (atol {SERVE_ATOL}); the card's "
          f"forwards {card_s * 1e3:.1f} ms; K3 launches {launches} (expected {want}) [{card}]")
    return launches


PARITY_SEEDS, PARITY_EPOCHS, PARITY_ROWS, PARITY_SEGMENT = 4, 6, 2000, 3   # phase 14
PARITY_MSE_RTOL, PARITY_RANK_ATOL = 1e-4, 1e-3
PARITY_JAX_RECORD = os.path.join("artifacts", "parity_fused", "fc300_faithful", "ours.json")
PARITY_REF_DIR = os.path.join("artifacts", "parity_fc300")


def _finite_leaves(np, tree):
    if isinstance(tree, dict):
        return all(_finite_leaves(np, v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite_leaves(np, v) for v in tree)
    return bool(np.isfinite(tree))


def parity_harness_on_card(torch, np, kc, tmp, card):
    """Phase 14: the training-quality harness (``tools/parity_experiment.py``
    ``--mode ours``) at FC, PARITY_SEEDS seeds x PARITY_EPOCHS epochs on
    PARITY_ROWS rows, once with ``--segment-epochs PARITY_SEGMENT`` and once
    without: (a) every stat of the two records equal (FC is bit-identical,
    as 13a); (b) the record's keys those of the JAX package's record
    (``PARITY_JAX_RECORD``) plus the port's four, every number finite, every
    trace PARITY_EPOCHS long; (c) the final weights of two seeds scored by
    ``_final_stats`` on the card and on the CPU: MSEs within
    PARITY_MSE_RTOL relative, Spearman and Shapiro-W within
    PARITY_RANK_ATOL (rank ties may flip); (d) ``--mode aggregate`` against
    the reference's committed seeds and ``parity_gate`` against the JAX
    record render.  K1 and K2 launch epochs x (batches + 1) and epochs x
    batches a run (one launch for all seeds).  Returns the launches."""
    from rankaae_tpu_torch.models.inference import InferenceModel
    from rankaae_tpu_torch.tools import parity_experiment as pe
    from rankaae_tpu_torch.tools import parity_gate

    base = ["--mode", "ours", "--epochs", str(PARITY_EPOCHS), "--rows", str(PARITY_ROWS),
            "--seeds", str(PARITY_SEEDS), "--device", "cuda"]
    runs, walls = {}, {}
    zero_launches("kendall_pair_sums", "kendall_grad_rows")
    for name, extra in (("uncut", []), ("segmented", ["--segment-epochs", str(PARITY_SEGMENT)])):
        t0 = time.perf_counter()
        runs[name] = pe.main(base + ["--json-dir", os.path.join(tmp, f"parity_{name}")] + extra)
        walls[name] = time.perf_counter() - t0
    launches = read_launches("kendall_pair_sums", "kendall_grad_rows")
    assert_tickets_clear(kc, "after 14a")
    n_train = runs["uncut"].train_spec.shape[0]
    n_batch = -(-n_train // runs["uncut"].cfg.batch_size)
    want = {"kendall_pair_sums": 2 * PARITY_EPOCHS * (n_batch + 1),
            "kendall_grad_rows": 2 * PARITY_EPOCHS * n_batch}
    assert launches == want, (launches, want)
    uncut, seg = runs["uncut"].record, runs["segmented"].record
    # (a)
    assert uncut["seeds"] == seg["seeds"], "segmented run differs from the uncut one"
    # (b)
    with open(os.path.join(HERE, PARITY_JAX_RECORD)) as f:
        jax_rec = json.load(f)
    extra_keys = {"stack", "device", "seed_scheme", "command"}
    assert set(uncut) == set(jax_rec) | extra_keys, sorted(uncut)
    js = jax_rec["seeds"][0]
    for s in uncut["seeds"]:
        assert set(s) == set(js), sorted(s)
        for k, v in js.items():
            if isinstance(v, dict):
                assert set(s[k]) == set(v), (k, sorted(s[k]))
        assert _finite_leaves(np, s), s
        assert len(s["metrics_trace"]) == PARITY_EPOCHS and all(
            len(s[k]) == PARITY_EPOCHS for k in ("val_recon_trace", "lr_recon_trace",
                                                 "gain_trace"))
        assert all(len(v) == PARITY_EPOCHS for v in s["component_traces"].values())
    # (c)
    run = runs["uncut"]
    worst = {"mse_rel": 0.0, "rank": 0.0, "other": 0.0}
    for i in (0, 1):
        t = run.results.trial(i)
        got = {}
        for dev in ("cuda", "cpu"):
            m = InferenceModel(t["final_params"], t["final_batch_stats"], run.cfg, device=dev)
            got[dev] = pe._final_stats(m.encode, m.decode, run.val_spec, run.val_aux,
                                       train_spec=run.train_spec)
        for k, v in got["cpu"].items():
            a, b = np.asarray(got["cuda"][k], float), np.asarray(v, float)
            if k.startswith("recon_mse"):
                worst["mse_rel"] = max(worst["mse_rel"], float(np.max(np.abs(a - b) / np.abs(b))))
            elif k in ("style_desc_rho", "shapiro_min", "coupling"):
                worst["rank"] = max(worst["rank"], float(np.max(np.abs(a - b))))
            else:
                worst["other"] = max(worst["other"], float(np.max(np.abs(a - b))))
    assert worst["mse_rel"] <= PARITY_MSE_RTOL and worst["rank"] <= PARITY_RANK_ATOL \
        and worst["other"] <= PARITY_RANK_ATOL, worst
    # (d)
    agg_md, gate_md = os.path.join(tmp, "aggregate.md"), os.path.join(tmp, "gate.md")
    pe.main(["--mode", "aggregate", "--json-dir", os.path.join(tmp, "parity_uncut"),
             "--ref-json-dir", os.path.join(HERE, PARITY_REF_DIR), "--out", agg_md])
    parity_gate.main(["--pair", "FC", os.path.join(HERE, PARITY_JAX_RECORD),
                      os.path.join(tmp, "parity_uncut", "ours.json"),
                      "--columns", "rankaae_tpu (TPU v5e)", "rankaae_tpu_torch (card)",
                      "--out", gate_md])
    with open(agg_md) as f:
        agg = f.read()
    with open(gate_md) as f:
        gate = f.read()
    assert "## Secondary: final-epoch models" in agg and "rankaae_tpu_torch (n=4)" in agg, agg
    assert gate.count("OVERLAP") + gate.count("DISJOINT") >= 4, gate
    print(f"14 parity harness: --mode ours at FC, {PARITY_SEEDS} seeds x {PARITY_EPOCHS} epochs "
          f"on {PARITY_ROWS} rows (n_train {n_train}, {n_batch} batches an epoch): "
          f"(a) --segment-epochs {PARITY_SEGMENT} and uncut records equal in every stat; "
          f"(b) keys as {PARITY_JAX_RECORD} + {sorted(extra_keys)}, all finite, traces "
          f"{PARITY_EPOCHS} long; (c) two seeds' final weights scored card vs CPU: "
          f"{json.dumps(worst)} (MSE rtol {PARITY_MSE_RTOL}, Spearman/Shapiro atol "
          f"{PARITY_RANK_ATOL}); (d) aggregate ({len(agg.splitlines())} lines) and gate "
          f"({len(gate.splitlines())} lines) rendered; training walls "
          f"{runs['uncut'].wall:.2f} / {runs['segmented'].wall:.2f} s, commands "
          f"{walls['uncut']:.2f} / {walls['segmented']:.2f} s; K1/K2 launches {launches} "
          f"(expected {want}) [{card}]")
    return launches


# phase 15: the grouped conv kernels C1-C3 (``ops/conv1d_cuda.py``)
#: lengths each table shape is checked at: a convolution's input, a
#: transposed convolution's input (its output is stride times as long)
CONV_LENGTHS = (1, 3, 8, 16, 32, 64, 128, 256)
CONV_T_LENGTHS = (1, 2, 4, 8, 16, 64)
CONV_ROWS = (1, 3, 70)
CONV_GROUPS = 5
# C1 and C2 sum at most 8 * 17 products an output, C3 up to N * L: their
# largest difference from the plain version, over the reference's largest
# magnitude (float32 sums in another order)
CONV_RTOL = {"C1": 1e-5, "C2": 1e-5, "C3": 1e-4}
#: phase 15b: the main path's largest convolutions at T 32, B 1024, as
#: (label, (C_in, C_out, taps, stride) in conv terms, mode, lx):
#: the stride-1 blocks' 11-tap convolutions at 256, the normal encoder's
#: first two stride-2 ones, and the last DecodingBlock's transposed 4 -> 4,
#: 64 -> 256
CONV_TIMED = (
    ("4->4 k11 s1 L256 replicate", (4, 4, 11, 1), "replicate", 256),
    ("4->4 k11 s1 L256 zero", (4, 4, 11, 1), "zeros", 256),
    ("4->4 k11 s2 L256->128 zero", (4, 4, 11, 2), "zeros", 256),
    ("4->4 k11 s2 L128->64 zero", (4, 4, 11, 2), "zeros", 128),
    ("transposed 4->4 k4 L64->256", (4, 4, 4, 4), "transposed", 256),
)
CONV_TIMED_B, CONV_TIMED_T = 1024, 32
#: phase 15a's cases at B 1024, T 32 (several tiles a block): CONV_TIMED and
#: the CNN discriminator's replicate-padded 5-tap convolutions at L 64
CONV_LARGE = CONV_TIMED + (
    ("1->2 k5 s1 L64 replicate", (1, 2, 5, 1), "replicate", 64),
    ("2->2 k5 s1 L64 replicate", (2, 2, 5, 1), "replicate", 64),
    ("2->1 k5 s1 L64 replicate", (2, 1, 5, 1), "replicate", 64),
)
CONV_FORMS = ("normal", "compact")
#: the launch counters of C1-C3 and the kernels the device trace names
CONV_COUNTERS = {"C1": "conv.fwd_launches", "C2": "conv.dgrad_launches",
                 "C3": "conv.wgrad_launches"}
CONV_KERNELS = {"C1": "conv_fwd_kernel", "C2": "conv_dgrad_kernel", "C3": "conv_wgrad_kernel"}
#: cuDNN's convolution kernels, none of which may run in a training epoch
CUDNN_CONV_NAMES = ("fft", "region_transform", "wgrad_alg", "dgrad_engine",
                    "implicit_convolve_sgemm", "xmma_fprop")


def _conv_case(torch, cc, key, mode, n, groups, lx, dev, seed):
    """A geometry and random operands of one check: for a convolution x,
    w, b, dy and a bias of C2's; for a transposed one its x (C2's dy), w,
    its bias, and its dy (C1's x)."""
    ci, co, k, s = key
    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = 0 if mode in ("none", "transposed") else (k - 1) // 2
    geo = cc.Geometry(ci, co, k, s, pad, mode == "replicate", groups)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    w = rnd(groups * co, ci, k) / (ci * k) ** 0.5
    if mode == "transposed":
        return geo, rnd(n, groups * co, lx), w, rnd(groups * ci), rnd(n, groups * ci, lx * s)
    return geo, rnd(n, groups * ci, lx), w, rnd(groups * co), rnd(n, groups * co,
                                                                   geo.out_length(lx))


def conv_runs(cc, geo, mode, x, w, b, other):
    """The three kernels and their plain versions on one case: {kernel:
    (kernel's result, plain result)}, C3's weight and bias gradients joined."""
    if mode == "transposed":            # x is the transposed conv's input, other its dy
        lx = x.shape[-1] * geo.stride
        c1 = (cc.forward(other, w, None, geo), cc.forward_plain(other, w, None, geo))
        c2 = (cc.input_grad(x, w, lx, geo, b), cc.input_grad_plain(x, w, lx, geo, b))
        c3k = cc.weight_grad(other, x, geo, cc.BIAS_X)
        c3p = cc.weight_grad_plain(other, x, geo, cc.BIAS_X)
    else:                               # other is dy
        bias_in = b.new_ones(geo.groups * geo.c_in)
        c1 = (cc.forward(x, w, b, geo), cc.forward_plain(x, w, b, geo))
        c2 = (cc.input_grad(other, w, x.shape[-1], geo, bias_in),
              cc.input_grad_plain(other, w, x.shape[-1], geo, bias_in))
        c3k = cc.weight_grad(x, other, geo, cc.BIAS_DY)
        c3p = cc.weight_grad_plain(x, other, geo, cc.BIAS_DY)
    return {"C1": c1, "C2": c2, "C3": (c3k, c3p)}


def _check_conv_case(torch, cc, key, mode, n, groups, lx, dev, seed, worst):
    """One case of phase 15a: C1, C2 and C3 against their plain versions
    (CONV_RTOL), C3 bit-identical over two calls, C1 with its bias equal to
    C1 without it plus the bias, bit for bit; ``worst`` takes each kernel's
    largest relative difference."""
    geo, x, w, b, other = _conv_case(torch, cc, key, mode, n, groups, lx, dev, seed=seed)
    runs = conv_runs(cc, geo, mode, x, w, b, other)
    for name, (got, want) in runs.items():
        if name == "C3":
            got, want = torch.cat([got[0].flatten(), got[1]]), \
                torch.cat([want[0].flatten(), want[1]])
        err = ((got - want).abs().max() / want.abs().max()).item()
        worst[name] = max(worst[name], err)
        assert err <= CONV_RTOL[name], (name, key, mode, lx, n, groups, err)
    again = conv_runs(cc, geo, mode, x, w, b, other)["C3"][0]
    assert all(torch.equal(a, c) for a, c in zip(runs["C3"][0], again)), (key, mode, lx, n)
    if mode != "transposed":    # C1 rounds the bias in once, after the taps' sum
        assert torch.equal(cc.forward(x, w, b, geo), cc.forward(x, w, None, geo) + b[:, None]), \
            (key, mode, lx, n)


def check_conv(torch, cc):
    """Phase 15a: every table shape as a convolution (no, zero and replicate
    padding) and, where kernel == stride, as a transposed one, over
    CONV_LENGTHS x CONV_ROWS; then CONV_LARGE at the main path's B 1024, T
    32, where a C1 or C2 block walks several tiles through its two buffers
    and a C3 block several sub-tiles: C1, C2 and C3 against their plain
    versions (CONV_RTOL), C3 bit-identical over two calls.  Returns the
    largest relative difference of each kernel in each pass."""
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False     # the plain versions in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = dict.fromkeys(CONV_RTOL, 0.0)
    cases = 0
    for key in cc.SHAPES:
        _, _, k, s = key
        modes = ["none"] if k == 1 else ["none", "zeros", "replicate"]
        for mode in modes + (["transposed"] if k == s else []):
            lengths = CONV_T_LENGTHS if mode == "transposed" else CONV_LENGTHS
            for lx in lengths:
                if mode != "transposed" and lx + (k - 1) // 2 * 2 * (mode != "none") < k:
                    continue
                for n in CONV_ROWS:
                    _check_conv_case(torch, cc, key, mode, n, CONV_GROUPS, lx, dev, cases, worst)
                    cases += 1
    large = dict.fromkeys(CONV_RTOL, 0.0)
    for i, (_, key, mode, lx) in enumerate(CONV_LARGE):
        _check_conv_case(torch, cc, key, mode, CONV_TIMED_B, CONV_TIMED_T,
                         lx // key[3] if mode == "transposed" else lx, dev, 10_000 + i, large)
    torch.cuda.synchronize()
    print(f"15a conv kernels: {cases} cases ({len(cc.SHAPES)} shapes, N <= {max(CONV_ROWS)}, "
          f"{CONV_GROUPS} groups) and {len(CONV_LARGE)} at B {CONV_TIMED_B}, T {CONV_TIMED_T} "
          f"({', '.join(label for label, *_ in CONV_LARGE)}) agree with the plain versions, "
          f"largest relative differences {json.dumps(worst)} and at B {CONV_TIMED_B} "
          f"{json.dumps(large)} (limits {json.dumps(CONV_RTOL)}); C3 bit-identical over two "
          f"calls in every case")
    return {"small": worst, "large": large}


def conv_bytes(geo, mode, n, lx):
    """Bytes C1, C2 and C3 must move at (geo, n, lx): each input read once
    and each output written once (C3's few hundred output floats a group
    left out)."""
    if mode == "transposed":            # C2 maps (n, g*co, lx/s) to (n, g*ci, lx)
        small = n * geo.groups * geo.c_out * (lx // geo.stride) * 4
        big = n * geo.groups * geo.c_in * lx * 4
        return {"C1": small + big, "C2": small + big, "C3": small + big}
    x = n * geo.groups * geo.c_in * lx * 4
    y = n * geo.groups * geo.c_out * geo.out_length(lx) * 4
    return {"C1": x + y, "C2": x + y, "C3": x + y}


def time_conv(torch, cc, card):
    """Phase 15b: C1-C3 at CONV_TIMED (B 1024, T 32): CUDA events around
    back-to-back calls, against their byte bound (bytes over 3.35 TB/s),
    their plain versions and cuDNN (``library_ms``: ``F.conv1d`` or
    ``conv_transpose1d`` and ``torch.ops.aten.convolution_backward``, a
    yardstick the port never calls).  Returns {label: {kernel: times}}."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    for label, key, mode, lx in CONV_TIMED:
        n, groups = CONV_TIMED_B, CONV_TIMED_T
        geo, x, w, b, other = _conv_case(torch, cc, key, mode, n, groups,
                                         lx // key[3] if mode == "transposed" else lx, dev, 0)
        nbytes = conv_bytes(geo, mode, n, lx)
        if mode == "transposed":
            x_t, dy_t, big = x, other, lx
            kern = {"C1": lambda: cc.forward(dy_t, w, None, geo),
                    "C2": lambda: cc.input_grad(x_t, w, big, geo, b),
                    "C3": lambda: cc.weight_grad(dy_t, x_t, geo, cc.BIAS_X)}
            plain = {"C1": lambda: cc.forward_plain(dy_t, w, None, geo),
                     "C2": lambda: cc.input_grad_plain(x_t, w, big, geo, b),
                     "C3": lambda: cc.weight_grad_plain(dy_t, x_t, geo, cc.BIAS_X)}
            lib_in, lib_w, lib_out = dy_t, w, x_t      # C1 is the conv of dy_t
            lib = {"C2": lambda: F.conv_transpose1d(x_t, w, b, geo.stride, 0, 0, groups)}
            lib_pad = 0
        else:
            dy = other
            kern = {"C1": lambda: cc.forward(x, w, b, geo),
                    "C2": lambda: cc.input_grad(dy, w, lx, geo),
                    "C3": lambda: cc.weight_grad(x, dy, geo, cc.BIAS_DY)}
            plain = {"C1": lambda: cc.forward_plain(x, w, b, geo),
                     "C2": lambda: cc.input_grad_plain(dy, w, lx, geo),
                     "C3": lambda: cc.weight_grad_plain(x, dy, geo, cc.BIAS_DY)}
            # cuDNN on the padded input for replicate padding (the pad not timed)
            lib_in = F.pad(x, (geo.pad, geo.pad), mode="replicate") if geo.replicate else x
            lib_w, lib_out, lib_pad = w, dy, 0 if geo.replicate else geo.pad
            lib = {}
        lib.setdefault("C1", lambda: F.conv1d(lib_in, lib_w, None if mode == "transposed"
                                              else b, geo.stride, lib_pad, 1, groups))
        lib["C2"] = lib.get("C2") or (lambda: torch.ops.aten.convolution_backward(
            lib_out, lib_in, lib_w, None, [geo.stride], [lib_pad], [1], False, [0], groups,
            [True, False, False]))
        lib["C3"] = lambda: torch.ops.aten.convolution_backward(
            lib_out, lib_in, lib_w, [lib_w.shape[0]], [geo.stride], [lib_pad], [1], False,
            [0], groups, [False, True, True])
        rows[label] = {}
        for name in ("C1", "C2", "C3"):
            ms = time_ms(torch, kern[name], reps=50, warmup=5)
            bound = nbytes[name] / PEAK_BYTES_PER_S * 1e3
            rows[label][name] = {
                "ms": ms, "bound_ms": bound, "bound_by": "bytes", "roofline": bound / ms,
                "plain_ms": time_ms(torch, plain[name], reps=10, warmup=2),
                "library_ms": time_ms(torch, lib[name], reps=20, warmup=3)}
        torch.cuda.empty_cache()
        print(f"15b {label}, B {n}, T {groups}: " + json.dumps(rows[label]) + f" [{card}]")
    return rows


def conv_epoch_trace(torch, cfg_path, splits, trials=CONV_TIMED_T):
    """One traced training epoch of each form of CONV_FORMS at T ``trials``
    (after a warm-up epoch): {form: the ``conv.*`` counters' launches, the
    calls the epoch's protocol makes (counted by hooks on the conv modules
    and the smoothing filter, and on their outputs for each backward), the
    conv kernels the device trace shows and their device ms, the cuDNN
    convolution kernels it shows, and its device ms in all}."""
    from rankaae_tpu_torch.models import primitives as P
    from rankaae_tpu_torch.ops import losses
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils import tracing
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    out = {}
    for form in CONV_FORMS:
        params = Parameters.from_yaml(cfg_path)
        params.update({"ae_form": form})
        cfg = TrainConfig.from_parameters(params)
        P.set_matmul_precision(cfg.matmul_precision)
        data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
        core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                              trials=trials, device="cuda")
        state = core.init_state(0)
        state, _ = core.epoch_step(state, 0, data)
        torch.cuda.synchronize()
        want = dict.fromkeys(CONV_COUNTERS, 0)

        def counted(calls, weighted, grads_x):
            """Count a call's launches, and those of each backward through it."""
            def on_backward(_):
                want["C2" if calls == "C1" else "C1"] += grads_x
                want["C3"] += weighted
            return on_backward

        def hook(m, inp, y):
            tconv = isinstance(m, P.TrialConvTranspose1d)
            want["C2" if tconv else "C1"] += 1
            if y.requires_grad:
                y.register_hook(counted("C2" if tconv else "C1",
                                        int(m.weight.requires_grad), int(inp[0].requires_grad)))

        handles = [m.register_forward_hook(hook) for model in core.models.values()
                   for m in model.modules()
                   if isinstance(m, (P.TrialConv1d, P.TrialConvTranspose1d))]
        smooth = losses.gaussian_smooth_1d

        def smoothing(x, *a):
            want["C1"] += 1
            y = smooth(x, *a)
            if y.requires_grad:
                y.register_hook(lambda _: want.__setitem__("C2", want["C2"] + 1))
            return y

        losses.gaussian_smooth_1d = smoothing
        before = {k: tracing.counter(v) for k, v in CONV_COUNTERS.items()}
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                state, _ = core.epoch_step(state, 1, data)
                torch.cuda.synchronize()
        finally:
            losses.gaussian_smooth_1d = smooth
            for h in handles:
                h.remove()
        traced = dict.fromkeys(CONV_COUNTERS, 0)
        traced_ms = dict.fromkeys(CONV_COUNTERS, 0.0)
        cudnn = {}
        all_ms = 0.0
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = (evt.time_range.end - evt.time_range.start) / 1e3
            all_ms += ms
            for k, kname in CONV_KERNELS.items():
                traced[k] += kname in evt.name
                traced_ms[k] += ms * (kname in evt.name or (k == "C3" and
                                                             "conv_wgrad_sum" in evt.name))
            if any(c in evt.name for c in CUDNN_CONV_NAMES):
                cudnn[evt.name[:80]] = cudnn.get(evt.name[:80], 0) + 1
        got = {k: int(tracing.counter(v) - before[k]) for k, v in CONV_COUNTERS.items()}
        out[form] = {"launches": got, "protocol": want, "traced": traced,
                     "traced_ms": traced_ms, "cudnn": cudnn, "device_ms": all_ms}
        del core, state, data
        torch.cuda.empty_cache()
    return out


def conv_epoch_main(argv) -> int:
    """Phase 15c's traced epochs in a process of their own (``chip_smoke.py
    --conv-epoch DATA OUT``): :func:`conv_epoch_trace` on the splits in
    DATA, its result into OUT as JSON."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.ops import conv1d_cuda as cc

    data_npz, out = argv
    cc.build()
    with np.load(data_npz) as z:
        splits = tuple(z[k] for k in ("a", "b", "c", "d"))
    res = conv_epoch_trace(torch, os.path.join(HERE, "example", "fix_config.yaml"), splits)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def conv_epoch_launches(np, splits, card):
    """Phase 15c: :func:`conv_epoch_trace` in a fresh process (the first
    profiler session there): the ``conv.*`` counters equal to the calls the
    epoch's protocol makes and to the conv kernels the device trace shows,
    and no cuDNN convolution kernel in the trace."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_conv_epoch_") as tmp:
        data_npz, out = os.path.join(tmp, "data.npz"), os.path.join(tmp, "conv_epoch.json")
        np.savez(data_npz, a=splits[0], b=splits[1], c=splits[2], d=splits[3])
        res = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                              "--conv-epoch", data_npz, out], capture_output=True, text=True,
                             timeout=900, cwd=HERE)
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        with open(out) as f:
            runs = json.load(f)
    for form, r in runs.items():
        got = r["launches"]
        assert got == r["protocol"] and min(got.values()) > 0, (form, got, r["protocol"])
        assert r["traced"] == got, (form, got, r["traced"])
        assert not r["cudnn"], (form, r["cudnn"])
        print(f"15c {form}, T {CONV_TIMED_T}, a process of its own: one traced epoch's conv "
              f"launches {json.dumps(got)} = the protocol's conv calls = the conv kernels the "
              f"device trace shows; no cuDNN convolution kernel; their device ms "
              f"{json.dumps(r['traced_ms'])} of {r['device_ms']:.1f} ms of device operations "
              f"[{card}]")
    return runs


def conv_epoch_repeatable(torch, cfg_path, splits, card, trials=CONV_TIMED_T):
    """Phase 15d: the first training epoch of each form of CONV_FORMS at T
    ``trials``, from seed 0, twice: every parameter, statistic, optimizer
    moment and log bit-identical (C3 sums in a fixed order; cuDNN's weight
    gradients did not, ROADMAP's known hazards)."""
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    def leaves(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        elif hasattr(tree, "__dict__"):
            yield from leaves(vars(tree), prefix)

    for form in CONV_FORMS:
        params = Parameters.from_yaml(cfg_path)
        params.update({"ae_form": form})
        cfg = TrainConfig.from_parameters(params)
        data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
        runs = []
        for _ in range(2):
            core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                                  trials=trials, device="cuda")
            state, log = core.epoch_step(core.init_state(0), 0, data)
            torch.cuda.synchronize()
            runs.append(dict(leaves({"models": {k: m.state_dict() for k, m in
                                                 core.models.items()},
                                      "state": state, "log": log})))
            del core, state
        diff = [k for k, v in runs[0].items()
                if v.is_floating_point() and not torch.equal(v, runs[1][k])]
        assert runs[0].keys() == runs[1].keys() and not diff, (form, diff[:10])
        print(f"15d {form}, T {trials}: the first epoch twice from seed 0, "
              f"{len(runs[0])} leaves (weights, statistics, moments, logs) bit-identical "
              f"[{card}]")
        torch.cuda.empty_cache()



#: 16d: the largest keep-mask of the benchmark's cells, a T 256 (B 1024, 4,
#: 256) channel dropout, and its largest normal draw, spec_noise (B 1024, 256)
DRAW_TIMED = (("keep_mask", (256, 1024, 4, 256)), ("normal", (256, 1024, 256)))
#: phase 16: D1 (``ops/draws_cuda.py``) against its plain version on the
#: card: (trials, a trial's shape), ragged and whole groups of four, and
#: the benchmark cells' two largest draws
DRAW_CASES = ((1, (8,)), (3, (5,)), (8, (1024, 6)), (4, (33, 4, 9)), (2, (7, 3)),
              (256, (1024, 1)), (5, (4099,))) + tuple((s[0], s[1:]) for _, s in DRAW_TIMED)
#: the second offset carries into the counter's second word within a call
DRAW_OFFSETS = (0, 2 ** 32 - 3)
DRAW_SEEDS = (0, 2 ** 33 + 17, 2 ** 64 - 8)
#: the normals' largest gap to the plain version, in float32 ulps of the
#: plain value: each side's r cos theta carries at most logf's 1 ulp
#: (halved by the square root, plus its rounding: 1), sincosf's 2 and the
#: product's rounding, 3.5 ulps against the exact value; twice that, 7,
#: apart, and the plain version on the card calls the card's log, sin and cos
DRAW_NORMAL_ULPS = 8
DRAW_KEEP = 0.9
DRAW_FORMS = (("compact", 8), ("FC", 8))
#: 16a: the forms whose every D1 call of a training epoch is held to the
#: plain version, as drawn and again at each of DRAW_OFFSETS
DRAW_EPOCH_FORMS = (("compact", 8), ("normal", 8), ("FC", 8))
#: the trace's names of D1 and of the per-trial generators' kernels it replaces
DRAW_KERNEL = "trial_draws_kernel"
TORCH_DRAW_KERNELS = ("distribution_elementwise", "randperm", "curand")


def _ulps(torch, a, b):
    """|a - b| in float32 ulps of b (the spacing above |b|)."""
    mag = b.abs()
    spacing = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((a - b).abs() / spacing).max())


def _same_draw(torch, dc, mode, keys, offset, shape, keep, a=None):
    """D1's draw (``a``, or a fresh one) against the plain version's: the
    normals' gap in ulps, 0 for the other modes, which must be equal."""
    if a is None:
        a = dc.draw_kernel(mode, keys, offset, shape, keep)
    b = dc.draw_plain(mode, keys, offset, shape, keep)
    assert a.dtype == b.dtype and a.shape == b.shape, (mode, shape, a.dtype, b.dtype)
    if mode != dc.NORMAL:
        assert torch.equal(a, b), (mode, shape, offset)
        return 0.0
    ulps = _ulps(torch, a, b)
    assert ulps <= DRAW_NORMAL_ULPS and torch.isfinite(a).all(), (shape, offset, ulps)
    return ulps


def check_draws(torch, dc, card):
    """Phase 16a, first part: D1 against its plain version on the card,
    every mode, DRAW_CASES x DRAW_OFFSETS x DRAW_SEEDS: bits, uniforms and
    masks bit-identical, normals within DRAW_NORMAL_ULPS.  Returns the
    normals' largest gap in ulps."""
    worst = 0.0
    for trials, shape in DRAW_CASES:
        for offset in DRAW_OFFSETS:
            for seed in DRAW_SEEDS:
                keys = dc.keys_tensor([seed + t for t in range(trials)], "cuda")
                full = (trials, *shape)
                for mode in (dc.BITS, dc.UNIFORM, dc.KEEP, dc.NORMAL):
                    worst = max(worst, _same_draw(torch, dc, mode, keys, offset, full,
                                                  DRAW_KEEP))
                torch.cuda.empty_cache()
    print(f"16a: D1 against its plain version on the card, {len(DRAW_CASES)} shapes (the "
          f"largest {[s for _, s in DRAW_TIMED]}) x offsets {list(DRAW_OFFSETS)} x seeds "
          f"{list(DRAW_SEEDS)}: bits, uniforms and keep-masks bit-identical; normals at most "
          f"{worst:g} ulps apart (bound {DRAW_NORMAL_ULPS}) [{card}]")
    return worst


def check_epoch_draws(torch, dc, cfg_path, splits, card):
    """Phase 16a, second part: every D1 call of one training epoch of each
    of DRAW_EPOCH_FORMS (seed 2^33 + 17) held to the plain version on the
    card as it was drawn, and each distinct (mode, shape, keep) of the
    epoch again at each of DRAW_OFFSETS: bits, uniforms and masks
    bit-identical, normals within DRAW_NORMAL_ULPS.  Returns the normals'
    largest gap in ulps."""
    from rankaae_tpu_torch.models import primitives as P
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    worst = 0.0
    kernel = dc.draw
    for form, trials in DRAW_EPOCH_FORMS:
        params = Parameters.from_yaml(cfg_path)
        params.update({"ae_form": form})
        cfg = TrainConfig.from_parameters(params)
        P.set_matmul_precision(cfg.matmul_precision)
        data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
        core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                              trials=trials, device="cuda")
        state = core.init_state(DRAW_SEEDS[1])
        calls, sites = [0], {}

        def held(mode, keys, offset, shape, keep=1.0):
            a = kernel(mode, keys, offset, shape, keep)
            gap = _same_draw(torch, dc, mode, keys, offset, tuple(shape), keep, a)
            calls[0] += 1
            sites[(mode, tuple(shape), float(keep))] = gap
            return a

        dc.draw = held
        try:
            state, _ = core.epoch_step(state, 0, data)
            torch.cuda.synchronize()
        finally:
            dc.draw = kernel
        keys = state.sampler._key_tensor
        for (mode, shape, keep) in sites:
            for offset in DRAW_OFFSETS:
                sites[(mode, shape, keep)] = max(
                    sites[(mode, shape, keep)],
                    _same_draw(torch, dc, mode, keys, offset, shape, keep))
        gap = max(sites.values())
        worst = max(worst, gap)
        assert calls[0] > 0 and any(m == dc.KEEP for m, _, _ in sites), (form, sites)
        print(f"16a {form}, T {trials}: all {calls[0]} D1 calls of a training epoch equal to "
              f"the plain version as drawn, and its {len(sites)} distinct draws "
              f"{sorted((m, s) for m, s, _ in sites)} again at offsets {list(DRAW_OFFSETS)}; "
              f"normals within {gap:g} ulps [{card}]")
        del core, state, data
        torch.cuda.empty_cache()
    return worst


def _draw_program(sampler):
    t = sampler.trials
    return [sampler.normal("spec_noise", (t, 64, 256)), sampler.keep_mask((t, 64, 4, 33), 0.8),
            sampler.permutation(4900), sampler.normal("z_real", (t, 1024, 5)),
            sampler.keep_mask((t, 1024, 6), DRAW_KEEP), sampler.normal("dis_noise", (t, 3))]


def sampler_draws(torch, card):
    """Phase 16b: ``TrialSampler`` on the card (D1): T 4 equal to trials 0-3
    of T 8 and trial g to the 1-trial run of seed s + g, bit for bit; the
    CPU's plain-version sampler of the same seed equal in bits, masks and
    permutations, within DRAW_NORMAL_ULPS in normals, in state; a state
    taken mid-run and set on a fresh sampler giving the same next draws."""
    from rankaae_tpu_torch.utils.sampler import TrialSampler

    seed = 2 ** 33 + 17
    t8 = _draw_program(TrialSampler(seed, 8, "cuda"))
    t4 = TrialSampler(seed, 4, "cuda")
    assert t4.philox
    got4 = _draw_program(t4)
    for a, b in zip(t8, got4):
        assert torch.equal(a[:4], b), a.shape
    for g in (0, 3, 7):
        for a, b in zip(t8, _draw_program(TrialSampler(seed + g, 1, "cuda"))):
            assert torch.equal(a[g], b[0]), (g, a.shape)
    cpu = TrialSampler(seed, 4, "cpu")            # the card's route, by the plain version
    cpu.philox = True
    cpu._set_keys([seed + t for t in range(4)], 0)
    ulps = 0.0
    for a, b in zip(got4, _draw_program(cpu)):
        if a.is_floating_point():
            ulps = max(ulps, _ulps(torch, a.cpu(), b))
        else:
            assert torch.equal(a.cpu(), b), a.shape
    assert ulps <= DRAW_NORMAL_ULPS, ulps
    assert [s.tobytes() for s in t4.get_state()] == [s.tobytes() for s in cpu.get_state()]
    fresh = TrialSampler(0, 4, "cuda")
    fresh.set_state(t4.get_state())
    for a, b in zip(_draw_program(t4), _draw_program(fresh)):
        assert torch.equal(a, b)
    print(f"16b: TrialSampler on the card: T 4 = trials 0-3 of T 8 and trial g (0, 3, 7) = the "
          f"1-trial run of seed s + g, bit for bit, over normal, keep_mask and permutation "
          f"draws; the CPU's plain-version sampler equal in masks, permutations and state, "
          f"normals within {ulps:g} ulps; a state set mid-run gives the same next draws "
          f"[{card}]")


def draw_epoch_trace(torch, cfg_path, splits):
    """One traced training epoch of each of DRAW_FORMS (after a warm-up
    epoch): {form: D1's calls by the ``draw.launches`` counter, the
    ``draw.*`` spans of the epoch, D1's kernels in the device trace and
    their device ms, the generator kernels the trace shows, the spans'
    device ms}."""
    from rankaae_tpu_torch.models import primitives as P
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils import tracing
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    out = {}
    for form, trials in DRAW_FORMS:
        params = Parameters.from_yaml(cfg_path)
        params.update({"ae_form": form})
        cfg = TrainConfig.from_parameters(params)
        P.set_matmul_precision(cfg.matmul_precision)
        data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
        core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                              trials=trials, device="cuda")
        state = core.init_state(0)
        state, _ = core.epoch_step(state, 0, data)
        torch.cuda.synchronize()
        before = tracing.counters()
        tracing.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            state, _ = core.epoch_step(state, 1, data)
            torch.cuda.synchronize()
        spans = [s for s in tracing.newest(tracing.spans(), "epoch")
                 if s.name.startswith("draw.")]
        traced, traced_ms, generators = 0, 0.0, {}
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if DRAW_KERNEL in evt.name:
                traced += 1
                traced_ms += (evt.time_range.end - evt.time_range.start) / 1e3
            if any(k in evt.name for k in TORCH_DRAW_KERNELS):
                generators[evt.name[:80]] = generators.get(evt.name[:80], 0) + 1
        after = tracing.counters()
        out[form] = {
            "trials": trials,
            "launches": int(after.get("draw.launches", 0) - before.get("draw.launches", 0)),
            "elements": int(after.get("draw.elements", 0) - before.get("draw.elements", 0)),
            "spans": len(spans), "traced": traced, "traced_ms": traced_ms,
            "span_device_ms": sum(s.device_ms for s in spans), "generators": generators}
        del core, state, data
        torch.cuda.empty_cache()
    return out


def draw_epoch_main(argv) -> int:
    """Phase 16c's traced epochs in a process of their own (``chip_smoke.py
    --draw-epoch DATA OUT``): :func:`draw_epoch_trace` on the splits in
    DATA, its result into OUT as JSON."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.ops import conv1d_cuda as cc
    from rankaae_tpu_torch.ops import draws_cuda as dc

    data_npz, out = argv
    cc.build()
    dc.build()
    with np.load(data_npz) as z:
        splits = tuple(z[k] for k in ("a", "b", "c", "d"))
    res = draw_epoch_trace(torch, os.path.join(HERE, "example", "fix_config.yaml"), splits)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def draw_epoch_launches(np, splits, card):
    """Phase 16c: :func:`draw_epoch_trace` in a fresh process: one D1 launch
    a draw site, the same count in ``draw.launches``, in the epoch's
    ``draw.*`` spans and in the device trace, and none of the per-trial
    generators' kernels."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_draw_epoch_") as tmp:
        data_npz, out = os.path.join(tmp, "data.npz"), os.path.join(tmp, "draw_epoch.json")
        np.savez(data_npz, a=splits[0], b=splits[1], c=splits[2], d=splits[3])
        res = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                              "--draw-epoch", data_npz, out], capture_output=True, text=True,
                             timeout=900, cwd=HERE)
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        with open(out) as f:
            runs = json.load(f)
    for form, r in runs.items():
        assert r["launches"] > 0 and r["launches"] == r["spans"] == r["traced"], (form, r)
        assert not r["generators"], (form, r["generators"])
        print(f"16c {form}, T {r['trials']}, a process of its own: one traced epoch's "
              f"draw.launches {r['launches']} = its draw.* spans = the D1 kernels the device "
              f"trace shows; {r['elements']} elements; no generator kernel; D1's device ms "
              f"{r['traced_ms']:.3f}, the spans' device-stream ms {r['span_device_ms']:.3f} "
              f"[{card}]")
    return runs


def time_draws(torch, dc, card):
    """Phase 16d: D1 alone at DRAW_TIMED: ``ms`` CUDA events around 50
    wrapper calls, ``device_ms`` 20 calls in one CUDA graph, ``plain_ms``
    the plain version on the card, ``bound_ms`` the bytes written over
    3.35 TB/s, ``library_ms`` one ``torch.rand`` (``randn``) over the whole
    (T, ...) shape from one generator (the single-generator bar), and
    ``per_trial_ms`` the route D1 replaced: a generator call a trial, the
    stack and, for a mask, the compare.  Returns {draw: times}."""
    rows = {}
    for what, shape in DRAW_TIMED:
        keys = dc.keys_tensor(range(shape[0]), "cuda")
        mode = dc.KEEP if what == "keep_mask" else dc.NORMAL
        out_bytes = torch.empty(0, dtype=dc.DTYPES[mode]).element_size() * \
            int(torch.tensor(shape).prod())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        lib = torch.rand if mode == dc.KEEP else torch.randn
        gens = [torch.Generator(device="cuda") for _ in range(shape[0])]
        for t, g in enumerate(gens):
            g.manual_seed(t)

        def per_trial():
            draws = torch.stack([lib(shape[1:], generator=g, device="cuda") for g in gens])
            return draws < DRAW_KEEP if mode == dc.KEEP else draws
        rows[what] = {
            "shape": list(shape),
            "ms": time_ms(torch, lambda: dc.draw_kernel(mode, keys, 0, shape, DRAW_KEEP),
                          reps=50, warmup=5),
            "device_ms": graph_ms(torch, lambda: dc.draw_kernel(mode, keys, 0, shape,
                                                                 DRAW_KEEP), reps=20),
            "plain_ms": time_ms(torch, lambda: dc.draw_plain(mode, keys, 0, shape, DRAW_KEEP),
                                reps=3, warmup=1),
            "bound_ms": out_bytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(torch, lambda: lib(shape, generator=gen, device="cuda"),
                                  reps=20, warmup=3),
            "per_trial_ms": time_ms(torch, per_trial, reps=5, warmup=2)}
        rows[what]["roofline"] = rows[what]["bound_ms"] / rows[what]["device_ms"]
        del gens
        torch.cuda.empty_cache()
        print(f"16d {what} {tuple(shape)}: " + json.dumps(rows[what]) + f" [{card}]")
    return rows


# phase 17: the channel PReLUs and branch sums P1 (``ops/prelu_cuda.py``)
#: 17a: the forms (ae_form, CNN discriminator) whose T 8 training epochs give
#: P1's calls, each held to the plain version as called; the benchmark
#: cells' T, at which each distinct call is held again
PRELU_FORMS = (("normal", False), ("compact", False), ("compact", True))
PRELU_EPOCH_T, PRELU_CELL_T = 8, 256
#: the slope gradients' largest difference from the exact sum of the plain
#: version's products (float32 products summed in float64) over its largest
#: magnitude: the kernel sums in double.  PyTorch's float32 reduction over up
#: to B x L = 262,144 products a channel is itself up to ~1e-6 off it, so
#: the kernel is held no further from PyTorch's sum than PyTorch's own error
#: and this
PRELU_DW_RTOL = 1e-6
#: 17b: (label, (B, T*C, L), memory order of the dims, terms): a normal-form
#: block's end at T 256 with three PReLUs, with the identity residual between
#: two, one PReLU there, and the one-channel excitation's second PReLU of
#: the normal encoder's first block, laid out (C, B, L)
PRELU_TIMED = (
    ("3 terms", (1024, 1024, 256), (0, 1, 2), (True, True, True)),
    ("identity", (1024, 1024, 256), (0, 1, 2), (True, False, True)),
    ("1 term", (1024, 1024, 256), (0, 1, 2), (True,)),
    ("1 term, (C, B, L)", (1024, 256, 128), (1, 0, 2), (True,)),
)
#: 17c: the forms whose traced T 8 epoch is held to the counters
PRELU_TRACE_FORMS = ("compact", "normal")
PRELU_COUNTERS = {k: LAUNCH_COUNTERS[f"prelu_sum_{k}"] for k in ("fwd", "bwd", "tail")}
PRELU_KERNELS = {"fwd": "prelu_sum_fwd_kernel", "bwd": "prelu_sum_bwd_kernel",
                 "sum": "prelu_slope_sum_kernel"}


def prelu_call_key(ys, ws):
    """A P1 call's shape, memory order of its dims and term pattern."""
    order = tuple(sorted(range(3), key=lambda d: -ys[0].stride(d)))
    return tuple(ys[0].shape), order, tuple(w is not None for w in ws)


def held_prelu_forward(torch, pc, ys, ws, out=None):
    """P1's forward (``out``, or a fresh call) against the plain version:
    bit for bit, in the layout of the terms."""
    if out is None:
        out = pc.forward(ys, ws)
    want = pc.forward_plain(ys, ws)
    assert torch.equal(out, want), prelu_call_key(ys, ws)
    assert pc.in_layout(out, ys[0]) is out, (out.stride(), ys[0].stride())
    return out


def held_prelu_backward(torch, pc, dout, ys, ws, got=None, kernel=None):
    """P1's backward (``got``, or a fresh call) against the plain version:
    each activated term's dy bit for bit; its slope gradient within
    PRELU_DW_RTOL of the exact sum of the plain version's products, no
    further from the plain (PyTorch float32) sum than that sum's own error
    and PRELU_DW_RTOL (all over the exact sum's largest magnitude), and
    bit-identical over a second call (of ``kernel``, default
    ``pc.backward``).  Returns the largest of each of the three relative
    differences: {"exact", "torch_own", "torch"}."""
    kernel = pc.backward if kernel is None else kernel
    dys, dws = kernel(dout, ys, ws) if got is None else got
    pdy, pdw = pc.backward_plain(dout, ys, ws)
    again = kernel(dout, ys, ws)[1]
    worst = dict.fromkeys(("exact", "torch_own", "torch"), 0.0)
    for k, w in enumerate(ws):
        if w is None:
            assert dys[k] is None and dws[k] is None
            continue
        key = (k, prelu_call_key(ys, ws))
        assert torch.equal(dys[k], pdy[k]), key
        exact = torch.where(ys[k] > 0, 0, ys[k] * dout).double().sum((0, 2))
        scale = exact.abs().max().clamp_min(1e-300)
        errs = {"exact": dws[k].double() - exact, "torch_own": pdw[k].double() - exact,
                "torch": dws[k].double() - pdw[k].double()}
        errs = {n: (e.abs().max() / scale).item() for n, e in errs.items()}
        assert errs["exact"] <= PRELU_DW_RTOL, (key, errs)
        assert errs["torch"] <= errs["torch_own"] + PRELU_DW_RTOL, (key, errs)
        assert torch.equal(dws[k], again[k]), key
        worst = {n: max(worst[n], errs[n]) for n in worst}
    return worst


def prelu_operands(torch, shape, order, pattern, seed):
    """Random terms, slopes and an output gradient of one P1 call: (B, C,
    L) tensors laid out with their dims in ``order``; slopes of either sign
    (training moves them off 0.01)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    physical = tuple(shape[d] for d in order)
    back = tuple(order.index(d) for d in range(3))

    def term():
        return torch.randn(physical, device="cuda", generator=gen).permute(back)
    ys = [term() for _ in pattern]
    ws = [torch.randn(shape[1], device="cuda", generator=gen) * 0.25 if a else None
          for a in pattern]
    return ys, ws, term()


def check_prelu(torch, pc, cfg_path, splits, card):
    """Phase 17a: every P1 call of one T 8 training epoch of each of
    PRELU_FORMS held to the plain version as called (forward and dy bit for
    bit, slope gradients as :func:`held_prelu_backward`); then each distinct
    call at the cells' T 256 (its channels 32 times as many) on random
    operands.  Returns the slope gradients' largest relative differences."""
    from rankaae_tpu_torch.models import primitives as P
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    worst, keys = dict.fromkeys(("exact", "torch_own", "torch"), 0.0), {}
    fwd, bwd = pc.forward, pc.backward

    def widen(errs):
        for n in worst:
            worst[n] = max(worst[n], errs[n])
    for form, cnn in PRELU_FORMS:
        params = Parameters.from_yaml(cfg_path)
        params.update({"ae_form": form, "use_cnn_discriminator": cnn})
        cfg = TrainConfig.from_parameters(params)
        P.set_matmul_precision(cfg.matmul_precision)
        data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
        core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                              trials=PRELU_EPOCH_T, device="cuda")
        calls = {"fwd": 0, "bwd": 0}

        def held_fwd(ys, ws):
            out = held_prelu_forward(torch, pc, ys, ws, fwd(ys, ws))
            calls["fwd"] += 1
            keys.setdefault(prelu_call_key(ys, ws), False)
            return out

        def held_bwd(dout, ys, ws):
            got = bwd(dout, ys, ws)
            widen(held_prelu_backward(torch, pc, dout, ys, ws, got, bwd))
            calls["bwd"] += 1
            keys[prelu_call_key([dout], ws)] = True
            return got

        pc.forward, pc.backward = held_fwd, held_bwd
        try:
            state, _ = core.epoch_step(core.init_state(0), 0, data)
            torch.cuda.synchronize()
        finally:
            pc.forward, pc.backward = fwd, bwd
        assert calls["fwd"] > 0 and calls["bwd"] > 0, (form, calls)
        print(f"17a {form}{' + CNN' if cnn else ''}, T {PRELU_EPOCH_T}: all {calls['fwd']} P1 "
              f"forward and {calls['bwd']} backward calls of a training epoch equal to the "
              f"plain version as called [{card}]")
        del core, state, data
        torch.cuda.empty_cache()
    scale = PRELU_CELL_T // PRELU_EPOCH_T
    for i, ((b, c, length), order, pattern) in enumerate(sorted(keys)):
        ys, ws, dout = prelu_operands(torch, (b, c * scale, length), order, pattern, i)
        held_prelu_forward(torch, pc, ys, ws)
        if keys[((b, c, length), order, pattern)]:
            widen(held_prelu_backward(torch, pc, dout, ys, ws))
        del ys, ws, dout
        torch.cuda.empty_cache()
    print(f"17a: the {len(keys)} distinct P1 calls (shape, memory order, terms) of those "
          f"epochs at T {PRELU_CELL_T} ({sum(keys.values())} with a backward): forward and "
          f"dy bit for bit; slope gradients at most {worst['exact']:.3g} off the exact sum "
          f"of the products (limit {PRELU_DW_RTOL:g}) and {worst['torch']:.3g} off "
          f"PyTorch's float32 sum, itself {worst['torch_own']:.3g} off (over the largest "
          f"magnitude); bit-identical over two calls [{card}]")
    return worst


def prelu_library(torch, ys, ws):
    """The parent's chain: ``F.prelu`` of each activated term, the terms
    added in order (a yardstick the port never calls on the card)."""
    import torch.nn.functional as F

    out = None
    for y, w in zip(ys, ws):
        v = y if w is None else F.prelu(y, w)
        out = v if out is None else out + v
    return out


def time_prelu(torch, pc, card):
    """Phase 17b: P1 at each case of PRELU_TIMED, forward and backward:
    ``ms`` CUDA events around 50
    wrapper calls, ``device_ms`` 20 calls in one CUDA graph, ``plain_ms``,
    ``bound_ms`` the bytes over 3.35 TB/s ((terms + 1) N 4 forward, (1 +
    2 activated) N 4 backward), ``library_ms`` the parent's ``F.prelu`` and
    adds, forward and their autograd backward (slope sums included)."""
    rows = {}
    for label, shape, order, pattern in PRELU_TIMED:
        ys, ws, dout = prelu_operands(torch, shape, order, pattern, 0)
        n = dout.numel()
        leaves = [y.clone().requires_grad_() for y in ys]
        slopes = [w.clone().requires_grad_() for w in ws if w is not None]
        it = iter(slopes)
        chain = prelu_library(torch, leaves, [next(it) if a else None for a in pattern])
        act = sum(pattern)
        sides = {
            "fwd": (lambda: pc.forward(ys, ws), lambda: pc.forward_plain(ys, ws),
                    lambda: prelu_library(torch, ys, ws), (len(pattern) + 1) * n * 4),
            "bwd": (lambda: pc.backward(dout, ys, ws), lambda: pc.backward_plain(dout, ys, ws),
                    lambda: torch.autograd.grad(chain, leaves + slopes, dout,
                                                retain_graph=True), (1 + 2 * act) * n * 4)}
        rows[label] = {}
        for side, (kern, plain, lib, nbytes) in sides.items():
            row = {"ms": time_ms(torch, kern, reps=50, warmup=5),
                   "device_ms": graph_ms(torch, kern, reps=20),
                   "plain_ms": time_ms(torch, plain, reps=5, warmup=2),
                   "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "library_ms": time_ms(torch, lib, reps=10, warmup=2)}
            row["roofline"] = row["bound_ms"] / row["device_ms"]
            rows[label][side] = row
        del ys, ws, dout, leaves, slopes, chain, sides
        torch.cuda.empty_cache()
        print(f"17b {label} at (B, T*C, L) {shape}: " + json.dumps(rows[label]) + f" [{card}]")
    return rows


def prelu_epoch_trace(torch, cfg_path, splits, trials=PRELU_EPOCH_T):
    """One traced training epoch of each of PRELU_TRACE_FORMS at T
    ``trials`` (after a warm-up epoch): {form: the ``prelu.*`` counters'
    calls, the block forwards that run module by module (hooks on the
    stacked blocks; an eval-mode K3 block is not one), P1's kernels in the
    device trace and their device ms, PyTorch's PReLU kernels in the trace,
    its device ms in all}."""
    from rankaae_tpu_torch.models import primitives as P
    from rankaae_tpu_torch.models.blocks import TrialDecodingBlock, TrialEncodingBlock
    from rankaae_tpu_torch.train.trainer import RankAAETrainer, TrialData
    from rankaae_tpu_torch.utils import tracing
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    out = {}
    for form in PRELU_TRACE_FORMS:
        params = Parameters.from_yaml(cfg_path)
        params.update({"ae_form": form})
        cfg = TrainConfig.from_parameters(params)
        P.set_matmul_precision(cfg.matmul_precision)
        data = TrialData(*(torch.from_numpy(a).to("cuda") for a in splits))
        core = RankAAETrainer(cfg, n_train=len(splits[0]), n_val=len(splits[2]),
                              trials=trials, device="cuda")
        state, _ = core.epoch_step(core.init_state(0), 0, data)
        torch.cuda.synchronize()
        blocks = {"train": 0, "eval": 0}

        def hook(m, inp, y):
            if not (getattr(m, "fused", False) and not m.training):
                blocks["train" if m.training else "eval"] += 1

        handles = [m.register_forward_hook(hook) for model in core.models.values()
                   for m in model.modules()
                   if isinstance(m, (TrialEncodingBlock, TrialDecodingBlock))]
        before = {k: tracing.counter(v) for k, v in PRELU_COUNTERS.items()}
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                state, _ = core.epoch_step(state, 1, data)
                torch.cuda.synchronize()
        finally:
            for h in handles:
                h.remove()
        traced = dict.fromkeys(PRELU_KERNELS, 0)
        traced_ms, library, all_ms = 0.0, {}, 0.0
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = (evt.time_range.end - evt.time_range.start) / 1e3
            all_ms += ms
            mine = [k for k, name in PRELU_KERNELS.items() if name in evt.name]
            for k in mine:
                traced[k] += 1
                traced_ms += ms
            if not mine and "prelu" in evt.name.lower():
                library[evt.name[:80]] = library.get(evt.name[:80], 0) + 1
        got = {k: int(tracing.counter(v) - before[k]) for k, v in PRELU_COUNTERS.items()}
        out[form] = {"launches": got, "blocks": blocks, "traced": traced,
                     "traced_ms": traced_ms, "library": library, "device_ms": all_ms}
        del core, state, data
        torch.cuda.empty_cache()
    return out


def prelu_epoch_main(argv) -> int:
    """Phase 17c's traced epochs in a process of their own (``chip_smoke.py
    --prelu-epoch DATA OUT``): :func:`prelu_epoch_trace` on the splits in
    DATA, its result into OUT as JSON."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.ops import _nvcc
    from rankaae_tpu_torch.ops import conv1d_cuda as cc
    from rankaae_tpu_torch.ops import draws_cuda as dc
    from rankaae_tpu_torch.ops import prelu_cuda as pc

    data_npz, out = argv
    _nvcc.compile_all([cc.SOURCE, dc.SOURCE, pc.SOURCE])
    with np.load(data_npz) as z:
        splits = tuple(z[k] for k in ("a", "b", "c", "d"))
    res = prelu_epoch_trace(torch, os.path.join(HERE, "example", "fix_config.yaml"), splits)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def prelu_epoch_launches(np, splits, card):
    """Phase 17c: :func:`prelu_epoch_trace` in a fresh process: the P1
    kernels of the device trace equal to the ``prelu.*`` counters (two
    launches a backward call), ``prelu.tail_launches`` equal to the
    block forwards that run module by module, and no PyTorch PReLU kernel
    in the epoch."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prelu_epoch_") as tmp:
        data_npz, out = os.path.join(tmp, "data.npz"), os.path.join(tmp, "prelu_epoch.json")
        np.savez(data_npz, a=splits[0], b=splits[1], c=splits[2], d=splits[3])
        res = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                              "--prelu-epoch", data_npz, out], capture_output=True, text=True,
                             timeout=900, cwd=HERE)
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        with open(out) as f:
            runs = json.load(f)
    for form, r in runs.items():
        got, traced, blocks = r["launches"], r["traced"], r["blocks"]
        assert got["tail"] > 0 and got["tail"] == blocks["train"] + blocks["eval"], (form, r)
        assert traced["fwd"] == got["fwd"] and traced["bwd"] == traced["sum"] \
            and traced["bwd"] + traced["sum"] == got["bwd"], (form, r)
        assert not r["library"], (form, r["library"])
        print(f"17c {form}, T {PRELU_EPOCH_T}, a process of its own: one traced epoch's "
              f"prelu counters {json.dumps(got)} = the P1 kernels the device trace shows "
              f"{json.dumps(traced)}; tail launches = the block forwards run module by module "
              f"({blocks['train']} in train mode, {blocks['eval']} in eval mode); no PyTorch "
              f"PReLU kernel; P1's device ms {r['traced_ms']:.1f} of {r['device_ms']:.1f} ms of "
              f"device operations [{card}]")
    return runs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rankaae_tpu_torch.data.dataset import load_split_arrays, split_sizes
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes_csv
    from rankaae_tpu_torch.models.primitives import set_matmul_precision
    from rankaae_tpu_torch.ops import _nvcc
    from rankaae_tpu_torch.ops import conv1d_cuda as cc
    from rankaae_tpu_torch.ops import draws_cuda as dc
    from rankaae_tpu_torch.ops import fused_block_cuda as fb
    from rankaae_tpu_torch.ops import kendall as tk
    from rankaae_tpu_torch.ops import kendall_cuda as kc
    from rankaae_tpu_torch.ops import prelu_cuda as pc
    from rankaae_tpu_torch.train.facade import Trainer
    from rankaae_tpu_torch.utils import tracing
    from rankaae_tpu_torch.utils.config import Parameters, TrainConfig

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ----------------------------------------------------- #
    t_start = t0 = time.perf_counter()
    sources = (kc.SOURCE, fb.SOURCE, cc.SOURCE, dc.SOURCE, pc.SOURCE)
    _nvcc.compile_all(sources)
    for lib in (kc, fb, cc, dc, pc):
        lib.build()
    print(f"build: {', '.join(s.name for s in sources)} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    summed = (cc.SOURCE, pc.SOURCE)               # many kernels: their count and most registers
    for source in sources:                        # the ptxas report, kept beside the library
        regs = []
        for line in _nvcc.build_log(source).splitlines():
            if source not in summed and ("entry function" in line or "Used" in line
                                         or "spill" in line):
                print(f"  ptxas {source.name}: {line.strip()}")
            regs += [int(r) for r in re.findall(r"Used (\d+) registers", line)]
            if "spill" in line:                   # no kernel may spill registers
                assert set(re.findall(r"(\d+) bytes spill", line)) == {"0"}, (source.name, line)
        if source in summed:
            print(f"  ptxas {source.name}: {len(regs)} kernels, at most {max(regs)} registers, "
                  f"no spills")

    # ---- 2. kernels against their plain versions ----------------------- #
    t0 = time.perf_counter()
    cfg_path = os.path.join(HERE, "example", "fix_config.yaml")
    cfg = TrainConfig.from_yaml(cfg_path)
    n_rows = 7000
    n_train, n_val, _ = split_sizes(n_rows, (cfg.train_ratio, cfg.validation_ratio,
                                             cfg.test_ratio))
    n_full, trailing = divmod(n_train, cfg.batch_size)
    errs = check_kernels(torch, np, kc, tk, {cfg.batch_size, trailing, n_val, 300, 100, 33, 2})
    check_graph(torch, np, kc)
    times = time_kernels(torch, np, kc, cfg.batch_size, cfg.n_aux)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")

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
        zero_launches("kendall_pair_sums", "kendall_grad_rows")
        metrics = trainer.train()
        launches = read_launches("kendall_pair_sums", "kendall_grad_rows")
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

    print(f"phases 1-3: {time.perf_counter() - t_start:.1f} s")

    # ---- 4. card vs CPU on one batch ----------------------------------- #
    # at depth 5 this batch is ill-conditioned: a 1e-7 relative perturbation
    # of the weights moves its MI loss by 8.7e-4 on the CPU alone, so no
    # pointwise bound near rounding can hold; at depth 3 the same
    # perturbation moves every loss by under 1e-6
    t0 = time.perf_counter()
    pcfg = cfg.replace(dropout_rate=0.0, dis_dropout_rate=0.0, dis_noise=0.0, n_layers=3)
    loss_err, worst, _, _ = batch_parity(
        torch, np, pcfg, dict.fromkeys(CONV_BATCH_SPREAD, PARITY_ATOL),
        {"params": LEAF_ATOL, "stats": LEAF_ATOL}, LEAF_RTOL)
    print(f"parity: one faithful batch (B={pcfg.batch_size}, n_layers 3), card vs CPU: max "
          f"loss difference {loss_err:.3g}; parameters/stats max "
          f"{max(worst['params'], worst['stats']):.3g}, worst per-leaf relative norm "
          f"{worst['rel']:.3g}; phase 4 {time.perf_counter() - t0:.1f} s")

    # ---- 5. K3 against its plain version ------------------------------- #
    t0 = time.perf_counter()
    set_matmul_precision("highest")       # TF32 off for the plain version's convs
    k3_err, k3_times = check_k3(torch, fb)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")

    # ---- 6. serving the conv forms -------------------------------------- #
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        k3_launches = serve_normal(torch, np, fb, cfg_path, tmp, card)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s; phases 1-6: "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 7. training the conv forms ------------------------------------- #
    set_matmul_precision(cfg.matmul_precision)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_conv_") as tmp:
        conv_launches, p1_launches = train_conv(torch, np, kc, fb, cfg_path, tmp, card,
                                                n_batch)
    t0 = time.perf_counter()
    ccfg = cfg.replace(ae_form="normal", use_cnn_discriminator=True, dropout_rate=0.0,
                       dis_dropout_rate=0.0, dis_noise=0.0)
    loss_err, worst, l_cpu, l_gpu = batch_parity(torch, np, ccfg, CONV_BATCH_LOSS_ATOL,
                                                 CONV_BATCH_LEAF_ATOL)
    print("7c parity: one faithful batch, normal form, CNN discriminator, B "
          f"{ccfg.batch_size}, card vs CPU: per loss "
          + json.dumps({n: abs(l_cpu[n] - l_gpu[n]) for n in l_cpu})
          + f" (atol {json.dumps(CONV_BATCH_LOSS_ATOL)}); leaves max params "
          f"{worst['params']:.3g}, stats {worst['stats']:.3g} (atol "
          f"{json.dumps(CONV_BATCH_LEAF_ATOL)}); 7c {time.perf_counter() - t0:.1f} s")
    print(f"phases 1-7: {time.perf_counter() - t_start:.1f} s")

    # ---- 8. several trials at once -------------------------------------- #
    t0 = time.perf_counter()
    trials_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_trials_")   # 9c reports it
    tmp8 = trials_dir.name
    trial_launches, wall_8a = train_trials(torch, np, kc, cfg_path, tmp8, card, expect)
    print(f"8a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        csv = make_synthetic_xanes_csv(os.path.join(tmp, "data.csv"), n_rows=n_rows,
                                       dim=cfg.dim_in, seed=0)
        sp = load_split_arrays(csv, (cfg.train_ratio, cfg.validation_ratio, cfg.test_ratio),
                               cfg.n_aux)
    splits = (sp["train"].spec, sp["train"].aux, sp["val"].spec, sp["val"].aux)
    # phase 4's config, then with fix_config's dropout and discriminator noise
    for what, icfg, rates in (("phase 4's config", pcfg, (INDEPENDENCE_LR, CHAOTIC_LR)),
                              ("phase 4's config with the config's dropout and noise",
                               cfg.replace(n_layers=3), (INDEPENDENCE_LR,))):
        for lr in rates:
            err, spread = trial_independence(torch, np, icfg.replace(lr_base=lr), splits)
            print(f"8b lr_base {lr}: trial 2 of 4 (seed 10) vs the 1-trial run with seed 12, "
                  f"{what}, 2 epochs on the card: " + json.dumps(err)
                  + "; the 1-trial run against itself with its weights perturbed by 1e-7: "
                  + json.dumps(spread))
            if lr == INDEPENDENCE_LR:        # phase 4's tolerances, and far below the move
                assert err["train"] <= PARITY_ATOL, (what, err, spread)
                assert err["leaf"] <= LEAF_ATOL and err["rel"] <= LEAF_RTOL, (what, err, spread)
                assert err["leaf"] <= 1e-2 * err["moved"], (what, err, spread)   # (stats too)
    print(f"8b: held at lr_base {INDEPENDENCE_LR}, without and with dropout and "
          f"discriminator noise (training losses atol {PARITY_ATOL}, leaves atol {LEAF_ATOL} "
          f"and rtol {LEAF_RTOL}, and under 1% of the weights' move); "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trial_throughput(torch, cfg, splits, card)
    print(f"8c: {time.perf_counter() - t0:.1f} s; phases 1-8: "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 9. resume, recalibration and the report ------------------------ #
    import importlib.util

    figures = all(importlib.util.find_spec(m) for m in ("matplotlib", "seaborn"))
    with trials_dir, tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as tmp9:
        csv8 = os.path.join(tmp8, Parameters.from_yaml(cfg_path).get("data_file"))
        t0 = time.perf_counter()
        resume_runs, _ = resume_on_card(torch, np, kc, fb, tmp9, csv8, cfg_path, card)
        per_epoch = {"kendall_pair_sums": n_batch + 1, "kendall_grad_rows": n_batch,
                     "fused_block": 0}
        for name, epochs in (("uncut", RESUME_EPOCHS), ("cut", RESUME_CUT),
                             ("resumed", RESUME_EPOCHS - RESUME_CUT)):
            want = {k: epochs * v for k, v in per_epoch.items()}
            assert resume_runs[name][1] == want, (name, resume_runs[name][1], want)
        print(f"9a: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        recal_work, recal_launches = recalibrated_trials(torch, np, kc, fb, tmp9, csv8,
                                                         cfg_path, card)
        # one wave: one K1/K2 launch for both trials; K3 once a trial in the
        # validations' two eval-mode decodes, then one amplitude_gain
        # reconstruction of each of the three bundles
        want = {"kendall_pair_sums": RECAL_EPOCHS * (n_batch + 1),
                "kendall_grad_rows": RECAL_EPOCHS * n_batch,
                "fused_block": RECAL_TRIALS * (RECAL_EPOCHS * 2 + 3) * NORMAL_FUSED_BLOCKS}
        assert recal_launches == want, (recal_launches, want)
        print(f"9b: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        if not figures:
            print("9c: matplotlib and seaborn are not installed here: the reports compute "
                  "every number their figures show (the decoder sweeps included) and write "
                  "every file but the PNGs; no figure was drawn")
        report_k3 = {}
        for label, work, jobs, blocks in (("8a's tree (FC, 8 trials)", tmp8, cfg.trials, 0),
                                          ("9b's tree (normal form, 2 trials)", recal_work,
                                           RECAL_TRIALS, NORMAL_FUSED_BLOCKS)):
            k3, _ = report_card_vs_cpu(torch, np, fb, work,
                                       os.path.join(tmp9, f"report_cpu_{len(report_k3)}"),
                                       label, card, figures)
            # one decode a trial's evaluation, then the best model's report:
            # its evaluation, a sweep a style, and its reconstruction
            want = blocks * (jobs + 1 + cfg.nstyle + 1)
            assert k3 == want, (label, k3, want)
            report_k3[label] = k3
        print(f"9c: {time.perf_counter() - t0:.1f} s; phases 1-9: "
              f"{time.perf_counter() - t_start:.1f} s")

        # ---- 10. every form stacked on the trial axis -------------------- #
        t0 = time.perf_counter()
        normal_launches = normal_trials(torch, np, kc, fb, tmp9, csv8, cfg_path, card, expect)
        ncfg = cfg.replace(ae_form="normal")
        trial_throughput(torch, ncfg, splits, card, NORMAL_TRIALS_T, label="10a", profiled=(1,))
        print(f"10a: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        deterministic_cost(torch, ncfg, splits, card)
        torch.backends.cudnn.deterministic = True
        try:
            icfg = ncfg.replace(lr_base=INDEPENDENCE_LR)
            err, spread = trial_independence(torch, np, icfg, splits)
        finally:
            torch.backends.cudnn.deterministic = False
        print(f"10b lr_base {INDEPENDENCE_LR}: trial 2 of 4 (seed 10) vs the 1-trial run with "
              f"seed 12, normal form with the config's dropout and noise, 2 epochs on the "
              f"card, cuDNN deterministic: " + json.dumps(err)
              + "; the 1-trial run against itself with its weights perturbed by 1e-7: "
              + json.dumps(spread))
        bounds = {"train": max(PARITY_ATOL, 2 * spread["train"]),
                  "leaf": max(LEAF_ATOL, 2 * spread["leaf"]),
                  "rel": max(LEAF_RTOL, 2 * spread["rel"])}
        assert all(err[k] <= v for k, v in bounds.items()), (err, spread, bounds)
        print(f"10b: held within {json.dumps(bounds)} (phase 4's tolerances, or twice the "
              f"perturbation spread where that is larger); {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        qved_launches = qved_trials(torch, np, kc, fb, tmp9, cfg_path, card, expect, n_rows)
        print(f"10c: {time.perf_counter() - t0:.1f} s; phases 1-10: "
              f"{time.perf_counter() - t_start:.1f} s")

        # ---- 11. the trainer's remaining options ------------------------- #
        t0 = time.perf_counter()
        option_launches = option_trials(torch, np, kc, fb, tmp9, csv8, cfg_path, card, expect)
        print(f"11a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        option_batches(torch, np, pcfg, cfg, card)
        print(f"11b: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add_launches(option_launches, flat_optim_on_card(torch, np, kc, fb, tmp9, csv8,
                                                         cfg_path, card, expect, spread))
        print(f"11c: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add_launches(option_launches, bf16_on_card(torch, np, kc, fb, tmp9, csv8, cfg_path,
                                                   card, expect, pcfg))
        print(f"11d: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        option_profiles(torch, card, splits)
        print(f"11e: {time.perf_counter() - t0:.1f} s; phases 1-11: "
              f"{time.perf_counter() - t_start:.1f} s")

        # ---- 12. remat, trials over ranks, the dp layout, the loader ---- #
        t0 = time.perf_counter()
        remat_launches = remat_trials(torch, np, kc, fb, tmp9, csv8, cfg_path, card, expect)
        remat_cost(torch, cfg, splits, card)
        print(f"12a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        add_launches(remat_launches, trials_over_ranks(torch, np, kc, fb, tmp9, csv8, cfg_path,
                                                       card, expect, tmp8, wall_8a))
        print(f"12b: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        dp_layout(torch, np, tmp9, cfg, splits, card)
        loader_times(np, csv8, card)
        print(f"12c, 12d: {time.perf_counter() - t0:.1f} s; phases 1-12: "
              f"{time.perf_counter() - t_start:.1f} s")

        # ---- 13. the JAX package's public surface ------------------------ #
        from rankaae_tpu_torch.data.native import native_available

        t0 = time.perf_counter()
        run_launches = run_resumed_on_card(torch, np, kc, cfg, splits, tmp9, card, expect)
        print(f"13a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        set_matmul_precision("highest")
        dual_k3 = dual_aae_on_card(torch, np, fb, csv8, card)
        set_matmul_precision(cfg.matmul_precision)
        print(f"13b: {time.perf_counter() - t0:.1f} s")
        print(f"13c native_available(): {native_available()}")
        print(f"phases 1-13: {time.perf_counter() - t_start:.1f} s")

        # ---- 14. the training-quality harness ---------------------------- #
        t0 = time.perf_counter()
        parity_launches = parity_harness_on_card(torch, np, kc, tmp9, card)
        print(f"14: {time.perf_counter() - t0:.1f} s; phases 1-14: "
              f"{time.perf_counter() - t_start:.1f} s")

    # ---- 15. the grouped conv kernels C1-C3 ------------------------------- #
    t0 = time.perf_counter()
    # the main path's C1-C3 calls: every one of phases 1-14 in this process
    # (phase 15's check cases, timing loops and epochs are not counted)
    conv_launches_main = {k: int(tracing.counter(v)) for k, v in CONV_COUNTERS.items()}
    print(f"C1-C3 calls of phases 1-14 in this process: {json.dumps(conv_launches_main)}")
    conv_err = check_conv(torch, cc)
    conv_times = time_conv(torch, cc, card)
    conv_epoch_launches(np, splits, card)
    conv_epoch_repeatable(torch, cfg_path, splits, card)
    set_matmul_precision(cfg.matmul_precision)
    print(f"15: {time.perf_counter() - t0:.1f} s; phases 1-15: "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 16. the trial sampler's draws D1 ---------------------------------- #
    t0 = time.perf_counter()
    # D1's calls of phases 1-15 in this process (16's checks and timing loops
    # are not counted)
    draw_launches_main = int(tracing.counter("draw.launches"))
    print(f"D1 calls of phases 1-15 in this process: {draw_launches_main}, "
          f"{int(tracing.counter('draw.elements'))} elements")
    draw_ulps = max(check_draws(torch, dc, card),
                    check_epoch_draws(torch, dc, cfg_path, splits, card))
    set_matmul_precision(cfg.matmul_precision)
    sampler_draws(torch, card)
    draw_epoch_launches(np, splits, card)
    draw_times = time_draws(torch, dc, card)
    print(f"16: {time.perf_counter() - t0:.1f} s; phases 1-16: "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 17. the channel PReLUs and branch sums P1 ------------------------- #
    t0 = time.perf_counter()
    prelu_err = check_prelu(torch, pc, cfg_path, splits, card)
    set_matmul_precision(cfg.matmul_precision)
    prelu_times = time_prelu(torch, pc, card)
    prelu_epoch_launches(np, splits, card)
    print(f"17: {time.perf_counter() - t0:.1f} s; phases 1-17: "
          f"{time.perf_counter() - t_start:.1f} s")

    for name in ("kendall_pair_sums", "kendall_grad_rows"):
        launches[name] += conv_launches[name] + trial_launches[name] + recal_launches[name] \
            + sum(run[1][name] for run in resume_runs.values()) + normal_launches[name] \
            + qved_launches[name] + option_launches[name] + remat_launches[name] \
            + run_launches[name] + parity_launches[name]
    k3_launches += conv_launches["fused_block"] + conv_launches["fused_block_serve"] \
        + recal_launches["fused_block"] + sum(report_k3.values()) \
        + normal_launches["fused_block"] + option_launches["fused_block"] \
        + remat_launches["fused_block"] + dual_k3
    print(f"main-path launches: K1 {launches['kendall_pair_sums']}, K2 "
          f"{launches['kendall_grad_rows']} (phase 3, 7a, 8a, 9a, 9b, 10a, 10c, 11a, 11c, "
          f"11d, 12a, 12b, 13a and 14a training), K3 {k3_launches} (phase 6 CLI, 7a training and "
          f"CLI, 9b training and amplitude gains, 9c reports, 10a, 11a, 11c, 11d and 12a "
          f"training, 11d CLI, 13b DualAAE)")

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
    conv = conv_times[CONV_TIMED[0][0]]
    for name, counter in CONV_COUNTERS.items():
        rows.append({
            "name": name, "route": "cuda", "source": "rankaae_tpu_torch/csrc/conv1d.cu",
            "replaces": None, "launches": conv_launches_main[name],
            "max_abs_err": conv_err["large"][name], "ms": conv[name]["ms"],
            "plain_ms": conv[name]["plain_ms"], "bound_ms": conv[name]["bound_ms"],
            "bound_by": "bytes", "library_ms": conv[name]["library_ms"], "device_ms": None})
    d1 = draw_times["keep_mask"]
    rows.append({
        "name": "trial_draws", "route": "cuda", "source": "rankaae_tpu_torch/csrc/trial_draws.cu",
        "replaces": None, "launches": draw_launches_main, "max_ulps_normal": draw_ulps,
        "ms": d1["ms"], "plain_ms": d1["plain_ms"], "bound_ms": d1["bound_ms"],
        "bound_by": "bytes", "library_ms": d1["library_ms"], "device_ms": d1["device_ms"]})
    for side in ("fwd", "bwd"):
        p1 = prelu_times[PRELU_TIMED[0][0]][side]
        rows.append({
            "name": f"prelu_sum_{side}", "route": "cuda",
            "source": "rankaae_tpu_torch/csrc/prelu_sum.cu", "replaces": None,
            "launches": {path: int(n[f"prelu_sum_{side}"]) for path, n in p1_launches.items()},
            "slope_rel_err": prelu_err,
            "ms": p1["ms"], "plain_ms": p1["plain_ms"], "bound_ms": p1["bound_ms"],
            "bound_by": "bytes", "library_ms": p1["library_ms"], "device_ms": p1["device_ms"]})
    print("library_ms: null — no single PyTorch call computes the Kendall pair sums "
          "or their gradient rows, nor the fused EncodingBlock (two convs, BNs, PReLUs, "
          "residual and excitation MLP); K3's row is at the serving shape C 4, B 1024; "
          "launches are the main paths' (phases 3, 6, 7a, 8a, 9a, 9b, 9c, 10a, 10c, 11a, "
          "11c, 11d, 12a, 12b, 13a, 13b and 14a); C1-C3 (no TPU kernel: the JAX package "
          "leaves its convolutions to XLA) at " + CONV_TIMED[0][0] + ", B 1024, T 32, "
          "max_abs_err their largest difference relative to the plain version's magnitude "
          "over 15a's cases at B 1024, T 32, library_ms cuDNN's, launches every call of "
          "phases 1-14 in this process; D1 (no TPU kernel: the JAX package draws with "
          "jax.random) at a T 256 (B 1024, 4, 256) keep-mask, library_ms one torch.rand over "
          "that shape from one generator, launches every call of phases 1-15; P1 (no TPU "
          "kernel: the JAX package leaves PReLU to XLA) forward and backward at three terms "
          "(B, T*C, L) = (1024, 1024, 256), library_ms F.prelu and the adds and their "
          "autograd backward, launches those of phase 7's training by path (normal: 7a's "
          f"{EPOCHS} epochs; compact: 7b's {len(BRANCH_RUNS)} runs), the backward's two a "
          "call (the partials and their sum)")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-sc-rank"]:        # one rank of phase 12b
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--dp-rank"]:              # one rank of phase 12c
        sys.exit(dp_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--conv-epoch"]:           # phase 15c's traced epochs
        sys.exit(conv_epoch_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--draw-epoch"]:           # phase 16c's traced epochs
        sys.exit(draw_epoch_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--prelu-epoch"]:          # phase 17c's traced epochs
        sys.exit(prelu_epoch_main(sys.argv[2:]))
    sys.exit(main())
