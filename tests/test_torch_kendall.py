"""The port's Kendall loss against the JAX package's.

The port's plain loss (``rankaae_tpu_torch/ops/kendall.py``) and the CPU
path of its kernel wrappers (``ops/kendall_cuda.py``: the plain versions of
K1/K2 behind the same ``autograd.Function`` the card uses) are held against
``rankaae_tpu.ops.kendall.kendall_constraint`` (plain XLA) and
``kendall_constraint_pallas`` run in Pallas interpret mode.  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against the
same plain versions there.  As on the card, the CPU path splits the work:
K1 (plain) returns the integer row sums P and N with the loss, and K2
(plain) turns them into the gradient without a second pass over the pairs.

Tolerance: rtol 1e-4 / atol 1e-6 on the loss and atol 1e-6 on the gradient,
as ``tests/test_kendall_pallas.py`` uses — sums over ~1e5 pairs taken in
another order.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import rankaae_tpu.ops.kendall_pallas as kp
from rankaae_tpu.ops.kendall import kendall_constraint as jax_kendall

from rankaae_tpu_torch.ops import kendall as tk
from rankaae_tpu_torch.ops import kendall_cuda as kc

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(kp, "_INTERPRET", True)


def _inputs(seed, b, k=5, t=None, ties=True):
    rng = np.random.default_rng(seed)
    shape = (b, k) if t is None else (t, b, k)
    d = rng.normal(size=shape).astype(np.float32)
    if ties:
        d[..., 1] = rng.choice([4.0, 5.0, 6.0], size=shape[:-1])  # discrete CN
    s = rng.normal(size=shape).astype(np.float32)
    s[..., 0] += 0.8 * d[..., 0]       # some real rank structure
    return d, s


def _torch_loss_grad(fn, d, s, activate):
    st = torch.tensor(s, requires_grad=True)
    loss = fn(torch.tensor(d), st, activate)
    loss.sum().backward()
    return loss.detach().numpy(), st.grad.numpy()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("b", [256, 300])
def test_plain_matches_jax_xla_and_pallas(b, activate, ties):
    d, s = _inputs(b, b, ties=ties)
    loss, grad = _torch_loss_grad(
        lambda d_, s_, a: tk.kendall_constraint(d_, s_, activate=a), d, s, activate)

    f_xla = lambda s_: jax_kendall(jnp.asarray(d), s_, activate=activate)
    f_pl = lambda s_: kp.kendall_constraint_pallas(jnp.asarray(d), s_, activate)
    for f in (f_xla, f_pl):
        l_ref, g_ref = jax.value_and_grad(f)(jnp.asarray(s))
        np.testing.assert_allclose(loss, float(l_ref), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad, np.asarray(g_ref), atol=ATOL)


@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("b", [256, 300])
def test_kernel_function_cpu_path_matches_pallas(b, activate):
    """The autograd.Function the card runs (here over K1/K2's plain
    versions) against the Pallas custom VJP."""
    d, s = _inputs(100 + b, b)
    loss, grad = _torch_loss_grad(
        lambda d_, s_, a: kc.KendallFunction.apply(d_[None], s_[None], a)[0],
        d, s, activate)
    l_ref, g_ref = jax.value_and_grad(
        lambda s_: kp.kendall_constraint_pallas(jnp.asarray(d), s_, activate))(jnp.asarray(s))
    np.testing.assert_allclose(loss, float(l_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, np.asarray(g_ref), atol=ATOL)


@pytest.mark.parametrize("b", [256, 300])
def test_pair_sums_plain_matches_pallas_fwd_kernel(b):
    """K1's plain version against ``_fwd_kernel`` (interpret mode): the
    sums, and the counts exactly."""
    d, s = _inputs(200 + b, b)
    sums, cnts, w, loss = kc.pair_sums(torch.tensor(d)[None], torch.tensor(s)[None], True)
    d_bk, d_t, s_bk, s_t, bb, _ = kp._prepare(jnp.asarray(d), jnp.asarray(s))
    sums_ref, cnts_ref = kp._pair_sums_pallas(bb, d_bk, d_t, s_bk, s_t)
    np.testing.assert_allclose(sums[0].numpy(), np.asarray(sums_ref), rtol=RTOL)
    np.testing.assert_array_equal(cnts[0].numpy(), np.asarray(cnts_ref).astype(np.int32))
    np.testing.assert_allclose(
        loss.numpy()[0], float(kp.kendall_constraint_pallas(jnp.asarray(d), jnp.asarray(s), True)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b", [256, 300])
def test_grad_rows_plain_matches_pallas_bwd_kernel(b):
    """K2's plain version against ``_bwd_kernel`` (interpret mode), with the
    row sums and activation weights of K1 and the incoming gradient g."""
    d, s = _inputs(300 + b, b)
    _, _, w, _, pos_rows, neg_rows = kc.pair_sums(
        torch.tensor(d)[None], torch.tensor(s)[None], True, rows=True)
    g = 0.75
    rows = kc.grad_rows(pos_rows, neg_rows, w, torch.tensor([g], dtype=torch.float32))
    d_bk, d_t, s_bk, s_t, bb, k = kp._prepare(jnp.asarray(d), jnp.asarray(s))
    raw = kp._grad_rows_pallas(bb, d_bk, d_t, s_bk, s_t, jnp.asarray(w[0].numpy()))[:bb]
    ref = np.asarray(raw) * (-2.0 * g / ((bb * bb - bb) * k))
    np.testing.assert_allclose(rows[0].numpy(), ref, atol=ATOL)


def _tied_inputs(seed, b, t=4, k=5):
    """A discrete descriptor column (tgt = 0 pairs) and exactly tied styles
    under distinct descriptors (p = 0 with tgt != 0: the tie rule)."""
    d, s = _inputs(seed, b, k=k, t=t)
    s[..., 2] = np.random.default_rng(seed + 1).choice([-0.5, 0.0, 0.5], size=(t, b))
    s[:, 1, 2] = s[:, 0, 2]
    assert np.all(d[:, 1, 2] != d[:, 0, 2])
    return d, s


@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("b", [2, 33, 300])
def test_row_sums_through_grad_rows_match_pallas_bwd_and_jax_grad(b, activate):
    """K1's row sums (plain) turned into the gradient by K2 (plain), T 4,
    ragged B, ties in d and in s: P and N against a numpy count, the
    gradient against ``_bwd_kernel`` (interpret mode) and against
    ``jax.grad`` of the XLA loss."""
    d, s = _tied_inputs(400 + b, b)
    t, _, k = d.shape
    g = np.linspace(0.5, 1.5, t).astype(np.float32)
    sums, cnts, w, loss, pos_rows, neg_rows = kc.pair_sums(
        torch.tensor(d), torch.tensor(s), activate, rows=True)
    grad = kc.grad_rows(pos_rows, neg_rows, w, torch.tensor(g)).numpy()

    tgt = np.sign(d[:, :, None, :] - d[:, None, :, :]).astype(np.int64)
    pos = (s[:, :, None, :] - s[:, None, :, :]) * tgt > 0
    np.testing.assert_array_equal(pos_rows.numpy(), np.where(pos, tgt, 0).sum(axis=2))
    np.testing.assert_array_equal(neg_rows.numpy(), np.where(pos, 0, tgt).sum(axis=2))

    # the Pallas kernel on the first trial (interpret mode costs ~0.4 s a
    # call); every trial against the XLA loss
    d_bk, d_t, s_bk, s_t, bb, _ = kp._prepare(jnp.asarray(d[0]), jnp.asarray(s[0]))
    raw = kp._grad_rows_pallas(bb, d_bk, d_t, s_bk, s_t, jnp.asarray(w[0].numpy()))[:bb]
    np.testing.assert_allclose(grad[0], np.asarray(raw) * (-2.0 * g[0] / ((b * b - b) * k)),
                               atol=ATOL)
    for i in range(t):
        l_ref, g_ref = jax.value_and_grad(
            lambda s_: g[i] * jax_kendall(jnp.asarray(d[i]), s_, activate=activate))(
                jnp.asarray(s[i]))
        np.testing.assert_allclose(g[i] * loss[i].item(), float(l_ref), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad[i], np.asarray(g_ref), atol=ATOL)


def test_function_asks_for_row_sums_only_when_a_gradient_is_wanted(monkeypatch):
    """Under ``torch.no_grad()`` (validation) or with constant styles, the
    Function's CPU path does not ask K1 for the row sums."""
    asked = []
    real = kc.pair_sums

    def spy(descriptors, styles, activate, rows=False):
        asked.append(rows)
        return real(descriptors, styles, activate, rows)

    monkeypatch.setattr(kc, "pair_sums", spy)
    d, s = _inputs(13, 40, t=2)
    dt, st = torch.tensor(d), torch.tensor(s, requires_grad=True)
    with torch.no_grad():
        loss_val = kc.KendallFunction.apply(dt, st, True)
    loss_const = kc.KendallFunction.apply(dt, st.detach(), True)
    loss = kc.KendallFunction.apply(dt, st, True)
    assert asked == [False, False, True]
    assert not loss_val.requires_grad and loss.requires_grad
    np.testing.assert_array_equal(loss_val.numpy(), loss.detach().numpy())
    np.testing.assert_array_equal(loss_const.numpy(), loss.detach().numpy())


@pytest.mark.parametrize("activate", [False, True])
def test_trial_batched_equals_per_trial_loop(activate):
    """The (T, B, K) form, plain and through the kernel Function's CPU path,
    equals a loop over trials."""
    d, s = _inputs(7, 120, t=4)
    loss_p, grad_p = _torch_loss_grad(
        lambda d_, s_, a: tk.kendall_constraint(d_, s_, activate=a), d, s, activate)
    loss_f, grad_f = _torch_loss_grad(kc.KendallFunction.apply, d, s, activate)
    for i in range(4):
        loss_i, grad_i = _torch_loss_grad(
            lambda d_, s_, a: tk.kendall_constraint(d_, s_, activate=a), d[i], s[i], activate)
        for loss, grad in ((loss_p, grad_p), (loss_f, grad_f)):
            np.testing.assert_allclose(loss[i], loss_i, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(grad[i], grad_i, atol=ATOL)


def test_cpu_dispatch_uses_plain_version_and_counts_no_launch():
    d, s = _inputs(11, 64)
    fwd0, bwd0 = kc.fwd_launches, kc.bwd_launches
    loss_d, grad_d = _torch_loss_grad(
        lambda d_, s_, a: kc.kendall_constraint(d_, s_, activate=a), d, s, True)
    loss_p, grad_p = _torch_loss_grad(
        lambda d_, s_, a: tk.kendall_constraint(d_, s_, activate=a), d, s, True)
    np.testing.assert_array_equal(loss_d, loss_p)
    np.testing.assert_array_equal(grad_d, grad_p)
    assert (kc.fwd_launches, kc.bwd_launches) == (fwd0, bwd0)


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguity", "shape", "k"])
def test_wrappers_reject_bad_inputs(bad):
    d = torch.zeros((1, 8, 5))
    s = torch.zeros((1, 8, 5))
    if bad == "dtype":
        s = s.double()
    elif bad == "rank":
        d, s = d[0], s[0]
    elif bad == "contiguity":
        s = torch.zeros((1, 5, 8)).transpose(1, 2)
    elif bad == "shape":
        s = torch.zeros((1, 9, 5))
    else:
        d, s = torch.zeros((1, 8, 33)), torch.zeros((1, 8, 33))
    with pytest.raises((TypeError, ValueError)):
        kc.pair_sums(d, s, True)


@pytest.mark.parametrize("bad", ["dtype", "shape", "w", "contiguity", "rank"])
def test_grad_rows_rejects_bad_inputs(bad):
    pos = torch.zeros((1, 8, 5), dtype=torch.int32)
    neg = torch.zeros((1, 8, 5), dtype=torch.int32)
    w, g = torch.ones((1, 5)), torch.ones((1,))
    if bad == "dtype":
        pos = pos.float()
    elif bad == "shape":
        neg = torch.zeros((1, 9, 5), dtype=torch.int32)
    elif bad == "w":
        w = torch.ones((1, 4))
    elif bad == "contiguity":
        neg = torch.zeros((1, 5, 8), dtype=torch.int32).transpose(1, 2)
    else:
        pos, neg = pos[0], neg[0]
    with pytest.raises(ValueError):
        kc.grad_rows(pos, neg, w, g)
