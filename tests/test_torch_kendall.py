"""The port's Kendall loss against the JAX package's.

The port's plain loss (``rankaae_tpu_torch/ops/kendall.py``) and the CPU
path of its kernel wrappers (``ops/kendall_cuda.py``: the plain versions of
K1/K2 behind the same ``autograd.Function`` the card uses) are held against
``rankaae_tpu.ops.kendall.kendall_constraint`` (plain XLA) and
``kendall_constraint_pallas`` run in Pallas interpret mode.  The CUDA kernels
themselves run only on the card; ``chip_smoke.py`` holds them against the
same plain versions there.

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
    activation weights of K1 and the incoming gradient g."""
    d, s = _inputs(300 + b, b)
    _, _, w, _ = kc.pair_sums(torch.tensor(d)[None], torch.tensor(s)[None], True)
    g = 0.75
    rows = kc.grad_rows(torch.tensor(d)[None], torch.tensor(s)[None], w,
                        torch.tensor([g], dtype=torch.float32))
    d_bk, d_t, s_bk, s_t, bb, k = kp._prepare(jnp.asarray(d), jnp.asarray(s))
    raw = kp._grad_rows_pallas(bb, d_bk, d_t, s_bk, s_t, jnp.asarray(w[0].numpy()))[:bb]
    ref = np.asarray(raw) * (-2.0 * g / ((bb * bb - bb) * k))
    np.testing.assert_allclose(rows[0].numpy(), ref, atol=ATOL)


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
