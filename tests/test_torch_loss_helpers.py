"""The key-taking loss helpers of ``rankaae_tpu/ops/losses.py:62-126``
(``adversarial_loss``, ``discriminator_loss``, ``generator_loss``,
``mutual_info_loss``) in the port (``rankaae_tpu_torch/ops/losses.py``),
where a ``torch.Generator`` takes the key's place: each equals the JAX
helper given the same prior draws (the port's, handed to the JAX helper in
place of its ``jax.random.normal`` draw) and the same discriminator,
encoder and decoder (fixed linear maps), within 1e-6.  The generator's
label is 1, the JAX package's documented deviation from the reference."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.ops import losses as jax_losses

from rankaae_tpu_torch.ops import losses
from tests import torch_parity  # noqa: F401  (one torch thread a process)

B, NSTYLE, N_REAL, ATOL = 24, 6, 32, 1e-6
RNG = np.random.default_rng(3)
W = RNG.normal(size=(NSTYLE, 1)).astype(np.float32)       # the FC discriminator's logit
W2 = RNG.normal(size=(NSTYLE, 2)).astype(np.float32)      # the CNN one's two classes
A = RNG.normal(size=(NSTYLE, 16)).astype(np.float32)      # decoder
E = RNG.normal(size=(16, NSTYLE)).astype(np.float32)      # encoder
STYLES = RNG.normal(size=(B, NSTYLE)).astype(np.float32)


def _same_draws(monkeypatch, seed):
    """A generator for the port, and the JAX helper's normal draws replaced
    by the same generator's draws, in order."""
    replay = torch.Generator().manual_seed(seed)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(torch.randn(tuple(shape), generator=replay).numpy(), dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    return torch.Generator().manual_seed(seed)


def _logit(x, beta, rng):
    return x @ (W if isinstance(x, jnp.ndarray) else torch.from_numpy(W))


def _log_probs(x, beta, rng):
    if isinstance(x, jnp.ndarray):
        return jax.nn.log_softmax(x @ W2, axis=-1)
    return torch.log_softmax(x @ torch.from_numpy(W2), dim=-1)


CASES = {
    "adversarial": (
        lambda g: losses.adversarial_loss(torch.from_numpy(STYLES)[None], _logit, 0.3, g, N_REAL),
        lambda: jax_losses.adversarial_loss(jnp.asarray(STYLES), _logit, 0.3,
                                            jax.random.PRNGKey(0), N_REAL)),
    "discriminator": (
        lambda g: losses.discriminator_loss(torch.from_numpy(STYLES)[None], _log_probs, g,
                                            N_REAL),
        lambda: jax_losses.discriminator_loss(jnp.asarray(STYLES), _log_probs,
                                              jax.random.PRNGKey(0), N_REAL)),
    "generator": (
        lambda g: losses.generator_loss(torch.from_numpy(STYLES)[None], _log_probs, g),
        lambda: jax_losses.generator_loss(jnp.asarray(STYLES), _log_probs,
                                          jax.random.PRNGKey(0))),
    "mutual_info": (
        lambda g: losses.mutual_info_loss(lambda x: x @ torch.from_numpy(E),
                                          lambda z: torch.tanh(z @ torch.from_numpy(A)),
                                          g, N_REAL, NSTYLE),
        lambda: jax_losses.mutual_info_loss(lambda x: x @ E, lambda z: jnp.tanh(z @ A),
                                            jax.random.PRNGKey(0), N_REAL, NSTYLE)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_equals_jax(monkeypatch, name):
    port, ref = CASES[name]
    got = port(_same_draws(monkeypatch, 5))
    want = float(ref())
    assert got.shape == (1,)
    assert abs(float(got[0]) - want) <= ATOL, (name, float(got[0]), want)


def test_generator_labels_its_styles_real():
    """Label 1: a discriminator sure the styles are real gives a loss near
    0, one sure they are fake a large one."""
    styles = torch.zeros(1, B, NSTYLE)

    def sure(p_real):
        return lambda x, beta, g: torch.log(torch.tensor([1 - p_real, p_real])).expand(
            *x.shape[:-1], 2)

    assert losses.generator_loss(styles, sure(1 - 1e-6), None)[0] < 1e-5
    assert losses.generator_loss(styles, sure(1e-6), None)[0] > 10


def test_helpers_carry_the_trial_axis():
    g = torch.Generator().manual_seed(0)
    styles = torch.from_numpy(np.stack([STYLES, -STYLES]))
    assert losses.adversarial_loss(styles, _logit, 0.3, g, N_REAL).shape == (2,)
    mi = losses.mutual_info_loss(lambda x: x, lambda z: z, g, N_REAL, NSTYLE, trials=3)
    assert mi.shape == (3,) and torch.all(mi == 0)
