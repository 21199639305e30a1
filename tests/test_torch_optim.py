"""The port's RAdam and AdaBound against ``rankaae_tpu.optim.optimizers``.

Twelve steps, so that RAdam's rectifier switches on (rho_t > 5 from the
sixth step with b2 0.999 and 0.9999), with weight decay, a null gradient
(a BatchNorm-fed bias) and, for AdaBound, the runtime lr cut to 0.1x once
as the plateau scheduler cuts it (its bounds follow lr / base_lr) and
gradients large enough on one leaf that its lower bound clips the step.
Tolerance atol 1e-6 (float32 updates of the same formulas).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rankaae_tpu.optim.optimizers import make_optimizer as jax_make_optimizer

from rankaae_tpu_torch.optim.optimizers import make_optimizer
from tests import torch_parity  # noqa: F401  (one torch thread a process)

ATOL = 1e-6
STEPS = 12
SHAPES = [(16, 8), (8,), (3,)]


@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.9 * 1.1, 0.009 * 1.1 + 0.99)],
                         ids=["default", "gan_beta"])
@pytest.mark.parametrize("name", ["RAdam", "AdaBound"])
def test_optimizer_matches_jax_over_twelve_steps(name, betas):
    rng = np.random.default_rng(21)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    kw = {"base_lr": 1e-2} if name == "AdaBound" else {}
    jopt = jax_make_optimizer(name, betas=betas, weight_decay=0.01, **kw)
    topt = make_optimizer(name, betas=betas, weight_decay=0.01, **kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.tensor(p) for p in params]
    tstate = topt.init(tp)
    for step in range(STEPS):
        lr = 1e-2 if step < 8 else 1e-3          # the plateau cut, 0.1x
        grads = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
        grads[0] *= 10.0       # AdaBound's lower bound binds on these in later steps
        grads[2][:] = 0.0
        jp, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp, jnp.float32(lr))
        topt.update([torch.tensor(g) for g in grads], tstate, tp,
                    torch.tensor(lr, dtype=torch.float32))
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       err_msg=f"step {step}")
    assert tstate.count == int(jstate.count) == STEPS
    moved = np.abs(tp[0].numpy() - params[0]).max()
    assert moved > 100 * ATOL, moved
