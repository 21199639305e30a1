"""Shared pieces of the port's trainer parity tests (``tests/test_torch_*``)
against the JAX package.

One faithful ``_train_batch`` of ``rankaae_tpu_torch`` is held against
``jax.jit(RankAAETrainer._train_batch)`` from the same weights (carried over
by the weight bridge) and the same random draws: the JAX keys of the batch
are recreated with ``jax.random.split(rng, 17)`` and the three draws the
batch consumes are handed to the port's sampler (:class:`FixedDraws`).
Dropout and the discriminator noise are 0 in every compared config, so
nothing else is drawn.  Both optimizers start the batch from second moments
of :data:`NU0`, not 0: from zero moments Adam's first step is
lr * g / (|g| + 1e-8), a full-size step in the direction of the rounding
noise wherever a gradient is near zero (a bias that feeds an affine-free
BatchNorm has an exactly null gradient), and that noise differs between two
stacks.  Tolerances: :data:`BATCH_ATOL` on the six losses and on every
parameter and running-statistic leaf after the batch (several sequential
optimizer steps of float32 arithmetic taken in another order),
:data:`VAL_ATOL` on ``_validate``.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import TrialData as JaxTrialData

from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
from rankaae_tpu_torch.train.trainer import TrialData
from rankaae_tpu_torch.utils.sampler import Sampler
from rankaae_tpu_torch.utils.weights import from_jax, to_jax

NU0 = 1e-8      # second moments both optimizers start the batch from
BATCH_ATOL, VAL_ATOL = 1e-4, 1e-5
LOSSES = ("dis", "gen", "aux", "recon", "smooth", "mi")


class FixedDraws(Sampler):
    """A sampler that hands out given arrays for the named draws."""

    def __init__(self, draws):
        super().__init__(0, "cpu")
        self.draws = draws

    def normal(self, name, shape):
        x = self.draws.pop(name)
        assert tuple(x.shape) == tuple(shape), (name, x.shape, shape)
        return torch.tensor(np.asarray(x))


def make_data(seed, n):
    aux, spec, _ = make_synthetic_xanes(n_rows=n, dim=256, seed=seed)
    return spec.astype(np.float32), aux.astype(np.float32)


def jax_init(jtr, seed=0):
    """The JAX trainer's fresh state, its initialisation compiled once."""
    return jax.jit(jtr.init_state)(jax.random.PRNGKey(seed))


def load_jax_weights(ttr, jstate):
    """Load the JAX state's weights and running statistics into the port's
    modules."""
    sds = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    for key, m in ttr.models.items():
        m.load_state_dict(sds[key])


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def compare_batch(jtr, jstate, ttr, tstate, spec, aux, alpha=0.3, epoch=0, seed=42):
    """One batch on both stacks from ``jstate``'s weights (loaded into the
    port's modules here); asserts the losses and every leaf after the step.
    Returns the number of leaves checked, the changes of every element of
    the autoencoder's weight matrices and kernels, and both loss dicts."""
    load_jax_weights(ttr, jstate)
    jstate = jstate._replace(opt={
        k: o._replace(nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, NU0), o.nu))
        for k, o in jstate.opt.items()})
    for o in tstate.opt.values():
        for v in o.nu:
            v.fill_(NU0)
    rng = jax.random.PRNGKey(seed)
    new_jstate, jlosses = jax.jit(jtr._train_batch)(
        jstate, jnp.asarray(spec), jnp.asarray(aux), jnp.float32(alpha), jnp.int32(epoch), rng)

    cfg = jtr.cfg
    keys = jax.random.split(rng, 17)      # trainer.py:315-319,335,387,462
    sampler = FixedDraws({
        "spec_noise": jax.random.normal(keys[0], spec.shape),
        "z_real": jax.random.normal(keys[1], (cfg.batch_size, cfg.nstyle)),
        "z_sample": jax.random.normal(keys[12], (spec.shape[0], cfg.nstyle)),
    })
    _, tlosses = ttr._train_batch(tstate, torch.tensor(spec), torch.tensor(aux),
                                  alpha, epoch, sampler)
    assert not sampler.draws             # all three draws were consumed

    for name in LOSSES:
        np.testing.assert_allclose(tlosses[name].item(), float(jlosses[name]),
                                   atol=BATCH_ATOL, err_msg=name)
    params, stats = to_jax(ttr.models)
    got = _flat({"params": params, "stats": stats})
    ref = _flat({"params": new_jstate.params, "stats": new_jstate.batch_stats})
    assert sorted(got) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name], value, atol=BATCH_ATOL, err_msg=name)
    old = _flat({"params": jstate.params, "stats": jstate.batch_stats})
    moved = [np.abs(value - old[name]).ravel() for name, value in ref.items()
             if name.startswith("['params']['enc']") or name.startswith("['params']['dec']")
             if value.ndim >= 2]
    return len(ref), np.concatenate(moved), tlosses, jlosses


def compare_validate(jtr, jstate, ttr, tstate, spec, aux, alpha=0.25, seed=7):
    """``_validate`` on both stacks from ``jstate``'s weights (loaded into
    the port's modules here), on ``spec``/``aux`` as the validation split;
    asserts the latent and every validation loss.  Returns the port's."""
    load_jax_weights(ttr, jstate)
    cfg = jtr.cfg
    rng = jax.random.PRNGKey(seed)
    jdata = JaxTrialData(*(jnp.asarray(a) for a in (spec, aux, spec, aux)))
    z_ref, ref = jtr._validate(jstate, jdata, jnp.float32(alpha), rng)
    k1, k2 = jax.random.split(rng)
    n_real = cfg.batch_size if cfg.gradient_reversal else jtr.n_val
    sampler = FixedDraws({"z_val": jax.random.normal(k1, (jtr.n_val, cfg.nstyle)),
                          "z_real_val": jax.random.normal(k2, (n_real, cfg.nstyle))})
    tdata = TrialData(*(torch.tensor(a) for a in (spec, aux, spec, aux)))
    z, got = ttr._validate(tstate, tdata, alpha, sampler)
    assert not sampler.draws
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=VAL_ATOL)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].item(), float(value), atol=VAL_ATOL, err_msg=name)
    return got
