"""How far float32 rounding moves the normal-form batch of
``tests/test_torch_conv_train_normal.py``, on both stacks.

The method of ``rankaae_tpu_torch/tools/batch_spread.py``: the test's batch
(its config, data, JAX draws and second moments of 1e-8) runs from the
JAX package's initial weights, then again from those weights each
multiplied by (1 + 1e-7 N(0, 1)) for :data:`SAMPLES` seeds, on the JAX
package and on the port.  The largest change of the MI loss and of any leaf
over the perturbed runs is the batch's spread on each stack.  The test
prints both spreads and the difference between the two stacks run in
sequence from the same weights.

It holds what the parity test's design rests on: the whole-batch MI loss of
this batch moves by more than half the parity tolerance (1e-4) under a
1e-7 perturbation, on each stack, and the two stacks differ by no more than
twice that spread.  So the difference is rounding that the MI step
amplifies, and the parity test compares every step from identical inputs.

The MI loss does not move smoothly: it takes one of two values 1.6e-4
apart, and a perturbation either flips it or moves it by a few 1e-6.  How
many perturbations flip it depends on the CPU that runs the suite (the
order of its float32 sums): on one x86 host 1 of 16 seeds flipped the JAX
package's loss and none of the first 3 did.  So the spread is taken over 16
seeds, enough that each stack shows the flip.
"""
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import RankAAETrainer as JaxTrainer
from rankaae_tpu.utils.config import TrainConfig as JaxTrainConfig

from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import FixedDraws
from tests.test_torch_conv_train_normal import B, CFG, N_VAL
from tests.torch_parity import (BATCH_ATOL, NU0, _flat, batch_draws, jax_init,
                                load_jax_weights, make_data, perturbed)

SAMPLES = 16


@pytest.fixture(scope="module")
def runs():
    jtr = JaxTrainer(JaxTrainConfig(**CFG), n_train=B, n_val=N_VAL)
    jstate = jax_init(jtr)
    jstate = jstate._replace(opt={
        k: o._replace(nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, NU0), o.nu))
        for k, o in jstate.opt.items()})
    spec, aux = make_data(5, B)
    rng = jax.random.PRNGKey(42)
    draws = batch_draws(jtr.cfg, rng, B)
    step = jax.jit(jtr._train_batch)

    def jax_batch(seed):
        new, losses = step(jstate._replace(params=perturbed(jstate.params, seed)),
                           jnp.asarray(spec), jnp.asarray(aux), jnp.float32(0.3),
                           jnp.int32(0), rng)
        return float(losses["mi"]), _flat({"p": new.params, "s": new.batch_stats})

    def port_batch(seed):
        ttr = RankAAETrainer(TrainConfig(**CFG), n_train=B, n_val=N_VAL, device="cpu")
        tstate = ttr.init_state(0)
        load_jax_weights(ttr, jstate._replace(params=perturbed(jstate.params, seed)))
        for o in tstate.opt.values():
            for v in o.nu:
                v.fill_(NU0)
        _, losses = ttr._train_batch(tstate, torch.tensor(spec)[None], torch.tensor(aux)[None],
                                     0.3, 0, FixedDraws(dict(draws)))
        params, stats = ttr.export(0)
        return losses["mi"].item(), _flat({"p": params, "s": stats})

    out = {}
    for name, batch in (("jax", jax_batch), ("port", port_batch)):
        mi, leaves = batch(None)
        spread_mi = spread_leaf = 0.0
        for seed in range(1, SAMPLES + 1):
            mi_s, leaves_s = batch(seed)
            spread_mi = max(spread_mi, abs(mi_s - mi))
            spread_leaf = max(spread_leaf, max(float(np.abs(leaves_s[k] - v).max())
                                               for k, v in leaves.items()))
        out[name] = {"mi": mi, "leaves": leaves, "spread_mi": spread_mi,
                     "spread_leaf": spread_leaf}
    return out


def test_stacks_differ_by_the_rounding_spread(runs):
    jax_run, port_run = runs["jax"], runs["port"]
    diff_mi = abs(jax_run["mi"] - port_run["mi"])
    diff_leaf = max(float(np.abs(port_run["leaves"][k] - v).max())
                    for k, v in jax_run["leaves"].items())
    print(json.dumps({"spread_mi": {k: runs[k]["spread_mi"] for k in runs},
                      "spread_leaf": {k: runs[k]["spread_leaf"] for k in runs},
                      "jax_vs_port": {"mi": diff_mi, "leaf": diff_leaf}}))
    spread_mi = max(jax_run["spread_mi"], port_run["spread_mi"])
    spread_leaf = max(jax_run["spread_leaf"], port_run["spread_leaf"])
    assert jax_run["spread_mi"] > BATCH_ATOL / 2 and port_run["spread_mi"] > BATCH_ATOL / 2
    assert diff_mi <= 2 * spread_mi
    assert diff_leaf <= 2 * spread_leaf
