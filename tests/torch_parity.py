"""Shared pieces of the port's trainer parity tests (``tests/test_torch_*``)
against the JAX package.

One faithful ``_train_batch`` of ``rankaae_tpu_torch`` is held against
``jax.jit(RankAAETrainer._train_batch)`` from the same weights (carried over
by the weight bridge into trial 0 of its stacked modules) and the same
random draws: the JAX keys of the batch are recreated with
``jax.random.split(rng, 17)`` and the three draws the batch consumes are
handed to the port's sampler (:class:`FixedDraws`).
Dropout and the discriminator noise are 0 in every compared config, so
nothing else is drawn.  Both optimizers start the batch from second moments
of :data:`NU0`, not 0: from zero moments Adam's first step is
lr * g / (|g| + 1e-8), a full-size step in the direction of the rounding
noise wherever a gradient is near zero (a bias that feeds an affine-free
BatchNorm has an exactly null gradient), and that noise differs between two
stacks.  Tolerances: :data:`BATCH_ATOL` on the losses and on every
parameter and running-statistic leaf after each step (float32 arithmetic
taken in another order), :data:`VAL_ATOL` on ``_validate``.  A batch
amplifies the rounding its first steps leave (a Kendall pair that flips,
the mutual-info step) by an amount that depends on the order of the CPU's
sums, so :func:`compare_batch_by_steps` holds the whole batch to the
larger of :data:`BATCH_ATOL` and twice its 1e-7 perturbation spread, and
takes each step alone from the JAX package's own inputs to it.  The fused
and joint protocols take no steps in sequence: :func:`compare_batch` holds
their whole batch alone, its three draws keys 0-2 of ``split(rng, 9)``
(:func:`batch_draws`).
"""
import inspect
import json

import numpy as np

import jax
import jax.numpy as jnp
import torch

from rankaae_tpu.train.trainer import TrialData as JaxTrialData

from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
from rankaae_tpu_torch.tools.batch_spread import PERTURBATION
from rankaae_tpu_torch.train.trainer import OPT_SPECS, TrialData
from rankaae_tpu_torch.utils.sampler import FixedDraws
from rankaae_tpu_torch.utils.weights import from_jax

#: one torch thread a process.  The suite runs several worker processes at
#: once, and torch's default of one thread a core oversubscribes the CPU
#: many times over: a port test ran 10-20x slower in the suite than alone.
#: One thread also fixes the order of torch's CPU sums, which the thread
#: count sets, so the port's results do not depend on the host's core
#: count.  Every ``tests/test_torch_*.py`` imports this module.
torch.set_num_threads(1)

NU0 = 1e-8      # second moments both optimizers start the batch from
BATCH_ATOL, VAL_ATOL = 1e-4, 1e-5
LOSSES = ("dis", "gen", "aux", "recon", "smooth", "mi")
#: perturbation seeds of a batch's spread: one of 16 showed a flip of the
#: normal-form batch's MI loss that none of the first 3 did
#: (``tests/test_torch_batch_spread.py``)
SPREAD_SEEDS = range(1, 17)


def make_data(seed, n):
    aux, spec, _ = make_synthetic_xanes(n_rows=n, dim=256, seed=seed)
    return spec.astype(np.float32), aux.astype(np.float32)


def jax_init(jtr, seed=0):
    """The JAX trainer's fresh state, its initialisation compiled once."""
    return jax.jit(jtr.init_state)(jax.random.PRNGKey(seed))


def load_jax_weights(ttr, jstate, trial=0):
    """Load the JAX state's weights and running statistics into trial
    ``trial`` of the port's modules."""
    ttr.load_trial_state_dicts(trial, from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats)))


def _flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _with_nu0(jstate, tstate):
    """Both optimizers' second moments at :data:`NU0`; returns the JAX state."""
    for o in tstate.opt.values():
        for v in o.nu:
            v.fill_(NU0)
    return jstate._replace(opt={
        k: o._replace(nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, NU0), o.nu))
        for k, o in jstate.opt.items()})


def jax_batch_runner(jtr, spec, aux, alpha, epoch, rng):
    """A jitted JAX ``_train_batch`` of ``spec``/``aux`` that records the
    inputs of every optimizer step as it is taken (``jax.debug.callback``):
    the weights, the running statistics its loss starts from, the moment
    state, the lr, the loss closure's draws and ``spec_in`` (``free``), and
    the step's outputs ``(loss, params, batch_stats, moments)``.  Returns
    ``run(jstate) -> (records by optimizer name, new state, losses)``; the
    batch compiles once."""
    records = {}
    real = jtr._opt_step

    def record(name, loss_fn, params, opt_state, lr):
        free = inspect.getclosurevars(loss_fn).nonlocals
        out = real(name, loss_fn, params, opt_state, lr)
        jax.debug.callback(
            lambda rec, name=name: records.__setitem__(name, rec),
            {"params": params, "stats": free["stats"], "opt": opt_state, "lr": lr,
             "free": {k: free[k] for k in ("z_sample", "spec_in", "z_real", "aux")
                      if k in free},
             "out": out})
        return out

    step = jax.jit(jtr._train_batch)
    args = (jnp.asarray(spec), jnp.asarray(aux), jnp.float32(alpha), jnp.int32(epoch), rng)

    def run(jstate):
        records.clear()
        jtr._opt_step = record
        try:
            new_state, losses = step(jstate, *args)
            jax.effects_barrier()
        finally:
            del jtr._opt_step
        return dict(records), new_state, losses

    return run


def perturbed(params, seed):
    """``params`` with every element multiplied by (1 + 1e-7 N(0, 1)) drawn
    from numpy seed ``seed`` (unchanged if ``seed`` is None): float32
    rounding of the weights."""
    if seed is None:
        return params
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) * (1 + PERTURBATION * rng.standard_normal(np.shape(x))))
        .astype(np.float32), params)


def _port_moments(ttr, name, tree):
    """A JAX moment tree of optimizer ``name``'s parameter subset as the
    port's list of tensors (trial 0 of its parameters)."""
    out = []
    for role in OPT_SPECS[name][0]:
        sd = from_jax({role: jax.tree_util.tree_map(np.asarray, tree[role])}, {})[role]
        for (key, _), p in zip(ttr.single_models[role].named_parameters(),
                               ttr.models[role].parameters()):
            out.append(sd[key].reshape(p.shape).clone())
    return out


def _assert_leaves(ttr, params, stats, what):
    """Every leaf of trial 0 of the port's modules against the JAX trees;
    returns the JAX leaves by path."""
    tparams, tstats = ttr.export(0)
    got = _flat({"params": tparams, "stats": tstats})
    ref = _flat({"params": params, "stats": stats})
    assert sorted(got) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name], value, atol=BATCH_ATOL, err_msg=f"{what} {name}")
    return ref


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def compare_step_alone(ttr, tstate, name, record, step):
    """Optimizer step ``name`` of the port from the JAX inputs in
    ``record`` (weights, running statistics, moments, lr): ``step(free)``
    runs the port's step method with the loss closure's free variables
    ``free`` and returns its loss; asserts the loss and every leaf after the
    step against the JAX step's outputs.  Returns the number of leaves."""
    ttr.load_trial_state_dicts(0, from_jax(_to_np(record["params"]), _to_np(record["stats"])))
    opt = tstate.opt[name]
    opt.count = int(record["opt"].count)
    opt.mu = _port_moments(ttr, name, record["opt"].mu)
    opt.nu = _port_moments(ttr, name, record["opt"].nu)
    np.testing.assert_array_equal(tstate.sched[name].lr.numpy(), float(record["lr"]))
    for m in ttr.models.values():
        m.train()
    loss, new_params, new_stats, _ = record["out"]
    np.testing.assert_allclose(step(record["free"]).item(), float(loss), atol=BATCH_ATOL,
                               err_msg=name)
    return len(_assert_leaves(ttr, new_params, new_stats, f"after {name}:"))


def _compare_forward_alone(ttr, params, stats, forward, ref_stats, what):
    """A stats-only train-mode forward of the port (``forward()``) from the
    JAX weights and statistics ``params``/``stats``: the running statistics
    after it against ``ref_stats``, the JAX package's after the same
    forward."""
    ttr.load_trial_state_dicts(0, from_jax(_to_np(params), _to_np(stats)))
    for m in ttr.models.values():
        m.train()
    with torch.no_grad():
        forward()
    _, got = ttr.export(0)
    got, ref = _flat(got), _flat(_to_np(ref_stats))
    assert sorted(got) == sorted(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name], value, atol=BATCH_ATOL, err_msg=f"{what}: {name}")


def _port_batch(jtr, jstate, ttr, tstate, spec, aux, alpha, epoch, rng):
    """The port's whole ``_train_batch`` from ``jstate``'s weights and the
    JAX batch's draws, on ``tstate`` (second moments of :data:`NU0`).
    Returns the six losses and every leaf after the batch, by path."""
    load_jax_weights(ttr, jstate)
    _with_nu0(jstate, tstate)
    sampler = FixedDraws(batch_draws(jtr.cfg, rng, spec.shape[0]))
    _, losses = ttr._train_batch(tstate, torch.tensor(spec)[None], torch.tensor(aux)[None],
                                 alpha, epoch, sampler)
    assert not sampler.draws             # all three draws were consumed
    params, stats = ttr.export(0)
    return ({k: v.item() for k, v in losses.items()},
            _flat({"params": params, "stats": stats}), losses)


def compare_whole_batch(run_jax, jstate, port_batch, what=""):
    """The whole batch on both stacks from ``jstate``'s weights: the six
    losses and every leaf after it held to the larger of
    :data:`BATCH_ATOL` and twice the batch's 1e-7 perturbation spread.

    The spread is the method of ``rankaae_tpu_torch/tools/batch_spread.py``
    on this batch: each stack runs it again from ``jstate``'s weights
    :func:`perturbed` with each of :data:`SPREAD_SEEDS`, and the spread of
    a loss or a leaf is the largest change (max abs) that any perturbed run
    of either stack shows from that stack's unperturbed run.  A step that
    is dropped, taken twice or out of order, or state chained wrongly from
    one step to the next, moves losses and leaves by tens to hundreds of
    times that.  Prints the differences and spreads as one JSON line and
    returns the JAX run's records, new state and losses, and the port's
    losses."""
    records, new_jstate, jlosses = run_jax(jstate)
    ref = ({k: float(v) for k, v in jlosses.items()},
           _flat({"params": new_jstate.params, "stats": new_jstate.batch_stats}))
    got_losses, got_leaves, tlosses = port_batch(jstate)
    spread = ({k: 0.0 for k in LOSSES}, {k: 0.0 for k in ref[1]})
    for stack, base in (("jax", ref), ("port", (got_losses, got_leaves))):
        for seed in SPREAD_SEEDS:
            state = jstate._replace(params=perturbed(jstate.params, seed))
            if stack == "jax":
                _, new, losses = run_jax(state)
                run = ({k: float(v) for k, v in losses.items()},
                       _flat({"params": new.params, "stats": new.batch_stats}))
            else:
                run = port_batch(state)[:2]
            for k in LOSSES:
                spread[0][k] = max(spread[0][k], abs(run[0][k] - base[0][k]))
            for k in ref[1]:
                spread[1][k] = max(spread[1][k], float(np.abs(run[1][k] - base[1][k]).max()))
    diff = ({k: abs(got_losses[k] - ref[0][k]) for k in LOSSES},
            {k: float(np.abs(got_leaves[k] - v).max()) for k, v in ref[1].items()})
    worst = max(ref[1], key=lambda k: diff[1][k] / max(BATCH_ATOL, 2 * spread[1][k]))
    print(json.dumps({"whole batch": what, "loss_diff": diff[0], "loss_spread": spread[0],
                      "leaf_diff_max": max(diff[1].values()),
                      "leaf_spread_max": max(spread[1].values()),
                      "tightest_leaf": [worst, diff[1][worst], spread[1][worst]]}))
    assert sorted(got_leaves) == sorted(ref[1])
    for k in LOSSES:
        assert diff[0][k] <= max(BATCH_ATOL, 2 * spread[0][k]), (k, diff[0][k], spread[0][k])
    for k in ref[1]:
        assert diff[1][k] <= max(BATCH_ATOL, 2 * spread[1][k]), (k, diff[1][k], spread[1][k])
    return records, new_jstate, jlosses, tlosses


def compare_batch(jtr, jstate, ttr, tstate, spec, aux, alpha=0.3, epoch=0, seed=42,
                  what=""):
    """One whole batch on both stacks from ``jstate``'s weights, from second
    moments of :data:`NU0` (:func:`compare_whole_batch`: the six losses
    and every leaf within the larger of :data:`BATCH_ATOL` and twice the
    batch's 1e-7 perturbation spread).  For the protocols that take no
    steps in sequence (fused, joint), where there is no step to take
    alone.  Returns the JAX batch's new state and losses and the port's
    losses."""
    jstate = _with_nu0(jstate, tstate)
    rng = jax.random.PRNGKey(seed)
    step = jax.jit(jtr._train_batch)
    args = (jnp.asarray(spec), jnp.asarray(aux), jnp.float32(alpha), jnp.int32(epoch), rng)

    def run_jax(state):
        new_state, losses = step(state, *args)
        return {}, new_state, losses

    def port_batch(state):
        return _port_batch(jtr, state, ttr, tstate if state is jstate else ttr.init_state(0),
                           spec, aux, alpha, epoch, rng)

    _, new_jstate, jlosses, tlosses = compare_whole_batch(
        run_jax, jstate, port_batch, what or f"{jtr.cfg.protocol}, {jtr.cfg.ae_form}")
    return new_jstate, jlosses, tlosses


def compare_batch_by_steps(jtr, jstate, ttr, tstate, spec, aux, alpha=0.3, epoch=0, seed=42):
    """One batch on both stacks, whole and each step from identical inputs.

    The whole batch runs on both from ``jstate``'s weights
    (:func:`compare_whole_batch`: the six losses and every leaf after it,
    within the larger of :data:`BATCH_ATOL` and twice the batch's 1e-7
    perturbation spread).  Then every optimizer step runs on the port alone
    from the JAX package's inputs to it (:func:`compare_step_alone`), and
    so do the stats-only forwards between two steps (the non-GRL branch's
    first encode and decode, the dead re-encode before the mutual-info
    step), each held to :data:`BATCH_ATOL`: float32 rounding that one step
    amplifies (a Kendall pair that flips, the mutual-info step) is not
    carried into the next, as it is when the steps run in sequence.
    Returns the changes of every element of the autoencoder's weight
    matrices and kernels over the JAX batch, the port's losses of the whole
    batch and the number of leaves held after each step."""
    jstate = _with_nu0(jstate, tstate)
    rng = jax.random.PRNGKey(seed)
    run_jax = jax_batch_runner(jtr, spec, aux, alpha, epoch, rng)

    def port_batch(state):
        # the unperturbed run on ``tstate``, which the steps below go on from
        return _port_batch(jtr, state, ttr, tstate if state is jstate else ttr.init_state(0),
                           spec, aux, alpha, epoch, rng)

    records, new_jstate, _, tlosses = compare_whole_batch(
        run_jax, jstate, port_batch, f"{jtr.cfg.ae_form}, B {spec.shape[0]}")

    def arr(free, key):
        return torch.tensor(np.asarray(free[key]))[None]

    enc, dec = ttr.models["enc"], ttr.models["dec"]
    b = spec.shape[0]
    steps = {
        "adversarial": lambda free: ttr._adversarial_step(
            tstate, arr(free, "spec_in"), arr(free, "z_real"), ttr._beta(alpha), None),
        "discriminator": lambda free: ttr._discriminator_step(
            tstate, arr(free, "spec_in"), arr(free, "z_real"), None),
        "generator": lambda free: ttr._generator_step(tstate, arr(free, "spec_in"), None),
        "correlation": lambda free: ttr._correlation_step(
            tstate, arr(free, "spec_in"), arr(free, "aux"), None),
        "reconstruction": lambda free: ttr._reconstruction_step(
            tstate, arr(free, "spec_in"), None),
        "mutual_info": lambda free: ttr._mutual_info_step(
            tstate, b, FixedDraws({"z_sample": np.asarray(free["z_sample"])[None]})),
        "smoothness": lambda free: ttr._smoothness_step(tstate, arr(free, "spec_in"), None),
    }
    if "discriminator" in records:          # the non-GRL branch's first encode and decode
        spec_in = arr(records["discriminator"]["free"], "spec_in")
        _compare_forward_alone(ttr, jstate.params, jstate.batch_stats,
                               lambda: dec(enc(spec_in)), records["discriminator"]["stats"],
                               "the first encode and decode")
    n_checked = 0
    for name in steps:
        if name == "mutual_info":           # the dead re-encode before it
            out = records["reconstruction"]["out"]
            spec_in = arr(records["reconstruction"]["free"], "spec_in")
            _compare_forward_alone(ttr, out[1], out[2], lambda: enc(spec_in),
                                   records["mutual_info"]["stats"], "the dead re-encode")
        if name in records:
            n_checked = compare_step_alone(ttr, tstate, name, records[name], steps[name])
    old = _flat({"params": jstate.params})
    ref = _flat({"params": new_jstate.params})
    return np.concatenate([np.abs(value - old[name]).ravel() for name, value in ref.items()
                           if name.startswith(("['params']['enc']", "['params']['dec']"))
                           if value.ndim >= 2]), tlosses, n_checked


def batch_draws(cfg, rng, b):
    """The draws of one JAX batch of ``b`` rows from the batch key ``rng``,
    each with a trial axis of 1: keys 0, 1 and 12 of ``split(rng, 17)``
    under the faithful protocol (``trainer.py:315-319,335,387,462``), keys
    0, 1 and 2 of ``split(rng, 9)`` under fused and joint (``:552-558``,
    ``:787-791``)."""
    faithful = cfg.protocol == "faithful"
    keys = jax.random.split(rng, 17 if faithful else 9)
    return {"spec_noise": np.asarray(jax.random.normal(keys[0], (b, cfg.dim_in)))[None],
            "z_real": np.asarray(jax.random.normal(keys[1], (cfg.batch_size, cfg.nstyle)))[None],
            "z_sample": np.asarray(jax.random.normal(keys[12 if faithful else 2],
                                                     (b, cfg.nstyle)))[None]}


def validate_draws(cfg, rng, n_val):
    """The draws of a JAX validation from its key ``rng``
    (``trainer.py:869,886-913``), each with a trial axis of 1."""
    k1, k2 = jax.random.split(rng)
    n_real = cfg.batch_size if cfg.gradient_reversal else n_val
    return {"z_val": np.asarray(jax.random.normal(k1, (n_val, cfg.nstyle)))[None],
            "z_real_val": np.asarray(jax.random.normal(k2, (n_real, cfg.nstyle)))[None]}


def compare_validate(jtr, jstate, ttr, tstate, spec, aux, alpha=0.25, seed=7):
    """``_validate`` on both stacks from ``jstate``'s weights (loaded into
    the port's modules here), on ``spec``/``aux`` as the validation split;
    asserts the latent and every validation loss.  Returns the port's."""
    load_jax_weights(ttr, jstate)
    cfg = jtr.cfg
    rng = jax.random.PRNGKey(seed)
    jdata = JaxTrialData(*(jnp.asarray(a) for a in (spec, aux, spec, aux)))
    z_ref, ref = jtr._validate(jstate, jdata, jnp.float32(alpha), rng)
    sampler = FixedDraws(validate_draws(cfg, rng, jtr.n_val))
    tdata = TrialData(*(torch.tensor(a) for a in (spec, aux, spec, aux)))
    z, got = ttr._validate(tstate, tdata, alpha, sampler)
    assert not sampler.draws
    np.testing.assert_allclose(z[0].numpy(), np.asarray(z_ref), atol=VAL_ATOL)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].item(), float(value), atol=VAL_ATOL, err_msg=name)
    return got


def epoch_draws(jtr, rng, epoch):
    """Every draw of one JAX ``epoch_step`` of a state whose key is ``rng``
    (``trainer.py:938-964``): the epoch's permutation from
    ``fold_in(rng, epoch)``, each batch's draws from
    ``fold_in(k_epoch, 1000 + i)`` and the validation's from the split's
    second key; each with a trial axis of 1, as :class:`FixedDraws` takes
    them."""
    cfg = jtr.cfg
    k_epoch = jax.random.fold_in(rng, epoch)
    k_perm, k_val = jax.random.split(k_epoch)
    draws = {"permutation": [np.asarray(jax.random.permutation(k_perm, jtr.n_train))[None]]}
    for i, start in enumerate(range(0, jtr.n_train, cfg.batch_size)):
        b = min(cfg.batch_size, jtr.n_train - start)
        for k, v in batch_draws(cfg, jax.random.fold_in(k_epoch, 1000 + i), b).items():
            draws.setdefault(k, []).append(v)
    for k, v in validate_draws(cfg, k_val, jtr.n_val).items():
        draws[k] = [v]
    return draws


def start_from_jax(jtr, jstate, ttr, tstate, trial=0):
    """Both stacks from ``jstate``'s weights (loaded into trial ``trial`` of
    the port's modules, the trackers' snapshots retaken) and second moments
    of :data:`NU0`; returns the JAX state."""
    load_jax_weights(ttr, jstate, trial)
    tstate.best_state = ttr._snapshot()
    tstate.best_recon_state = ttr._snapshot()
    return _with_nu0(jstate, tstate)


def compare_epoch(jlog, jstate, ttr, tlog, tstate, trial=0, atol=BATCH_ATOL):
    """One epoch's results of trial ``trial`` of the port against the JAX
    epoch's (``jlog``/``jstate`` of one trial): every log key, both
    trackers, the plateau states, and every leaf of the weights and of both
    trackers' snapshots.  Returns the largest difference seen."""
    worst = 0.0

    def close(got, ref, what):
        nonlocal worst
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        assert got.shape == ref.shape, (what, got.shape, ref.shape)
        if got.size:
            worst = max(worst, float(np.abs(got - ref).max()))
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=what)

    assert sorted(tlog) == sorted(jlog)
    assert tlog["epoch"] == int(jlog["epoch"])
    for k in tlog:
        if k != "epoch":
            close(tlog[k][trial].numpy(), jlog[k], f"log {k}")
    for k in ("best_epoch", "best_combined", "faithful_best", "best_recon_epoch", "best_recon"):
        close(getattr(tstate, k)[trial].numpy(), getattr(jstate, k), k)
    for name, sched in tstate.sched.items():
        for field in ("lr", "best", "num_bad"):
            close(getattr(sched, field)[trial].numpy(), getattr(jstate.sched[name], field),
                  f"sched {name} {field}")
    for snapshot, params, stats in ((None, jstate.params, jstate.batch_stats),
                                    (tstate.best_state, jstate.best_params,
                                     jstate.best_batch_stats),
                                    (tstate.best_recon_state, jstate.best_recon_params,
                                     jstate.best_recon_batch_stats)):
        tparams, tstats = ttr.export(trial, snapshot)
        got = _flat({"params": tparams, "stats": tstats})
        ref = _flat({"params": params, "stats": stats})
        assert sorted(got) == sorted(ref)
        for name, value in ref.items():
            close(got[name], value, name)
    return worst
