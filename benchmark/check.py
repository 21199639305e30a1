"""What decides ``correct``: the program's first epoch, recorded as it runs,
against the plain reference run afterwards: the protocol of
:mod:`benchmark.reference` with the model module that the cell's
configuration names (``benchmark/models/conv.py`` for the conv forms).

The set-up's warm-up epoch is the check's epoch.  It runs through the
window's own call (``RankAAETrainer.epoch_step``) on the window's data and
state, with a :class:`Recorder` installed on the trainer object.  For the
checked trials (a few of the T, drawn from the seed) it keeps on the host
the random draws the program makes in the first and the last batch and in
the validation (its own sampler's numbers, passed through unchanged), and,
around each of those batches' five optimizer steps, the weights and
statistics, the stepping optimizer's moments and the step's loss; then the
epoch's validation log.

Once the window has closed and the program is freed, the reference runs on
the same rows (the benchmark's own data, gathered by the program's
permutation) with the same draws:

* from the initial weights (made by the benchmark from the seed) through
  the first three steps of batch 1, as the program ran them;
* each of the five steps of batch 1 and of the last batch (B 804, the
  trailing one) from the program's state before that step: AdamW's first
  step from zero moments is sign(gradient) * lr, so a leaf whose gradient
  is rounding noise takes a full step either way, and runs that part by
  one rounding part by a full step after it; each step is therefore
  followed from the state the program had, and its loss, gradient, update
  and statistics compared;
* the validation pass and its five quality metrics from the weights and
  statistics that entered the program's validation.

The numbers compared (:data:`NUMBERS`), each against its limit (the
cell's configuration file holds them; ``PERF.md`` gives the readings of
sound runs, controls and faults they were set from):

* ``loss``: the largest gap of a step's loss, over the larger of the
  reference's loss and :data:`SCALE_FLOOR`: each step from the program's
  state, and the first two from the initial weights (the third's,
  ``loss3_from_start``, is printed and not compared: it follows the
  Kendall step's first AdamW update, whose rounding-set signs move it by up
  to half a percent);
* ``grad``: each step's gradient (from the stepping optimizer's first
  moments before and after it), by the median leaf: the gap between the
  program's and the reference's norm of a leaf's gradient over the larger
  of the reference's norm and the median leaf's, the median over the
  leaves.  The worst leaf's (``grad_worst_leaf``) is printed beside it and
  not compared: the PReLU slopes and biases whose effect the next
  BatchNorm nearly takes out have gradients that are small remainders of
  large sums, off by up to a tenth in float32 (PERF.md gives the look);
* ``change``: the change of the parameters over each step and over the
  first three from the initial weights, by the median leaf as ``grad``,
  leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's; and so of the BatchNorm statistics.  The worst
  leaf's gap (``change_worst_leaf``, ``change3_worst_leaf``) is printed
  beside it and not compared: several leaves here have gradients a few
  thousandths of the median leaf's (biases whose shift the next BatchNorm
  takes out, but for a PReLU's kink), whose float32 rounding error is of
  their own size; AdamW scales every element's step to about lr, so those
  leaves step by rounding on either side;
* ``val``: the largest gap of the validation's losses, gain and quality
  metrics, over the larger of the reference's value and :data:`SCALE_FLOOR`;
  the combined metric's gap is over the size of its terms (the sum of each
  weighted metric's magnitude) where that is larger: it is a signed sum of
  terms near 1 that passes near 0 as training moves, and its rounding
  error is that of its terms, not of their sum;
* ``start``: the largest difference between the weights the program starts
  from and the benchmark's (0: they are copied);
* ``draws``: the checked trials whose draws are not sound (a permutation
  that is none, normal draws whose mean or variance is off 0 or 1 by more
  than six standard errors, keep-masks whose rate is).
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import reference as ref

NUMBERS = ("loss", "grad", "change", "val", "start", "draws")
#: read and printed beside them, not compared (PERF.md says why)
READINGS = ("loss3_from_start", "grad_worst_leaf", "change_worst_leaf", "change3_worst_leaf")
#: a loss or metric is held by its gap over the larger of its reference value
#: and this: the Kendall loss is a signed sum over pairs that passes near 0
#: as the styles reorder, where a relative gap says nothing
SCALE_FLOOR = 0.01
#: a parameter leaf whose reference gradient is under this share of the
#: median leaf's is left out of ``change``
NULL_GRADIENT = 1e-3
STEP_OPT = {step: opt for step, opt, _ in ref.STEPS}
STATS = ("running_mean", "running_var")


def _host(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.detach().index_select(0, idx).cpu()


class DrawTap:
    """The program's sampler, unchanged, with every draw's checked-trial
    slices handed to ``sink`` as it is made."""

    def __init__(self, inner, idx, sink):
        self._inner, self._idx, self._sink = inner, idx, sink

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def normal(self, name, shape):
        x = self._inner.normal(name, shape)
        self._sink(("normal", name, x))
        return x

    def keep_mask(self, shape, keep):
        m = self._inner.keep_mask(shape, keep)
        self._sink(("mask", float(keep), m))
        return m

    def permutation(self, n):
        p = self._inner.permutation(n)
        self._sink(("perm", None, p))
        return p


class Recorder:
    """Installed on a trainer and its state for one epoch (see the module
    docstring); :meth:`remove` puts the trainer's own calls and sampler
    back."""

    def __init__(self, trainer, state, trials: List[int]):
        self.trainer, self.state = trainer, state
        self.trials = list(trials)
        self.idx = torch.tensor(self.trials, device=trainer.device)
        self.checked = {1, trainer.n_batch}
        self.batch = 0
        self.head, self.val = [], []
        self.current = self.head
        self.batches: Dict[int, dict] = {}
        self.batch_mi = []
        self.sampler = state.sampler
        state.sampler = DrawTap(self.sampler, self.idx, self._sink)
        self._calls = {"_train_batch": trainer._train_batch}
        trainer._train_batch = self._batch
        for step, _, _ in ref.STEPS:
            name = f"_{step}_step"
            self._calls[name] = getattr(trainer, name)
            setattr(trainer, name, self._wrap_step(step, self._calls[name]))

    def remove(self):
        self.state.sampler = self.sampler
        for name in self._calls:
            self.trainer.__dict__.pop(name, None)

    def _sink(self, record):
        if self.current is not None:
            kind, name, x = record
            self.current.append((kind, name, _host(x, self.idx)))

    def weights(self):
        return {role: {n: _host(t, self.idx) for n, t in m.state_dict().items()}
                for role, m in self.trainer.models.items()}

    def moments(self, opt):
        """Optimizer ``opt``'s (count, mu, nu) by leaf name, checked trials."""
        tr, o = self.trainer, self.state.opt[opt]
        names = [f"{key}.{n}" for key in tr._keys(opt) for n, _ in tr.models[key].named_parameters()]
        return (o.count, {n: _host(t, self.idx) for n, t in zip(names, o.mu)},
                {n: _host(t, self.idx) for n, t in zip(names, o.nu)})

    def _batch(self, state, spec, aux, alpha, epoch, sampler=None):
        self.batch += 1
        checked = self.batch in self.checked
        if checked:
            self.current = []
            self.batches[self.batch] = {"draws": self.current, "pos": [], "steps": {}}
        else:
            self.current = None
        state, losses = self._calls["_train_batch"](state, spec, aux, alpha, epoch, sampler)
        self.batch_mi.append(_host(losses["mi"], self.idx))
        self.current = self.val if self.batch == self.trainer.n_batch else None
        return state, losses

    def _wrap_step(self, step, call):
        def wrapped(*args, **kw):
            rec = self.batches.get(self.batch)
            if rec is None:
                return call(*args, **kw)
            opt = STEP_OPT[step]
            if not rec["pos"]:
                rec["pos"].append(len(rec["draws"]))
                rec["pre"] = self.weights()
            pre_m = self.moments(opt)
            loss = call(*args, **kw)
            rec["pos"].append(len(rec["draws"]))
            rec["steps"][step] = {"loss": _host(loss, self.idx), "pre_m": pre_m,
                                  "post_w": self.weights(), "post_mu": self.moments(opt)[1]}
            return loss
        return wrapped

    def finish(self, log, weights0):
        """Everything the reference needs, as host tensors: the records, the
        epoch's log and the benchmark's initial weights, checked trials."""
        keep = ("val_recon", "val_aux", "val_smooth", "val_mi", "val_dis", "val_gain",
                "metrics", "combined")
        return {"trials": self.trials, "n_batch": self.trainer.n_batch, "head": self.head,
                "val": self.val, "batches": self.batches, "batch_mi": self.batch_mi,
                "log": {k: _host(log[k], self.idx) for k in keep},
                "weights0": {role: {n: t.index_select(0, self.idx.to(t.device)).cpu()
                                    for n, t in sd.items()} for role, sd in weights0.items()}}


# --------------------------------------------------------------------------- #
# the reference's run and the numbers
# --------------------------------------------------------------------------- #

def _draws(records, j, device):
    return ref.Draws([(kind, name, value[j].to(device)) for kind, name, value in records])


def _trial(tree, j, device):
    return {role: {n: t[j].to(device) for n, t in sd.items()} for role, sd in tree.items()}


def _rel(a, b, scale=0.0):
    return abs(a - b) / max(abs(b), scale, SCALE_FLOOR)


def _norm_gap(prog: Dict[str, float], refn: Dict[str, float], at=(), median=False):
    """The worst leaf's |norm_prog - norm_ref| over the larger of its
    reference norm and the median leaf's (median over nonzero leaves), and
    ``at`` with that leaf, its two norms and the median; with ``median``,
    the median leaf's gap."""
    nonzero = [v for v in refn.values() if v > 0]
    med = float(np.median(nonzero)) if nonzero else 0.0
    gaps = []
    for n, r in refn.items():
        den, gap = max(r, med), abs(prog[n] - r)
        gaps.append((gap / den if den > 0 else (0.0 if gap == 0 else math.inf),
                     at + (n, prog[n], r, med)))
    if not gaps:
        return 0.0, at
    gaps.sort(key=lambda g: g[0])
    return gaps[(len(gaps) - 1) // 2] if median else gaps[-1]


def _moved(grads) -> set:
    """Leaves whose gradient is at least NULL_GRADIENT of the median leaf's."""
    norms = {n: float(g.double().norm()) for n, g in grads.items()}
    nonzero = [v for v in norms.values() if v > 0]
    med = float(np.median(nonzero)) if nonzero else 0.0
    return {n for n, v in norms.items() if med > 0 and v >= NULL_GRADIENT * med}


def _change_gap(before, prog_after, ref_after, params, at=(), median=False):
    """The worst (or with ``median`` the median) leaf's change gap over
    ``params`` (names ``role.leaf``), and so over the BatchNorm statistics
    that either side moved, and where it is."""
    gap, where = 0.0, at
    stats = [f"{r}.{n}" for r in before for n in before[r] if n.endswith(STATS)]
    for names in (sorted(params), stats):
        prog, refn = {}, {}
        for name in names:
            role, n = name.split(".", 1)
            p = float((prog_after[role][n] - before[role][n]).double().norm())
            r = float((ref_after[role][n].detach() - before[role][n]).double().norm())
            if p > 0 or r > 0:
                prog[name], refn[name] = p, r
        if refn:
            g, w = _norm_gap(prog, refn, at, median)
            if g >= gap:
                gap, where = g, w
    return gap, where


def _draws_sound(records, n_train) -> bool:
    normals = [v.float().reshape(-1) for kind, _, v in records if kind == "normal"]
    if normals:
        x = torch.cat(normals).double()
        se = 1.0 / math.sqrt(x.numel())
        if abs(float(x.mean())) > 6 * se or abs(float(x.var()) - 1.0) > 6 * math.sqrt(2) * se:
            return False
    for kind, keep, v in records:
        if kind == "mask":
            se = math.sqrt(keep * (1 - keep) / v.numel())
            if abs(float(v.float().mean()) - keep) > 6 * se:
                return False
        if kind == "perm" and not torch.equal(torch.sort(v.reshape(-1)).values,
                                              torch.arange(n_train)):
            return False
    return True


def run_reference(cfg, rec, data, epoch: int, device, where=None, *, model
                  ) -> Dict[str, float]:
    """The numbers of :data:`NUMBERS` for the recorded epoch ``rec``
    (:meth:`Recorder.finish`) of ``cfg`` on ``data`` (the benchmark's host
    arrays: train spectra, train descriptors, val spectra, val
    descriptors), the reference's model from the model module ``model``.
    ``where``, a dict, gets each number's worst place."""
    ref.float32_only()
    train_spec, train_aux, val_spec, val_aux = (torch.as_tensor(a, device=device) for a in data)
    b, n_batch = cfg["batch_size"], rec["n_batch"]
    out = {k: 0.0 for k in NUMBERS + READINGS}
    where = {} if where is None else where

    def worst(name, value, at):
        if value > out[name] or name not in where:
            where[name] = at
        out[name] = max(out[name], value)

    for j in range(len(rec["trials"])):
        w0 = _trial(rec["weights0"], j, device)
        first = _trial(rec["batches"][1]["pre"], j, device)
        worst("start", max(float((first[r][n] - w0[r][n]).abs().max())
                           for r in w0 for n in w0[r]), j)
        perm = [v[j] for kind, _, v in rec["head"] if kind == "perm"][0].to(device)
        records = rec["head"] + rec["val"] + [r for k in rec["batches"]
                                              for r in rec["batches"][k]["draws"]]
        if not _draws_sound([(kind, name, v[j]) for kind, name, v in records],
                            train_spec.shape[0]):
            worst("draws", out["draws"] + 1.0, j)

        def rows(k):
            i = perm[(k - 1) * b:k * b]
            return train_spec.index_select(0, i), train_aux.index_select(0, i)

        def loss_gap(k, step, value, at, name="loss"):
            prog = float(rec["batches"][k]["steps"][step]["loss"][j])
            worst(name, _rel(prog, value), (j, k, step, at, prog, value))

        # the first three steps of batch 1 from the initial weights
        batch = rec["batches"][1]
        spec, aux = rows(1)
        trial = ref.Trial(cfg, w0, device, model=model)
        draws = _draws(batch["draws"][:batch["pos"][3]], j, device)
        trial.begin(spec, draws)
        moved = set()
        for s, (step, _, _) in enumerate(ref.STEPS[:3]):
            value, grads = trial.step(step, aux, epoch, draws)
            loss_gap(1, step, value, "from the start", "loss" if s < 2 else "loss3_from_start")
            moved |= _moved(grads)
        after3 = _trial(batch["steps"]["reconstruction"]["post_w"], j, device)
        worst("change", *_change_gap(w0, after3, trial.w, moved,
                                     (j, 1, "first three steps, median leaf"), median=True))
        worst("change3_worst_leaf", *_change_gap(w0, after3, trial.w, moved,
                                                 (j, 1, "first three steps")))

        # every step of the first and the last batch from the program's state
        for k, batch in rec["batches"].items():
            spec, aux = rows(k)
            pre = _trial(batch["pre"], j, device)
            for s, (step, opt, _) in enumerate(ref.STEPS):
                post = batch["steps"][step]
                count, mu, nu = post["pre_m"]
                trial = ref.Trial(cfg, pre, device, {opt: (count, _pick(mu, j), _pick(nu, j))},
                                  model=model)
                draws = _draws(batch["draws"][:batch["pos"][0]]
                               + batch["draws"][batch["pos"][s]:batch["pos"][s + 1]], j, device)
                trial.begin(spec, draws)
                value, grads = trial.step(step, aux, epoch, draws)
                loss_gap(k, step, value, "from the program's state")
                b1 = ref.betas_of(cfg, opt)[0]
                prog = {n: float(((post["post_mu"][n][j] - b1 * mu[n][j]) / (1.0 - b1))
                                 .double().norm()) for n in grads}
                refn = {n: float(g.double().norm()) for n, g in grads.items()}
                worst("grad", *_norm_gap(prog, refn, (j, k, step, "median leaf"), median=True))
                worst("grad_worst_leaf", *_norm_gap(prog, refn, (j, k, step)))
                after = _trial(post["post_w"], j, device)
                moved = _moved(grads)
                worst("change", *_change_gap(pre, after, trial.w, moved, (j, k, step, "median leaf"),
                                             median=True))
                worst("change_worst_leaf", *_change_gap(pre, after, trial.w, moved, (j, k, step)))
                pre = after

        # the validation from the state that entered the program's
        last = rec["batches"][n_batch]["steps"]["smoothness"]["post_w"]
        trial = ref.Trial(cfg, _trial(last, j, device), device, model=model)
        avg_mi = float(np.mean([float(mi[j]) for mi in rec["batch_mi"]]))
        val = trial.validate(val_spec, val_aux, epoch, _draws(rec["val"], j, device), avg_mi)
        log = rec["log"]
        pairs = [(float(log[f"val_{k}"][j]), val[k])
                 for k in ("recon", "aux", "smooth", "mi", "dis", "gain")]
        pairs += list(zip(log["metrics"][j].tolist(), val["metrics"]))
        pairs.append((float(log["combined"][j]), val["combined"]))
        names = ["recon", "aux", "smooth", "mi", "dis", "gain", "shapiro", "recon_metric",
                 "avg_mi", "spearman", "aux_metric", "combined"]
        terms = float(np.abs(np.multiply(ref.METRIC_WEIGHTS, val["metrics"])).sum())
        gaps = [(_rel(p, r, terms if n == "combined" else 0.0), n, p, r)
                for n, (p, r) in zip(names, pairs)]
        top = max(gaps)
        worst("val", top[0], (j,) + top[1:])
    return out


def _pick(tree, j):
    return {n: t[j] for n, t in tree.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number within its limit (the cell's
    configuration file holds them), and the numbers beside their limits."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(numbers[k] is not None and numbers[k] <= limits[k] for k in NUMBERS), checks
