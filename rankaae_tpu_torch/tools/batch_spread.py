"""How well-conditioned one training batch is, on the CPU.

    python -m rankaae_tpu_torch.tools.batch_spread [--ae-form normal]
        [--cnn-discriminator] [--batch-size 1024] [--lr-base 1e-3] [--samples 3]
        [--perturb weights|inputs]

Runs one ``_train_batch`` of ``example/fix_config.yaml`` (with the
given overrides, dropout and discriminator noise at 0) from seeded weights
and fixed draws, then again ``--samples`` times from the same weights each
multiplied by (1 + 1e-7 N(0, 1)) (``--perturb inputs``: from the same
weights, with each input element so multiplied instead), and prints one
JSON object: per loss, and
over the parameter and running-statistic leaves after the batch, the largest
difference any perturbed run shows from the unperturbed one (max |diff| and
the largest per-leaf |diff| / |leaf|, Frobenius).  A perturbation of 1e-7 is
float32 rounding, so no comparison of this batch across two devices or two
stacks can hold tighter than these spreads.  The input perturbation
reaches what the weight perturbation does not: a loss that divides by a
sum of inputs near 0 (the flex target's input means).  :func:`batch_spread`
also takes the relative size (``perturbation``: 2^-9, half a bfloat16
unit, for a config with bfloat16 activations) and any config, whose
``protocol``, ``flat_optim`` and ``activation_dtype`` apply.  Runs on the
CPU only.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
from rankaae_tpu_torch.train.trainer import RankAAETrainer
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import FixedDraws

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PERTURBATION = 1e-7


def one_batch(cfg: TrainConfig, spec, aux, draws, perturb_seed=None, perturb="weights",
              perturbation: float = PERTURBATION):
    """Losses and state dicts after one batch from the weights of seed 0,
    the weights (or, ``perturb="inputs"``, the inputs ``spec``) perturbed
    by ``perturbation`` relative with ``perturb_seed`` unless it is None.
    Every optimizer's second moments start at 1e-8 (see
    ``tests/torch_parity.py``)."""
    tr = RankAAETrainer(cfg, n_train=spec.shape[0], n_val=spec.shape[0], device="cpu")
    state = tr.init_state(0)
    spec = torch.tensor(spec)
    if perturb_seed is not None:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            targets = ([spec] if perturb == "inputs" else
                       [p for m in tr.models.values() for p in m.parameters()])
            for p in targets:
                p.mul_(1 + perturbation * torch.randn(p.shape, generator=gen))
    for o in state.opt.values():
        for v in o.nu:
            v.fill_(1e-8)
    _, losses = tr._train_batch(state, spec[None], torch.tensor(aux)[None], 0.3,
                                0, FixedDraws({k: v[None] for k, v in draws.items()}))
    return ({k: v.item() for k, v in losses.items()},
            {f"{k}.{n}": t.detach().clone() for k, m in tr.models.items()
             for n, t in m.state_dict().items() if t.is_floating_point()})


def batch_spread(cfg: TrainConfig, batch_size: int, samples: int = 3, data=None,
                 perturb: str = "weights", perturbation: float = PERTURBATION) -> dict:
    """The spreads of one batch of ``data`` ((spec, aux), default the
    synthetic spectra of seed 11) under a perturbation of the weights or
    the inputs (``perturb``), as the module docstring says."""
    if perturb not in ("weights", "inputs"):
        raise ValueError(f"perturb must be 'weights' or 'inputs', not {perturb!r}")
    if data is None:
        aux, spec, _ = make_synthetic_xanes(n_rows=batch_size, dim=cfg.dim_in, seed=11)
    else:
        spec, aux = data
    rng = np.random.default_rng(12)
    draws = {"spec_noise": rng.normal(size=spec.shape).astype(np.float32),
             "z_real": rng.normal(size=(cfg.batch_size, cfg.nstyle)).astype(np.float32),
             "z_sample": rng.normal(size=(batch_size, cfg.nstyle)).astype(np.float32)}
    spec, aux = spec.astype(np.float32), aux.astype(np.float32)
    base_losses, base_leaves = one_batch(cfg, spec, aux, draws)
    loss_spread = {k: 0.0 for k in base_losses}
    leaf = {kind: {"max_abs": 0.0, "max_rel": 0.0} for kind in ("params", "stats")}
    params = {f"{k}.{n}" for k, m in RankAAETrainer(cfg, 1, 1, device="cpu").models.items()
              for n, _ in m.named_parameters()}
    for s in range(samples):
        losses, leaves = one_batch(cfg, spec, aux, draws, perturb_seed=s + 1, perturb=perturb,
                                   perturbation=perturbation)
        for k in losses:
            loss_spread[k] = max(loss_spread[k], abs(losses[k] - base_losses[k]))
        for name, ref in base_leaves.items():
            d = (leaves[name] - ref).abs()
            entry = leaf["params" if name in params else "stats"]
            entry["max_abs"] = max(entry["max_abs"], d.max().item())
            entry["max_rel"] = max(entry["max_rel"], (d.norm() / ref.norm()).item())
    return {"ae_form": cfg.ae_form, "use_cnn_discriminator": cfg.use_cnn_discriminator,
            "batch_size": batch_size, "lr_base": cfg.lr_base, "samples": samples,
            "protocol": cfg.protocol, "activation_dtype": cfg.activation_dtype,
            "perturbation": perturbation, "perturb": perturb, "losses": loss_spread,
            "leaves": leaf}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ae-form", default="normal", choices=("FC", "normal", "compact"))
    ap.add_argument("--cnn-discriminator", action="store_true")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--lr-base", type=float, default=None,
                    help="override the config's lr_base")
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--perturb", default="weights", choices=("weights", "inputs"))
    args = ap.parse_args()
    cfg = TrainConfig.from_yaml(os.path.join(REPO, "example", "fix_config.yaml")).replace(
        ae_form=args.ae_form, use_cnn_discriminator=args.cnn_discriminator,
        batch_size=args.batch_size, dropout_rate=0.0, dis_dropout_rate=0.0, dis_noise=0.0)
    if args.lr_base is not None:
        cfg = cfg.replace(lr_base=args.lr_base)
    print(json.dumps(batch_spread(cfg, args.batch_size, args.samples, perturb=args.perturb)))


if __name__ == "__main__":
    main()
