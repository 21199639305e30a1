"""Model registry (counterpart of ``rankaae_tpu/models/registry.py``).

The FC and conv (``normal``, ``compact``) forms and both discriminators are
ported; ``qved`` raises ``NotImplementedError`` naming the ROADMAP item
that ports it.

With ``trials=T`` the builders return modules over (T, B, ...) for the
trainer: the stacked FC modules for ``ae_form: FC`` and the FC
discriminator, and for the forms not stacked yet (the conv forms, the CNN
discriminator) today's module behind :class:`Unstacked`, at T = 1.
Without ``trials`` they return the single-trial modules that serving and
the bundles use.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from rankaae_tpu_torch.models.decoders import CompactDecoder, Decoder, FCDecoder, TrialFCDecoder
from rankaae_tpu_torch.models.discriminators import (
    DiscriminatorCNN,
    DiscriminatorFC,
    TrialDiscriminatorFC,
)
from rankaae_tpu_torch.models.encoders import CompactEncoder, Encoder, FCEncoder, TrialFCEncoder

#: every form the config schema accepts -> (encoder, decoder) classes, or the
#: ROADMAP item that ports it
AE_FORMS = {
    "FC": (FCEncoder, FCDecoder),
    "normal": (Encoder, Decoder),
    "compact": (CompactEncoder, CompactDecoder),
    "qved": "queue 1, item 6 (qved form)",
}


def stacks_trials(cfg) -> bool:
    """Whether the config's modules stack trials (FC form, FC
    discriminator); the other forms train one trial at a time."""
    return cfg.ae_form == "FC" and not cfg.use_cnn_discriminator


class Unstacked(nn.Module):
    """A single-trial module behind the trial-axis interface, at T = 1:
    takes (1, B, ...), calls the module on (B, ...) with the sampler's
    trial 0 (and a per-trial ``beta`` of shape (1, 1, 1) as a 0-d tensor),
    and returns (1, ...)."""

    trials = 1

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x, *args, sampler=None):
        if x.shape[0] != 1:
            raise ValueError(f"{type(self.module).__name__} is not stacked on a trial "
                             f"axis: it takes one trial, got {x.shape[0]}")
        args = [a.reshape(()) if isinstance(a, torch.Tensor) else a for a in args]
        return self.module(x[0], *args,
                           sampler=None if sampler is None else sampler.trial(0))[None]

    def trial_state_dict(self, i: int, sd: Optional[Mapping[str, torch.Tensor]] = None
                         ) -> Dict[str, torch.Tensor]:
        assert i == 0, i
        sd = self.state_dict() if sd is None else sd
        return {k[len("module."):]: v for k, v in sd.items()}

    def load_trial_state_dict(self, i: int, sd: Mapping[str, torch.Tensor]) -> None:
        assert i == 0, i
        self.module.load_state_dict(sd)


def _check_unstacked(trials: int, what: str) -> None:
    if trials != 1:
        raise ValueError(f"{what} is not stacked on a trial axis yet (ROADMAP queue 1, "
                         f"item 1): train it with trials=1, got {trials}")


def build_autoencoder(cfg, trials: Optional[int] = None):
    """Instantiate (encoder, decoder) modules from a TrainConfig: the
    single-trial modules, or with ``trials`` the trainer's (T, B, ...)
    modules."""
    form = AE_FORMS[cfg.ae_form]
    if isinstance(form, str):
        raise NotImplementedError(
            f"ae_form {cfg.ae_form!r} is not ported yet: ROADMAP {form}")
    enc_kw = dict(nstyle=cfg.nstyle, dropout_rate=cfg.dropout_rate, dim_in=cfg.dim_in,
                  n_layers=cfg.n_layers)
    dec_kw = dict(nstyle=cfg.nstyle, dropout_rate=cfg.dropout_rate, dim_out=cfg.dim_out,
                  last_layer_activation=cfg.decoder_activation, n_layers=cfg.n_layers)
    if trials is not None and cfg.ae_form == "FC":
        return TrialFCEncoder(trials, **enc_kw), TrialFCDecoder(trials, **dec_kw)
    enc_cls, dec_cls = form
    encoder, decoder = enc_cls(**enc_kw), dec_cls(**dec_kw)
    if trials is None:
        return encoder, decoder
    _check_unstacked(trials, f"ae_form {cfg.ae_form!r}")
    return Unstacked(encoder), Unstacked(decoder)


def build_discriminator(cfg, trials: Optional[int] = None):
    """Instantiate the discriminator (reference ``trainer.py:455-463``): the
    single-trial module, or with ``trials`` the trainer's."""
    if cfg.use_cnn_discriminator:
        dis = DiscriminatorCNN(nstyle=cfg.nstyle, dropout_rate=cfg.dis_dropout_rate,
                               noise=cfg.dis_noise)
        if trials is None:
            return dis
        _check_unstacked(trials, "the CNN discriminator")
        return Unstacked(dis)
    kw = dict(nstyle=cfg.nstyle, dropout_rate=cfg.dis_dropout_rate, noise=cfg.dis_noise,
              layers=cfg.FC_discriminator_layers)
    return DiscriminatorFC(**kw) if trials is None else TrialDiscriminatorFC(trials, **kw)
