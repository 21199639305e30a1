"""Model registry (counterpart of ``rankaae_tpu/models/registry.py``).

Every form the config schema accepts (FC, ``normal``, ``compact``,
``qved``) and both discriminators.  With ``trials=T`` the builders return
the trainer's modules, stacked T times over (T, B, ...); without, the
single-trial modules that serving and the bundles use.  The modules
compute in the config's ``activation_dtype``, and the conv forms take the
config's ``remat`` (``rankaae_tpu/models/registry.py:22-36``; the FC and
qved forms have no block for it).  :class:`DualAAE` is the reference's
``DummyDualAAE``: an encoder, a decoder and a discriminator behind one
forward.
"""
from __future__ import annotations

from typing import Mapping, Optional

from torch import nn

from rankaae_tpu_torch.models.decoders import (
    CompactDecoder,
    Decoder,
    FCDecoder,
    QvecDecoder,
    TrialCompactDecoder,
    TrialDecoder,
    TrialFCDecoder,
    TrialQvecDecoder,
)
from rankaae_tpu_torch.models.discriminators import (
    DiscriminatorCNN,
    DiscriminatorFC,
    TrialDiscriminatorCNN,
    TrialDiscriminatorFC,
)
from rankaae_tpu_torch.models.encoders import (
    CompactEncoder,
    Encoder,
    FCEncoder,
    QvecEncoder,
    TrialCompactEncoder,
    TrialEncoder,
    TrialFCEncoder,
    TrialQvecEncoder,
)
from rankaae_tpu_torch.models.primitives import set_activation_dtype
from rankaae_tpu_torch.utils.device import resolve_device
from rankaae_tpu_torch.utils.weights import from_jax_variables

#: the forms whose encoder and decoder take ``remat``
REMAT_FORMS = ("normal", "compact")

#: every form the config schema accepts -> ((encoder, stacked encoder),
#: (decoder, stacked decoder))
AE_FORMS = {
    "FC": ((FCEncoder, TrialFCEncoder), (FCDecoder, TrialFCDecoder)),
    "normal": ((Encoder, TrialEncoder), (Decoder, TrialDecoder)),
    "compact": ((CompactEncoder, TrialCompactEncoder), (CompactDecoder, TrialCompactDecoder)),
    "qved": ((QvecEncoder, TrialQvecEncoder), (QvecDecoder, TrialQvecDecoder)),
}


def _build(classes, trials: Optional[int], **kw):
    single, stacked = classes
    return single(**kw) if trials is None else stacked(trials, **kw)


def build_autoencoder(cfg, trials: Optional[int] = None):
    """Instantiate (encoder, decoder) modules from a TrainConfig: the
    single-trial modules, or with ``trials`` the trainer's (T, B, ...)
    modules, computing in the config's ``activation_dtype``, the conv forms
    under the config's ``remat``."""
    enc, dec = AE_FORMS[cfg.ae_form]
    dtype = cfg.activation_dtype
    kw = {"remat": cfg.remat} if cfg.ae_form in REMAT_FORMS else {}
    return (set_activation_dtype(_build(enc, trials, nstyle=cfg.nstyle,
                                        dropout_rate=cfg.dropout_rate, dim_in=cfg.dim_in,
                                        n_layers=cfg.n_layers, **kw), dtype),
            set_activation_dtype(_build(dec, trials, nstyle=cfg.nstyle,
                                        dropout_rate=cfg.dropout_rate, dim_out=cfg.dim_out,
                                        last_layer_activation=cfg.decoder_activation,
                                        n_layers=cfg.n_layers, **kw), dtype))


def build_discriminator(cfg, trials: Optional[int] = None):
    """Instantiate the discriminator (reference ``trainer.py:455-463``): the
    single-trial module, or with ``trials`` the trainer's, computing in the
    config's ``activation_dtype``."""
    if cfg.use_cnn_discriminator:
        dis = _build((DiscriminatorCNN, TrialDiscriminatorCNN), trials, nstyle=cfg.nstyle,
                     dropout_rate=cfg.dis_dropout_rate, noise=cfg.dis_noise)
    else:
        dis = _build((DiscriminatorFC, TrialDiscriminatorFC), trials, nstyle=cfg.nstyle,
                     dropout_rate=cfg.dis_dropout_rate, noise=cfg.dis_noise,
                     layers=cfg.FC_discriminator_layers)
    return set_activation_dtype(dis, cfg.activation_dtype)


class DualAAE(nn.Module):
    """Encoder + decoder + discriminator behind one forward, the reference's
    ``DummyDualAAE`` (``sc/clustering/model.py:665-676``;
    ``rankaae_tpu/models/registry.py:55-84``): ``cls_encoder()``,
    ``cls_decoder()`` and a default ``DiscriminatorCNN()`` or
    ``DiscriminatorFC()``, on ``device`` (default ``"cuda"``; raises if no
    CUDA device is present), in eval mode as the JAX ``apply`` runs them.
    ``forward(x)`` returns (reconstruction, the discriminator's output on
    the latent at beta 0.3).  On the card the conv decoders' eval-mode
    stride-1 blocks run as the K3 kernel."""

    def __init__(self, use_cnn_dis: bool, cls_encoder, cls_decoder, device=None):
        super().__init__()
        self.encoder = cls_encoder()
        self.decoder = cls_decoder()
        self.discriminator = DiscriminatorCNN() if use_cnn_dis else DiscriminatorFC()
        self.to(resolve_device(device)).eval()

    def load_jax(self, variables: Mapping) -> "DualAAE":
        """Load the JAX ``DualAAE``'s variables ``{"enc", "dec", "dis"}``
        (``utils/weights.py::from_jax_variables``)."""
        sds = from_jax_variables(variables)
        for role, m in (("enc", self.encoder), ("dec", self.decoder),
                        ("dis", self.discriminator)):
            m.load_state_dict(sds[role])
        return self

    def forward(self, x, sampler=None):
        z = self.encoder(x, sampler)
        return self.decoder(z, sampler), self.discriminator(z, 0.3, sampler)
