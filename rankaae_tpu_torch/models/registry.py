"""Model registry (counterpart of ``rankaae_tpu/models/registry.py``).

Only the FC form is ported so far; the conv forms (``normal``,
``compact``), ``qved`` and ``DiscriminatorCNN`` raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from rankaae_tpu_torch.models.decoders import FCDecoder
from rankaae_tpu_torch.models.discriminators import DiscriminatorFC
from rankaae_tpu_torch.models.encoders import FCEncoder

#: every form the config schema accepts -> ROADMAP item that ports it
#: (None = ported)
AE_FORMS = {
    "FC": None,
    "normal": "queue 1, item 11 (conv forms)",
    "compact": "queue 1, item 11 (conv forms)",
    "qved": "queue 1, item 12 (qved form)",
}


def build_autoencoder(cfg):
    """Instantiate (encoder, decoder) modules from a TrainConfig."""
    todo = AE_FORMS[cfg.ae_form]
    if todo is not None:
        raise NotImplementedError(
            f"ae_form {cfg.ae_form!r} is not ported yet: ROADMAP {todo}")
    encoder = FCEncoder(nstyle=cfg.nstyle, dropout_rate=cfg.dropout_rate,
                        dim_in=cfg.dim_in, n_layers=cfg.n_layers)
    decoder = FCDecoder(nstyle=cfg.nstyle, dropout_rate=cfg.dropout_rate,
                        dim_out=cfg.dim_out,
                        last_layer_activation=cfg.decoder_activation,
                        n_layers=cfg.n_layers)
    return encoder, decoder


def build_discriminator(cfg):
    """Instantiate the discriminator (reference ``trainer.py:455-463``)."""
    if cfg.use_cnn_discriminator:
        raise NotImplementedError(
            "DiscriminatorCNN is not ported yet: ROADMAP queue 1, item 11 (conv forms)")
    return DiscriminatorFC(nstyle=cfg.nstyle, dropout_rate=cfg.dis_dropout_rate,
                           noise=cfg.dis_noise, layers=cfg.FC_discriminator_layers)
