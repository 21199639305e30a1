"""Model registry (counterpart of ``rankaae_tpu/models/registry.py``).

The FC and conv (``normal``, ``compact``) forms and both discriminators are
ported; ``qved`` raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

from rankaae_tpu_torch.models.decoders import CompactDecoder, Decoder, FCDecoder
from rankaae_tpu_torch.models.discriminators import DiscriminatorCNN, DiscriminatorFC
from rankaae_tpu_torch.models.encoders import CompactEncoder, Encoder, FCEncoder

#: every form the config schema accepts -> (encoder, decoder) classes, or the
#: ROADMAP item that ports it
AE_FORMS = {
    "FC": (FCEncoder, FCDecoder),
    "normal": (Encoder, Decoder),
    "compact": (CompactEncoder, CompactDecoder),
    "qved": "queue 1, item 12 (qved form)",
}


def build_autoencoder(cfg):
    """Instantiate (encoder, decoder) modules from a TrainConfig."""
    form = AE_FORMS[cfg.ae_form]
    if isinstance(form, str):
        raise NotImplementedError(
            f"ae_form {cfg.ae_form!r} is not ported yet: ROADMAP {form}")
    enc_cls, dec_cls = form
    encoder = enc_cls(nstyle=cfg.nstyle, dropout_rate=cfg.dropout_rate,
                      dim_in=cfg.dim_in, n_layers=cfg.n_layers)
    decoder = dec_cls(nstyle=cfg.nstyle, dropout_rate=cfg.dropout_rate,
                      dim_out=cfg.dim_out,
                      last_layer_activation=cfg.decoder_activation,
                      n_layers=cfg.n_layers)
    return encoder, decoder


def build_discriminator(cfg):
    """Instantiate the discriminator (reference ``trainer.py:455-463``)."""
    if cfg.use_cnn_discriminator:
        return DiscriminatorCNN(nstyle=cfg.nstyle, dropout_rate=cfg.dis_dropout_rate,
                                noise=cfg.dis_noise)
    return DiscriminatorFC(nstyle=cfg.nstyle, dropout_rate=cfg.dis_dropout_rate,
                           noise=cfg.dis_noise, layers=cfg.FC_discriminator_layers)
