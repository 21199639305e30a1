"""The models: every form's encoder and decoder (FC, normal, compact, qved),
both discriminators, single and stacked on a trial axis, the registry and
``DualAAE``; ``InferenceModel`` is in ``models/inference.py``."""
from rankaae_tpu_torch.models.registry import (  # noqa: F401
    AE_FORMS,
    DualAAE,
    build_autoencoder,
    build_discriminator,
)
from rankaae_tpu_torch.models.encoders import (  # noqa: F401
    CompactEncoder,
    Encoder,
    FCEncoder,
    QvecEncoder,
)
from rankaae_tpu_torch.models.decoders import (  # noqa: F401
    CompactDecoder,
    Decoder,
    FCDecoder,
    QvecDecoder,
)
from rankaae_tpu_torch.models.discriminators import DiscriminatorCNN, DiscriminatorFC  # noqa: F401
from rankaae_tpu_torch.models.grl import grad_reverse  # noqa: F401
