"""Losses, statistics, and the Kendall rank-correlation loss with its CUDA
kernel pair (``kendall_constraint``: the kernels on a CUDA tensor, the plain
loss on a CPU one); the fused conv block kernel is ``ops/fused_block_cuda``."""
from rankaae_tpu_torch.ops.losses import (  # noqa: F401
    adversarial_loss,
    alpha_schedule,
    discriminator_loss,
    generator_loss,
    mutual_info_loss,
    recon_loss,
    smoothness_loss,
)
from rankaae_tpu_torch.ops.kendall_cuda import kendall_constraint  # noqa: F401
from rankaae_tpu_torch.ops.stats import (  # noqa: F401
    max_interstyle_spearman,
    shapiro_w,
    spearman_rho,
)
