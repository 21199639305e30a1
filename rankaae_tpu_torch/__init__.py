"""rankaae_tpu_torch — the PyTorch/CUDA port of ``rankaae_tpu``.

Rank-constrained adversarial autoencoders over XANES spectra, trained and
served on an NVIDIA H100.  The module layout and the public names mirror
``rankaae_tpu`` name for name, so each module's counterpart sits at the same
path in the JAX package, which stays the reference this package is tested
against.

* models are ``nn.Module``s, every form stacked on a trial axis for
  training; the training protocol runs eagerly, its per-batch and
  per-epoch loops are plain Python loops (``RankAAETrainer.run``);
* the O(B^2) Kendall rank-correlation loss runs as a pair of CUDA kernels
  written for ``sm_90a`` (``ops/kendall_cuda.py``, ``csrc/kendall.cu``);
* the conv decoders' eval-mode stride-1 blocks run as one fused CUDA
  kernel (``ops/fused_block_cuda.py``, ``csrc/fused_block.cu``); bundles,
  ``InferenceModel`` and ``serve.py`` serve the trained models;
* several trials train at once on one card, or over processes and cards
  (``run_trials``, ``cli/train_sc.py``), and the report ranks them;
* entry points take an explicit ``device`` and default to ``"cuda"``.

``RankAAETrainer``, ``run_trials`` and ``InferenceModel`` are served from
here lazily, so ``import rankaae_tpu_torch`` stays light.  This package
imports nothing of ``jax``, ``rankaae_tpu`` or ``msgpack``.
"""

__version__ = "0.1.0"

from rankaae_tpu_torch.utils.config import Parameters, TrainConfig  # noqa: F401


def __getattr__(name):
    # lazy heavyweight imports (``rankaae_tpu/__init__.py:25-39``)
    if name == "RankAAETrainer":
        from rankaae_tpu_torch.train.trainer import RankAAETrainer

        return RankAAETrainer
    if name == "run_trials":
        from rankaae_tpu_torch.parallel.trials import run_trials

        return run_trials
    if name == "InferenceModel":
        from rankaae_tpu_torch.models.inference import InferenceModel

        return InferenceModel
    raise AttributeError(f"module 'rankaae_tpu_torch' has no attribute {name!r}")
