"""The sources of random draws for a training run.

``rankaae_tpu`` splits and folds ``jax.random`` keys; here every draw comes
from a seeded ``torch.Generator``, in program order.  A :class:`Sampler` is
one generator (one trial, for a single-trial module); a
:class:`TrialSampler` is one generator per trial, trial g of a run
with base seed s seeded with s + g, and draws each trial's slice from that
trial's generator.  So trial g of a T-trial run takes exactly the draws of a
1-trial run with seed s + g, whatever T is.  Draws are named after what they
feed, so a :class:`FixedDraws` can hand in fixed arrays for the named draws
where two runs must take the same numbers (``jax.random`` and
``torch.Generator`` give different numbers from the same seed, and a CPU
and a CUDA generator do too).  A :class:`TrialSampler`'s generators are
stateful, so a resumed run is exact only if their states are saved and
restored (:meth:`TrialSampler.get_state`, :meth:`TrialSampler.set_state`):
a CPU generator's state is its Mersenne-Twister state, a CUDA one's its
Philox seed and offset.  Each of a :class:`TrialSampler`'s draws runs in a
span ``draw.<name>`` (``draw.keep_mask``, ``draw.permutation``;
``utils/tracing.py``).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from rankaae_tpu_torch.utils import tracing


class Sampler:
    """Named draws from one generator on ``device``, seeded ``seed``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        """Standard-normal float32 draw; ``name`` identifies the draw site
        (``spec_noise``, ``z_real``, ``z_sample``, ``dis_noise``, ...)."""
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def keep_mask(self, shape: Sequence[int], keep: float) -> torch.Tensor:
        """Boolean dropout keep-mask, True with probability ``keep``."""
        return torch.rand(tuple(shape), generator=self.generator, device=self.device) < keep

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)


class TrialSampler:
    """Named draws for ``trials`` stacked trials: every shape passed in has
    the trial axis leading, and trial t's slice comes from generator t
    (seeded ``seed + t``).  One launch per trial and draw site."""

    def __init__(self, seed: int, trials: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.generators: List[torch.Generator] = []
        for t in range(trials):
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed + t)
            self.generators.append(g)

    @property
    def trials(self) -> int:
        return len(self.generators)

    def get_state(self) -> List[np.ndarray]:
        """Every generator's state, as host uint8 arrays (one per trial)."""
        return [g.get_state().numpy().copy() for g in self.generators]

    def set_state(self, states: Sequence[np.ndarray]) -> None:
        """Restore what :meth:`get_state` returned, generator by generator."""
        if len(states) != self.trials:
            raise ValueError(f"{len(states)} generator states for {self.trials} trials")
        for g, st in zip(self.generators, states):
            g.set_state(torch.from_numpy(np.asarray(st, np.uint8).copy()))

    def _stack(self, draw, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(shape)
        if shape[0] != self.trials:
            raise ValueError(f"draw of shape {shape} for {self.trials} trials")
        if self.trials == 1:
            return draw(shape[1:], self.generators[0])[None]
        return torch.stack([draw(shape[1:], g) for g in self.generators])

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        """(T, ...) standard-normal float32 draw; ``name`` as in
        :meth:`Sampler.normal`."""
        with tracing.span("draw", name):
            return self._stack(lambda s, g: torch.randn(s, generator=g, device=self.device),
                               shape)

    def keep_mask(self, shape: Sequence[int], keep: float) -> torch.Tensor:
        with tracing.span("draw.keep_mask"):
            return self._stack(lambda s, g: torch.rand(s, generator=g, device=self.device),
                               shape) < keep

    def permutation(self, n: int) -> torch.Tensor:
        """(T, n): one permutation of range(n) per trial."""
        with tracing.span("draw.permutation"):
            return self._stack(
                lambda s, g: torch.randperm(s[0], generator=g, device=self.device),
                (self.trials, n))


class FixedDraws(TrialSampler):
    """A sampler that hands out given arrays for the named draws: each
    ``draws[name]`` is an array with the trial axis leading, or a list of
    them handed out in order (a draw site that a run visits several times,
    and the ``permutation`` of each epoch)."""

    def __init__(self, draws, trials: int = 1, device="cpu"):
        super().__init__(0, trials, device)
        self.draws = {k: list(v) if isinstance(v, list) else [v] for k, v in draws.items()}

    def _pop(self, name: str) -> torch.Tensor:
        queue = self.draws[name]
        x = torch.tensor(np.asarray(queue.pop(0)), device=self.device)
        if not queue:
            del self.draws[name]
        return x

    def normal(self, name: str, shape: Sequence[int]) -> torch.Tensor:
        x = self._pop(name)
        assert tuple(x.shape) == tuple(shape), (name, tuple(x.shape), tuple(shape))
        return x

    def permutation(self, n: int) -> torch.Tensor:
        x = self._pop("permutation")
        assert tuple(x.shape) == (self.trials, n), tuple(x.shape)
        return x.long()
