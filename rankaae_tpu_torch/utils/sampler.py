"""The sources of random draws for a training run.

``rankaae_tpu`` splits and folds ``jax.random`` keys; here every draw comes
from a seeded stream, in program order.  A :class:`Sampler` is one
``torch.Generator`` (one trial, for a single-trial module); a
:class:`TrialSampler` is one stream per trial, trial g of a run with base
seed s seeded with s + g, and draws each trial's slice from that trial's
stream: on a CUDA device a counter-based Philox stream, every trial's slice
of a draw in one launch (``ops/draws_cuda.py``), on the CPU one
``torch.Generator`` a trial.  So trial g of a T-trial run takes exactly the
draws of a 1-trial run with seed s + g, whatever T is.  Draws are named
after what they feed, so a :class:`FixedDraws` can hand in fixed arrays for
the named draws where two runs must take the same numbers (``jax.random``,
a CPU ``torch.Generator`` and the Philox streams give different numbers
from the same seed).  A :class:`TrialSampler`'s streams are stateful, so a
resumed run is exact only if their states are saved and restored
(:meth:`TrialSampler.get_state`, :meth:`TrialSampler.set_state`): a CPU
generator's state is its Mersenne-Twister state, a Philox stream's its key
and offset (16 bytes, a CUDA generator's layout, the offset tagged with
:data:`STATE_TAG` so that a per-trial CUDA generator's state is refused,
not read as a stream's).  Each of a
:class:`TrialSampler`'s draws runs in a span ``draw.<name>``
(``draw.keep_mask``, ``draw.permutation``; ``utils/tracing.py``).
"""
from __future__ import annotations

import math
import struct
from typing import List, Sequence

import numpy as np
import torch

from rankaae_tpu_torch.ops import draws_cuda
from rankaae_tpu_torch.utils import tracing

#: bits 48-62 of a Philox stream's saved offset (the offset in 32-bit words
#: below them): a CUDA generator's state has 0 there
STATE_TAG = draws_cuda.STREAM >> 16
_TAG_SHIFT = 48


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
    the trial axis leading, and trial t's slice comes from stream t (seed
    ``seed + t``).

    On a CUDA device (:attr:`philox`) each draw is one launch of D1
    (``ops/draws_cuda.py``): trial t's slice from its Philox4x32-10 stream
    of key ``seed + t`` at the sampler's counter offset, which every draw
    advances by the same amount for all trials.  On the CPU each trial's
    slice comes from its own ``torch.Generator``, one call a trial, stacked.
    :attr:`generators` (one a trial, seeded ``seed + t``) exist either way:
    the trainer draws the initial weights from them."""

    def __init__(self, seed: int, trials: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.philox = self.device.type == "cuda"
        self.generators: List[torch.Generator] = []
        for t in range(trials):
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed + t)
            self.generators.append(g)
        if self.philox:
            self._set_keys([self.seed + t for t in range(trials)], 0)

    @property
    def trials(self) -> int:
        return len(self.generators)

    def _set_keys(self, keys: Sequence[int], offset: int) -> None:
        self._keys = [int(k) % 2 ** 64 for k in keys]
        self._key_tensor = draws_cuda.keys_tensor(self._keys, self.device)
        self._offset = int(offset)          # counters consumed by every trial's stream

    def get_state(self) -> List[np.ndarray]:
        """Every trial's stream state, as host uint8 arrays (one per trial):
        a CPU generator's Mersenne-Twister state, or with :attr:`philox` 16
        bytes in the layout of a CUDA generator's: the key (uint64) and the
        offset in 32-bit words, 4 a counter (int64), little-endian, with
        :data:`STATE_TAG` in its bits 48-62."""
        if self.philox:
            words = 4 * self._offset
            if words >> _TAG_SHIFT:
                raise OverflowError(f"a stream offset of {words} words does not fit the "
                                    f"state's {_TAG_SHIFT} bits")
            tagged = (STATE_TAG << _TAG_SHIFT) | words
            return [np.frombuffer(struct.pack("<Qq", k, tagged), np.uint8).copy()
                    for k in self._keys]
        return [g.get_state().numpy().copy() for g in self.generators]

    def set_state(self, states: Sequence[np.ndarray]) -> None:
        """Restore what :meth:`get_state` returned, trial by trial."""
        if len(states) != self.trials:
            raise ValueError(f"{len(states)} generator states for {self.trials} trials")
        if not self.philox:
            for g, st in zip(self.generators, states):
                g.set_state(torch.from_numpy(np.asarray(st, np.uint8).copy()))
            return
        keys, offsets = [], set()
        for st in states:
            raw = np.asarray(st, np.uint8).tobytes()
            if len(raw) != 16:
                raise ValueError(f"a {len(raw)}-byte state where a Philox stream has 16 "
                                 "(a state saved from CPU generators?)")
            key, tagged = struct.unpack("<Qq", raw)
            if tagged >> _TAG_SHIFT != STATE_TAG:
                raise ValueError("a 16-byte state without the Philox streams' tag: a CUDA "
                                 "generator's, saved by a run that drew from one generator "
                                 "a trial; these streams cannot resume it")
            keys.append(key)
            offsets.add(tagged & ((1 << _TAG_SHIFT) - 1))
        if len(offsets) != 1 or next(iter(offsets)) % 4:
            raise ValueError(f"the trials' offsets {sorted(offsets)} are not one multiple of 4")
        self._set_keys(keys, next(iter(offsets)) // 4)

    def _draw(self, mode: int, shape: Sequence[int], keep: float = 1.0) -> torch.Tensor:
        x = draws_cuda.draw(mode, self._key_tensor, self._offset, shape, keep)
        self._offset += draws_cuda.counters(math.prod(tuple(shape)[1:]))
        return x

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
            if self.philox:
                return self._draw(draws_cuda.NORMAL, shape)
            return self._stack(lambda s, g: torch.randn(s, generator=g, device=self.device),
                               shape)

    def keep_mask(self, shape: Sequence[int], keep: float) -> torch.Tensor:
        with tracing.span("draw.keep_mask"):
            if self.philox:
                return self._draw(draws_cuda.KEEP, shape, keep)
            return self._stack(lambda s, g: torch.rand(s, generator=g, device=self.device),
                               shape) < keep

    def permutation(self, n: int) -> torch.Tensor:
        """(T, n): one permutation of range(n) per trial (on a CUDA device
        the stable order of 63-bit keys, two words an element)."""
        with tracing.span("draw.permutation"):
            if self.philox:
                w = self._draw(draws_cuda.BITS, (self.trials, n, 2)).long() & 0xFFFFFFFF
                return torch.argsort((w[..., 0] << 31) | (w[..., 1] >> 1), dim=1, stable=True)
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
