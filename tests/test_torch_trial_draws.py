"""The trial sampler's Philox draws (``rankaae_tpu_torch/ops/draws_cuda.py``,
``utils/sampler.py::TrialSampler`` on a CUDA device).

On the CPU :class:`PhiloxOnCpu`, a ``TrialSampler`` that takes the card's
route, runs the plain version, the same Philox4x32-10 as the card's kernel
D1 in int64 torch ops:

* the cipher against Random123's known answers, and the offset, key and
  word layout of a draw;
* trial g of T 4 bit-identical to a 1-trial sampler of seed s + g over a
  run of ``normal``, ``keep_mask`` and ``permutation`` draws, at a seed
  past 32 bits;
* ``get_state``/``set_state`` in the middle of a run: the next draws equal,
  the 16-byte layout (key, tagged offset in 32-bit words), a trial subset
  resumed under its own base seed, and the states refused where they
  cannot be one run's, a per-trial CUDA generator's among them;
* the draws judged as ``benchmark/check.py::_draws_sound`` judges them, the
  keep-mask the float32 decision ``uniform < keep``, the normal finite at
  the words' extremes;
* a plain ``TrialSampler`` on the CPU stays one ``torch.Generator`` a trial.

On the card (``chip`` marker, skipped without CUDA): D1 against the plain
version, ``python -m pytest --noconftest -m chip
tests/test_torch_trial_draws.py`` (``tests/conftest.py`` imports JAX).
"""
import math
import struct

import numpy as np
import pytest
import torch

from benchmark.check import _draws_sound
from rankaae_tpu_torch.ops import draws_cuda as dc
from rankaae_tpu_torch.utils.sampler import STATE_TAG, TrialSampler

SEED = 2 ** 33 + 17          # past 32 bits, as the benchmark's seeds can be
T = 4
#: a run's draws, in order: (kind, argument)
PROGRAM = (("normal", (1024, 7)), ("mask", (33, 4, 9)), ("perm", 301), ("normal", (5,)),
           ("mask", (64, 6)), ("normal", (3, 2, 2)), ("perm", 17), ("mask", (1,)))
KEEP = 0.9


class PhiloxOnCpu(TrialSampler):
    """A ``TrialSampler`` on the CPU that draws as on the card: Philox
    streams keyed seed + t, through the plain version."""

    def __init__(self, seed: int, trials: int):
        super().__init__(seed, trials, "cpu")
        self.philox = True
        self._set_keys([self.seed + t for t in range(trials)], 0)


def _state(key: int, words: int) -> np.ndarray:
    """A stream's 16 bytes: the key, then the offset in words, tagged."""
    return np.frombuffer(struct.pack("<Qq", key, (STATE_TAG << 48) | words), np.uint8)


def _run(sampler, program=PROGRAM):
    out = []
    t = sampler.trials
    for kind, arg in program:
        if kind == "normal":
            out.append(sampler.normal("z", (t, *arg)))
        elif kind == "mask":
            out.append(sampler.keep_mask((t, *arg), KEEP))
        else:
            out.append(sampler.permutation(arg))
    return out


def _words(*xs):
    return [torch.tensor(x, dtype=torch.int64) for x in xs]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff), (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32-10."""
    assert tuple(int(w) for w in dc.philox(*_words(*ctr, *key))) == want


def test_draw_layout():
    """Element i of trial t: counter offset + i // 4 (STREAM above it),
    key seed + t, word i % 4; the keys are the seeds mod 2^64."""
    seeds = [SEED, 2 ** 64 - 1, -3]
    keys = dc.keys_tensor(seeds, "cpu")
    bits = dc.draw(dc.BITS, keys, 41, (3, 10)).long() & 0xFFFFFFFF
    for t, s in enumerate(seeds):
        k = s % 2 ** 64
        for i in (0, 3, 4, 9):
            want = dc.philox(*_words(41 + i // 4, 0, 0, dc.STREAM, k & 0xFFFFFFFF, k >> 32))
            assert int(bits[t, i]) == int(want[i % 4]), (t, i)
    assert dc.counters(10) == 3 and dc.counters(12) == 3 and dc.counters(1) == 1
    # the uniform, the keep-mask and the normal read the same words
    u = dc.draw(dc.UNIFORM, keys, 41, (3, 10))
    assert torch.equal(u, (bits >> 8).float() * 2.0 ** -24)
    assert torch.equal(dc.draw(dc.KEEP, keys, 41, (3, 10), keep=0.3), u < 0.3)
    q = bits.new_zeros((3, 12))
    q[:, :10] = bits
    normal = dc.box_muller(q.view(3, 3, 4)).view(3, 12)[:, :10]
    assert torch.equal(dc.draw(dc.NORMAL, keys, 41, (3, 10)), normal)


def test_trial_g_of_t4_is_the_one_trial_run_of_seed_s_plus_g():
    stacked = _run(PhiloxOnCpu(SEED, T))
    for g in range(T):
        single = _run(PhiloxOnCpu(SEED + g, 1))
        for (kind, _), a, b in zip(PROGRAM, stacked, single):
            assert a.dtype == b.dtype and torch.equal(a[g], b[0]), (g, kind)
    # the trials' streams differ
    assert not torch.equal(stacked[0][0], stacked[0][1])


def test_state_mid_run_gives_the_same_next_draws():
    a = PhiloxOnCpu(SEED, T)
    _run(a, PROGRAM[:3])
    state = a.get_state()
    offset = dc.counters(1024 * 7) + dc.counters(33 * 4 * 9) + dc.counters(301 * 2)
    assert len(state) == T
    for t, st in enumerate(state):   # key (uint64), offset in words (int64) under the tag
        assert st.dtype == np.uint8 and st.shape == (16,)
        assert st.tobytes() == struct.pack("<Qq", SEED + t, (0x4431 << 48) | 4 * offset)
    want = _run(a, PROGRAM[3:])
    b = PhiloxOnCpu(0, T)
    b.set_state(state)
    assert [s.tobytes() for s in b.get_state()] == [s.tobytes() for s in state]
    for x, y in zip(want, _run(b, PROGRAM[3:])):
        assert torch.equal(x, y)
    # trials 1..2 resumed as a run of their own (base seed + 1)
    c = PhiloxOnCpu(SEED + 1, 2)
    c.set_state(state[1:3])
    for x, y in zip(want, _run(c, PROGRAM[3:])):
        assert torch.equal(x[1:3], y)


@pytest.mark.parametrize("bad", ["cpu_generator", "cuda_generator", "offsets", "quarter",
                                 "count"])
def test_set_state_refuses_what_no_run_saved(bad):
    s = PhiloxOnCpu(SEED, T)
    states = s.get_state()
    if bad == "cpu_generator":
        states = TrialSampler(SEED, T, "cpu").get_state()
    elif bad == "cuda_generator":       # (seed, offset) of one CUDA generator a trial
        states = [np.frombuffer(struct.pack("<Qq", SEED + t, 8), np.uint8) for t in range(T)]
    elif bad == "offsets":
        states[1] = _state(SEED + 1, 8)
    elif bad == "quarter":
        states = [_state(SEED + t, 6) for t in range(T)]
    else:
        states = states[:2]
    with pytest.raises(ValueError):
        s.set_state(states)


def test_draws_are_sound():
    """Per trial, as the benchmark's check judges a recorded epoch's draws:
    the normals' mean and variance within 6 standard errors, each mask's
    keep share within 6, each permutation one of range(n)."""
    s = PhiloxOnCpu(SEED, T)
    n = 1400
    records = [("normal", "z", s.normal("z", (T, 512, 256))),
               ("mask", KEEP, s.keep_mask((T, 256, 4, 64), KEEP)),
               ("perm", None, s.permutation(n)),
               ("normal", "z_real", s.normal("z_real", (T, 512, 6))),
               ("mask", 0.5, s.keep_mask((T, 512, 6), 0.5))]
    for g in range(T):
        assert _draws_sound([(kind, name, v[g]) for kind, name, v in records], n), g
    x = records[0][2].double()
    assert abs(float(x.mean())) < 6 / math.sqrt(x.numel())
    assert abs(float(x.var()) - 1) < 6 * math.sqrt(2 / x.numel())
    # and the judge is not blind: a constant stream is not sound
    assert not _draws_sound([("normal", "z", torch.zeros(100))], n)


def test_keep_mask_is_the_float32_decision():
    """(w >> 8) < ceil(keep 2^24) decides exactly as (w >> 8) 2^-24 <
    float32(keep), at keeps whose float32 scales to a whole number and not."""
    m = torch.arange(0, 2 ** 24, 4099, dtype=torch.int64)
    m = torch.cat((m, torch.tensor([0, 1, 2 ** 24 - 1])))
    u = m.float() * 2.0 ** -24
    for keep in (0.9, 0.5, 0.75, 0.1, 1e-7, 1.0 - 1e-8, 0.0, 1.0, 1.5):
        assert torch.equal(m < dc.keep_threshold(keep), u < keep), keep


def test_normal_is_finite_at_the_words_extremes():
    w = torch.tensor([[0, 0, 0xFFFFFFFF, 0xFFFFFFFF], [0xFF, 0x80000000, 0x100, 0x40000000]])
    z = dc.box_muller(w)
    assert torch.isfinite(z).all()
    r_max = math.sqrt(-2 * math.log(2.0 ** -24))
    assert float(z[0, 0]) == pytest.approx(r_max, rel=1e-6) and float(z[0, 1]) == 0.0
    assert float(z[0, 2]) == 0.0 and float(z[0, 3]) == 0.0          # u1 = 1: r = 0
    assert float(z[1, 0]) == pytest.approx(-r_max, rel=1e-6)        # theta = pi


def test_cpu_default_keeps_one_generator_a_trial():
    s = TrialSampler(SEED, T, "cpu")
    assert not s.philox and len(s.get_state()[0]) > 16
    gen = torch.Generator().manual_seed(SEED + 2)
    assert torch.equal(s.normal("z", (T, 5))[2], torch.randn(5, generator=gen))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

CARD_SHAPES = ((1, 8), (3, 5), (8, 1024, 6), (4, 33, 4, 9), (2, 7, 3))


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present (decided when the test
    runs, not when it is collected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: D1 runs only there")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda, shape):
    keys = dc.keys_tensor([SEED + t for t in range(shape[0])], cuda)
    for mode in (dc.BITS, dc.UNIFORM, dc.KEEP):
        a = dc.draw_kernel(mode, keys, 12345, shape, keep=KEEP)
        b = dc.draw_plain(mode, keys, 12345, shape, keep=KEEP)
        assert a.dtype == b.dtype and torch.equal(a, b), mode
    a = dc.draw_kernel(dc.NORMAL, keys, 12345, shape)
    b = dc.draw_plain(dc.NORMAL, keys, 12345, shape)
    # CUDA's logf (1 ulp) and sincosf (2 ulp) in D1 against torch's log,
    # sin and cos on the card in the plain version: a few ulps of |z|
    ulp = torch.finfo(torch.float32).eps * b.abs().clamp_min(2.0 ** -20)
    assert float(((a - b).abs() / ulp).max()) <= 8
