"""The channel PReLUs and branch sums P1 (``ops/prelu_cuda.py``,
``csrc/prelu_sum.cu``): the autograd Function's plain route and the
blocks' use of it on the CPU; the kernels themselves on the card.

* The Function's plain version against ``F.prelu`` and the adds in the
  blocks' order, bit for bit in float32: the output and the gradient of
  every term and slope, for each term pattern the blocks build (one PReLU;
  a PReLU and an identity; three PReLUs; the identity residual between two
  PReLUs) and a term laid out (C, B, L), whose layout the output keeps.
* The normal and compact forms and the CNN discriminator routed through
  the Function as on the card (its plain version here), against the
  modules run one by one: loss, every gradient and every running statistic
  bit for bit in train mode, in a no-grad train-mode forward and in eval
  mode; no ``F.prelu`` on the route, and one tail call a block forward.
* The CPU route itself: each block's output, gradients and statistics are
  the modules' run one by one, as before P1.
* On the card (``chip`` marker, skipped without CUDA): the kernels against
  the plain version at the cells' largest shapes, every layout and path;
  every P1 call of a normal, compact and compact + CNN T 8 epoch; the
  stacked blocks through P1 against their modules; a ``remat`` block.  Run
  them there with ``python -m pytest --noconftest -m chip
  tests/test_torch_prelu_kernels.py`` (``tests/conftest.py`` imports JAX).
"""
import copy
import dataclasses
import re

import pytest
import torch
import torch.nn.functional as F

from rankaae_tpu_torch.models import registry
from rankaae_tpu_torch.models.blocks import (
    DecodingBlock,
    EncodingBlock,
    TrialDecodingBlock,
    TrialEncodingBlock,
    run_block,
)
from rankaae_tpu_torch.models.primitives import reset_parameters
from rankaae_tpu_torch.ops import prelu_cuda as pc
from rankaae_tpu_torch.utils import tracing
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import Sampler, TrialSampler

# one torch thread a process, as tests/torch_parity.py sets for the other
# port tests (it sets the order of the CPU's sums); that module imports JAX,
# which this file does not, so that its card tests run without it
torch.set_num_threads(1)

CONFIG = "example/fix_config.yaml"
#: the term patterns the blocks build, and P1's kernels: a PReLU (True) or
#: the identity
PATTERNS = {"one": (True,), "three": (True, True, True),
            "identity-between": (True, False, True)}
#: (ae_form, use_cnn_discriminator) of the models with stacked conv blocks
FORMS = (("normal", True), ("compact", False), ("compact", True))
#: on the card, the slope gradients' largest difference from the products'
#: exact sum (the plain version's float32 products summed in float64) over
#: its largest magnitude; the kernel sums in double.  PyTorch's float32
#: reduction is itself up to 1.2e-6 off that sum (a normal + CNN T 8
#: epoch), so the kernel is held no further from PyTorch's result than
#: PyTorch's own error and this
DW_RTOL = 1e-6


def _operands(shape, pattern, order=(0, 1, 2), device="cpu", seed=0):
    """Terms, slopes (either sign) and an output gradient of a (B, C, L)
    call, the tensors laid out with their dims in ``order``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    physical = tuple(shape[d] for d in order)
    back = tuple(order.index(d) for d in range(3))

    def term():
        return torch.randn(physical, device=device, generator=gen).permute(back)
    ys = [term() for _ in pattern]
    ws = [torch.randn(shape[1], device=device, generator=gen) * 0.25 if a else None
          for a in pattern]
    return ys, ws, term()


def _parent_sum(ys, ws):
    """``F.prelu`` of each activated term, the terms added in order."""
    out = None
    for y, w in zip(ys, ws):
        v = y if w is None else F.prelu(y, w)
        out = v if out is None else out + v
    return out


def _grads(fn, ys, ws, dout):
    ys = [y.clone().requires_grad_() for y in ys]
    ws = [None if w is None else w.clone().requires_grad_() for w in ws]
    out = fn(ys, ws)
    leaves = ys + [w for w in ws if w is not None]
    return out, torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("name", PATTERNS)
@pytest.mark.parametrize("order", [(0, 1, 2), (1, 0, 2)], ids=["contiguous", "C-B-L"])
def test_function_equals_prelu_and_adds(name, order):
    ys, ws, dout = _operands((6, 8, 16), PATTERNS[name], order)
    want, want_grads = _grads(_parent_sum, ys, ws, dout)
    got, got_grads = _grads(lambda y, w: pc.prelu_sum(list(zip(y, w))), ys, ws, dout)
    assert torch.equal(got, want)
    assert got.stride() == want.stride()
    assert len(got_grads) == len(want_grads)
    for a, b in zip(got_grads, want_grads):
        assert torch.equal(a, b)


def test_plain_backward_is_torchs_prelu_backward():
    """dy and the slope gradient of the plain backward against PyTorch's own
    PReLU backward (its full-size slope gradient, summed over (B, L))."""
    ys, ws, dout = _operands((5, 12, 33), (True,))
    dy, dw = torch.ops.aten._prelu_kernel_backward(dout, ys[0], ws[0][:, None])
    pdy, pdw = pc.backward_plain(dout, ys, ws)
    assert torch.equal(pdy[0], dy)
    assert torch.equal(pdw[0], dw.sum((0, 2)) if dw.dim() == 3 else dw.flatten())


def test_identity_gradient_is_the_output_gradient():
    ys, ws, dout = _operands((3, 4, 8), PATTERNS["identity-between"])
    leaves = [y.clone().requires_grad_() for y in ys]
    out = pc.prelu_sum(list(zip(leaves, ws)))
    grads = torch.autograd.grad(out, leaves, dout)
    assert grads[1] is dout


def _models(form, cnn, trials=2, seed=0):
    cfg = dataclasses.replace(TrainConfig.from_yaml(CONFIG), ae_form=form,
                              use_cnn_discriminator=cnn)
    enc, dec = registry.build_autoencoder(cfg, trials=trials)
    dis = registry.build_discriminator(cfg, trials=trials)
    gen = torch.Generator().manual_seed(seed)
    for m in (enc, dec, dis):
        for t in range(trials):
            reset_parameters(m, gen, trial=t)
    # slopes of either sign, so every PReLU's negative side counts
    with torch.no_grad():
        for m in (enc, dec, dis):
            for name, p in m.named_parameters():
                if "relu" in name:
                    p.uniform_(-0.5, 0.5, generator=gen)
    return enc, dec, dis


def _model_pass(enc, dec, dis, spec, mode):
    """A pass of the three models in ``mode`` (train: a loss and every
    gradient; no_grad: a train-mode forward without autograd, as the
    trainer's statistics-only forwards; eval): the outputs, gradients and
    buffers."""
    mods = (enc, dec, dis)
    for m in mods:
        m.train(mode != "eval")
    smp = TrialSampler(5, enc.trials, "cpu")
    with torch.set_grad_enabled(mode == "train"):
        z = enc(spec, sampler=smp)
        out = dec(z, sampler=smp)
        logits = dis(z, sampler=smp)
    loss = out.square().mean() + z.cos().mean() + logits.square().mean()
    grads = []
    if mode == "train":
        params = [p for m in mods for p in m.parameters()]
        grads = list(torch.autograd.grad(loss, params, allow_unused=True))
    return [z, out, logits, loss] + grads + [b.clone() for m in mods for b in m.buffers()]


def _on_route(monkeypatch):
    """Route the stacked modules through the Function as on the card (its
    plain version here); count its calls of several terms; refuse
    ``F.prelu`` while the route is on."""
    tails = []
    plain = pc.forward_plain

    def counted(ys, ws):
        if len(ys) > 1:
            tails.append(tuple(w is not None for w in ws))
        return plain(ys, ws)

    def refused(*args, **kw):
        raise AssertionError("F.prelu on P1's route")

    monkeypatch.setattr(pc, "takes", lambda y: y.dtype == torch.float32)
    monkeypatch.setattr(pc, "forward_plain", counted)
    monkeypatch.setattr(F, "prelu", refused)
    return tails


@pytest.mark.parametrize("mode", ["train", "no_grad", "eval"])
@pytest.mark.parametrize("form,cnn", FORMS)
def test_models_through_p1_equal_the_modules(form, cnn, mode, monkeypatch):
    enc, dec, dis = _models(form, cnn)
    spec = torch.rand(2, 6, 256, generator=torch.Generator().manual_seed(3))
    plain = _model_pass(*copy.deepcopy((enc, dec, dis)), spec, mode)
    blocks = [m for mod in (enc, dec) for m in mod.modules()
              if isinstance(m, (TrialEncodingBlock, TrialDecodingBlock))]
    k3 = sum(1 for m in blocks if getattr(m, "fused", False)) if mode == "eval" else 0
    tails = _on_route(monkeypatch)
    routed = _model_pass(enc, dec, dis, spec, mode)
    assert len(routed) == len(plain)
    for i, (a, b) in enumerate(zip(routed, plain)):
        assert (a is None and b is None) or torch.equal(a, b), i
    # one tail call a block forward run module by module (K3 takes the
    # eval-mode blocks of its shape), with the identity residual where a
    # stride-1 block has no shortcut
    assert len(tails) == len(blocks) - k3
    assert set(tails) <= {(True, True, True), (True, False, True)}
    if form == "normal" and mode != "eval":
        assert (True, False, True) in tails


def _parent_block(block, x, sampler):
    """A block's modules run one by one, as before P1."""
    out = block.bn1(x) if block.has_bn1 else x
    residual = out
    out = block.relu1(block.conv1(out))
    out = block.relu2(block.conv2(block.bn2(out)))
    has_short = getattr(block, "has_short", True)
    res = block.relu_short(block.conv_short(residual)) if has_short else residual
    excit = block.dropout_1(residual, sampler) if block.has_dropout else residual
    excit = block.relu_excit_2(block.fc2(block.relu_excit_1(block.fc1(excit))))
    if block.has_excit_conv:
        excit = block.relu_excit_3(block.conv_excit(block.bn_excit(excit)))
    return out + res + excit


#: (class, kwargs): a stride-1 block with the identity residual, a strided
#: encoding block from one channel (its excitation laid out (C, B, L)), a
#: decoding block that changes the channels
BLOCKS = (
    ("encoding-identity", dict(in_channels=4, out_channels=4, in_len=64, out_len=64,
                               kernel_size=11, stride=1)),
    ("encoding-strided", dict(in_channels=1, out_channels=4, in_len=64, out_len=16,
                              kernel_size=7, stride=2)),
    ("decoding", dict(in_channels=4, out_channels=2, in_len=16)),
)


def _block(kind, kw, trials, seed=0):
    enc = kind.startswith("encoding")
    if trials:
        block = (TrialEncodingBlock if enc else TrialDecodingBlock)(trials, **kw)
    else:
        block = (EncodingBlock if enc else DecodingBlock)(**kw)
    gen = torch.Generator().manual_seed(seed)
    for t in range(max(trials, 1)):
        reset_parameters(block, gen, trial=t)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "relu" in name:
                p.uniform_(-0.5, 0.5, generator=gen)
    return block.train()


def _block_pass(block, x, run, trials, dout_seed=1):
    """``run(block, x, sampler)``: the output, the input's and every
    parameter's gradient and the buffers."""
    xs = x.clone().requires_grad_()
    sampler = TrialSampler(7, trials, str(x.device)) if trials else Sampler(7, str(x.device))
    out = run(block, xs, sampler)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(dout_seed)).to(
        x.device)
    grads = torch.autograd.grad(out, [xs] + list(block.parameters()), dout)
    return [out] + list(grads) + [b.clone() for b in block.buffers()]


@pytest.mark.parametrize("trials", [0, 3], ids=["single", "stacked"])
@pytest.mark.parametrize("kind,kw", BLOCKS, ids=[k for k, _ in BLOCKS])
def test_cpu_blocks_are_their_modules(kind, kw, trials):
    block = _block(kind, kw, trials)
    x = torch.randn(5, max(trials, 1) * kw["in_channels"], kw["in_len"],
                    generator=torch.Generator().manual_seed(2))
    want = _block_pass(copy.deepcopy(block), x, _parent_block, trials)
    got = _block_pass(block, x, lambda b, xs, s: b(xs, s), trials)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


def test_wrapper_refuses_what_it_cannot_run():
    y = torch.zeros(2, 3, 8)
    w = torch.zeros(3)
    with pytest.raises(ValueError, match="term patterns"):
        pc.forward([y] * 4, [w] * 4)
    with pytest.raises(ValueError, match="term patterns"):
        pc.forward([y, y], [None, None])
    with pytest.raises(ValueError, match="term patterns"):
        pc.forward([y, y], [None, w])
    with pytest.raises(ValueError, match="term patterns"):
        pc.forward([y, y], [w, None])
    with pytest.raises(ValueError, match="w_0"):
        pc.forward([y], [torch.zeros(4)])
    with pytest.raises(ValueError, match="dense"):
        pc.forward([y[:, :, ::2]], [w])
    with pytest.raises(ValueError, match="y_1"):
        pc.forward([y, y.double(), y], [w, None, w])
    with pytest.raises(ValueError, match="y_1"):
        pc.forward([y, y.transpose(0, 1).contiguous().transpose(0, 1), y], [w, None, w])
    assert not pc.takes(y)
    assert set(PATTERNS.values()) == set(pc.PATTERNS)
    assert len(_kernel_patterns()) == len(pc.PATTERNS)


def _kernel_patterns():
    """The (terms, activated-bit mask) pairs that csrc/prelu_sum.cu
    instantiates (its PRELU_PATTERNS)."""
    line = re.search(r"#define PRELU_PATTERNS\(X\)(.*)", pc.SOURCE.read_text()).group(1)
    return {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", line)}


@pytest.mark.parametrize("name", PATTERNS)
def test_each_pattern_has_a_kernel(name):
    pattern = PATTERNS[name]
    ws = [torch.zeros(1) if a else None for a in pattern]
    assert (len(pattern), pc.act_mask(ws)) in _kernel_patterns()


def test_layouts():
    x = torch.zeros(6, 8, 16)
    assert pc.inner_size(x) == 16
    assert pc.inner_size(torch.zeros(8, 6, 16).transpose(0, 1)) == 6 * 16
    assert pc.inner_size(torch.zeros(6, 16, 8).transpose(1, 2)) == 1
    assert pc.inner_size(x[:, :, ::2]) is None
    assert pc.inner_size(torch.zeros(6, 8, 1)) == 1
    strided = x[:, :, ::2]
    assert pc.same_layout([strided])[0].is_contiguous()
    cbl = torch.zeros(8, 6, 16).transpose(0, 1)
    first, second = pc.same_layout([cbl, x])
    assert first is cbl and second.stride() == cbl.stride()
    # the tiles: at most 32 rows each, about 1,024 blocks, a function of the shape
    assert pc.tiles(1024, 1024, 256, True) == 32
    assert pc.tiles(1024, 1024, 4, True) == 256
    assert pc.tiles(1, 256, 1024 * 128, True) == 1
    assert pc.tiles(804, 32, 256, True) == 128


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present (decided when the test
    runs, not when it is collected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _slopes_close(dw, plain, dout, y):
    """``dw`` (the kernel's slope gradient) within DW_RTOL of the exact sum
    of the plain version's products, and no further from ``plain`` (PyTorch's
    float32 sum) than PyTorch's own error and DW_RTOL, each over the exact
    sum's largest magnitude."""
    exact = torch.where(y > 0, 0, y * dout).double().sum((0, 2))
    scale = exact.abs().max().clamp_min(1e-300)
    err = ((dw.double() - exact).abs().max() / scale).item()
    own = ((plain.double() - exact).abs().max() / scale).item()
    gap = ((dw.double() - plain.double()).abs().max() / scale).item()
    assert err <= DW_RTOL and gap <= own + DW_RTOL, (err, own, gap)


def _held(ys, ws, dout):
    """The kernels against the plain version on one call: the forward and
    each dy bit for bit, the output in the terms' layout, each slope
    gradient as :func:`_slopes_close` and bit-identical over two calls."""
    out = pc.forward(ys, ws)
    assert torch.equal(out, pc.forward_plain(ys, ws))
    assert pc.in_layout(out, ys[0]) is out
    dys, dws = pc.backward(dout, ys, ws)
    pdy, pdw = pc.backward_plain(dout, ys, ws)
    again = pc.backward(dout, ys, ws)[1]
    for k, w in enumerate(ws):
        if w is None:
            assert dys[k] is None and dws[k] is None
            continue
        assert torch.equal(dys[k], pdy[k]), k
        _slopes_close(dws[k], pdw[k], dout, ys[k])
        assert torch.equal(dws[k], again[k]), k


#: (shape, memory order, pattern): a normal block's end at T 256 with three
#: PReLUs and with the identity residual; one PReLU at the excitation's
#: lengths 4, 2 and 1; the one-channel excitation laid out (C, B, L); a
#: length that is no multiple of 4 (the one-element path); channels last
CARD_CASES = (
    ((1024, 1024, 256), (0, 1, 2), (True, True, True)),
    ((1024, 1024, 256), (0, 1, 2), (True, False, True)),
    ((1024, 1024, 4), (0, 1, 2), (True,)),
    ((1024, 2048, 2), (0, 1, 2), (True,)),
    ((1050, 2048, 1), (0, 1, 2), (True,)),
    ((1024, 256, 128), (1, 0, 2), (True,)),
    ((804, 256, 4), (1, 0, 2), (True,)),
    ((77, 96, 17), (0, 1, 2), (True, True, True)),
    ((33, 64, 12), (0, 2, 1), (True, False, True)),
)


@pytest.mark.chip
@pytest.mark.parametrize("shape,order,pattern", CARD_CASES)
def test_kernels_match_plain_on_card(cuda, shape, order, pattern):
    _held(*_operands(shape, pattern, order, cuda))
    torch.cuda.synchronize()


@pytest.mark.chip
def test_unaligned_terms_take_the_one_element_path_on_card(cuda):
    ys, ws, dout = _operands((64, 32, 16), (True, True, True), device=cuda)
    base = torch.randn(ys[0].numel() + 1, device=cuda)
    ys[1] = base[1:].view(ys[0].shape)           # 4 bytes past an aligned block
    assert not pc._vec(16, *ys)
    _held(ys, ws, dout)


def _card_data(cfg, seed=0):
    from rankaae_tpu_torch.data.dataset import split_sizes
    from rankaae_tpu_torch.data.synthetic import make_synthetic_xanes
    from rankaae_tpu_torch.train.trainer import TrialData

    aux, spec, _ = make_synthetic_xanes(n_rows=7000, dim=cfg.dim_in, seed=seed)
    n_train, n_val, _ = split_sizes(7000, (cfg.train_ratio, cfg.validation_ratio,
                                           cfg.test_ratio))
    cut = [torch.tensor(a, dtype=torch.float32, device="cuda")
           for a in (spec[:n_train], aux[:n_train, :cfg.n_aux],
                     spec[n_train:n_train + n_val], aux[n_train:n_train + n_val, :cfg.n_aux])]
    return TrialData(*cut)


@pytest.mark.chip
@pytest.mark.parametrize("form,cnn", FORMS)
def test_epoch_calls_match_plain_on_card(cuda, form, cnn, monkeypatch):
    """Every P1 call of a T 8 training epoch held to the plain version as
    called (the validation's eval-mode calls forward only)."""
    from rankaae_tpu_torch.train.trainer import RankAAETrainer

    cfg = dataclasses.replace(TrainConfig.from_yaml(CONFIG), ae_form=form,
                              use_cnn_discriminator=cnn)
    data = _card_data(cfg)
    core = RankAAETrainer(cfg, n_train=len(data.train_spec), n_val=len(data.val_spec),
                          trials=8, device="cuda")
    fwd, bwd = pc.forward, pc.backward
    calls = {"fwd": 0, "bwd": 0}

    def held_fwd(ys, ws):
        out = fwd(ys, ws)
        assert torch.equal(out, pc.forward_plain(ys, ws))
        calls["fwd"] += 1
        return out

    def held_bwd(dout, ys, ws):
        got = bwd(dout, ys, ws)
        pdy, pdw = pc.backward_plain(dout, ys, ws)
        for k, w in enumerate(ws):
            if w is not None:
                assert torch.equal(got[0][k], pdy[k]), k
                _slopes_close(got[1][k], pdw[k], dout, ys[k])
        calls["bwd"] += 1
        return got

    monkeypatch.setattr(pc, "forward", held_fwd)
    monkeypatch.setattr(pc, "backward", held_bwd)
    core.epoch_step(core.init_state(0), 0, data)
    torch.cuda.synchronize()
    assert calls["fwd"] > 0 and calls["bwd"] > 0


#: (form, module name) of the blocks the card tests take from the models at
#: T 8: the normal encoder's first block (one channel in, strided, its
#: excitation laid out (C, B, L)), a stride-1 block with the identity
#: residual (K3's shape, in train mode), a stride-1 block that changes the
#: channels, and two decoding blocks
CARD_BLOCKS = (("normal", "enc.block0"), ("normal", "dec.eblock0"), ("normal", "dec.eblock2"),
               ("normal", "dec.dblock1"), ("compact", "dec.dblock2"))


def _card_block(form, name, cuda):
    enc, dec, _ = _models(form, False, trials=8)
    block = dict(enc=enc, dec=dec)[name[:3]].get_submodule(name[4:]).to(cuda).train()
    t, c_in = block.relu_excit_1.weight.shape
    x = torch.randn(1024, t * c_in, block.fc1.weight.shape[-1],
                    generator=torch.Generator().manual_seed(2)).to(cuda)
    return block, x


@pytest.mark.chip
@pytest.mark.parametrize("form,name", CARD_BLOCKS)
def test_blocks_through_p1_equal_their_modules_on_card(cuda, form, name, monkeypatch):
    """A stacked block through P1 against the same block with P1 off (its
    modules one by one, PyTorch's PReLU and adds): output, dy-driven
    gradients and statistics bit for bit, the slopes' gradients within
    twice DW_RTOL (PyTorch's float32 sums are that close to exact here)."""
    block, x = _card_block(form, name, cuda)
    before = tracing.counter("prelu.tail_launches")
    got = _block_pass(copy.deepcopy(block), x, lambda b, xs, s: b(xs, s), 8)
    assert tracing.counter("prelu.tail_launches") == before + 1
    monkeypatch.setattr(pc, "takes", lambda y: False)
    want = _block_pass(block, x, lambda b, xs, s: b(xs, s), 8)
    names = ["out", "x"] + [n for n, _ in block.named_parameters()]
    for i, (a, b) in enumerate(zip(got, want)):
        name = names[i] if i < len(names) else "buffer"
        if "relu" in name:
            assert (a - b).abs().max() <= 2 * DW_RTOL * b.abs().max(), name
        else:
            assert torch.equal(a, b), name


@pytest.mark.chip
def test_remat_block_through_p1_on_card(cuda):
    """``remat``: the block under ``torch.utils.checkpoint`` (P1's forward
    again in the recompute) bit for bit the block without it."""
    block, x = _card_block(*CARD_BLOCKS[1], cuda)
    want = _block_pass(copy.deepcopy(block), x, lambda b, xs, s: run_block(b, xs, s, False), 8)
    before = tracing.counter("prelu.tail_launches")
    got = _block_pass(block, x, lambda b, xs, s: run_block(b, xs, s, True), 8)
    assert tracing.counter("prelu.tail_launches") == before + 2
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
