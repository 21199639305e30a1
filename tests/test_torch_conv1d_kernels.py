"""The grouped 1-D convolution kernels C1–C3 (``ops/conv1d_cuda.py``,
``csrc/conv1d.cu``): their shape table, their plain versions and the two
autograd Functions, on the CPU; the kernels themselves on the card.

* Every convolution the normal and compact forms and the CNN discriminator
  build at T 32 from the shipped config, and the smoothing loss's filter,
  has a kernel: the modules' weights walked, and a train-mode forward and
  backward of each model and the smoothing loss routed through the
  Functions (on the CPU their plain versions) with every per-group shape
  recorded.  That routed run equals the plain route (``F.conv1d`` and its
  autograd) in float64 at 1e-10: the role swap of the transposed
  convolutions and the replicate pad's fold, at the models' own shapes.
* Each table shape, at small B, groups and length, in float64: the
  Function's forward, input gradient, weight gradient and bias gradient
  against ``F.conv1d`` (after ``F.pad`` replicate) or ``F.conv_transpose1d``
  and their autograd, at 1e-10, and ``gradcheck`` of the Function.
* On the card (``chip`` marker, as the benchmark's card tests; skipped
  without CUDA): each kernel against
  its plain version at the main path's shapes, and C3 bit-identical over
  two calls.  Run them there with ``python -m pytest --noconftest -m chip
  tests/test_torch_conv1d_kernels.py`` (``tests/conftest.py`` imports JAX).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from rankaae_tpu_torch.models import registry
from rankaae_tpu_torch.models.primitives import (
    TrialConv1d,
    TrialConvTranspose1d,
    gaussian_smooth_1d,
    reset_parameters,
)
from rankaae_tpu_torch.ops import conv1d_cuda as cc
from rankaae_tpu_torch.train.trainer import GAU_KERNEL_SIZE
from rankaae_tpu_torch.utils.config import TrainConfig
from rankaae_tpu_torch.utils.sampler import TrialSampler

# one torch thread a process, as tests/torch_parity.py sets for the other
# port tests; that module imports JAX, which this file does not, so that its
# card tests run on a machine without it
torch.set_num_threads(1)

CONFIG = "example/fix_config.yaml"
#: (ae_form, use_cnn_discriminator) of the models whose convolutions run on the card
FORMS = (("normal", False), ("compact", False), ("normal", True), ("compact", True))


def _models(form, cnn, trials):
    cfg = dataclasses.replace(TrainConfig.from_yaml(CONFIG), ae_form=form,
                              use_cnn_discriminator=cnn)
    enc, dec = registry.build_autoencoder(cfg, trials=trials)
    return cfg, enc, dec, registry.build_discriminator(cfg, trials=trials)


def _module_geometry(m):
    if isinstance(m, TrialConv1d):
        return cc.conv_geometry(m.weight.flatten(0, 1), m.stride, m.padding, m.replicate,
                                m.weight.shape[0] * m.groups)
    return cc.transpose_geometry(m.weight.flatten(0, 1), m.stride,
                                 m.weight.shape[0] * m.groups)


@pytest.mark.parametrize("form,cnn", FORMS)
def test_every_model_conv_has_a_kernel(form, cnn):
    _, enc, dec, dis = _models(form, cnn, trials=32)
    convs = [m for mod in (enc, dec, dis) for m in mod.modules()
             if isinstance(m, (TrialConv1d, TrialConvTranspose1d))]
    assert convs
    for m in convs:
        cc.check_geometry(_module_geometry(m))
    cc.check_geometry(cc.conv_geometry(torch.empty(1, 1, GAU_KERNEL_SIZE), 1,
                                       (GAU_KERNEL_SIZE - 1) // 2, True, 1))


def _run(enc, dec, dis, spec, seed):
    """One train-mode pass of the three models, a scalar of every output."""
    smp = TrialSampler(seed, enc.trials, "cpu")
    z = enc(spec, sampler=smp)
    out = dec(z, sampler=smp)
    logits = dis(z, sampler=smp)
    return out.square().mean() + z.cos().mean() + logits.square().mean()


def _recording(monkeypatch):
    """Route the modules through the Functions, as on the card, and record
    every per-group shape the wrapper checks."""
    met = []
    original = cc.check_geometry

    def check(geo):
        met.append(geo.key)
        original(geo)

    monkeypatch.setattr(cc, "check_geometry", check)
    monkeypatch.setattr(cc, "_on_card", lambda x: True)
    return met


@pytest.mark.parametrize("form,cnn", FORMS)
def test_models_through_the_functions_equal_the_plain_route(form, cnn, monkeypatch):
    """The Functions' route (C1–C3's plain versions, as on the card) against
    ``F.conv1d``'s autograd, and every per-group shape it meets in the table."""
    _, enc, dec, dis = _models(form, cnn, trials=2)
    gen = torch.Generator().manual_seed(3)
    for mod in (enc, dec, dis):
        for t in range(2):
            reset_parameters(mod, gen, trial=t)
        mod.double().train()
    spec = torch.rand(2, 3, 256, dtype=torch.float64, generator=gen)
    params = [p for mod in (enc, dec, dis) for p in mod.parameters()]

    def grads():
        loss = _run(enc, dec, dis, spec, 11)
        return [loss.detach()] + list(torch.autograd.grad(loss, params, allow_unused=True))

    plain = grads()
    met = _recording(monkeypatch)
    routed = grads()
    assert (2, 2, 5, 1) in met if cnn else (4, 4, 2, 2) in met
    assert len(plain) == len(routed)
    for a, b in zip(plain, routed):
        if a is None:
            assert b is None
            continue
        torch.testing.assert_close(b, a, atol=1e-10, rtol=1e-10)


def test_smoothing_through_the_function(monkeypatch):
    """The smoothing loss's filter (float32 whatever its input, as the
    reference's) through C1 and C2's plain versions: the same forward, and
    the input gradient within float32 rounding of ``F.pad``'s autograd."""
    spec = torch.rand(6, 256, generator=torch.Generator().manual_seed(5))
    weights = torch.rand(6, 256, generator=torch.Generator().manual_seed(6))

    def run():
        x = spec.clone().requires_grad_()
        y = gaussian_smooth_1d(x, GAU_KERNEL_SIZE)
        return y, torch.autograd.grad((y * weights).sum(), x)[0]

    y_plain, dx_plain = run()
    met = _recording(monkeypatch)
    y, dx = run()
    assert met == [(1, 1, GAU_KERNEL_SIZE, 1)]
    assert torch.equal(y, y_plain)
    torch.testing.assert_close(dx, dx_plain, atol=1e-6, rtol=1e-6)


def _cases():
    """(shape, pad mode) for every table shape: a convolution with zero,
    replicate and no padding where it has taps to pad, and the transposed
    convolution where kernel == stride."""
    for key in cc.SHAPES:
        c_in, c_out, k, s = key
        modes = ["none"] if k == 1 else ["none", "zeros", "replicate"]
        for mode in modes:
            yield pytest.param(key, mode, id=f"{c_in}-{c_out}-{k}-{s}-{mode}")
        if k == s:
            yield pytest.param(key, "transposed", id=f"{c_in}-{c_out}-{k}-{s}-transposed")


def _operands(key, mode, groups=2, n=3, seed=0):
    c_in, c_out, k, s = key
    gen = torch.Generator().manual_seed(seed)
    pad = 0 if mode in ("none", "transposed") else (k - 1) // 2
    geo = cc.Geometry(c_in, c_out, k, s, pad, mode == "replicate", groups)
    w = torch.randn(groups * c_out, c_in, k, dtype=torch.float64, generator=gen)
    if mode == "transposed":
        x = torch.randn(n, groups * c_out, 3, dtype=torch.float64, generator=gen)
        b = torch.randn(groups * c_in, dtype=torch.float64, generator=gen)
    else:
        x = torch.randn(n, groups * c_in, 3 * s + k + 2, dtype=torch.float64, generator=gen)
        b = torch.randn(groups * c_out, dtype=torch.float64, generator=gen)
    return geo, x, w, b


@pytest.mark.parametrize("key,mode", list(_cases()))
def test_function_matches_torch_conv(key, mode):
    geo, x, w, b = _operands(key, mode)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    if mode == "transposed":
        fn = cc.ConvTranspose1dFunction
        want = F.conv_transpose1d(*leaves, geo.stride, 0, 0, geo.groups)
    else:
        fn = cc.Conv1dFunction
        xr, pad = leaves[0], geo.pad
        if mode == "replicate":
            xr, pad = F.pad(xr, (pad, pad), mode="replicate"), 0
        want = F.conv1d(xr, leaves[1], leaves[2], geo.stride, pad, 1, geo.groups)
    ins = [t.clone().requires_grad_() for t in (x, w, b)]
    got = fn.apply(*ins, geo)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=1e-10)
    dy = torch.randn_like(want)
    for a, e in zip(torch.autograd.grad(got, ins, dy), torch.autograd.grad(want, leaves, dy)):
        torch.testing.assert_close(a, e, atol=1e-10, rtol=1e-10)
    assert torch.autograd.gradcheck(lambda *t: fn.apply(*t, geo), ins)


def test_function_without_bias_or_weight_gradient():
    """No bias (C3 writes no bias slot) and a weight that takes no gradient
    (the smoothing filter: C3 does not run) through the same Functions."""
    geo, x, w, _ = _operands((1, 1, 17, 1), "replicate", groups=1)
    xs = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(cc.Conv1dFunction.apply(xs, w, None, geo).sum(), xs)
    xr = x.clone().requires_grad_()
    want = F.conv1d(F.pad(xr, (8, 8), mode="replicate"), w)
    (ex,) = torch.autograd.grad(want.sum(), xr)
    torch.testing.assert_close(dx, ex, atol=1e-10, rtol=1e-10)
    geo, x, w, _ = _operands((4, 4, 11, 1), "zeros")
    wl = w.clone().requires_grad_()
    dw, db = torch.autograd.grad(cc.Conv1dFunction.apply(x, wl, None, geo).sum(),
                                 (wl,)) + (None,)
    ones = torch.ones(3, 8, x.shape[-1], dtype=torch.float64)
    dw_plain, db_plain = cc.weight_grad_plain(x, ones, geo, cc.BIAS_NONE)
    torch.testing.assert_close(dw, dw_plain, atol=1e-10, rtol=1e-10)
    assert db is None and db_plain is None


def test_wrapper_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="no conv1d kernel"):
        cc.check_geometry(cc.Geometry(5, 8, 2, 2, 0, False, 32))
    with pytest.raises(ValueError, match="kernel == stride"):
        cc.conv_transpose1d(torch.zeros(1, 4, 8), torch.zeros(4, 4, 3), None, 2)
    # the CPU route is the plain one: F.pad + F.conv1d, whatever the shape
    x = torch.randn(2, 5, 9)
    w = torch.randn(8, 5, 3)
    torch.testing.assert_close(cc.conv1d(x, w, None, 1, 1, True),
                               F.conv1d(F.pad(x, (1, 1), mode="replicate"), w))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

#: the main path's largest convolutions at T 32, B 1024: (key, mode, groups,
#: lx), the transposed 4 -> 4 64 -> 256, the smoothing filter at T*B rows and
#: the CNN discriminator's 2 -> 2 convolution at L 64
CARD_CASES = (
    ((4, 4, 11, 1), "replicate", 32, 256), ((4, 4, 11, 1), "zeros", 32, 256),
    ((4, 4, 11, 2), "zeros", 32, 256), ((1, 4, 11, 2), "replicate", 32, 256),
    ((4, 4, 4, 4), "transposed", 32, 64), ((1, 1, 4, 4), "transposed", 128, 64),
    ((4, 2, 11, 1), "replicate", 32, 256), ((8, 8, 2, 2), "transposed", 32, 2),
    ((2, 2, 5, 1), "replicate", 32, 64),
)


@pytest.fixture
def cuda():
    """Skips the test where no CUDA device is present (decided when the test
    runs, not when it is collected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only there")
    return torch.device("cuda")


def _card_operands(key, mode, groups, lx, device, n=1024, seed=0):
    c_in, c_out, k, s = key
    gen = torch.Generator(device=device).manual_seed(seed)
    pad = 0 if mode == "transposed" else (k - 1) // 2
    geo = cc.Geometry(c_in, c_out, k, s, pad, mode == "replicate", groups)
    ly = geo.out_length(lx)
    x = torch.randn(n, groups * c_in, lx, device=device, generator=gen)
    dy = torch.randn(n, groups * c_out, ly, device=device, generator=gen)
    w = torch.randn(groups * c_out, c_in, k, device=device, generator=gen) / (c_in * k) ** 0.5
    b = torch.randn(groups * c_out, device=device, generator=gen)
    return geo, x, dy, w, b


def _close(got, want, rtol):
    """|got - want| within ``rtol`` of want's largest magnitude: float32 sums
    taken in another order than the plain version's."""
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= rtol * scale, (
        (got - want).abs().max().item(), scale)


@pytest.mark.chip
@pytest.mark.parametrize("key,mode,groups,lx", CARD_CASES)
def test_kernels_match_plain_on_card(cuda, key, mode, groups, lx):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    geo, x, dy, w, b = _card_operands(key, mode, groups, lx, cuda)
    # C1 and C2 sum at most 8 * 17 products a value; C3 N * L of them
    _close(cc.forward(x, w, b, geo), cc.forward_plain(x, w, b, geo), 1e-5)
    bias_in = torch.randn(groups * geo.c_in, device=cuda)
    _close(cc.input_grad(dy, w, lx, geo, bias_in),
           cc.input_grad_plain(dy, w, lx, geo, bias_in), 1e-5)
    bias_of = cc.BIAS_X if mode == "transposed" else cc.BIAS_DY
    dw, db = cc.weight_grad(x, dy, geo, bias_of)
    dw_plain, db_plain = cc.weight_grad_plain(x, dy, geo, bias_of)
    _close(dw, dw_plain, 1e-4)
    _close(db, db_plain, 1e-4)
    dw2, db2 = cc.weight_grad(x, dy, geo, bias_of)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.chip
@pytest.mark.parametrize("key,mode,groups,lx", CARD_CASES)
def test_kernels_add_the_bias_last_on_card(cuda, key, mode, groups, lx):
    """C1 and C2 round the bias in once, after the taps' sum: with it, each
    output is the output without it plus the bias, bit for bit.  A bias
    carried through every partial sum instead made each rounding of its
    size, and moved the gradients of a CNN-discriminator batch by 1e-2
    against float64 where cuDNN's moved them by 3e-5."""
    geo, x, dy, w, b = _card_operands(key, mode, groups, lx, cuda)
    if mode != "transposed":
        assert torch.equal(cc.forward(x, w, b, geo), cc.forward(x, w, None, geo) + b[:, None])
    bias_in = torch.randn(groups * geo.c_in, device=cuda) * 1e3
    assert torch.equal(cc.input_grad(dy, w, lx, geo, bias_in),
                       cc.input_grad(dy, w, lx, geo) + bias_in[:, None])
