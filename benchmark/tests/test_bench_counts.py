"""The operation and byte counts against hand counts and against PyTorch's
own FLOP counter on the reference's layers, every configuration through
its own model module."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark import reference as ref

CONFIGS = {c["name"]: c["file"] for c in harness.load_spec()["configs"]}


def config_file(name):
    with open(os.path.join(harness.ROOT, CONFIGS[name])) as f:
        return json.load(f)


def test_encoding_block_by_hand():
    conv = harness.load_model(config_file("fix-normal"))
    # the normal encoder's first block: 1 -> 4 channels, 256 -> 128, 11 taps,
    # excitation 4: conv1 (stride 1) 4*1*11*256, conv2 (stride 2) 4*4*11*128,
    # the shortcut 4*1*2*128, fc1 256*4, fc2 4*128, the 1x1 conv 4*1*128
    assert conv.encoding_block_macs(1, 4, 256, 128, 11, 2, 4) == \
        11264 + 22528 + 1024 + 1024 + 512 + 512
    # a decoders' stride-1 block, 4 -> 4 at 256, 11 taps, excitation 2: two
    # convs of 4*4*11*256 and the excitation's 4*(256*2 + 2*256)
    assert conv.encoding_block_macs(4, 4, 256, 256, 11, 1, 2) == 2 * 45056 + 4096


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_counts_match_torch_flop_counter(name):
    """The model module's ``macs`` against the counter on its own forwards:
    the counter sees the convolutions and matrix products, which is all
    that ``macs`` counts."""
    config = config_file(name)
    cfg, model = config["config"], harness.load_model(config)
    gen = torch.Generator().manual_seed(0)
    w = {role: {n: t[0] for n, t in sd.items()}
         for role, sd in ref.make_weights(model.layout(cfg), 1, gen, "cpu").items()}
    x = torch.rand(2, cfg["dim_in"])
    z = torch.randn(2, cfg["nstyle"])
    counts = []
    for role, fn, args in (("enc", model.encoder, (x,)), ("dec", model.decoder, (z,)),
                           ("dis", model.discriminator, (z, 1.0))):
        with FlopCounterMode(display=False) as fc:
            fn(cfg, ref.Net(w[role], False), *args)
        counts.append(fc.get_total_flops() / 2 / 2)
    assert tuple(counts) == model.macs(cfg)


def test_kendall_bound_by_hand():
    # T 1, B 4, K 1, all 6 pairs untied: reads 2*4, writes 5 + 1 + 2*4 words;
    # 4*6 + 4*6 operations
    t_ms, by = flops.bound("kendall_pair_sums", 1, 4, 1, 6)
    assert by == "bytes"
    assert t_ms == pytest.approx((8 + 5 + 1 + 8) * 4 / flops.PEAK_BYTES_PER_S * 1e3)
    # T 32, B 1024, K 5, every pair untied: 4 + 4 operations a pair
    pairs = 32 * 5 * (1024 * 1024 - 1024) // 2
    t_ms, by = flops.bound("kendall_pair_sums", 32, 1024, 5, pairs)
    assert by == "operations"
    assert t_ms == pytest.approx(8 * pairs / flops.PEAK_F32_OPS_PER_S * 1e3)
    assert flops.bound("kendall_pair_sums", 1, 4, 1, 6, rows=False)[0] < \
        flops.bound("kendall_pair_sums", 1, 4, 1, 6)[0]


def test_untied_pairs():
    import numpy as np

    d = np.array([[1.0, 4.0], [2.0, 4.0], [3.0, 5.0]])
    assert flops.untied_pairs(d) == 3 + 2


def test_k3_bound_by_hand():
    b, c, L, K, E = 1050, 4, 256, 11, 2
    ops = b * (2 * 2 * c * c * K * L + (15 + 4 * E) * c * L)
    t_ms, by = flops.k3_bound(b, c)
    assert by == "operations"
    assert t_ms == pytest.approx(ops / flops.PEAK_F32_OPS_PER_S * 1e3)
