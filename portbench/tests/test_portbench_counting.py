"""The benchmark's counts of operations and bytes agree with counts by
hand, for one convolution, one GroupNorm and one attention call, and the
reference records them as it runs on the meta device."""
import math

import pytest
import torch

from portbench import counting
from portbench.reference.ops import RefOps


def test_conv_by_hand():
    # 3x3, 64 -> 128 channels, 2 x 32 x 32 out: 2 * (2*128*32*32) * 64*9 operations
    flops, nbytes = counting.conv_counts((2, 64, 32, 32), (128, 64, 3, 3), (2, 128, 32, 32), 4)
    assert flops == 2 * (2 * 128 * 32 * 32) * 64 * 9 == 301989888
    assert nbytes == (2 * 64 * 32 * 32 + 128 * 64 * 9 + 2 * 128 * 32 * 32) * 4


def test_groupnorm_by_hand():
    n = 1 * 256 * 64 * 64
    assert counting.gn_bytes(n, 0, 2) == 2 * n * 2
    assert counting.gn_bytes(n, 256, 4) == (2 * n + 256) * 4


def test_attention_by_hand():
    # one head of 512 over 256 tokens: QK^T and PV, 2 * 256 * 256 * 512 each
    flops, nbytes = counting.attention_counts(1, 256, 256, 512, 4)
    assert flops == 2 * (2 * 256 * 256 * 512)
    assert nbytes == 4 * 256 * 512 * 4


def test_bound_takes_the_larger():
    assert counting.bound_s(67e12, 0, "float32") == pytest.approx(1.0)
    assert counting.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert counting.bound_s(989e12, 3.35e12 / 2, "bfloat16") == pytest.approx(1.0)


def test_reference_records_its_calls_on_meta():
    c = counting.Counter(4)
    ops = RefOps("f32", c)
    x = torch.empty(2, 64, 32, 32, device="meta")
    w = torch.empty(128, 64, 3, 3, device="meta")
    ops.conv2d(x, w, None, padding=1)
    y = torch.empty(2, 128, 32, 32, device="meta")
    ops.group_norm(y, torch.empty(128, device="meta"), torch.empty(128, device="meta"), 1e-6,
                   silu=True, pre_add=torch.empty(2, 128, device="meta"))
    q = torch.empty(1, 256, 512, device="meta")
    ops.attention(q, q, q, 1, legacy_scale=False)
    assert c.flops(["gemm"]) == 301989888
    assert c.nbytes(["k1"]) == counting.gn_bytes(2 * 128 * 32 * 32, 256, 4)
    assert c.flops(["k2"]) == 4 * 256 * 256 * 512
    assert c.n_calls() == 3


def test_counter_bound_sums_calls():
    c = counting.Counter(2)
    c.add("k2", 989e9, 0)
    c.add("k2", 989e9, 0)
    c.add("gemm", 989e12, 0)
    assert c.bound_s(["k2"], "bfloat16") == pytest.approx(2e-3)
    assert math.isclose(c.flops(), 2 * 989e9 + 989e12)
