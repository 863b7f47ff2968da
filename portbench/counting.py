"""The benchmark's yardstick for work: the operations and bytes of each
convolution, matrix product, GroupNorm and attention, computed from shapes,
the table of the card's peaks, and the bound of a call.

The counting follows the rule of the port's own kernel table (PERF.md §6):
operations are the multiply-adds the mathematics needs, two per
multiply-add; bytes are each input read once and each output written once,
whatever a kernel reads again.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, Tuple

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "conv_counts", "matmul_counts", "gn_bytes",
           "attention_counts", "bound_s", "Counter"]

# NVIDIA's data sheet for the H100 SXM part, dense rates, at the full 700 W
# power limit: float32 outside the tensor cores (the f32 cells run with
# TF32 off) and bfloat16 on the tensor cores; HBM3 at 3.35 TB/s.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _numel(shape: Iterable[int]) -> int:
    return math.prod(int(s) for s in shape)


def conv_counts(x_shape, w_shape, out_shape, itemsize: int) -> Tuple[int, int]:
    """A convolution's (operations, bytes): 2 x out elements x Cin/groups x
    kh x kw operations; x, the weight and the output each moved once."""
    cin_per_group, kh, kw = w_shape[1], w_shape[2], w_shape[3]
    flops = 2 * _numel(out_shape) * cin_per_group * kh * kw
    nbytes = (_numel(x_shape) + _numel(w_shape) + _numel(out_shape)) * itemsize
    return flops, nbytes


def matmul_counts(a_shape, b_shape, out_shape, itemsize: int) -> Tuple[int, int]:
    """A (batched) product [..., m, k] @ [..., k, n]: 2 x out elements x k
    operations; both operands and the output moved once."""
    k = a_shape[-1]
    flops = 2 * _numel(out_shape) * k
    nbytes = (_numel(a_shape) + _numel(b_shape) + _numel(out_shape)) * itemsize
    return flops, nbytes


def gn_bytes(n: int, extra: int, itemsize: int) -> int:
    """K1's bytes for a map of n elements: x read and y written; `extra`
    elements of a fused per-channel pre-add or FiLM scale and shift are
    read once."""
    return (2 * n + extra) * itemsize


def attention_counts(b: int, tq: int, tk: int, c: int, itemsize: int) -> Tuple[int, int]:
    """K2 over all heads of C channels: QK^T and PV, 4 B Tq Tk C operations,
    q, k, v read and o written once."""
    return 4 * b * tq * tk * c, (2 * b * tq * c + 2 * b * tk * c) * itemsize


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak of `dtype` and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


class Counter:
    """Calls counted by (kind, operations, bytes): kinds "gemm"
    (convolutions, linears, matrix products), "k1" (GroupNorm) and "k2"
    (the UNets' attention)."""

    def __init__(self, itemsize: int):
        self.itemsize = itemsize
        self.calls: Dict[Tuple[str, int, int], int] = collections.Counter()

    def add(self, kind: str, flops: int, nbytes: int) -> None:
        self.calls[(kind, int(flops), int(nbytes))] += 1

    def flops(self, kinds=None) -> int:
        return sum(f * n for (k, f, _), n in self.calls.items() if kinds is None or k in kinds)

    def nbytes(self, kinds=None) -> int:
        return sum(b * n for (k, _, b), n in self.calls.items() if kinds is None or k in kinds)

    def bound_s(self, kinds, dtype: str) -> float:
        """The sum over calls of each call's own bound."""
        return sum(bound_s(f, b, dtype) * n for (k, f, b), n in self.calls.items()
                   if k in kinds)

    def n_calls(self, kinds=None) -> int:
        return sum(n for (k, _, _), n in self.calls.items() if kinds is None or k in kinds)
