"""Dense AABB-overlap pair counting (K5) and the pair budget it suggests.

Counterpart of ``edyn_tpu/ops/overlap_count.py`` (Pallas kernel
``count_overlaps``): the number of pairs i < j of valid AABBs that overlap
on all three axes, without materialising the [N, N] mask. The CUDA kernel
is ``edyn_tpu_torch/csrc/overlap_count.cu``; ``count_overlaps_plain`` is its
plain PyTorch version, a dense comparison in row blocks so memory stays
bounded at 10k+ bodies. The kernel is templated on the scalar type, with a
float and a double entry point. The wrapper takes the plain version for
CPU tensors and launches the entry of the boxes' dtype for CUDA tensors,
never falling back or casting; ``LAUNCHES["count_overlaps"]`` counts the
float entry's launches, ``LAUNCHES_F64`` the double entry's.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_lib

ROW_BLOCK = 512   # rows per step of the plain version
INT32_MAX = 2**31 - 1

LAUNCHES = {"count_overlaps": 0}
LAUNCHES_F64 = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts():
    for counts in (LAUNCHES, LAUNCHES_F64):
        for k in counts:
            counts[k] = 0


def count_overlaps_plain(aabb_min, aabb_max, valid) -> int:
    """K5's plain version: pairs i < j, both valid, whose boxes overlap on
    every axis (touching counts)."""
    N = aabb_min.shape[0]
    total = 0
    for i0 in range(0, N, ROW_BLOCK):
        i1 = min(N, i0 + ROW_BLOCK)
        o = (torch.all(aabb_min[i0:i1, None, :] <= aabb_max[None, i0:, :], -1)
             & torch.all(aabb_max[i0:i1, None, :] >= aabb_min[None, i0:, :],
                         -1))
        o &= valid[i0:i1, None] & valid[None, i0:]
        gi = torch.arange(i0, i1, device=o.device)[:, None]
        gj = torch.arange(i0, N, device=o.device)[None, :]
        total += int((o & (gi < gj)).sum())
    return total


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"edyn_count_overlaps": [_P, _P, _P, _I, _P, _P],
              "edyn_count_overlaps_f64": [_P, _P, _P, _I, _P, _P]}


def count_overlaps_tensor(aabb_min, aabb_max, valid):
    """K5's count as a one-element int64 tensor on the inputs' device,
    without waiting for it: the plain version for CPU tensors, the kernel
    for CUDA tensors. aabb_min, aabb_max [N, 3] float32 or float64, valid
    [N] bool."""
    if cuda_lib.on_cpu(aabb_min, aabb_max, valid):
        return torch.tensor([count_overlaps_plain(aabb_min, aabb_max, valid)])
    N = aabb_min.shape[0]
    dt = aabb_min.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"aabb_min: float32 or float64 expected, got {dt}")
    cuda_lib.check(aabb_min, "aabb_min", (N, 3), dt)
    cuda_lib.check(aabb_max, "aabb_max", (N, 3), dt)
    cuda_lib.check(valid, "valid", (N,), torch.bool)
    lib = cuda_lib.load("overlap_count", SIGNATURES)
    fn, counts = ((lib.edyn_count_overlaps_f64, LAUNCHES_F64)
                  if dt == torch.float64
                  else (lib.edyn_count_overlaps, LAUNCHES))
    total = torch.empty((1,), dtype=torch.int64, device=aabb_min.device)
    rc = fn(aabb_min.data_ptr(), aabb_max.data_ptr(), valid.data_ptr(), N,
            total.data_ptr(), cuda_lib.stream(total))
    cuda_lib.launched(counts, "count_overlaps", rc, total.device)
    return total


def count_overlaps(aabb_min, aabb_max, valid) -> int:
    """K5: number of overlapping valid AABB pairs (strict upper triangle).
    Counted in 64 bits; raises where the count exceeds the int32 that the
    JAX kernel returns."""
    n = int(count_overlaps_tensor(aabb_min, aabb_max, valid).item())
    if n > INT32_MAX:
        raise OverflowError(f"{n} overlapping pairs exceed int32")
    return n


def suggest_max_pairs(state, slack: float = 1.5) -> int:
    """Measure the live pair count and suggest a padded budget."""
    n = count_overlaps(state.aabb_min.contiguous(),
                       state.aabb_max.contiguous(), state.valid.contiguous())
    return max(256, int(n * slack))
