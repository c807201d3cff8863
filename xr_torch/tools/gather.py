"""The gathers of the texture-fetch microbenchmarks, with the reference's
layouts: each public function launches its CUDA kernel (csrc/gather.cu) on
CUDA tensors, and takes its plain PyTorch version (``*_plain``) only for
tensors on the CPU.

u32 tables travel as int32 bit patterns (torch's uint32 has few kernels);
an index outside the table row reads as 0 in the kernels and in the plain
versions alike.
"""

from __future__ import annotations

import torch

from xr_torch import kernels

I32, I64 = torch.int32, torch.int64


def _in_row(idx: torch.Tensor, width: int):
    """(index clamped into [0, width), mask of indices inside it)."""
    ok = (idx >= 0) & (idx < width)
    return torch.where(ok, idx, 0).long(), ok


def lane_gather_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[s, j] = tab[s, idx[0, j]] for idx (1, W) i32, tab (S, W) i32 or
    f32 — the lane gather of ``tools/probe_lanegather.py:26``."""
    i, ok = _in_row(idx[0], tab.shape[1])
    return torch.where(ok[None, :], tab[:, i], 0)


def quad_gather_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[...] = sum over s of tab[s, idx[...]] for tab (S, PP) i32 holding
    u32 bits, wrapping mod 2^32 — ``tools/microbench_gather.py:108``'s
    16-channel gather. The sum runs in int64 (sign-extended terms are
    congruent mod 2^32 to the u32 ones) and is cut back to its low 32 bits."""
    i, ok = _in_row(idx, tab.shape[1])
    s = tab[:, i].sum(0, dtype=I64) & 0xFFFFFFFF
    s = torch.where(s >= 2**31, s - 2**32, s).to(I32)
    return torch.where(ok, s, 0)


def quad_gather1_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[...] = tab[0, idx[...]] — ``tools/microbench_gather.py:133``'s
    one-channel gather."""
    i, ok = _in_row(idx, tab.shape[1])
    return torch.where(ok, tab[0][i], 0)


def lane_gather(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """P1: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if tab.device.type == "cpu":
        return lane_gather_plain(idx, tab)
    return kernels.lane_gather(idx, tab)


def quad_gather(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """P2: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if tab.device.type == "cpu":
        return quad_gather_plain(idx, tab)
    return kernels.quad_gather(idx, tab)


def quad_gather1(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """P3: the kernel on CUDA tensors, the plain version on CPU tensors."""
    if tab.device.type == "cpu":
        return quad_gather1_plain(idx, tab)
    return kernels.quad_gather1(idx, tab)
