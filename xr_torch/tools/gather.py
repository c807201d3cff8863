"""The gathers of the texture-fetch microbenchmarks, with the reference's
layouts: each public function launches its CUDA kernel (csrc/gather.cu) on
CUDA tensors, and takes its plain PyTorch version (``*_plain``) only for
tensors on the CPU.

The ``*_plain`` functions are the definitions. The ``*_rows_plain`` ones
are the algorithm of the kernels that first write the channel-major table
row-major (``table_rows_plain``: (S, W) -> (W, S), so that the S values of
one index are one contiguous row) and gather whole rows: the 16-channel
quad gather runs it on the card, the lane gather as a variant of the sweep
tool. ``quad_gather1_slices_plain`` is the algorithm of the one-channel
gather's slice design, another variant of the sweep tool (the shipped
kernel reads the row in place): the row cut into slices that fit a CTA's
shared memory, every element written once, by the slice that holds its
index. They equal the definitions bit for bit.

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
    return torch.where(ok, _wrap_u32(tab[:, i].sum(0, dtype=I64)), 0)


def _wrap_u32(s: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 sum as int32 bits."""
    s = s & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(I32)


def table_rows_plain(tab: torch.Tensor) -> torch.Tensor:
    """The (S, W) table row-major, (W, S): what the transpose kernel writes
    into the launch's scratch."""
    return tab.t().contiguous()


def quad_gather_rows_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """``quad_gather_plain`` by the kernels' algorithm: the table row-major,
    each index's row of S words gathered as one and summed."""
    i, ok = _in_row(idx, tab.shape[1])
    rows = table_rows_plain(tab)
    return torch.where(ok, _wrap_u32(rows[i].sum(-1, dtype=I64)), 0)


def lane_gather_rows_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """``lane_gather_plain`` by the transposed design: the table row-major,
    column idx[0, j]'s S words gathered as one row, the (W, S) result
    written back channel-major."""
    i, ok = _in_row(idx[0], tab.shape[1])
    rows = table_rows_plain(tab)
    return torch.where(ok[:, None], rows[i], 0).t().contiguous()


def quad_gather1_plain(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """out[...] = tab[0, idx[...]] — ``tools/microbench_gather.py:133``'s
    one-channel gather."""
    i, ok = _in_row(idx, tab.shape[1])
    return torch.where(ok, tab[0][i], 0)


P3_SLICE_WORDS = 200 * 256  # the most words of a slice (csrc/gather.cu, XR_P3_SLICE_KB)


def quad_gather1_slices(width: int, slice_words: int = P3_SLICE_WORDS):
    """The slice design's cut of a row of `width` words: (K, sw), K slices of sw
    words (a multiple of 4, at most slice_words), the last one shorter."""
    k = -(-width // slice_words)
    sw = -(-(-(-width // k)) // 4) * 4
    return -(-width // sw), sw


def quad_gather1_slices_plain(idx: torch.Tensor, tab: torch.Tensor,
                              slice_words: int = P3_SLICE_WORDS, writes=None) -> torch.Tensor:
    """``quad_gather1_plain`` by the slice design's algorithm: slice k holds words
    [k * sw, (k + 1) * sw) of row 0; an element is written by the slice its
    index falls into, and by slice 0 (as 0) where the index is outside the
    row. No element is written twice and none is left: `writes`, if given
    (zeros of idx's shape), counts them."""
    PP = tab.shape[1]
    K, sw = quad_gather1_slices(PP, slice_words)
    out = torch.empty_like(idx)
    for k in range(K):
        lo = k * sw
        words = min(sw, PP - lo)
        part = tab[0, lo:lo + words]
        hit = (idx >= lo) & (idx < lo + words)
        out[hit] = part[(idx[hit] - lo).long()]
        if k == 0:
            outside = (idx < 0) | (idx >= PP)
            out[outside] = 0
            hit = hit | outside
        if writes is not None:
            writes += hit
    return out


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
