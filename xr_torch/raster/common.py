"""Per-fragment formulas shared by every visibility path of the port (port of
``xr/raster/common.py``): integer coverage, the depth interpolation and the
strict (z, id) lexicographic resolve, which makes the result independent of
the order in which triangles are visited.
"""

from __future__ import annotations

import torch

from xr_torch.core import fixedpoint as fp

BG_TRI_ID = 2**31 - 1  # background id: loses every id tie
BG_DEPTH = float("inf")  # internal background depth; frames report 1.0


def pixel_grids(width: int, height: int, subpixel: int, device):
    """Fixed-point pixel-center grids (H, W) int32."""
    px = fp.pixel_center_fixed(torch.arange(width, device=device), subpixel)
    py = fp.pixel_center_fixed(torch.arange(height, device=device), subpixel)
    return (
        px[None, :].expand(height, width),
        py[:, None].expand(height, width),
    )


def fragment_depth(e0, e1, e2, z):
    """Interpolated NDC depth ((l0*z0 + l1*z1) + l2*z2) from exact edges."""
    l0, l1, l2 = fp.barycentrics_f32(e0, e1, e2)
    return (l0 * z[..., 0] + l1 * z[..., 1]) + l2 * z[..., 2]


def depth_range_mask(zf):
    """D3D depth-range clip: fragments outside [0, 1] are discarded."""
    return (zf >= 0.0) & (zf <= 1.0)


def resolve_better(z_new, id_new, z_best, id_best):
    """Lexicographic (z, id) strict improvement test."""
    return (z_new < z_best) | ((z_new == z_best) & (id_new < id_best))


def new_carry(shape, depth_test: bool, device):
    """(z, id) carry of a fold: (+inf, BG), or id -1 ("none") in painter's
    order."""
    zb = torch.full(shape, BG_DEPTH, dtype=torch.float32, device=device)
    tb = torch.full(shape, BG_TRI_ID if depth_test else -1, dtype=torch.int32, device=device)
    return zb, tb


def merge_chunk(zb, tb, zf, ids, depth_test: bool):
    """Merge one chunk into the (N, ...) carry: zf (N, K, ...) with +inf
    where uncovered, ids broadcasting against it. With the depth test the
    chunk's (z, id) lexicographic minimum wins if strictly better; in
    painter's order its highest covered id wins if higher."""
    if depth_test:
        z_new = zf.amin(1)
        id_new = torch.where(zf == z_new[:, None], ids, BG_TRI_ID).amin(1)
        id_new = torch.where(torch.isinf(z_new), BG_TRI_ID, id_new)
        # -0.0 ties 0.0 and the id decides: the depth kept is the winner's own
        own = (ids == id_new[:, None]) & (zf == z_new[:, None])
        z_new = torch.where(own, zf, BG_DEPTH).amin(1)
        upd = resolve_better(z_new, id_new, zb, tb)
    else:
        keyed = torch.where(torch.isinf(zf), -1, ids.expand(zf.shape))
        idx = keyed.argmax(1, keepdim=True)
        id_new = torch.gather(keyed, 1, idx)[:, 0]
        z_new = torch.gather(zf, 1, idx)[:, 0]
        upd = id_new > tb
    return torch.where(upd, z_new, zb), torch.where(upd, id_new, tb)


def final_ids(tb, depth_test: bool):
    """Painter's "none" (-1) becomes BG once the fold is done."""
    return tb if depth_test else torch.where(tb < 0, BG_TRI_ID, tb)


def tri_fragment(xs, ys, z, px, py, depth_test_range: bool = True):
    """Coverage + depth of setup triangles at fixed-point points."""
    mask, (e0, e1, e2) = fp.coverage(xs, ys, px, py)
    zf = fragment_depth(e0, e1, e2, z)
    if depth_test_range:
        mask = mask & depth_range_mask(zf)
    return mask, zf
