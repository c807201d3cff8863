"""Textures and the flattened mip pyramids, uniform and ragged (host numpy;
port of ``xr/scene/texture.py``). Quads are stored as int32 holding the
reference's u32 RGB8 bits."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from xr_torch.core.types import RaggedPyramid, TexturePyramid


def _pack_quads(levels) -> np.ndarray:
    """Sampling layout: for each level-l texel a 13-entry row — its own 2x2
    wrap quad (p, p+x, p+y, p+xy), then the 3x3 block of level l+1 anchored
    at (j//2-1, i//2-1) — each texel packed RGB8. One row holds a whole
    trilinear footprint. Returns (P, 13) uint32."""
    packed = []
    for lv in levels:
        q8 = np.floor(np.clip(lv, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint32)
        packed.append(q8[:, :, 0] | (q8[:, :, 1] << 8) | (q8[:, :, 2] << 16))

    rows = []
    for l, u32 in enumerate(packed):
        s = u32.shape[0]
        xs = np.roll(u32, -1, axis=1)
        ys = np.roll(u32, -1, axis=0)
        xy = np.roll(ys, -1, axis=1)
        own = np.stack([u32, xs, ys, xy], axis=-1)

        par = packed[min(l + 1, len(packed) - 1)]
        sp = par.shape[0]
        j = np.arange(s)[:, None]
        i = np.arange(s)[None, :]
        jp = (j // 2 - 1) % sp
        ip = (i // 2 - 1) % sp
        blocks = [par[(jp + r) % sp, (ip + c) % sp] for r in range(3) for c in range(3)]
        parent = np.stack(blocks, axis=-1)
        rows.append(np.concatenate([own, parent], axis=-1).reshape(-1, 13))
    return np.concatenate(rows, axis=0)


def build_pyramid(images: Sequence[np.ndarray]) -> TexturePyramid:
    """Flatten square power-of-two (S, S, 3) f32 textures with box-filter
    mips down to 1x1."""
    imgs = [np.asarray(im, np.float32) for im in images]
    s = imgs[0].shape[0]
    assert s & (s - 1) == 0 and s > 0, "texture size must be a power of two"
    for im in imgs:
        assert im.shape == (s, s, 3), f"all textures must be ({s},{s},3)"
    num_levels = s.bit_length()

    flats, quads = [], []
    for im in imgs:
        levels = [im]
        cur = im
        for _ in range(num_levels - 1):
            cur = 0.25 * (
                cur[0::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 0::2] + cur[1::2, 1::2]
            )
            levels.append(cur.astype(np.float32))
        flats.append(np.concatenate([lv.reshape(-1, 3) for lv in levels], axis=0))
        quads.append(_pack_quads(levels))

    return TexturePyramid(
        data=np.stack(flats, axis=0),
        quads=np.stack(quads, axis=0).view(np.int32),
        base_size=s,
        num_levels=num_levels,
    )


def _mip_levels(im: np.ndarray):
    """Box-filter mip chain of a square power-of-two image, down to 1x1."""
    s = im.shape[0]
    levels = [im.astype(np.float32)]
    cur = levels[0]
    for _ in range(s.bit_length() - 1):
        cur = 0.25 * (
            cur[0::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 0::2] + cur[1::2, 1::2]
        )
        levels.append(cur.astype(np.float32))
    return levels


def chain_rows(size: int) -> int:
    """Quad-table rows of one texture's full mip chain (a row a texel,
    every level down to 1x1)."""
    return sum((size >> k) ** 2 for k in range(size.bit_length()))


def build_ragged_pyramid(
    images: Sequence[np.ndarray], max_total_rows: int | None = None
) -> RaggedPyramid:
    """Mixed-size pyramid: each (S_i, S_i, 3) f32 square power-of-two
    texture keeps its native size. The per-texture mip chains (the box
    filter and 13-texel quad layout of build_pyramid) lie in one buffer
    that per-(texture, level) offset and size tables index. Levels past a
    texture's native chain repeat its 1x1 tail, so one static Lmax serves
    every texture.

    max_total_rows: optional texture area cap. While the quad table has
    more rows, the largest texture is replaced by its own first
    box-filtered mip (it loses only its finest level); ValueError if the
    textures need more rows even at 1x1. Sampler semantics are unchanged.
    """
    imgs = [np.asarray(im, np.float32) for im in images]
    for im in imgs:
        s = im.shape[0]
        assert s & (s - 1) == 0 and s > 0 and im.shape[:2] == (s, s), (
            f"textures must be square power-of-two, got {im.shape}"
        )
    if max_total_rows is not None:
        while sum(chain_rows(im.shape[0]) for im in imgs) > max_total_rows:
            k = max(range(len(imgs)), key=lambda i: imgs[i].shape[0])
            if imgs[k].shape[0] <= 1:
                raise ValueError(
                    f"max_total_rows={max_total_rows} unreachable: "
                    f"{len(imgs)} textures need "
                    f"{sum(chain_rows(im.shape[0]) for im in imgs)} rows "
                    "even at 1x1"
                )
            imgs[k] = _mip_levels(imgs[k])[1]
    lmax = max(im.shape[0].bit_length() for im in imgs)

    flats, quads = [], []
    offs = np.zeros((len(imgs), lmax), np.int64)
    sizes = np.zeros((len(imgs), lmax), np.int64)
    cursor = 0
    for t, im in enumerate(imgs):
        levels = _mip_levels(im)
        q = _pack_quads(levels)
        flats.append(np.concatenate([lv.reshape(-1, 3) for lv in levels]))
        quads.append(q)
        for k in range(lmax):
            kk = min(k, len(levels) - 1)
            sizes[t, k] = levels[kk].shape[0]
            offs[t, k] = cursor + sum(levels[j].shape[0] ** 2 for j in range(kk))
        cursor += q.shape[0]

    return RaggedPyramid(
        data=np.concatenate(flats, axis=0),
        quads=np.concatenate(quads, axis=0).view(np.int32),
        level_offset=offs.astype(np.int32),
        level_size=sizes.astype(np.int32),
        base_size_per_tex=np.asarray([im.shape[0] for im in imgs], np.int32),
        num_levels=lmax,
    )


def checkerboard(size: int = 256, cells: int = 8, color_a=(0.95, 0.95, 0.95),
                 color_b=(0.15, 0.2, 0.45)) -> np.ndarray:
    """Checker texture (high-frequency content that exercises the mips)."""
    ij = np.arange(size)
    cell = (ij * cells) // size
    mask = (cell[:, None] + cell[None, :]) % 2
    a = np.asarray(color_a, np.float32)
    b = np.asarray(color_b, np.float32)
    return np.where(mask[:, :, None] == 0, a, b).astype(np.float32)


def noise_texture(size: int = 256, seed: int = 3, lo=0.25, hi=1.0) -> np.ndarray:
    """Smooth value-noise RGB texture (terrain albedo)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((size, size, 3), np.float32)
    amp, cells = 1.0, 4
    total = 0.0
    while cells <= size:
        g = rng.random((cells, cells, 3)).astype(np.float32)
        yi = np.linspace(0, cells, size, endpoint=False)
        y0 = yi.astype(int) % cells
        y1 = (y0 + 1) % cells
        fy = (yi - yi.astype(int)).astype(np.float32)[:, None, None]
        row0 = g[y0]
        row1 = g[y1]
        col = np.linspace(0, cells, size, endpoint=False)
        x0 = col.astype(int) % cells
        x1 = (x0 + 1) % cells
        fx = (col - col.astype(int)).astype(np.float32)[None, :, None]
        v = (row0[:, x0] * (1 - fx) + row0[:, x1] * fx) * (1 - fy) + (
            row1[:, x0] * (1 - fx) + row1[:, x1] * fx
        ) * fy
        out += amp * v
        total += amp
        amp *= 0.55
        cells *= 2
    out /= total
    out = lo + (hi - lo) * (out - out.min()) / max(out.max() - out.min(), 1e-9)
    return out.astype(np.float32)
