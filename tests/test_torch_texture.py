"""The port's ragged texture pyramid and address modes against the
reference on the CPU, same numpy inputs on both sides:
- ``build_ragged_pyramid``: every array equal to the reference's, with and
  without the ``max_total_rows`` area cap, and the cap's ValueError;
- ``sample_trilinear`` on a ragged pyramid and with ``addr`` against
  ``xr.core.shade_math.sample_trilinear(xp=np)``: within 1e-6 absolute (the
  op order is the reference's, so the difference is expected to be 0);
- ``addr=None`` equals an all-zero ``addr``; a ragged pyramid of equal sizes
  equals the uniform one bit for bit; ``mip_math="closed"`` on a ragged
  pyramid raises ValueError; a 128-texel texture in a 10-level pyramid keeps
  sampling its 1x1 tail under clamp at LODs 7-9;
- ``lod_from_derivs`` with a per-pixel base size.
"""

import numpy as np
import pytest
import torch

from xr.core import shade_math as ref_sm
from xr.scene import texture as ref_tx
from xr_torch import convert
from xr_torch.core import shade_math as sm
from xr_torch.core.types import Material
from xr_torch.scene import texture as tx

torch.set_num_threads(1)

SIZES = (128, 16, 512, 32)


def _images(sizes=SIZES, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, (s, s, 3)).astype(np.float32) for s in sizes]


def _assert_same_pyramid(got, want):
    assert got.num_levels == want.num_levels and got.num_textures == want.num_textures
    assert got.quads.dtype == np.int32
    assert (got.quads.view(np.uint32) == np.asarray(want.quads)).all()
    for f in ("data", "level_offset", "level_size", "base_size_per_tex"):
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all(), f


@pytest.mark.parametrize("cap", [None, 300_000, 90_000, 2_000], ids=str)
def test_build_ragged_pyramid_equals_reference(cap):
    imgs = _images()
    _assert_same_pyramid(tx.build_ragged_pyramid(imgs, cap),
                         ref_tx.build_ragged_pyramid(imgs, cap))


def test_area_cap_halves_the_largest_texture_only():
    got = tx.build_ragged_pyramid(_images(), 300_000)
    assert list(got.base_size_per_tex) == [128, 16, 256, 32]
    assert got.quads.shape[0] == sum(tx.chain_rows(s) for s in (128, 16, 256, 32)) <= 300_000
    assert tx.chain_rows(512) == 349_525


def test_capped_texture_samples_as_its_own_first_mip():
    """Under the cap the 512 map is its level 1: a sample at LOD >= 1 of the
    native chain equals the capped chain's at LOD - 1, a magnified one
    (LOD 0) does not."""
    imgs = _images()
    native, capped = tx.build_ragged_pyramid(imgs), tx.build_ragged_pyramid(imgs, 300_000)
    n = 2048
    _, u, v, _, _ = _samples(n, 1, 10, 23)
    tid = np.full(n, 2, np.int32)
    lod = np.random.default_rng(1).uniform(1.0, 9.0, n).astype(np.float32)
    a = _port_sample(native, tid, u, v, lod)
    b = _port_sample(capped, tid, u, v, lod - 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)  # lod - 1 rounds once more
    zero = np.zeros(n, np.float32)
    assert np.abs(_port_sample(native, tid, u, v, zero)
                  - _port_sample(capped, tid, u, v, zero)).max() > 0.1


def test_area_cap_unreachable_raises_like_the_reference():
    imgs = _images((4, 2, 2))
    with pytest.raises(ValueError) as ref_err:
        ref_tx.build_ragged_pyramid(imgs, 2)
    with pytest.raises(ValueError) as err:
        tx.build_ragged_pyramid(imgs, 2)
    assert str(err.value) == str(ref_err.value)


def _samples(n, ntex, lmax, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, ntex, n).astype(np.int32),
            rng.uniform(-2, 3, n).astype(np.float32),
            rng.uniform(-2, 3, n).astype(np.float32),
            rng.uniform(-1, lmax + 1, n).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int32))


def _port_sample(pyr, tid, u, v, lod, addr=None, **kw):
    t = torch.from_numpy
    return sm.sample_trilinear(convert.textures_to_torch(pyr, "cpu"), t(tid), t(u), t(v), t(lod),
                               addr=None if addr is None else t(addr), **kw).numpy()


@pytest.mark.parametrize("kind", ["ragged", "uniform"])
@pytest.mark.parametrize("with_addr", [False, True], ids=["repeat", "addr"])
def test_sample_trilinear_equals_reference(kind, with_addr):
    if kind == "ragged":
        ref_pyr = ref_tx.build_ragged_pyramid(_images())
        pyr, ntex = tx.build_ragged_pyramid(_images()), len(SIZES)
    else:
        ref_pyr = ref_tx.build_pyramid(_images((64, 64)))
        pyr, ntex = tx.build_pyramid(_images((64, 64))), 2
    tid, u, v, lod, addr = _samples(8192, ntex, pyr.num_levels, 11)
    a = addr if with_addr else None
    want = ref_sm.sample_trilinear(ref_pyr, tid, u, v, lod, np, addr=a)
    got = _port_sample(pyr, tid, u, v, lod, a)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if with_addr:  # the clamp does something on these samples
        assert (got != _port_sample(pyr, tid, u, v, lod)).any()


def test_sample_trilinear_takes_the_reference_pyramid():
    """convert carries the reference's RaggedPyramid (u32 quads) across."""
    ref_pyr = ref_tx.build_ragged_pyramid(_images())
    tid, u, v, lod, addr = _samples(2048, len(SIZES), ref_pyr.num_levels, 5)
    want = ref_sm.sample_trilinear(ref_pyr, tid, u, v, lod, np, addr=addr)
    np.testing.assert_allclose(_port_sample(ref_pyr, tid, u, v, lod, addr), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["ragged", "uniform"])
def test_addr_none_equals_zero_addr(kind):
    imgs = _images((64, 64))
    pyr = tx.build_ragged_pyramid(imgs) if kind == "ragged" else tx.build_pyramid(imgs)
    tid, u, v, lod, _ = _samples(4096, 2, pyr.num_levels, 7)
    a = _port_sample(pyr, tid, u, v, lod)
    b = _port_sample(pyr, tid, u, v, lod, np.zeros_like(tid))
    assert (a == b).all()


def test_ragged_of_equal_sizes_equals_uniform_bit_for_bit():
    imgs = _images((64, 64, 64))
    tid, u, v, lod, addr = _samples(4096, 3, 7, 13)
    for a in (None, addr):
        uni = _port_sample(tx.build_pyramid(imgs), tid, u, v, lod, a)
        rag = _port_sample(tx.build_ragged_pyramid(imgs), tid, u, v, lod, a)
        assert (uni == rag).all()


def test_closed_mip_math_on_a_ragged_pyramid_raises():
    imgs = _images((32, 16))
    tid, u, v, lod, _ = _samples(16, 2, 6, 1)
    with pytest.raises(ValueError):
        ref_sm.sample_trilinear(ref_tx.build_ragged_pyramid(imgs), tid, u, v, lod, np,
                                mip_math="closed")
    with pytest.raises(ValueError):
        _port_sample(tx.build_ragged_pyramid(imgs), tid, u, v, lod, mip_math="closed")
    # a uniform pyramid takes the flag and samples as with the tables
    uni = tx.build_pyramid(_images((32, 32)))
    assert (_port_sample(uni, tid, u, v, lod, mip_math="closed")
            == _port_sample(uni, tid, u, v, lod)).all()


@pytest.mark.parametrize("lod", [7.0, 8.25, 9.0])
def test_clamp_past_a_short_chain_samples_its_1x1_tail(lod):
    """A 128-texel texture has 8 levels; in a pyramid of 10 its levels 7-9
    repeat the 1x1 tail, whose half-texel is 0.5: under clamp u and v pin to
    exactly 0.5 and every sample is the texture's mean texel."""
    imgs = _images((512, 128))
    pyr = tx.build_ragged_pyramid(imgs)
    assert pyr.num_levels == 10 and list(pyr.level_size[1, 7:]) == [1, 1, 1]
    n = 256
    _, u, v, _, _ = _samples(n, 2, 10, 17)
    tid = np.ones(n, np.int32)
    lods = np.full(n, lod, np.float32)
    addr = np.ones(n, np.int32)
    got = _port_sample(pyr, tid, u, v, lods, addr)
    want = ref_sm.sample_trilinear(ref_tx.build_ragged_pyramid(imgs), tid, u, v, lods, np,
                                   addr=addr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    tail = pyr.quads[pyr.level_offset[1, 9], 0]
    texel = np.asarray([tail & 0xFF, (tail >> 8) & 0xFF, (tail >> 16) & 0xFF], np.float32) / 255.0
    np.testing.assert_allclose(got, np.broadcast_to(texel, got.shape), rtol=0, atol=1e-6)


def test_lod_from_derivs_takes_a_per_pixel_base_size():
    rng = np.random.default_rng(2)
    d = [rng.normal(0, 0.01, 512).astype(np.float32) for _ in range(4)]
    d[0][:4] = (0.0, 1e30, -1e30, np.inf)  # the clamp before squaring
    base = rng.choice(np.asarray([128, 256, 512], np.float32), 512)
    want = ref_sm.lod_from_derivs(*d, base, np)
    got = sm.lod_from_derivs(*[torch.from_numpy(x) for x in d], torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    one = sm.lod_from_derivs(*[torch.from_numpy(x) for x in d], 256).numpy()
    np.testing.assert_allclose(one, ref_sm.lod_from_derivs(*d, 256, np), rtol=0, atol=2e-6)


def test_material_table_addr_column():
    m = Material.table([{"tex_id": 0}, {"tex_id": 1, "tex_addr": 1}])
    assert list(m.tex_addr) == [0, 1]
    assert Material.table([{"tex_id": 0}, {"tex_id": 1}]).tex_addr is None
