"""Core math of the port against the reference on seeded random inputs:
fixed point exact (negative coordinates included), camera matrices within
1e-6, LOD + trilinear sampling within 1e-6 (log may differ by an ulp
between libraries), the u8 resolve exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xr.core import fixedpoint as rfp
from xr.core import math3d as rm3
from xr.core import shade_math as rsm
from xr.core.types import Camera as RefCamera
from xr.scene import texture as ref_tx
from xr_torch import convert
from xr_torch.core import fixedpoint as fp
from xr_torch.core import math3d as m3
from xr_torch.core import shade_math as sm
from xr_torch.core.types import Camera, TexturePyramid

# the suite runs several worker processes on shared cores: one torch
# thread each keeps them from oversubscribing the CPU
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ints(rng, shape, lo=-4000, hi=4000):
    return rng.integers(lo, hi, size=shape).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixedpoint_exact(seed):
    rng = np.random.default_rng(seed)
    xs, ys = _ints(rng, (500, 3)), _ints(rng, (500, 3))
    px, py = _ints(rng, (500,)), _ints(rng, (500,))
    T = torch.from_numpy
    for a, b in zip(fp.edge_coeffs(T(xs), T(ys)), rfp.edge_coeffs(xs, ys)):
        assert (a.numpy() == b).all()
    assert (fp.doubled_area(T(xs), T(ys)).numpy() == rfp.doubled_area(xs, ys)).all()
    m, es = fp.coverage(T(xs), T(ys), T(px), T(py))
    rm, res = rfp.coverage(xs, ys, px, py)
    assert (m.numpy() == rm).all()
    for e, re in zip(es, res):
        assert (e.numpy() == re).all()
    for w, rw in zip(fp.barycentrics_f32(*es), rfp.barycentrics_f32(*res)):
        assert (w.numpy() == rw).all()
    coords = (rng.standard_normal(1000) * 900).astype(np.float32)
    assert (fp.snap_to_fixed(T(coords), 4).numpy() == rfp.snap_to_fixed(coords, 4)).all()
    # integer floor semantics on negatives (ceil division as -(-a // b))
    a = T(_ints(rng, (1000,)))
    assert ((-(-a // 4)).numpy() == -(-a.numpy() // 4)).all()
    assert ((a >> 1).numpy() == (a.numpy() >> 1)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_matrices_close(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        eye = (rng.standard_normal(3) * 10).astype(np.float32)
        target = (rng.standard_normal(3)).astype(np.float32)
        kw = dict(
            eye=eye, target=target, up=np.asarray((0, 1, 0), np.float32),
            fov_y=np.float32(rng.uniform(0.5, 1.5)),
            near=np.float32(rng.uniform(0.1, 1.0)), far=np.float32(rng.uniform(50, 200)),
        )
        aspect = float(rng.uniform(0.5, 2.0))
        rv, rp = rm3.camera_matrices(RefCamera(**{k: jnp.asarray(v) for k, v in kw.items()}), aspect, jnp)
        v, p = m3.camera_matrices(convert.camera_to_torch(Camera(**kw), CPU), aspect, CPU)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=0, atol=1e-6)
        np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pyramids():
    ref = ref_tx.build_pyramid([ref_tx.checkerboard(64, 8), ref_tx.noise_texture(64)])
    port = TexturePyramid(
        data=torch.from_numpy(np.asarray(ref.data)),
        quads=torch.from_numpy(np.asarray(ref.quads).view(np.int32)),
        base_size=ref.base_size, num_levels=ref.num_levels,
    )
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_lod_and_trilinear_close(seed, pyramids):
    ref, port = pyramids
    rng = np.random.default_rng(seed)
    n = 4000
    d = [(rng.standard_normal(n) * 10.0 ** rng.uniform(-4, 0, n)).astype(np.float32) for _ in range(4)]
    u = (rng.standard_normal(n) * 3).astype(np.float32)
    v = (rng.standard_normal(n) * 3).astype(np.float32)
    tex = rng.integers(0, 2, n).astype(np.int32)
    rlod = rsm.lod_from_derivs(*[jnp.asarray(x) for x in d], ref.base_size, jnp)
    lod = sm.lod_from_derivs(*[torch.from_numpy(x) for x in d], port.base_size)
    np.testing.assert_allclose(lod.numpy(), np.asarray(rlod), rtol=0, atol=1e-6)
    # sample at the SAME lod so the sampler is compared on its own
    rq = ref.replace(quads=jnp.asarray(ref.quads), data=jnp.asarray(ref.data))
    rc = rsm.sample_trilinear(rq, jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), rlod, jnp)
    c = sm.sample_trilinear(port, torch.from_numpy(tex), torch.from_numpy(u),
                            torch.from_numpy(v), torch.from_numpy(np.array(rlod)))
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=0, atol=1e-6)


def test_resolve_u8_exact():
    rng = np.random.default_rng(5)
    c = (rng.standard_normal((64, 64, 3)) * 0.7 + 0.5).astype(np.float32)
    c[0, :4, 0] = [0.5 / 255, 1.5 / 255, -0.0, 1.0]
    assert (sm.resolve_u8(torch.from_numpy(c)).numpy() == rsm.resolve_u8(c, np)).all()
    assert (sm.resolve_u8(torch.from_numpy(c)).numpy() == np.asarray(rsm.resolve_u8(jnp.asarray(c), jnp))).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_tri_fragment_exact(seed):
    from xr.raster import common as rrc
    from xr_torch.raster import common as rc

    rng = np.random.default_rng(seed)
    # positive-orientation triangles around the origin, points around them
    xs, ys = _ints(rng, (64, 1, 3), -60, 60), _ints(rng, (64, 1, 3), -60, 60)
    area = rfp.doubled_area(xs, ys)
    xs[..., [1, 2]] = np.where((area < 0)[..., None], xs[..., [2, 1]], xs[..., [1, 2]])
    ys[..., [1, 2]] = np.where((area < 0)[..., None], ys[..., [2, 1]], ys[..., [1, 2]])
    z = rng.uniform(-0.2, 1.2, (64, 1, 3)).astype(np.float32)
    px, py = _ints(rng, (1, 256), -70, 70), _ints(rng, (1, 256), -70, 70)
    T = torch.from_numpy
    m, zf = rc.tri_fragment(T(xs), T(ys), T(z), T(px), T(py))
    rm_, rzf = rrc.tri_fragment(xs, ys, z, px, py)
    assert (m.numpy() == rm_).all() and m.numpy().any()
    assert (zf.numpy()[rm_] == rzf[rm_]).all()
    gx, gy = rc.pixel_grids(7, 5, 4, CPU)
    rgx, rgy = rrc.pixel_grids(7, 5, 4)
    assert (gx.numpy() == rgx).all() and (gy.numpy() == rgy).all()


def test_shade_vertex_lit_point_lights_close():
    from xr.core.types import Lights as RefLights
    from xr_torch.core.types import Lights

    rng = np.random.default_rng(3)
    kw = dict(dir_dirs=[(-0.3, -0.8, -0.5), (0.5, -0.2, 0.1)],
              dir_colors=[(1.0, 0.9, 0.8), (0.2, 0.3, 0.4)],
              pt_pos=[(1.0, 2.0, 3.0)], pt_colors=[(0.5, 0.5, 0.2)])
    n = rng.standard_normal((300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    base = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    kd = rng.uniform(0, 1, 300).astype(np.float32)
    pos = rng.standard_normal((300, 3)).astype(np.float32)
    ref = rsm.shade_vertex_lit(n, base, kd, RefLights.make(**kw), np, world_pos=pos)
    lt = Lights.make(**kw)
    lt = Lights(**{f: torch.from_numpy(getattr(lt, f)) for f in
                   ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient")})
    T = torch.from_numpy
    out = sm.shade_vertex_lit(T(n), T(base), T(kd), lt, world_pos=T(pos))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_lambert_and_flat_face_close():
    from xr.core.types import Lights as RefLights
    from xr_torch.core.types import Lights

    rng = np.random.default_rng(5)
    n = rng.standard_normal((200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ld = np.asarray((-0.5, -0.7, -0.5), np.float32)
    T = torch.from_numpy
    lam = sm.lambert(T(n), T(ld)).numpy()
    np.testing.assert_allclose(lam, rsm.lambert(n, ld), rtol=0, atol=1e-6)
    assert (lam == 0).any() and (lam > 0).any()
    kw = dict(dir_dirs=[tuple(ld)], dir_colors=[(1.0, 1.0, 1.0)], ambient=(0.15, 0.15, 0.15),
              pt_pos=[(0.5, 2.0, 1.0)], pt_colors=[(0.3, 0.2, 0.1)])
    base = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    kd = rng.uniform(0, 1, 200).astype(np.float32)
    cen = rng.standard_normal((200, 3)).astype(np.float32)
    lt = Lights.make(**kw)
    lt = Lights(**{f: T(getattr(lt, f)) for f in
                   ("dir_dirs", "dir_colors", "pt_pos", "pt_colors", "ambient")})
    for c in (None, cen):
        ref = rsm.shade_flat_face(n, base, kd, RefLights.make(**kw), np, centroid=c)
        out = sm.shade_flat_face(T(n), T(base), T(kd), lt, centroid=None if c is None else T(c))
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
