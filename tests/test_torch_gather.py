"""The gather probes P1-P3 of the port against the Pallas kernels of the
reference tools, run with interpret=True on the CPU, on the same numpy
inputs: the plain versions (what the public functions run on CPU tensors)
must be bit-exact. The tools define their kernels inside ``main()`` and
``bench()``; the bodies here are those kernels', at small shapes. Also: the
public functions launch nothing on the CPU, an index outside the table row
reads as 0, the launch wrappers refuse CPU tensors, and the tools' inputs
are the reference tools' inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from xr_torch import kernels
from xr_torch.tools import gather, microbench_gather, probe_lanegather

torch.set_num_threads(1)


def _pallas_lane_gather(idx_np, tab_np):
    """tools/probe_lanegather.py:26-40 at the given shape."""
    S, W = tab_np.shape

    def k(idx_ref, tab_ref, out_ref):
        ii = jnp.broadcast_to(idx_ref[:], (S, W))
        out_ref[:] = jnp.take_along_axis(tab_ref[:], ii, axis=1)

    return np.asarray(pl.pallas_call(
        k,
        in_specs=[pl.BlockSpec((1, W), lambda: (0, 0)), pl.BlockSpec((S, W), lambda: (0, 0))],
        out_specs=pl.BlockSpec((S, W), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((S, W), tab_np.dtype),
        interpret=True,
    )(jnp.asarray(idx_np), jnp.asarray(tab_np)))


def _pallas_quad_gather(flat_np, tab_np, one_channel):
    """tools/microbench_gather.py:108-125 (k_gather) and :133-149
    (k_gather1) at the given shape."""
    NB = flat_np.shape[0]
    PP = tab_np.shape[1]

    def k_gather(idx_ref, tab_ref, out_ref):
        ii = idx_ref[:].reshape(1, 1024)
        rows = jnp.broadcast_to(ii, (16, 1024))
        g = jnp.take_along_axis(tab_ref[:], rows, axis=1)  # (16, 1024)
        out_ref[0] = g.sum(axis=0).reshape(8, 128)

    def k_gather1(idx_ref, tab_ref, out_ref):
        ii = idx_ref[:].reshape(1, 1024)
        g = jnp.take_along_axis(tab_ref[0:1, :], ii, axis=1)  # (1, 1024)
        out_ref[0] = g.reshape(8, 128)

    return np.asarray(pl.pallas_call(
        k_gather1 if one_channel else k_gather,
        grid=(NB,),
        in_specs=[pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0)),
                  pl.BlockSpec((16, PP), lambda b: (0, 0))],
        out_specs=pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((NB, 8, 128), jnp.uint32),
        interpret=True,
    )(jnp.asarray(flat_np), jnp.asarray(tab_np)))


def _quad_inputs(seed, NB=4, PP=1024):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 2**32, (16, PP), dtype=np.uint32)
    flat = rng.integers(0, PP, (NB, 8, 128)).astype(np.int32)
    return flat, tab


@pytest.mark.parametrize("S,dtype", [(8, np.uint32), (16, np.uint32), (16, np.float32)])
def test_lane_gather_matches_pallas(S, dtype):
    W = 1024
    rng = np.random.default_rng(S)
    tab_np = rng.integers(0, 1 << 20, size=(S, W)).astype(np.uint32)
    idx_np = rng.integers(0, 1000, size=(1, W)).astype(np.int32)
    if dtype == np.float32:
        tab_np = tab_np.astype(np.float32)
    want = _pallas_lane_gather(idx_np, tab_np)
    tab = torch.from_numpy(tab_np.view(np.int32) if dtype == np.uint32 else tab_np)
    kernels.reset_launches()
    got = gather.lane_gather(torch.from_numpy(idx_np), tab).numpy()
    assert not any(kernels.launches.values())
    assert got.dtype == tab.numpy().dtype
    assert np.array_equal(got.view(want.dtype), want)


@pytest.mark.parametrize("one_channel", [False, True], ids=["p2_16ch", "p3_1ch"])
def test_quad_gathers_match_pallas(one_channel):
    flat_np, tab_np = _quad_inputs(3)
    want = _pallas_quad_gather(flat_np, tab_np, one_channel)
    fn = gather.quad_gather1 if one_channel else gather.quad_gather
    kernels.reset_launches()
    got = fn(torch.from_numpy(flat_np), torch.from_numpy(tab_np.view(np.int32))).numpy()
    assert not any(kernels.launches.values())
    assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want)
    if not one_channel:  # and numpy's wrapping u32 sum
        assert np.array_equal(want, tab_np[:, flat_np].sum(0, dtype=np.uint32))


def test_out_of_row_index_reads_zero():
    tab = torch.arange(1, 33, dtype=torch.int32).reshape(2, 16)
    idx = torch.tensor([[0, -1, 15, 16]], dtype=torch.int32)
    lane = gather.lane_gather(idx, torch.nn.functional.pad(tab, (0, -12)))
    assert lane.tolist() == [[1, 0, 0, 0], [17, 0, 0, 0]]
    assert gather.quad_gather(idx, tab).tolist() == [[18, 0, 16 + 32, 0]]
    assert gather.quad_gather1(idx, tab).tolist() == [[1, 0, 16, 0]]


@pytest.mark.parametrize("name", ["lane_gather", "quad_gather", "quad_gather1"])
def test_launch_wrappers_refuse_what_the_kernels_do_not_take(name):
    fn = getattr(kernels, name)
    tab = torch.zeros((2, 8), dtype=torch.int32)
    idx = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fn(idx, tab)
    with pytest.raises(ValueError, match="CUDA"):
        fn(idx, tab.to(torch.float64))


def test_tool_inputs_are_the_reference_tools_inputs():
    # tools/microbench_gather.py:41-54 and :101-106, in numpy
    NPIX, P, NTEX = 1920 * 1080, 87381, 2
    rng = np.random.default_rng(0)
    base = (np.arange(NPIX, dtype=np.int64) * 37) % (P // 2)
    jitter = rng.integers(0, 64, NPIX)
    idx_np = ((base + jitter) % P).astype(np.int32)
    tex_np = (rng.random(NPIX) < 0.5).astype(np.int32)
    quads = rng.integers(0, 2**32, (NTEX, P, 13), dtype=np.uint32)
    idx, tex, q = microbench_gather.make_inputs()
    assert np.array_equal(idx, idx_np) and np.array_equal(tex, tex_np)
    assert np.array_equal(q, quads)
    flat, tab = microbench_gather.lane_layout(idx, tex, q)
    assert flat.shape == (2025, 8, 128) and tab.shape == (16, 174_848)
    assert np.array_equal(flat.reshape(-1), (tex * P + idx)[: 2025 * 1024])
    assert np.array_equal(tab.view(np.uint32)[:13, : NTEX * P], quads.reshape(-1, 13).T)
    assert not tab[13:].any() and not tab[:, NTEX * P:].any()
    # tools/probe_lanegather.py:17-24
    for width, subl, dtype in probe_lanegather.SHAPES:
        W = (width + 127) // 128 * 128
        rng = np.random.default_rng(0)
        tab_np = rng.integers(0, 1 << 20, size=(subl, W)).astype(np.uint32)
        idx_np = rng.integers(0, width, size=(1, W)).astype(np.int32)
        t, i, tu = probe_lanegather.make_inputs(width, subl, dtype)
        assert np.array_equal(tu, tab_np) and np.array_equal(i, idx_np)
        assert np.array_equal(t, tab_np.view(np.int32) if dtype == np.uint32
                              else tab_np.astype(np.float32))


def test_tools_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for tool in (probe_lanegather, microbench_gather):
        with pytest.raises(SystemExit):
            tool.main()
