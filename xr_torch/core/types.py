"""Core data types of the PyTorch port.

``RenderConfig`` is the static pipeline state: the same fields, defaults and
checks as ``xr.core.types.RenderConfig``, so a config converts 1:1 with
``RenderConfig(**dataclasses.asdict(ref_config))``. Scene structs are frozen
dataclasses whose leaves are numpy arrays (host side, as the scene modules
make them) or torch tensors on one device (see ``xr_torch.convert``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

MODE_FLAT = 0
MODE_GOURAUD = 1
MODE_TEXTURED = 2
MODE_PHONG = 3
MODE_DEPTH_ONLY = 4

MODE_NAMES = {
    MODE_FLAT: "flat",
    MODE_GOURAUD: "gouraud",
    MODE_TEXTURED: "textured",
    MODE_PHONG: "phong",
    MODE_DEPTH_ONLY: "depth_only",
}

# Per-vertex attribute widths carried through clipping/interpolation per mode.
MODE_ATTR_WIDTH = {
    MODE_FLAT: 0,
    MODE_GOURAUD: 3,
    MODE_TEXTURED: 5,
    MODE_PHONG: 8,
    MODE_DEPTH_ONLY: 0,
}


class _Replace:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class RenderConfig(_Replace):
    """Static pipeline state (field-for-field the reference's RenderConfig).

    The layout axes ``deferred_fetch``, ``record_split``, ``lod_fetch``,
    ``tex_fetch``, ``tex_split``, ``corner_fetch``, ``mip_math`` and
    ``record_pack`` only change how the reference lays data out for the
    TPU; every value is bit-identical to the default, and the port runs its
    one path for all of them. ``num_shards`` is the number of screen bands
    ``xr_torch.dist.shard.ShardedRenderer`` renders; ``Renderer`` ignores it.
    """

    width: int = 512
    height: int = 512
    mode: int = MODE_FLAT
    depth_test: bool = True
    cull_backfaces: bool = True
    # fixed-point raster precision: coords snap to 1/2**subpixel_bits pixel
    subpixel_bits: int = 2
    # guard band in NDC units (keeps post-clip coords inside exact int32)
    guard_band: float = 3.0
    # post-clip record capacity = ceil(num_tris * clip_expand) + 64
    clip_expand: float = 1.25
    # max plane-crossing triangles clipped per frame (0 = max(1024, T//16))
    clip_budget: int = 0
    # screen tiles and bin capacities
    tile_h: int = 64
    tile_w: int = 128
    bin_capacity: int = 256
    large_capacity: int = 1024
    bin_pairs: int = 4
    bin_quad_capacity: int = 4096
    # medium bin class: tris spanning <= medium_span^2 tiles get real pairs
    medium_span: int = 8
    medium_capacity: int = 2048
    # streaming visibility: entry capacity per live record, block size and
    # an absolute entry-capacity override (0 = derive)
    stream_expand: float = 2.0
    stream_block: int = 512
    stream_entry_cap: int = 0
    # visibility backend and raster path
    backend: str = "auto"
    pallas_interpret: bool = False
    raster_path: str = "auto"
    # data-layout axes of the reference (bit-identical; see class doc)
    deferred_fetch: str = "wide"
    record_split: int = 1
    lod_fetch: str = "record"
    tex_fetch: str = "wide"
    tex_split: int = 1
    corner_fetch: str = "pertri"
    mip_math: str = "table"
    record_pack: str = "value"
    # occlusion early-out and its refinements: accepted, they cannot change
    # the output and the port runs its one fold; bin_zorder orders each
    # tile's bin segment front to back (the same candidates, the same frame)
    z_earlyout: bool = False
    bin_zorder: bool = False
    z_chunk_gate: bool = False
    z_band_gate: bool = False
    # shadow mapping (MODE_PHONG only)
    shadow_map_size: int = 0
    shadow_bias: float = 2e-3
    # alpha blending
    blend: bool = False
    blend_capacity: int = 128
    blend_chunk: int = 8
    # non-finite counters per stage (nf_* stats; strict readback raises
    # naming the first stage with one)
    debug_checks: bool = False
    # screen bands (xr_torch.dist.shard)
    num_shards: int = 1
    bg_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __post_init__(self):
        # the reference's checks, one for one
        assert self.mode in MODE_NAMES, f"unknown mode {self.mode}"
        assert self.width > 0 and self.height > 0
        sub = 1 << self.subpixel_bits
        span = max(self.width, self.height) * sub * (1.0 + self.guard_band) / 2.0 * 2.0
        assert 2.0 * span * span < 2**31, (
            "subpixel_bits/guard_band too large for exact int32 edge functions "
            f"at {self.width}x{self.height}"
        )
        assert self.record_pack in ("value", "bits", "split")
        assert self.bin_pairs in (2, 4)
        assert self.record_split >= 1
        assert self.lod_fetch in ("record", "recompute")
        assert not (self.record_split > 1 and self.record_pack == "split"), (
            "record_split composes with the unified record table only "
            "(record_pack 'value'/'bits')"
        )
        assert not (self.record_split > 1 and self.deferred_fetch != "wide"), (
            "record_split applies to the wide record fetch only"
        )
        assert self.tex_split >= 1
        assert not (self.tex_split > 1 and self.tex_fetch != "wide"), (
            "tex_split applies to the wide quad fetch only"
        )
        assert self.mip_math in ("table", "closed")
        assert not ((self.z_chunk_gate or self.z_band_gate) and not self.z_earlyout), (
            "z_chunk_gate/z_band_gate refine the z early-out; set z_earlyout"
        )
        assert self.corner_fetch in ("pertri", "percorner")
        if self.record_pack == "value":
            lim = (8 * max(self.width, self.height) + 64) * sub
            assert lim < 2**24, (
                "framebuffer too large for exact f32 value-packed records; "
                "use record_pack='bits'"
            )

    @property
    def attr_width(self) -> int:
        return MODE_ATTR_WIDTH[self.mode]

    @property
    def subpixel(self) -> int:
        return 1 << self.subpixel_bits


# ---------------------------------------------------------------------------
# Scene structs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh(_Replace):
    """Triangle mesh as structure-of-arrays.

    positions (V,3) f32, normals (V,3) f32, uvs (V,2) f32, indices (T,3) i32
    (CCW front faces), material_id (T,) i32, transform_id (V,) i32, and the
    optional scene-static per-vertex material id vert_mat (V,) i32.
    """

    positions: Any
    normals: Any
    uvs: Any
    indices: Any
    material_id: Any
    transform_id: Any
    vert_mat: Any = None

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass(frozen=True)
class Camera(_Replace):
    """Perspective camera: eye/target/up (3,) f32, fov_y (radians), near, far."""

    eye: Any
    target: Any
    up: Any
    fov_y: Any
    near: Any
    far: Any


@dataclasses.dataclass(frozen=True)
class Lights(_Replace):
    """dir_dirs (Ld,3) (direction the light travels), dir_colors (Ld,3),
    pt_pos (Lp,3), pt_colors (Lp,3), ambient (3,)."""

    dir_dirs: Any
    dir_colors: Any
    pt_pos: Any
    pt_colors: Any
    ambient: Any

    @staticmethod
    def make(dir_dirs=None, dir_colors=None, pt_pos=None, pt_colors=None,
             ambient=(0.1, 0.1, 0.1)) -> "Lights":
        z3 = np.zeros((0, 3), np.float32)

        def arr(x):
            return z3 if x is None else np.asarray(x, np.float32).reshape(-1, 3)

        return Lights(
            dir_dirs=arr(dir_dirs),
            dir_colors=arr(dir_colors),
            pt_pos=arr(pt_pos),
            pt_colors=arr(pt_colors),
            ambient=np.asarray(ambient, np.float32),
        )


@dataclasses.dataclass(frozen=True)
class Material(_Replace):
    """One row per material: base_color (M,3), ka/kd/ks/shininess (M,),
    tex_id (M,) i32 (-1 = none), alpha (M,) or None, tex_addr (M,) or None."""

    base_color: Any
    ka: Any
    kd: Any
    ks: Any
    shininess: Any
    tex_id: Any
    alpha: Any = None
    tex_addr: Any = None

    @staticmethod
    def table(rows) -> "Material":
        def col(k, d, dt=np.float32):
            return np.asarray([r.get(k, d) for r in rows], dt)

        return Material(
            base_color=col("base_color", (1.0, 1.0, 1.0)),
            ka=col("ka", 1.0),
            kd=col("kd", 1.0),
            ks=col("ks", 0.0),
            shininess=col("shininess", 32.0),
            tex_id=col("tex_id", -1, np.int32),
            alpha=col("alpha", 1.0),
            tex_addr=(
                col("tex_addr", 0, np.int32)
                if any(r.get("tex_addr", 0) for r in rows)
                else None
            ),
        )


@dataclasses.dataclass(frozen=True)
class TexturePyramid(_Replace):
    """All scene textures with full mip chains in one gatherable buffer.

    data:  (Ntex, P, 3) f32, level k stored row-major at level_offset(k).
    quads: (Ntex, P, 13) int32 sampling layout: the own 2x2 wrap quad of
           each texel plus the parent level's 3x3 block, each texel packed
           RGB8 (below 2^24, so the int32 bits equal the reference's u32).
    """

    data: Any
    quads: Any = None
    base_size: int = 0
    num_levels: int = 0

    def level_size(self, k: int) -> int:
        return max(self.base_size >> k, 1)

    def level_offset(self, k: int) -> int:
        return sum(self.level_size(j) ** 2 for j in range(k))

    @property
    def num_textures(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass(frozen=True)
class RaggedPyramid(_Replace):
    """Mixed-size texture pyramid: every texture keeps its native square
    power-of-two size, and all mip chains lie in one gatherable buffer.

    data:   (Ptotal, 3) f32 reference texels.
    quads:  (Ptotal, 13) int32 sampling layout (see TexturePyramid.quads).
    level_offset: (Ntex, Lmax) i32 start row of (texture, level); levels
            past a texture's native chain repeat its last (1x1) level.
    level_size:   (Ntex, Lmax) i32 texel width of (texture, level), min 1.
    base_size_per_tex: (Ntex,) i32 native size (the per-pixel LOD scale).
    num_levels: Lmax, the longest native chain (static).
    """

    data: Any
    quads: Any
    level_offset: Any
    level_size: Any
    base_size_per_tex: Any
    num_levels: int = 0

    @property
    def num_textures(self) -> int:
        return self.level_offset.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene(_Replace):
    """mesh, materials, textures (a TexturePyramid, a RaggedPyramid or
    None), lights, model_matrices (M,4,4)."""

    mesh: Mesh
    materials: Material
    textures: Optional[Any]
    lights: Lights
    model_matrices: Any


@dataclasses.dataclass(frozen=True)
class Frame(_Replace):
    """color (H,W,3) u8, depth (H,W) f32 (1.0 = background), stats dict."""

    color: Any
    depth: Any
    stats: Any


def as_numpy_scene(scene: Scene) -> Scene:
    """A deep copy of a scene with every torch or numpy leaf as a numpy
    array on the host (for the CPU oracle)."""

    def leaf(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: leaf(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        if hasattr(x, "detach"):  # a torch tensor
            return x.detach().cpu().numpy().copy()
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return leaf(scene)
