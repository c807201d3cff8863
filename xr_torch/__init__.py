"""xr_torch — the xr renderer ported to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A second package beside the JAX reference ``xr``: the same scenes, configs,
frames and stats, computed with torch tensors on a device the caller names.
It never imports ``jax``, ``flax`` or ``xr``. Importing it turns off TF32 for
float32 matrix products and convolutions, so the vertex stage stays full
f32, and chooses no device. ``render_frame`` is the CPU oracle
(``xr_torch.cpu_ref``), which always renders on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from xr_torch.core.types import (  # noqa: E402,F401
    MODE_DEPTH_ONLY,
    MODE_FLAT,
    MODE_GOURAUD,
    MODE_PHONG,
    MODE_TEXTURED,
    Camera,
    Frame,
    Lights,
    Material,
    Mesh,
    RenderConfig,
    Scene,
)
from xr_torch.app.renderer import Renderer, readback_frame, render_step  # noqa: E402,F401
from xr_torch.convert import scene_to_torch  # noqa: E402,F401
from xr_torch.cpu_ref import render_frame  # noqa: E402,F401
from xr_torch.dist.shard import ShardedRenderer  # noqa: E402,F401

__all__ = [
    "MODE_FLAT", "MODE_GOURAUD", "MODE_TEXTURED", "MODE_PHONG",
    "MODE_DEPTH_ONLY", "RenderConfig", "Mesh", "Camera", "Lights",
    "Material", "Scene", "Frame", "Renderer", "ShardedRenderer", "render_step",
    "readback_frame", "scene_to_torch", "render_frame",
]
