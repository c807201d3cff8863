"""3D math (port of ``xr/core/math3d.py``), float32 torch tensors.

Conventions are the reference's: column vectors (p_clip = P @ V @ M @ p),
right-handed view space looking down -Z, D3D clip volume (z in [0, w]),
screen y down with pixel centers at +0.5. Functions take an explicit
``device``; reductions over 3 components are written out so the sum order
is fixed.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    n = torch.sqrt(_sum3(v * v))[..., None]
    return v / torch.clamp_min(n, eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _sum3(a * b)


def _mat4(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r) for r in rows]).to(F32)


def identity(device) -> torch.Tensor:
    return torch.eye(4, dtype=F32, device=device)


def look_at(eye, target, up, device) -> torch.Tensor:
    """Right-handed view matrix: camera at eye looking at target."""
    eye, target, up = _t(eye, device), _t(target, device), _t(up, device)
    z = normalize(eye - target)
    x = normalize(cross(up, z))
    y = cross(z, x)
    zero = torch.zeros((), dtype=F32, device=device)
    one = torch.ones((), dtype=F32, device=device)
    return _mat4(
        [
            [x[0], x[1], x[2], -dot(x, eye)],
            [y[0], y[1], y[2], -dot(y, eye)],
            [z[0], z[1], z[2], -dot(z, eye)],
            [zero, zero, zero, one],
        ]
    )


def perspective(fov_y, aspect, near, far, device) -> torch.Tensor:
    """Right-handed perspective onto the D3D clip volume (z = -near -> 0,
    z = -far -> 1, clip.w = -z_view)."""
    fov_y = _t(fov_y, device)
    f = _t(1.0, device) / torch.tan(fov_y * 0.5)
    near, far = _t(near, device), _t(far, device)
    a = far / (near - far)
    b = near * far / (near - far)
    zero = torch.zeros((), dtype=F32, device=device)
    return _mat4(
        [
            [f / _t(aspect, device), zero, zero, zero],
            [zero, f, zero, zero],
            [zero, zero, a, b],
            [zero, zero, -torch.ones((), dtype=F32, device=device), zero],
        ]
    )


def _rot(angle, device, build):
    angle = _t(angle, device)
    c, s = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros((), dtype=F32, device=device)
    one = torch.ones((), dtype=F32, device=device)
    return _mat4(build(c, s, zero, one))


def rotation_x(angle, device) -> torch.Tensor:
    return _rot(angle, device, lambda c, s, o, i: [
        [i, o, o, o], [o, c, -s, o], [o, s, c, o], [o, o, o, i]])


def rotation_y(angle, device) -> torch.Tensor:
    return _rot(angle, device, lambda c, s, o, i: [
        [c, o, s, o], [o, i, o, o], [-s, o, c, o], [o, o, o, i]])


def rotation_z(angle, device) -> torch.Tensor:
    return _rot(angle, device, lambda c, s, o, i: [
        [c, -s, o, o], [s, c, o, o], [o, o, i, o], [o, o, o, i]])


def orthographic(left, right, bottom, top, near, far, device) -> torch.Tensor:
    """Right-handed orthographic projection onto the D3D clip volume
    (z = -near -> 0, z = -far -> 1), for directional-light shadow passes:
    built from Python floats and rounded to f32 once, as the reference's."""
    l, r = float(left), float(right)
    b, t = float(bottom), float(top)
    n, f = float(near), float(far)
    m = np.array(
        [
            [2.0 / (r - l), 0, 0, -(r + l) / (r - l)],
            [0, 2.0 / (t - b), 0, -(t + b) / (t - b)],
            [0, 0, 1.0 / (n - f), n / (n - f)],
            [0, 0, 0, 1.0],
        ],
        np.float32,
    )
    return torch.as_tensor(m, device=device)


def scaling(v, device) -> torch.Tensor:
    """Scale by v (a scalar or three factors)."""
    v = _t(v, device) * torch.ones(3, dtype=F32, device=device)
    o = torch.zeros((), dtype=F32, device=device)
    i = torch.ones((), dtype=F32, device=device)
    return _mat4([[v[0], o, o, o], [o, v[1], o, o], [o, o, v[2], o], [o, o, o, i]])


def translation(v, device) -> torch.Tensor:
    m = identity(device)
    m[:3, 3] = _t(v, device)
    return m


def camera_matrices(camera, aspect, device):
    """(view, proj) for a Camera."""
    view = look_at(camera.eye, camera.target, camera.up, device)
    proj = perspective(camera.fov_y, aspect, camera.near, camera.far, device)
    return view, proj


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m (..., R, K) times column vectors v (..., K) -> (..., R), each
    product rounded and the K terms summed left to right. Written out
    instead of a matmul so the result is the same on every device and
    library (a BLAS or cuBLAS product picks its own order and FMAs)."""
    acc = m[..., 0] * v[..., 0:1]
    for k in range(1, m.shape[-1]):
        acc = acc + m[..., k] * v[..., k : k + 1]
    return acc


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small matrix product a @ b in the fixed order of matvec."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return acc


def fma_matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m (R, K) times column vectors v (..., K) -> (..., R) as a chain of
    fused multiply-adds over k = 0..K-1, the order numpy's and XLA's f32
    matrix products take on the CPU: each f32 product is exact in f64 and
    each step rounds once to f32 (the f64 sum rounds first, which can
    differ from one rounding only where it lands on an f32 halfway point)."""
    m64, v64 = m.double(), v.double()
    acc = (v64[..., 0:1] * m64[:, 0]).float()
    for k in range(1, m.shape[-1]):
        acc = (acc.double() + v64[..., k : k + 1] * m64[:, k]).float()
    return acc


def transform_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """(N,3) points -> (N,4) through one column-vector 4x4 matrix, as the
    reference's vertex stage computes it (fma_matvec): a product rounded
    term by term differs by an ulp at about half the vertices, and at
    config7's golden that moved a pixel's texture LOD by 2 LSB."""
    n = points.shape[0]
    p4 = torch.cat(
        [points, torch.ones((n, 1), dtype=F32, device=points.device)], dim=1
    )
    return fma_matvec(matrix, p4)


def transform_directions(dirs: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """(N,3) directions through the upper-left 3x3 of a 4x4 matrix (no
    translation), in the order of transform_points (fma_matvec). Right for
    rigid and uniformly scaled transforms; a non-uniform scale would need
    the inverse transpose."""
    return fma_matvec(matrix[:3, :3], dirs)
