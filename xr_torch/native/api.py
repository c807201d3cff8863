"""ctypes bindings of the port's native host components
(``xr_torch/native/src/xr_native.cpp``), built on first use (port of
``xr/native/api.py``).

``g++ -O2 -shared -fPIC -std=c++17 ... -lz`` builds the library into
``build/xr_torch/native/`` at the repository root (``.gitignore`` lists
``build/``), again whenever the source is newer than the library. Host
work only: when the toolchain or the build fails, ``load`` returns None and
callers take the pure-Python paths (``xr_torch/core/image.py``,
``xr_torch/scene/objio.py``), which give the same arrays and bytes;
``available()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "xr_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "xr_torch" / "native"
LIB = BUILD_DIR / "libxr_native.so"

_lock = threading.Lock()
_lib = None
_tried = False


class _XrObjMesh(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("uvs", ctypes.POINTER(ctypes.c_float)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("face_mat", ctypes.POINTER(ctypes.c_int32)),
        ("num_vertices", ctypes.c_int64),
        ("num_tris", ctypes.c_int64),
        ("num_materials", ctypes.c_int32),
        ("mat_names", ctypes.c_char_p),
        ("error", ctypes.c_char_p),
    ]


def build(force: bool = False) -> Optional[str]:
    """Compile the shared library unless it is newer than its source.
    Returns its path, or None when g++ is missing or the build fails. The
    library is written under a temporary name and renamed into place, so
    processes building at once never load a half-written file."""
    if not force and LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return str(LIB)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", tmp,
                        "-lz"], check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB)
        return str(LIB)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The native library (built if needed), or None; tried once a
    process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.xr_obj_parse_file.restype = ctypes.POINTER(_XrObjMesh)
        lib.xr_obj_parse_file.argtypes = [ctypes.c_char_p]
        lib.xr_obj_free.restype = None
        lib.xr_obj_free.argtypes = [ctypes.POINTER(_XrObjMesh)]
        lib.xr_write_png.restype = ctypes.c_int
        lib.xr_write_png.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64]
        lib.xr_build_mips.restype = None
        lib.xr_build_mips.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    return load() is not None


def parse_obj(path: str):
    """Parse an OBJ file natively: a dict of positions (V, 3), normals (V,
    3), uvs (V, 2), indices (T, 3), face_mat (T,) and the material names,
    as ``objio``'s Python parser returns it; None without the library.
    Raises IOError when the file cannot be read."""
    lib = load()
    if lib is None:
        return None
    mp = lib.xr_obj_parse_file(os.fsencode(path))
    m = mp.contents
    try:
        if m.error:
            raise IOError(f"OBJ parse failed: {m.error.decode()}")
        v, t = int(m.num_vertices), int(m.num_tris)

        def arr(ptr, n, dt):
            if n == 0:
                return np.zeros(0, dt)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dt, copy=True)

        return {
            "positions": arr(m.positions, v * 3, np.float32).reshape(v, 3),
            "normals": arr(m.normals, v * 3, np.float32).reshape(v, 3),
            "uvs": arr(m.uvs, v * 2, np.float32).reshape(v, 2),
            "indices": arr(m.indices, t * 3, np.int32).reshape(t, 3),
            "face_mat": arr(m.face_mat, t, np.int32),
            "materials": (m.mat_names or b"default").decode().split("\n"),
        }
    finally:
        lib.xr_obj_free(mp)


def write_png(path: str, image: np.ndarray) -> bool:
    """Encode an (H, W, 3) or (H, W) u8 image as an 8-bit RGB PNG; False
    without the library or when the file cannot be written (the caller
    falls back)."""
    lib = load()
    if lib is None:
        return False
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w, _ = img.shape
    rc = lib.xr_write_png(os.fsencode(path), img.ctypes.data_as(ctypes.c_char_p), h, w)
    return rc == 0


def build_mips(image: np.ndarray) -> Optional[np.ndarray]:
    """The flattened box-filter mip chain ((sum of (S >> k)^2, 3) f32) of
    one (S, S, 3) f32 texture, S a power of two; None without the
    library."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(image, np.float32)
    s = img.shape[0]
    if img.shape != (s, s, 3) or s & (s - 1):
        raise ValueError(f"expected an (S, S, 3) texture, S a power of two, got {img.shape}")
    total = sum(max(s >> k, 1) ** 2 for k in range(s.bit_length()))
    out = np.empty((total, 3), np.float32)
    lib.xr_build_mips(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), s,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
