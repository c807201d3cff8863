"""Host-side image I/O: PNG (read/write) and PPM, numpy + stdlib zlib
(port of ``xr/core/image.py``). ``write_png`` takes the native encoder
(``xr_torch.native``) where it builds, which writes the same bytes, and
this module's Python encoder otherwise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W) uint8 image as a non-interlaced 8-bit
    RGB PNG, natively when the library is available."""
    from xr_torch.native import api

    img = np.asarray(image)
    assert img.dtype == np.uint8, f"expected uint8, got {img.dtype}"
    if not api.write_png(path, img):
        _write_png_python(path, img)


def _write_png_python(path: str, img: np.ndarray) -> None:
    """The Python encoder: filter 0 on every row, one zlib level-6 IDAT."""
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    assert c == 3, f"expected 3 channels, got {c}"
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    # filter byte 0 (None) per scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    idat = zlib.compress(raw.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", idat))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filters. raw: (h, 1 + w*bpp) u8."""
    stride = w * bpp
    out = np.zeros((h, stride), np.uint16)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.uint16)
        prev = out[y - 1] if y > 0 else np.zeros(stride, np.uint16)
        if ftype == 0:
            out[y] = line
        elif ftype == 2:  # Up
            out[y] = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):  # Sub / Average / Paeth need a scan
            cur = np.zeros(stride, np.uint16)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = out[y - 1][x - bpp] if (y > 0 and x >= bpp) else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (int(a) + int(b)) // 2
                else:
                    p = int(a) + int(b) - int(c)
                    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(c))
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (int(line[x]) + int(pred)) & 0xFF
            out[y] = cur
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB/RGBA/gray PNG written by this module (or any
    non-interlaced 8-bit PNG). Returns (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _PNG_SIG, "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            assert bit_depth == 8 and interlace == 0, "unsupported PNG variant"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    raw = raw.reshape(h, 1 + w * channels)
    img = _unfilter(raw, h, w, channels).reshape(h, w, channels)
    if channels == 1:
        img = img.repeat(3, axis=2)
    elif channels == 4:
        img = img[:, :, :3]
    return img


def write_ppm(path: str, image: np.ndarray) -> None:
    img = np.asarray(image, np.uint8)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())
