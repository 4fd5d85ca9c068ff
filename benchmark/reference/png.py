"""A plain PNG reader: 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA
images, decoded with zlib and numpy, all five row filters (PNG spec,
section 9). The benchmark reads its map images with it."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.empty_like(line)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint8)
        elif ftype == 2:
            cur = line + prev
        elif ftype in (3, 4):
            ln, up = line.tolist(), prev.tolist()
            cur_l = [0] * stride
            for i in range(stride):
                a = cur_l[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur_l[i] = (ln[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"invalid PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """uint8 pixels, (H, W) for gray, else (H, W, C)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        ctype = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG")
    ch = _CHANNELS[color]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(data, h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


def free_space(path: str) -> np.ndarray:
    """(H, W) bool free cells of a map image, row 0 the map's bottom edge:
    the first channel above 128 (laser_models.py:397-404)."""
    img = read_png(path)[::-1]
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float64) > 128.0
