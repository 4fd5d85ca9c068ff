"""Readers for the map assets: PNG images and ROS map yaml files.

The JAX package reads maps with Pillow and PyYAML
(``utils/map_loader.py:18-41``). The port's machine has neither, so it
carries two small readers of its own:

* ``read_png``: 8-bit, non-interlaced PNGs (grayscale, gray+alpha, RGB,
  RGBA) decoded with stdlib ``zlib`` and numpy, all five row filters;
* ``read_map_yaml``: the flat ``key: value`` files of ROS ``map_server``,
  where a list value is given inline (``[a, b, c]``, with or without
  spaces) or as a block of ``- item`` lines.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Union

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples per pixel


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    rows = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:    # Sub: running sum per channel, modulo 256
            cur = np.empty_like(line)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp], dtype=np.uint8)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: sequential within the row
            ln = line.tolist()
            up = prev.tolist()
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
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[i] = (ln[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"invalid PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """PNG file -> uint8 array, (H, W) for grayscale else (H, W, C)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos + 8 <= len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        ctype = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length  # length + type + body + crc
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
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}); need 8-bit non-interlaced "
            "gray/gray+alpha/RGB/RGBA")
    ch = _CHANNELS[color]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if data.size != h * (w * ch + 1):
        raise ValueError(f"{path}: PNG data size does not match its header")
    img = _unfilter(data, h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


Scalar = Union[int, float, str]


def _scalar(text: str) -> Scalar:
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def read_map_yaml(path: str) -> Dict[str, Union[Scalar, List[Scalar]]]:
    """Parse a ROS map yaml (``image``, ``resolution``, ``origin``,
    ``negate``, ``occupied_thresh``, ``free_thresh``) into a dict."""
    out: Dict[str, Union[Scalar, List[Scalar]]] = {}
    block_key = None
    with open(path, "r") as f:
        for raw in f:
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            stripped = line.strip()
            if stripped.startswith("- ") or stripped == "-":
                if block_key is None:
                    raise ValueError(f"{path}: list item outside a key: {raw!r}")
                out[block_key].append(_scalar(stripped[1:].strip()))
                continue
            key, sep, value = line.partition(":")
            if not sep:
                raise ValueError(f"{path}: cannot parse line {raw!r}")
            key, value = key.strip(), value.strip()
            block_key = None
            if not value:
                out[key] = []
                block_key = key
            elif value.startswith("[") and value.endswith("]"):
                out[key] = [_scalar(v.strip())
                            for v in value[1:-1].split(",") if v.strip()]
            else:
                out[key] = _scalar(value)
    return out
