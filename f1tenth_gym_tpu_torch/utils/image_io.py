"""Readers and writers for the map assets: PNG images and flat yaml files.

The JAX package reads and writes maps and experiment files with Pillow and
PyYAML (``utils/map_loader.py:18-41``, ``tracks/trackgen.py:183-203``,
``utils/experiment.py:20``). The port's machine has neither, so it carries
small ones of its own:

* ``read_png``: 8-bit, non-interlaced PNGs (grayscale, gray+alpha, RGB,
  RGBA) decoded with stdlib ``zlib`` and numpy, all five row filters;
  ``write_png`` writes the same kind with filter 0;
* ``read_flat_yaml`` (``read_map_yaml`` for ROS ``map_server`` files): one
  top-level mapping of scalars and lists, a list given inline (``[a, b,
  c]``) or as a block of ``- item`` lines, scalars resolved as
  ``yaml.safe_load`` resolves them; ``write_map_yaml`` writes such a
  mapping in the layout of ``yaml.safe_dump``.
"""

from __future__ import annotations

import re
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


_CHUNK_HEADER = struct.Struct(">I4s")
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> color type


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (_CHUNK_HEADER.pack(len(body), ctype) + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 image, (H, W) grayscale or (H, W, C) with C in
    {2, 3, 4}, as an 8-bit non-interlaced PNG: every row with filter 0
    (None), one zlib-compressed IDAT chunk."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png needs uint8 pixels, got {img.dtype}")
    ch = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if ch not in _COLOR_TYPE:
        raise ValueError(f"write_png: unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, w * ch + 1), np.uint8)   # column 0: filter type 0
    rows[:, 1:] = img.reshape(h, w * ch)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 9))
                + _chunk(b"IEND", b""))


# ---------------------------------------------------------------- yaml
# Flat yaml files (one top-level mapping of scalars and lists of scalars),
# with the plain-scalar resolution of PyYAML's YAML 1.1 resolver: a float
# needs a dot, and an exponent needs its sign ("1e3" stays a string).
Scalar = Union[None, bool, int, float, str]

_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
                     |[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""",
                  re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9_]+(?:[eE][-+][0-9]+)?
                       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                       |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)""", re.X)
_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./-]*")


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _signed(text: str):
    sign = -1 if text[0] == "-" else 1
    return sign, (text[1:] if text[0] in "+-" else text)


def _plain_scalar(text: str) -> Scalar:
    """A plain (unquoted) scalar resolved as PyYAML's safe loader does."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        sign, v = _signed(text.replace("_", ""))
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.fullmatch(text):
        sign, v = _signed(text.replace("_", "").lower())
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


def _quoted(text: str, where: str) -> str:
    """The value of a single- or double-quoted scalar (the whole text)."""
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"{where}: unterminated or trailing text after "
                         f"quoted scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        if "'" in body.replace("''", ""):
            raise ValueError(f"{where}: stray quote in {text!r}")
        return body.replace("''", "'")
    if re.search(r'(?<!\\)(?:\\\\)*"', body):
        raise ValueError(f"{where}: stray quote in {text!r}")
    return body.encode("latin-1", "backslashreplace").decode("unicode_escape")


def _scalar(text: str, where: str) -> Scalar:
    text = text.strip()
    if text[:1] in ("'", '"'):
        return _quoted(text, where)
    if text[:1] in ("{", "[", "&", "*", "!", "|", ">", "@", "`") or \
            ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: not a flat scalar: {text!r}")
    return _plain_scalar(text)


def _split_outside_quotes(text: str, sep: str):
    """Split ``text`` on ``sep`` where it stands outside quotes."""
    parts, cur, quote = [], [], None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in ("'", '"'):
            quote = ch
        elif ch == sep:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment: one that starts the line or
    follows whitespace, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in ("'", '"') and (i == 0 or line[i - 1] in " \t:[,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _key_value(line: str, where: str):
    """Split ``key: value`` at the first ``:`` that ends the line or is
    followed by a space, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in ("'", '"') and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(line) or line[i + 1] in " \t"):
            key = _scalar(line[:i], where)
            return str(key) if not isinstance(key, str) else key, \
                line[i + 1:].strip()
    raise ValueError(f"{where}: expected 'key: value', got {line!r}")


def read_flat_yaml(path: str) -> Dict[str, Union[Scalar, List[Scalar]]]:
    """Parse a flat yaml file: one top-level mapping whose values are
    scalars (plain, single- or double-quoted), inline lists ``[a, b]`` or
    block lists of ``- item`` lines, with ``#`` comments. Values resolve as
    ``yaml.safe_load`` resolves them; a nested mapping raises."""
    out: Dict[str, Union[Scalar, List[Scalar]]] = {}
    block_key = None
    with open(path, "r") as f:
        for n, raw in enumerate(f, 1):
            where = f"{path}:{n}"
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            stripped = line.strip()
            if not stripped or stripped in ("---", "..."):
                continue
            if stripped.startswith("- ") or stripped == "-":
                if block_key is None:
                    raise ValueError(f"{where}: list item outside a key: "
                                     f"{raw!r}")
                if out[block_key] is None:
                    out[block_key] = []
                out[block_key].append(_scalar(stripped[1:], where))
                continue
            if line[0] in " \t":
                raise ValueError(f"{where}: nested mappings are not supported:"
                                 f" {raw!r}")
            key, value = _key_value(line, where)
            block_key = None
            if not value:
                out[key] = None      # a block list may follow
                block_key = key
            elif value.startswith("["):
                if not value.endswith("]"):
                    raise ValueError(f"{where}: unterminated list {value!r}")
                items = _split_outside_quotes(value[1:-1], ",")
                if items[-1].strip() == "":
                    items = items[:-1]
                out[key] = [_scalar(v, where) for v in items]
            else:
                out[key] = _scalar(value, where)
    return out


# a ROS map yaml (image, resolution, origin, negate, occupied_thresh,
# free_thresh) is a flat yaml file
read_map_yaml = read_flat_yaml


def _dump_scalar(v) -> str:
    """A scalar as ``yaml.safe_dump`` writes it."""
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _PLAIN_SAFE.fullmatch(v) and _plain_scalar(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as a yaml scalar")


def write_map_yaml(path: str, meta: Dict[str, object]) -> None:
    """Write a flat mapping as ``yaml.safe_dump`` lays it out: keys sorted,
    one ``key: value`` line each, a list as a block of ``- item`` lines.
    ``read_map_yaml`` reads it back."""
    lines = []
    for key in sorted(meta):
        value = meta[key]
        if isinstance(value, (list, tuple)):
            lines.append(f"{key}:" if value else f"{key}: []")
            lines += [f"- {_dump_scalar(v)}" for v in value]
        else:
            lines.append(f"{key}: {_dump_scalar(value)}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
