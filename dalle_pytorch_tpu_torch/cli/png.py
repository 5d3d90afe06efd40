"""8-bit PNG files with `zlib` and `struct` alone (no imaging library).

`write_png` stores a uint8 array of shape (H, W) as grey, (H, W, 3) as RGB
or (H, W, 4) as RGBA: one IHDR, one IDAT of every row behind filter byte 0
(None), one IEND.  `read_png` reads back what `write_png` writes: 8-bit,
non-interlaced files whose rows all use filter 0.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(array: np.ndarray) -> bytes:
    """The PNG file of a uint8 (H, W), (H, W, 3) or (H, W, 4) array."""
    if array.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, not {array.dtype}")
    pixels = array[..., None] if array.ndim == 2 else array
    if pixels.ndim != 3 or pixels.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"PNG takes (H, W), (H, W, 3) or (H, W, 4) pixels, not {array.shape}")
    h, w, c = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(pixels).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return _SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b"")


def write_png(path: Union[str, Path], array: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(array))


def read_png(path: Union[str, Path]) -> np.ndarray:
    """The uint8 pixels of a PNG that `write_png` wrote: (H, W) for grey,
    (H, W, C) otherwise."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, RGB or RGBA is read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter 0 is read")
    pixels = rows[:, 1:].reshape(h, w, channels)
    return pixels[..., 0] if channels == 1 else pixels
