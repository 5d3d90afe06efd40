"""PNG files with `zlib` and `struct` alone (no imaging library).

`write_png` stores a uint8 array of shape (H, W) as grey, (H, W, 3) as RGB
or (H, W, 4) as RGBA: one IHDR, one IDAT of every row behind filter byte 0
(None), one IEND.

`decode_png` reads what image tools write: grey, grey + alpha, RGB, RGBA
and palette images (with their tRNS transparency), 8 bits a sample (grey
and palette also at 1, 2 and 4), the image data split over any number of
IDAT chunks, each row behind any of the five filters (None, Sub, Up,
Average, Paeth).  It refuses 16-bit samples and interlaced (Adam7) files,
naming the file and the cause.  `convert` then gives the RGB or RGBA
pixels of PIL's `Image.convert` for the image's mode, so a reader without
PIL gets PIL's arrays; `read_png` is the two in one.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
# PNG colour type -> (PIL's mode of the decoded image, samples a pixel)
_MODES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}


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


class PngUnsupported(ValueError):
    """A valid PNG of a kind the reader does not take (16-bit samples,
    interlacing)."""


class PngImage(NamedTuple):
    """A decoded PNG: `samples` (H, W, C) uint8 as stored (palette indices
    for "P", grey scaled to 0..255 below 8 bits), PIL's `mode` for it, the
    `palette` (n, 3) of a "P" image, and `transparency`: a palette image's
    alpha per entry, or the one grey value or RGB triple that is
    transparent."""

    samples: np.ndarray
    mode: str
    palette: Optional[np.ndarray]
    transparency: Optional[np.ndarray]


def _average(line: bytearray, prior: bytes, bpp: int) -> None:
    for x in range(len(line)):
        left = line[x - bpp] if x >= bpp else 0
        line[x] = (line[x] + ((left + prior[x]) >> 1)) & 0xFF


def _paeth(line: bytearray, prior: bytes, bpp: int) -> None:
    for x in range(len(line)):
        if x >= bpp:
            a, c = line[x - bpp], prior[x - bpp]
        else:
            a = c = 0
        b = prior[x]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[x] = (line[x] + pred) & 0xFF


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """(h, stride) reconstructed bytes from the decompressed rows, each
    behind its filter byte.  Sub is a cumulative sum mod 256 over a row's
    pixels and Up an add, both vectorised; Average and Paeth walk a row."""
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: the image data holds {raw.size} bytes, not the {h * (stride + 1)} "
                         "its header gives")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # a row holds whole pixels: bpp divides the stride
            out[y] = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) & 0xFF).reshape(-1)
        elif kind == 2:
            out[y] = line + prior  # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_average if kind == 3 else _paeth)(buf, prior.tobytes(), bpp)
            out[y] = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{name}: row {y} has unknown filter type {kind}")
        prior = out[y]
    return out


def decode_png(data: bytes, name: str = "<png>") -> PngImage:
    """Decode the bytes of a PNG file (`name` names it in errors)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name} is not a PNG file")
    pos, header, idat, palette, trns = len(_SIGNATURE), None, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated chunk {tag!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _MODES:
        raise ValueError(f"{name}: unknown PNG colour type {color}")
    mode, channels = _MODES[color]
    if depth == 16:
        raise PngUnsupported(f"{name}: 16-bit samples are not read (8-bit PNG only)")
    if interlace:
        raise PngUnsupported(f"{name}: interlaced (Adam7) PNG is not read")
    if depth != 8 and not (color in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{name}: bit depth {depth} is not valid for colour type {color}")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: a palette image without a PLTE chunk")
    bpp = max(1, channels * depth // 8)
    stride = (w * channels * depth + 7) // 8
    rows = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8), h, stride, bpp, name)
    if depth < 8:
        samples = np.unpackbits(rows, axis=1)[:, : w * depth].reshape(h, w, depth)
        samples = (samples * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if color == 0:  # grey scales up to 0..255, as PIL's L;1, L;2 and L;4 do
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
        samples = samples[..., None]
    else:
        samples = rows.reshape(h, w, channels)
    transparency = None
    if trns is not None:
        if color == 3:
            transparency = np.full(len(palette), 255, np.uint8)
            transparency[: len(trns)] = np.frombuffer(trns[: len(palette)], np.uint8)
        elif color in (0, 2):  # 16-bit big-endian values, one for grey, three for RGB
            key = np.array(struct.unpack(f">{len(trns) // 2}H", trns), np.int64)
            if color == 0 and depth < 8:
                key = key * (255 // ((1 << depth) - 1))
            transparency = key.astype(np.uint16)
    return PngImage(samples, mode, palette, transparency)


def convert(img: PngImage, mode: str) -> np.ndarray:
    """(H, W, 3) for "RGB" or (H, W, 4) for "RGBA": the pixels of PIL's
    `Image.convert(mode)` on the image PIL opens from the same file.  Grey
    repeats into the three colours; RGB drops an alpha; a palette image
    looks its indices up; RGBA takes the stored alpha, the palette's tRNS
    alphas, or 0 where a grey or RGB pixel equals the transparent value
    (255 elsewhere)."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError(f"convert takes RGB or RGBA, not {mode!r}")
    s, h, w = img.samples, img.samples.shape[0], img.samples.shape[1]
    alpha = None
    if img.mode == "P":
        idx = s[..., 0]
        rgb = img.palette[np.minimum(idx, len(img.palette) - 1)]
        if img.transparency is not None:
            alpha = img.transparency[np.minimum(idx, len(img.transparency) - 1)]
    elif img.mode in ("L", "LA"):
        rgb = np.repeat(s[..., :1], 3, axis=-1)
        if img.mode == "LA":
            alpha = s[..., 1]
        elif img.transparency is not None:
            alpha = np.where(s[..., 0] == img.transparency[0], 0, 255).astype(np.uint8)
    else:
        rgb = s[..., :3]
        if img.mode == "RGBA":
            alpha = s[..., 3]
        elif img.transparency is not None:
            alpha = np.where((s == img.transparency.astype(np.int64)).all(-1), 0, 255).astype(np.uint8)
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    if alpha is None:
        alpha = np.full((h, w), 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def read_png(path: Union[str, Path]) -> np.ndarray:
    """The uint8 pixels of a PNG: (H, W) for grey, (H, W, 2) for grey +
    alpha, (H, W, 3) for RGB and (H, W, 4) for RGBA; a palette image comes
    as its RGB, or RGBA where it has a tRNS chunk."""
    img = decode_png(Path(path).read_bytes(), str(path))
    if img.mode == "P":
        return convert(img, "RGB" if img.transparency is None else "RGBA")
    return img.samples[..., 0] if img.mode == "L" else img.samples
