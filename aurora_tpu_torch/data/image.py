"""Image decoding for the training dataset, without PIL for PNG.

The reference opens every image with PIL (`Image.open(path).convert("RGB")`,
aurora_tpu/data/dataset.py). The card's host has no PIL, so the port
reads PNG itself with the standard library's zlib and numpy: 8-bit
non-interlaced gray, gray + alpha, RGB, RGBA and palette images (gray and
palette also at 1, 2 and 4 bits), all five row filters. PNG is lossless,
so the result equals PIL's `convert("RGB")` bit for bit: gray is
replicated (sub-byte gray scaled to 0..255), alpha is dropped, a palette
index maps through PLTE. Other formats, and PNG variants outside that set
(16-bit samples, Adam7 interlacing), go through PIL where it is
importable.

Two failures are told apart: a file that exists but does not decode
(truncated, corrupt) raises `ImageDecodeError`, for which the dataset
keeps the reference's zero frame; a format that no decoder on this host
reads raises `UnsupportedImageFormat`, naming the format, so that a
dataset of JPEGs on a host without PIL does not train on black frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# leading bytes → format name, for the error that names a format
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"RIFF", "WEBP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
# PNG color type → samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class ImageDecodeError(ValueError):
    """The file's bytes do not decode as the format they claim."""


class UnsupportedImageFormat(RuntimeError):
    """No decoder on this host reads the file's format."""


class _PngVariant(Exception):
    """A valid PNG outside what `read_png` reads (16-bit, interlaced)."""


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters → [height, stride] uint8."""
    if len(raw) < height * (stride + 1):
        raise ImageDecodeError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    ftypes, data = rows[:, 0], rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        f, line = int(ftypes[y]), data[y]
        if f == 0:                                  # None
            cur = line
        elif f == 1:                                # Sub: a running sum
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:                                # Up
            cur = line + prior
        elif f in (3, 4):                           # Average, Paeth
            cur = _sequential(line, prior, bpp, f)
        else:
            raise ImageDecodeError(f"PNG row filter {f} is not defined")
        out[y] = cur
        prior = out[y]
    return out


def _sequential(line: np.ndarray, prior: np.ndarray, bpp: int,
                ftype: int) -> np.ndarray:
    """Average and Paeth depend on the reconstructed byte to the left, so
    they run byte by byte."""
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, 3] uint8, equal to PIL's convert("RGB")."""
    if not data.startswith(PNG_SIGNATURE):
        raise ImageDecodeError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    try:
        while pos < len(data):
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            if len(body) != length:
                raise ImageDecodeError(f"PNG chunk {kind!r} is truncated")
            pos += 12 + length
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
    except struct.error as e:
        raise ImageDecodeError(f"PNG chunk header is truncated: {e}") from e
    if header is None:
        raise ImageDecodeError("PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ImageDecodeError(f"PNG color type {ctype} is not defined")
    if interlace or depth == 16:
        raise _PngVariant(f"PNG with {'Adam7 interlacing' if interlace else '16-bit samples'}")
    if depth != 8 and ctype not in (0, 3):
        raise ImageDecodeError(f"PNG color type {ctype} at {depth} bits")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageDecodeError(f"PNG image data: {e}") from e
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8))
    if depth < 8:
        rows = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (rows * weights).sum(-1, dtype=np.uint8)[:, :width]
        if ctype == 0:
            rows = rows * np.uint8(255 // ((1 << depth) - 1))
    px = rows.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ImageDecodeError("palette PNG has no PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _format_name(data: bytes) -> str:
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unrecognised"


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes → [H, W, 3] uint8 RGB: PNG by `read_png`, anything else
    (and PNG variants it does not read) by PIL where it is importable."""
    if data.startswith(PNG_SIGNATURE):
        try:
            return read_png(data)
        except _PngVariant as e:
            what = str(e)
    else:
        what = f"{_format_name(data)} image"
    try:
        import io
        from PIL import Image, UnidentifiedImageError
    except ImportError:
        raise UnsupportedImageFormat(
            f"{what}: no decoder on this host reads it (PIL is not "
            "importable; the port reads 8-bit non-interlaced PNG itself)"
        ) from None
    try:
        with Image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"))
    except (UnidentifiedImageError, OSError, ValueError) as e:
        raise ImageDecodeError(f"{what}: {e}") from e
