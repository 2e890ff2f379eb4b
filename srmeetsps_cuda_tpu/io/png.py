"""PNG codec on numpy and the standard library's ``zlib``.

Covers what the dataset layout and the visualizations use: non-interlaced
8-bit grayscale, gray+alpha, RGB and RGBA, and 16-bit versions of the same
(16-bit grayscale depth maps), with all five scanline filter types (PNG
specification, ISO/IEC 15948, section 9). Palette images, bit depths below
8 and Adam7 interlacing raise ``ValueError``.

Decoding reverses the filters in one vectorized pass when every scanline
uses None/Sub/Up, and otherwise along anti-diagonals: pixel (i, j) depends
only on (i, j-1), (i-1, j) and (i-1, j-1), so every pixel of one
anti-diagonal can be reconstructed at once.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_SAMPLES = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOUR_TYPE = {v: k for k, v in _SAMPLES.items()}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file truncated (no IEND)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, raw: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse the scanline filters. ``raw``: (h, stride) uint8 filtered
    bytes; returns the reconstructed (h, stride) uint8 bytes."""
    h, stride = raw.shape
    if np.any(ftype > 4):
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    x = raw.reshape(h, stride // bpp, bpp)
    if np.all(ftype <= 2):
        out = np.empty_like(x)
        prev = np.zeros_like(x[0])
        for i in range(h):
            row = x[i]
            if ftype[i] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[i] == 2:
                row = row + prev
            out[i] = row
            prev = out[i]
        return out.reshape(h, stride)
    # Anti-diagonal wavefront over a zero-bordered copy: rec[i+1, j+1] is
    # pixel (i, j), so left/up/up-left are always in bounds.
    w = stride // bpp
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    x = x.astype(np.int32)
    ft = ftype.astype(np.int32)
    for d in range(h + w - 1):
        i = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        j = d - i
        a = rec[i + 1, j]
        b = rec[i, j + 1]
        c = rec[i, j]
        f = ft[i][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        rec[i + 1, j + 1] = (x[i, j] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to ``(h, w)`` (one sample per pixel) or
    ``(h, w, samples)``, uint8 or uint16."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _SAMPLES:
        raise ValueError(f"unsupported PNG colour type {colour}")
    if depth not in (8, 16):
        raise ValueError(f"unsupported PNG bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    samples = _SAMPLES[colour]
    bpp = samples * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, stride + 1)
    px = _unfilter(raw[:, 0], raw[:, 1:], bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(h, w, samples)
    return px[..., 0] if samples == 1 else px


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _filter(ftype: int, px: np.ndarray, bpp: int) -> np.ndarray:
    """Apply one filter type to every scanline of ``px`` ((h, stride)
    uint8); returns the filtered bytes."""
    x = px.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1}.get(ftype)
    if pred is None:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        pred = _paeth(a, b, c)
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 2,
               level: int = 6) -> bytes:
    """Encode a uint8/uint16 image, ``(h, w)`` or ``(h, w, 1|2|3|4)``,
    with one filter type (0-4) on every scanline."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG needs uint8 or uint16 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, samples = img.shape
    if samples not in _COLOUR_TYPE:
        raise ValueError(f"cannot encode {samples} samples per pixel")
    depth = 8 * img.dtype.itemsize
    bpp = samples * img.dtype.itemsize
    px = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    px = px.view(np.uint8).reshape(h, w * bpp)
    rows = np.empty((h, w * bpp + 1), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = _filter(filter_type, px, bpp)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPE[samples], 0, 0,
                       0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 2,
              level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type, level))
