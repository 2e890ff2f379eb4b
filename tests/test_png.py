"""The numpy PNG codec (io/png.py) against PIL and OpenCV as oracles."""

import io
import struct
import zlib

import numpy as np
import pytest

from srmeetsps_cuda_tpu.io import png

FORMATS = {  # name -> (samples per pixel, dtype)
    "gray8": (1, np.uint8), "gray16": (1, np.uint16), "ga8": (2, np.uint8),
    "rgb8": (3, np.uint8), "rgba8": (4, np.uint8), "rgb16": (3, np.uint16),
}


def _image(fmt, h=37, w=53, seed=0):
    """Smooth gradients plus noise, so every filter type has work to do."""
    samples, dtype = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    top = np.iinfo(dtype).max
    base = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 0.2 + 0.5
    a = base[..., None] * np.linspace(0.5, 1.0, samples) * top
    a = (a + rng.integers(0, 8, a.shape)).clip(0, top).astype(dtype)
    return a[..., 0] if samples == 1 else a


def _oracle_decode(data, fmt):
    """PIL, except for 16-bit RGB, which PIL reduces to 8 bits: OpenCV."""
    if fmt == "rgb16":
        import cv2

        bgr = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        return bgr[..., ::-1]
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_encode_roundtrip_and_oracle_decodes(fmt, filter_type):
    img = _image(fmt)
    data = png.encode_png(img, filter_type)
    back = png.decode_png(data)
    assert back.dtype == img.dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(_oracle_decode(data, fmt), img)


@pytest.mark.parametrize("fmt", ["gray8", "gray16", "rgb8", "rgba8"])
def test_decodes_pil_encoded(fmt):
    """PIL's encoder picks its own (adaptive) filters per scanline."""
    from PIL import Image

    img = _image(fmt, h=64, w=96, seed=1)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)


@pytest.mark.parametrize("fmt", ["gray8", "gray16", "rgb8", "rgba8",
                                 "rgb16"])
def test_opencv_interop(fmt):
    """cv2 stores BGR(A); decoding cv2's file and cv2 decoding ours must
    agree with that channel order."""
    cv2 = pytest.importorskip("cv2")
    img = _image(fmt, seed=2)
    bgr = img if img.ndim == 2 else np.concatenate(
        [img[..., 2::-1], img[..., 3:]], axis=-1)
    ok, enc = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(png.decode_png(enc.tobytes()), bgr)
    got = cv2.imdecode(np.frombuffer(png.encode_png(img, 4), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, bgr)


def test_file_roundtrip(tmp_path):
    img = _image("rgb8")
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(ihdr, idat=b"", extra=b""):
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(idat)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("data,message", [
    (_png(struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0)), "colour type 3"),
    (_png(struct.pack(">IIBBBBB", 2, 2, 4, 0, 0, 0, 0)), "bit depth 4"),
    (_png(struct.pack(">IIBBBBB", 2, 2, 8, 0, 0, 0, 1)), "interlaced"),
    (b"GIF89a", "not a PNG"),
])
def test_rejects_unsupported(data, message):
    with pytest.raises(ValueError, match=message):
        png.decode_png(data)


def test_rejects_bad_crc():
    data = bytearray(png.encode_png(_image("gray8")))
    data[20] ^= 0xFF  # inside the IHDR body
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(data))


def test_ignores_ancillary_chunks():
    img = _image("gray8", h=3, w=4)
    rows = np.concatenate([np.zeros((3, 1), np.uint8), img], axis=1)
    data = _png(struct.pack(">IIBBBBB", 4, 3, 8, 0, 0, 0, 0), rows.tobytes(),
                extra=_chunk(b"tEXt", b"Comment\x00x"))
    np.testing.assert_array_equal(png.decode_png(data), img)
