"""The port's PNG codec (utils/imageio.py) against OpenCV: decoding
cv2-written PNGs (RGB, gray, RGBA; OpenCV's default every-row Sub and its
adaptive filters at an explicit compression level) and hand-built rows of
each filter type in the four color types (gray + alpha included) equals
``cv2.imdecode`` + ``cvtColor`` exactly; OpenCV decodes ``encode_png``'s
output to the same array; damaged bodies raise ValueError; JPEG without
OpenCV raises the named error."""

import builtins
import struct
import zlib

import cv2
import numpy as np
import pytest

from ideepcolor_tpu_torch.utils import imageio

from _torch_caffe import smooth_image


def _cv2_rgb(data: bytes) -> np.ndarray:
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _image(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    smooth = smooth_image(seed, h, w)
    noise = rng.integers(0, 256, (h, w, 3), np.uint8)
    rgb = smooth.copy()                  # smooth top, noise below
    rgb[h // 2:] = noise[h // 2:]
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    return {"rgb": rgb[..., ::-1], "gray": rgb[..., 0],
            "rgba": np.concatenate([rgb[..., ::-1], alpha], -1)}[kind]


def _filters(png: bytes) -> set:
    """The filter bytes of a PNG's rows (8-bit forms)."""
    pos, idat, hdr = 8, b"", None
    while pos < len(png):
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        body = png[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = hdr[0] * {0: 1, 2: 3, 4: 2, 6: 4}[hdr[3]] + 1
    return {raw[i * stride] for i in range(hdr[1])}


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (17, 5), (64, 97),
                                   (120, 33)])
@pytest.mark.parametrize("level", [None, 0, 9])
def test_decodes_cv2_pngs_exactly(kind, shape, level):
    img = _image(kind, *shape, seed=shape[0] * 7 + shape[1])
    params = [] if level is None else [cv2.IMWRITE_PNG_COMPRESSION, level]
    ok, buf = cv2.imencode(".png", img, params)
    assert ok
    data = buf.tobytes()
    got = imageio.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == shape + (3,)
    assert np.array_equal(got, _cv2_rgb(data))


def test_cv2_adaptive_filters_reach_all_five():
    """The parametrized images above exercise every filter type."""
    seen = set()
    for level in (0, 9):
        for shape in ((64, 97), (120, 33)):
            ok, buf = cv2.imencode(".png", _image("rgb", *shape, seed=3),
                                   [cv2.IMWRITE_PNG_COMPRESSION, level])
            seen |= _filters(buf.tobytes())
    assert seen == {0, 1, 2, 3, 4}


def _hand_png(rows: np.ndarray, filters, ctype: int) -> bytes:
    """A PNG whose scanlines are ``rows`` (H, stride) of raw filtered
    bytes with the given filter byte per row."""
    h, stride = rows.shape
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = b"".join(bytes([f]) + rows[i].tobytes()
                   for i, f in enumerate(filters))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (imageio.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", stride // ch, h, 8,
                                         ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("pattern", ["each", "0", "1", "2", "3", "4"])
def test_hand_built_filter_rows_match_cv2(ctype, pattern):
    """Random filtered bytes under each filter type (and all five cycling
    row by row) reconstruct as libpng reconstructs them."""
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(ctype * 10 + len(pattern))
    h, w = 11, 13
    rows = rng.integers(0, 256, (h, w * ch), np.uint8)
    filters = ([i % 5 for i in range(h)] if pattern == "each"
               else [int(pattern)] * h)
    data = _hand_png(rows, filters, ctype)
    assert np.array_equal(imageio.decode_image(data), _cv2_rgb(data))


@pytest.mark.parametrize("band", [1, 5, 1024])
def test_anti_diagonal_bands_match_cv2(band, monkeypatch):
    """Rows of random filters reconstructed along anti-diagonals in bands
    of ``band`` rows: each band starts from the last row of the one above."""
    monkeypatch.setattr(imageio, "_BAND", band)
    rng = np.random.default_rng(band)
    rows = rng.integers(0, 256, (23, 19 * 3), np.uint8)
    filters = [3, 4] + list(rng.integers(0, 5, 21))
    data = _hand_png(rows, filters, 2)
    assert np.array_equal(imageio.decode_image(data), _cv2_rgb(data))


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (64, 64), (75, 110)])
@pytest.mark.parametrize("gray", [False, True])
def test_encode_png_decodes_to_the_same_array(shape, gray):
    img = smooth_image(shape[0] + shape[1], *shape)
    if gray:
        img = img[..., 1]
    data = imageio.encode_png(img)
    assert _filters(data) <= {0, 2}
    want = np.repeat(img[..., None], 3, -1) if gray else img
    assert np.array_equal(_cv2_rgb(data), want)
    assert np.array_equal(imageio.decode_image(data), want)


def test_encode_png_refuses_other_arrays():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4),
                                                          np.uint8),
                np.zeros((0, 4, 3), np.uint8), np.zeros(5, np.uint8)):
        with pytest.raises(ValueError):
            imageio.encode_png(bad)


def _damaged():
    good = imageio.encode_png(smooth_image(1, 20, 30))
    idat = good.index(b"IDAT")
    bad_crc = bytearray(good)
    bad_crc[idat + 10] ^= 0xFF                      # body byte: CRC fails
    body = zlib.compress(b"\x00" * 10)              # far too few rows
    def chunk(kind, b):
        return (struct.pack(">I", len(b)) + kind + b
                + struct.pack(">I", zlib.crc32(kind + b)))
    ihdr = good[8:33]
    return {
        "truncated": good[:len(good) // 2],
        "signature_only": imageio.PNG_SIGNATURE,
        "bad_crc": bytes(bad_crc),
        "short_data": imageio.PNG_SIGNATURE + ihdr + chunk(b"IDAT", body)
        + chunk(b"IEND", b""),
        "not_zlib": imageio.PNG_SIGNATURE + ihdr
        + chunk(b"IDAT", b"garbage!") + chunk(b"IEND", b""),
        "no_idat": imageio.PNG_SIGNATURE + ihdr + chunk(b"IEND", b""),
        "bad_filter": _hand_png(np.zeros((2, 6), np.uint8), [0, 7], 2),
        "garbage": b"not an image at all",
    }


@pytest.mark.parametrize("name", sorted(_damaged()))
def test_damaged_bodies_raise_value_error(name):
    with pytest.raises(ValueError):
        imageio.decode_image(_damaged()[name])


@pytest.fixture
def no_cv2(monkeypatch):
    real = builtins.__import__

    def fake(name, *a, **k):
        if name == "cv2":
            raise ImportError("no module named cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_jpeg_needs_cv2(no_cv2):
    ok, buf = cv2.imencode(".jpg", smooth_image(2, 16, 16))
    with pytest.raises(imageio.UnsupportedImage, match="cv2"):
        imageio.decode_image(buf.tobytes())
    # the codec's own PNG still decodes, and garbage is a plain ValueError
    img = smooth_image(2, 16, 16)
    assert np.array_equal(imageio.decode_image(imageio.encode_png(img)), img)
    with pytest.raises(ValueError) as e:
        imageio.decode_image(b"garbage")
    assert not isinstance(e.value, imageio.UnsupportedImage)


def test_jpeg_and_16_bit_png_go_through_cv2_where_it_imports():
    img = smooth_image(4, 24, 40)
    ok, jpg = cv2.imencode(".jpg", img[..., ::-1])
    assert np.array_equal(imageio.decode_image(jpg.tobytes()),
                          _cv2_rgb(jpg.tobytes()))
    ok, png16 = cv2.imencode(".png", img.astype(np.uint16) * 257)
    assert np.array_equal(imageio.decode_image(png16.tobytes()),
                          _cv2_rgb(png16.tobytes()))
