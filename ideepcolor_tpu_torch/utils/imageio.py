"""The port's image codec: PNG in and out on ``zlib`` and ``struct``.

The JAX package decodes and encodes every image through OpenCV
(``cv2.imdecode``, ``cv2.imencode(".png")``, ``cv2.cvtColor``). The port's
server and tools do it here, so they run where OpenCV is not installed.

* :func:`decode_image`: bytes -> (H, W, 3) uint8 RGB, what
  ``cv2.cvtColor(cv2.imdecode(b, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)``
  gives. PNG is decoded here: 8 bits per sample, not interlaced, color types
  0 (gray), 2 (RGB), 4 (gray + alpha) and 6 (RGBA), all five row filters;
  gray is replicated to three channels and alpha dropped, as
  ``IMREAD_COLOR`` does. Every other body (JPEG, another PNG form, BMP, ...)
  goes to OpenCV when it imports. Without it, a body this module cannot
  decode raises :class:`UnsupportedImage` (a ValueError) naming the missing
  package, and the server answers 415 with its text.
* :func:`read_image`: a file -> :func:`decode_image` of its bytes, what
  ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` gives.
* :func:`encode_png`: (H, W, 3) uint8 RGB (or (H, W) gray) -> PNG bytes,
  filter None on the first row and Up on the others, so a reader
  reconstructs every row with one vectorized add.
* :func:`rgb_to_gray_u8`: ``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)`` on
  uint8, bit for bit.

Rows filtered None, Sub and Up are reconstructed with whole-row numpy
operations (Sub is a cumulative sum mod 256 along the row). Average and
Paeth depend on the reconstructed pixel to their left as well as on the row
above, so an image with such rows (libpng's adaptive filtering, OpenCV's at
an explicit compression level) is reconstructed along anti-diagonals
instead: every pixel of one anti-diagonal depends only on the two before
it, so each is one vectorized step, and a band of rows takes its width plus
its height in steps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
# color type -> samples per pixel, for the 8-bit forms decoded here
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
MAX_PIXELS = 1 << 30     # samples of a decoded image (OpenCV's own cap)
_BAND = 1024             # rows reconstructed together along anti-diagonals


class UnsupportedImage(ValueError):
    """A body in a format this module cannot decode and OpenCV, which
    could, is not installed."""


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _cv2_decode(data: bytes, what: str) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is None:
        raise UnsupportedImage(
            f"{what} needs OpenCV (the cv2 package), which is not installed; "
            f"send an 8-bit non-interlaced PNG")
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("undecodable image body")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (H, W, 3) uint8 RGB. ValueError on a body
    that is no image or a damaged one; :class:`UnsupportedImage` where only
    OpenCV could decode it and it is not installed."""
    data = bytes(data)
    if data.startswith(PNG_SIGNATURE):
        png = _parse_png(data)
        if png is not None:
            return png
        return _cv2_decode(data, "this PNG form (16-bit, palette or "
                                 "interlaced)")
    if data.startswith(_JPEG_SIGNATURE):
        return _cv2_decode(data, "JPEG")
    if _cv2() is None:
        raise ValueError("undecodable image body (neither PNG nor JPEG)")
    return _cv2_decode(data, "this image format")


def read_image(path) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB through :func:`decode_image`.
    FileNotFoundError when the file is missing; ValueError (or
    :class:`UnsupportedImage`) as :func:`decode_image` raises them."""
    with open(path, "rb") as f:
        return decode_image(f.read())


# cv2's RGB2GRAY on uint8: 15-bit fixed-point weights (summing to 1 << 15),
# rounded (exhaustively equal to cv2 over all 2**24 colors)
_GRAY_BITS = 15
_GRAY_WEIGHTS = (9798, 19235, 3735)


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 gray: ``cv2.cvtColor(rgb,
    cv2.COLOR_RGB2GRAY)`` (equally ``COLOR_BGR2GRAY`` of the BGR image)."""
    x = np.asarray(rgb)
    if x.dtype != np.uint8 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"expected (H,W,3) uint8 RGB, got {x.shape} "
                         f"{x.dtype}")
    wr, wg, wb = _GRAY_WEIGHTS
    y = (x[..., 0].astype(np.int32) * wr + x[..., 1].astype(np.int32) * wg
         + x[..., 2].astype(np.int32) * wb + (1 << (_GRAY_BITS - 1)))
    return (y >> _GRAY_BITS).astype(np.uint8)


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG (no IEND chunk)")


def _parse_png(data: bytes) -> np.ndarray | None:
    """The RGB array of a PNG in the decoded subset, None for a valid PNG
    outside it; ValueError on a damaged one."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, ctype, comp, filt, interlace = header
    if W == 0 or H == 0 or comp != 0 or filt != 0:
        raise ValueError(f"bad PNG header {header}")
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        return None
    ch = _CHANNELS[ctype]
    stride = W * ch
    if H * stride > MAX_PIXELS:
        raise ValueError(f"PNG of {W}x{H} exceeds {MAX_PIXELS} samples")
    try:                             # inflate no more than the rows hold
        raw = zlib.decompressobj().decompress(b"".join(idat),
                                              H * (stride + 1))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) < H * (stride + 1):
        raise ValueError(f"truncated PNG image data: {len(raw)} bytes for "
                         f"{H} rows of {stride + 1}")
    rows = np.frombuffer(raw, np.uint8, H * (stride + 1)).reshape(
        H, stride + 1)
    out = _unfilter(rows[:, 0], rows[:, 1:], ch)
    img = out.reshape(H, W, ch)
    if ch <= 2:                          # gray (+ alpha): replicate gray
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct filtered scanlines (PNG spec section 9): ``kinds`` (H,)
    filter bytes, ``rows`` (H, stride) filtered bytes -> (H, stride)."""
    H, stride = rows.shape
    top = int(kinds.max(initial=0))
    if top > 4:
        raise ValueError(f"unknown PNG row filter {top}")
    out = np.empty((H, stride), np.uint8)
    if top >= 3:                         # Average or Paeth rows
        prior = np.zeros(stride, np.uint8)
        for y in range(0, H, _BAND):
            out[y:y + _BAND] = _unfilter_band(kinds[y:y + _BAND],
                                              rows[y:y + _BAND], prior, bpp)
            prior = out[min(y + _BAND, H) - 1]
        return out
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, row = int(kinds[y]), rows[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:                  # Sub: running sum mod 256
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).ravel()
        else:                            # Up
            out[y] = row + prior
        prior = out[y]
    return out


def _unfilter_band(kinds: np.ndarray, rows: np.ndarray, prior: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Rows of any filters below the reconstructed row ``prior``, one
    anti-diagonal of pixels at a time. Pixel ``x`` of row ``y`` (1-based, 0
    is ``prior``) is stored at ``[x + y + 1, y]``: the pixels to the left,
    above and above-left of a diagonal's are contiguous slices of the two
    diagonals before it, and ``[y, y]`` is the zero pixel left of the row."""
    H, stride = rows.shape
    W = stride // bpp
    z = np.zeros((W + H + 1, H + 1, bpp), np.int16)    # reconstructed
    raw = np.zeros((W + H + 1, H + 1, bpp), np.int16)  # filtered
    z[1:W + 1, 0] = prior.reshape(W, bpp)
    px = rows.reshape(H, W, bpp)
    for y in range(1, H + 1):
        raw[y + 1:y + 1 + W, y] = px[y - 1]
    k = np.concatenate([[0], kinds])[:, None]
    sub, up, avg, paeth = (k == 1), (k == 2), (k == 3), (k == 4)
    for t in range(2, W + H + 1):
        lo, hi = max(1, t - W), min(H, t - 1) + 1
        a = z[t - 1, lo:hi]                      # left
        b = z[t - 1, lo - 1:hi - 1]              # above
        c = z[t - 2, lo - 1:hi - 1]              # above-left
        db, da = b - c, a - c
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(db + da)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth[lo:hi], pred,
                        np.where(avg[lo:hi], (a + b) >> 1,
                                 np.where(sub[lo:hi], a,
                                          np.where(up[lo:hi], b, 0))))
        pred += raw[t, lo:hi]
        np.bitwise_and(pred, 0xFF, out=z[t, lo:hi])
    out = np.empty((H, W, bpp), np.uint8)
    for y in range(1, H + 1):
        out[y - 1] = z[y + 1:y + 1 + W, y]
    return out.reshape(H, stride)


def _deflate(raw: bytes) -> bytes:
    z = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    return z.compress(raw) + z.flush()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB or (H, W) uint8 gray -> PNG bytes: 8-bit, not
    interlaced, filter None on the first row and Up on the others, deflated
    at level 1 with the run-length strategy (OpenCV's PNG defaults)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"expected (H,W,3) or (H,W) uint8, got {a.shape} "
                         f"{a.dtype}")
    H, W = a.shape[:2]
    if H == 0 or W == 0:
        raise ValueError(f"empty image {a.shape}")
    rows = a.reshape(H, -1)
    filtered = np.empty((H, rows.shape[1] + 1), np.uint8)
    filtered[0, 0] = 0
    filtered[1:, 0] = 2
    filtered[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=filtered[1:, 1:])
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2 if a.ndim == 3 else 0, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", _deflate(filtered.tobytes()))
            + _chunk(b"IEND", b""))
