"""8-bit grayscale PNG reading and writing on the standard library's zlib and
numpy (the port's stand-in for PIL, which the JAX package reads and writes
EuRoC frames with: okvis_tpu/datasets/euroc.py and synthetic.py).

The reader takes any 8-bit grayscale, non-interlaced PNG and undoes all five
row filters of the PNG specification. None and Sub rows do not depend on
the row above, so they are undone for the whole image at once (Sub as a
running sum along the row); a run of Up rows is one running sum down the
columns from the row before the run; Average and Paeth depend on the pixel
to the left as it is being rebuilt, so they are undone one pixel at a time
(slow: a few hundred ms for a 752 x 480 image of such rows). Every other
colour type, bit depth or interlace raises, naming the file.

The writer chooses one filter for every row (`filter`, Up by default), so
the datasets the port writes decode in a few vectorized steps; every filter
type can be written, for tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, their CRCs checked."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(payload) != length or crc_at + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kinds: np.ndarray, rows: np.ndarray, path: str) -> np.ndarray:
    """Undo the PNG row filters of an (H, W) uint8 image of filtered rows."""
    H, W = rows.shape
    bad = np.nonzero(kinds > 4)[0]
    if len(bad):
        raise ValueError(f"{path}: unknown PNG filter type {int(kinds[bad[0]])} on row {int(bad[0])}")
    out = np.empty_like(rows)
    free = kinds <= 1  # None and Sub rows need no row above
    out[kinds == 0] = rows[kinds == 0]
    out[kinds == 1] = np.cumsum(rows[kinds == 1], axis=1, dtype=np.uint8)
    y = 0
    while y < H:
        if free[y]:
            y += 1
            continue
        prev = out[y - 1] if y else np.zeros(W, np.uint8)
        if kinds[y] == 2:  # a run of Up rows: one running sum down the columns
            end = y
            while end < H and kinds[end] == 2:
                end += 1
            out[y:end] = prev + np.cumsum(rows[y:end], axis=0, dtype=np.uint8)
            y = end
            continue
        d, up, row = rows[y].tolist(), prev.tolist(), [0] * W
        left = 0
        if kinds[y] == 3:  # Average
            for x in range(W):
                left = row[x] = (d[x] + ((left + up[x]) >> 1)) & 255
        else:  # Paeth
            up_left = 0
            for x in range(W):
                left = row[x] = (d[x] + _paeth(left, up[x], up_left)) & 255
                up_left = up[x]
        out[y] = row
        y += 1
    return out


def read_png_gray(path: str, shape=None) -> np.ndarray:
    """The (H, W) float32 grey levels of an 8-bit grayscale PNG. With `shape`
    (H, W), an image of another size raises IOError, as the native decoder
    does."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour != 0 or interlace != 0 or compression != 0 or filtering != 0:
        raise ValueError(f"{path}: only 8-bit grayscale non-interlaced PNG is read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    if shape is not None and (H, W) != tuple(shape):
        raise IOError(f"{path}: image is {H} x {W}, expected {shape[0]} x {shape[1]}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {H} x {W}")
    raw = raw.reshape(H, W + 1)
    return _unfilter(raw[:, 0], raw[:, 1:], path).astype(np.float32)


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """The rows of `img` (H, W) uint8 filtered with one filter type."""
    x = img.astype(np.int16)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        up_left = np.zeros_like(x)
        up_left[1:, 1:] = x[:-1, :-1]
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", zlib.crc32(kind + payload))


def write_png_gray(path: str, img: np.ndarray, filter="up") -> None:
    """Write an (H, W) uint8 array as an 8-bit grayscale PNG, every row with
    the one filter type `filter` (a name of FILTERS or its number)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png_gray: want an (H, W) uint8 array, got {img.shape} {img.dtype}")
    kind = FILTERS.get(filter, filter)
    if kind not in FILTERS.values():
        raise ValueError(f"write_png_gray: unknown filter {filter!r}")
    H, W = img.shape
    rows = np.empty((H, W + 1), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = _filter(img, kind)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
