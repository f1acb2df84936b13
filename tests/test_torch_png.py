"""The port's PNG reader and writer (airdos_tpu_torch/io/png.py) against
OpenCV's (cv2.imdecode / cv2.imread / cv2.imwrite), on the CPU.

PNG byte streams are built here with zlib, one per colour type and bit
depth the decoder accepts, each row filtered with one of the five filter
types; every decode must equal OpenCV's exactly (``np.array_equal``, same
dtype and shape): IMREAD_UNCHANGED, IMREAD_GRAYSCALE, and airdos_tpu's
TartanAir reader (IMREAD_UNCHANGED, then COLOR_BGR2GRAY for a colour
image, as float32).  No tolerance is needed.
"""
import struct
import zlib

import numpy as np
import pytest

from airdos_tpu_torch.io import png
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

cv2 = pytest.importorskip("cv2")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_row(kind, cur, prev, bpp):
    """The forward PNG filter of one row (spec section 9)."""
    cur, prev = cur.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    b = prev
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((cur - pred) % 256).astype(np.uint8)


def _png_bytes(samples, color_type, depth, kinds, plte=None, trns=None):
    """A PNG stream of samples [H, W, C] (palette indices for colour type
    3), row y filtered with kinds[y % len(kinds)], the data split over two
    IDAT chunks."""
    h, w, ch = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        shifts = 8 - depth * (np.arange(per) + 1)
        rows = (padded.reshape(h, -1, per).astype(np.int64) << shifts) \
            .sum(-1).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.uint8)
    for y in range(h):
        kind = kinds[y % len(kinds)]
        out.append(bytes([kind]) + _filter_row(kind, rows[y], prev, bpp)
                   .tobytes())
        prev = rows[y]
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, 0))
    if plte is not None:
        data += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    z = zlib.compress(b"".join(out))
    return (data + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


# (colour type, bit depth, with a tRNS chunk)
CASES = [(0, d, False) for d in (1, 2, 4, 8, 16)] + \
    [(0, 8, True), (0, 16, True)] + \
    [(2, d, t) for d in (8, 16) for t in (False, True)] + \
    [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)] + \
    [(4, 8, False), (4, 16, False), (6, 8, False), (6, 16, False)]


def _samples(rng, color_type, depth, trns, h=13, w=37):
    """Random samples for one case, its PLTE and its tRNS bodies.  RGB
    samples have gray pixels mixed in (libpng keeps those as they are)."""
    plte = tr = None
    if color_type == 3:
        n = 1 << depth if depth < 8 else 200
        plte = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        s = rng.integers(0, n, (h, w, 1))
        if trns:
            tr = bytes(rng.integers(0, 256, max(1, n // 2)).astype(np.uint8))
        return s, plte, tr
    s = rng.integers(0, 1 << depth, (h, w, png._CHANNELS[color_type]))
    if color_type == 2:
        gray = rng.random((h, w)) < 0.25
        s[gray] = s[gray][:, :1]
    if trns:
        key = s[0, 0, :3] if color_type == 2 else s[0, 0, :1]
        tr = struct.pack(">" + "H" * len(key), *map(int, key))
    return s, plte, tr


def _assert_like_cv2(path):
    for flag, ours in ((cv2.IMREAD_UNCHANGED, png.imread_unchanged),
                       (cv2.IMREAD_GRAYSCALE, png.imread_grayscale)):
        want, got = cv2.imread(str(path), flag), ours(path)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (flag, got.dtype, got.shape, want.dtype, want.shape)
        assert np.array_equal(got, want), flag
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if im.ndim == 3:
        im = cv2.cvtColor(im, cv2.COLOR_BGR2GRAY)
    got = png.imread_gray(path)
    assert got.dtype == np.float32 and np.array_equal(got,
                                                      im.astype(np.float32))


@pytest.mark.parametrize("color_type,depth,trns", CASES)
def test_decoder_equals_opencv_per_colour_type_and_filter(
        tmp_path, color_type, depth, trns):
    rng = np.random.default_rng(color_type * 100 + depth * 2 + trns)
    s, plte, tr = _samples(rng, color_type, depth, trns)
    for kinds in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = tmp_path / f"f{''.join(map(str, kinds))}.png"
        path.write_bytes(_png_bytes(s, color_type, depth, kinds, plte, tr))
        _assert_like_cv2(path)
        want = cv2.imdecode(np.frombuffer(path.read_bytes(), np.uint8),
                            cv2.IMREAD_UNCHANGED)
        assert np.array_equal(png.imread_unchanged(path), want)


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("channels,dtype", [(1, np.uint8), (3, np.uint8),
                                            (4, np.uint8), (1, np.uint16),
                                            (3, np.uint16)])
def test_decoder_reads_what_opencv_writes(tmp_path, level, channels, dtype):
    """Files written by cv2.imwrite at compression levels 0, 3 and 9 (its
    libpng picks the filter of each row), of a smooth image with edges,
    as the datasets' frames are."""
    rng = np.random.default_rng(level + channels)
    y, x = np.mgrid[0:90, 0:120]
    base = (127 + 100 * np.sin(x / 7.0) * np.cos(y / 11.0)
            + rng.normal(0, 6, (90, 120)))
    base[30:60, 40:80] = 230
    scale = 257 if dtype == np.uint16 else 1
    planes = [np.roll(base, 9 * c, axis=1) for c in range(channels)]
    img = (np.clip(np.stack(planes, -1), 0, 255) * scale).astype(dtype)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / "cv.png"
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    _assert_like_cv2(path)
    assert np.array_equal(png.imread_unchanged(path), img)


@pytest.mark.parametrize("shape,dtype", [((31, 45), np.uint8),
                                         ((31, 45), np.uint16),
                                         ((20, 17, 3), np.uint8),
                                         ((20, 17, 4), np.uint16)])
def test_writer_round_trips(tmp_path, shape, dtype):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = tmp_path / "w.png"
    png.imwrite(path, img)
    assert np.array_equal(png.imread_unchanged(path), img)
    assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)


def test_malformed_files_raise(tmp_path):
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    data = bytearray(png.encode(img))
    path = tmp_path / "bad.png"
    data[-20] ^= 0xFF                        # inside IDAT: CRC mismatch
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.imread_unchanged(path)
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.imread_unchanged(path)
    assert png.imread_gray(tmp_path / "missing.png") is None
    assert png.imread_grayscale(tmp_path / "missing.png") is None


def test_interlaced_file_is_refused_by_name(tmp_path):
    """Adam7 files are outside the decoder (ROADMAP section 3): the error
    names the file."""
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"\0" * 40))
            + _chunk(b"IEND", b""))
    path = tmp_path / "adam7.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="adam7.png.*interlaced"):
        png.imread_unchanged(path)
