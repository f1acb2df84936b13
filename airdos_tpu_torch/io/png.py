"""PNG reading and writing in numpy and zlib, as the dataset readers use it.

airdos_tpu reads its sequences' PNGs with OpenCV (``cv2.imread``); this
module gives the same arrays without it:

- ``imread_unchanged``: ``cv2.IMREAD_UNCHANGED`` (libpng as OpenCV drives
  it): gray -> [H, W], colour -> BGR [H, W, 3], a file with an alpha
  channel or a tRNS chunk on a colour or palette image -> BGRA
  [H, W, 4]; uint16 for 16-bit files, else uint8, gray of 1, 2 or 4 bits
  scaled to 8 (x255, x85, x17);
- ``imread_gray``: airdos_tpu's TartanAir reader: the unchanged image,
  a colour one taken to gray with ``cv2.COLOR_BGR2GRAY``'s fixed-point
  weights (9798 R + 19235 G + 3735 B over 2^15, rounded), as float32;
- ``imread_grayscale``: ``cv2.IMREAD_GRAYSCALE``: uint8, a colour file
  taken to gray by libpng's own ``png_set_rgb_to_gray`` before its 16-bit
  samples are cut to their high byte;
- ``imwrite``: a plain writer (Sub filter on every row, zlib) of uint8 or
  uint16 gray, BGR or BGRA arrays, which ``imread_unchanged`` reads back
  as written.

Every chunk's CRC is checked.  Interlaced (Adam7) files are refused with a
``ValueError``: KITTI, EuRoC and TartanAir write none.  libpng's gamma
handling is not reproduced: a colour file with a gAMA chunk of a gamma
other than 1 is taken to gray by ``imread_grayscale`` as if it had none.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# cv2.COLOR_BGR2GRAY's 15-bit weights (OpenCV's RY15, GY15, BY15, for 8-
# and 16-bit input alike) and libpng's rgb_to_gray weights for (0.299,
# 0.587) as png_set_rgb_to_gray_fixed truncates them (/32768)
_CV_R, _CV_G, _CV_B = 9798, 19235, 3735
_PNG_R, _PNG_G = 9797, 19234
_PNG_B = 32768 - _PNG_R - _PNG_G


class _Png:
    """The decoded samples of one file: [H, W, channels] in the file's
    channel order, uint8 or uint16 (palette indices for colour type 3),
    with its colour type, bit depth, palette and transparency."""

    def __init__(self, samples, color_type, depth, palette, trns):
        self.samples = samples
        self.color_type = color_type
        self.depth = depth
        self.palette = palette
        self.trns = trns


def _chunks(data: bytes, name: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: bad CRC or truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int,
              name: str) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9): None, Sub and Up are
    vectorized; Average and Paeth depend on the left neighbour's result
    and run a loop per row."""
    if raw.size != h * (row_bytes + 1):
        raise ValueError(f"{name}: image data has {raw.size} bytes, "
                         f"expected {h * (row_bytes + 1)}")
    raw = raw.reshape(h, row_bytes + 1)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{name}: unknown filter type {int(kinds.max())}")
    out = np.empty((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        line = raw[y, 1:]
        kind = kinds[y]
        if kind == 0:
            cur = line
        elif kind == 1:             # Sub: a running sum per byte lane
            lanes = np.zeros(-(-row_bytes // bpp) * bpp, np.uint8)
            lanes[:row_bytes] = line
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:row_bytes]
        elif kind == 2:             # Up
            cur = line + prev
        elif kind == 3:
            cur = _average_row(line, prev, bpp)
        else:
            cur = _paeth_row(line, prev, bpp)
        out[y] = cur
        prev = out[y]
    return out


def _average_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """out[i] = line[i] + (out[i - bpp] + prev[i]) // 2 (mod 256).  Each
    of the bpp byte lanes is its own recurrence, run lane by lane."""
    out = np.empty_like(line)
    for k in range(bpp):
        a, lane = 0, []
        for x, b in zip(line[k::bpp].tolist(), prev[k::bpp].tolist()):
            a = (x + ((a + b) >> 1)) & 255
            lane.append(a)
        out[k::bpp] = lane
    return out


def _paeth_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """The Paeth predictor of the spec: with a left, b above, c above-left
    and p = a + b - c, the nearest of a, b, c to p (ties in that order);
    each of the bpp byte lanes is its own recurrence.  |p - a| = |b - c|
    depends on the row above only and is taken outside the loop; p - b =
    a - c and p - c = (b - c) + (a - c).  At the row's start a = c = 0,
    and the predictor is b."""
    out = np.empty_like(line)
    for k in range(bpp):
        up = prev[k::bpp].astype(np.int64)
        left_up = np.concatenate([[0], up[:-1]])
        a, lane = 0, []
        for x, b, c, bc, pa in zip(line[k::bpp].tolist(), up.tolist(),
                                   left_up.tolist(), (up - left_up).tolist(),
                                   np.abs(up - left_up).tolist()):
            ac = a - c
            pb = ac if ac >= 0 else -ac
            pc = bc + ac
            if pc < 0:
                pc = -pc
            if pa <= pb and pa <= pc:
                a = (x + a) & 255
            elif pb <= pc:
                a = (x + b) & 255
            else:
                a = (x + c) & 255
            lane.append(a)
        out[k::bpp] = lane
    return out


def _decode(data: bytes, name: str) -> _Png:
    header = None
    palette = trns = None
    idat = []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color_type, compression, filt, interlace = header
    if color_type not in _CHANNELS or depth not in _DEPTHS[color_type] \
            or compression or filt or w == 0 or h == 0:
        raise ValueError(f"{name}: unsupported IHDR {header}")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG files are not "
                         f"supported")
    if color_type == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    # libpng ignores a tRNS chunk of the wrong length (png_handle_tRNS)
    if trns is not None and (len(trns) != {0: 2, 2: 6}.get(color_type, -1)
                             if color_type != 3 else
                             not 0 < len(trns) <= len(palette)):
        trns = None
    channels = _CHANNELS[color_type]
    bits = channels * depth
    row_bytes = (w * bits + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: bad image data ({e})") from None
    rows = _unfilter(np.frombuffer(raw, np.uint8), h, row_bytes,
                     max(1, bits // 8), name)
    if depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    elif depth == 8:
        samples = rows.reshape(h, w, channels)
    else:                           # 1, 2 or 4 bits, one channel
        per = 8 // depth
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = unpacked.reshape(h, -1)[:, :w, None]
    return _Png(samples, color_type, depth, palette, trns)


def _read(path) -> Optional[_Png]:
    p = Path(path)
    if not p.exists():
        return None
    return _decode(p.read_bytes(), str(p))


def _expand(png: _Png, keep_alpha: bool) -> np.ndarray:
    """The samples as libpng gives them to OpenCV before any gray
    conversion: gray of 1-4 bits scaled to 8, palette indices looked up,
    RGB / gray+alpha / RGBA in the file's order; with keep_alpha, a
    colour or palette image with a tRNS chunk gains its alpha channel
    (png_set_tRNS_to_alpha), without it every alpha channel is dropped
    (png_set_strip_alpha).  Returns [H, W, C]."""
    s, ct = png.samples, png.color_type
    maxv = np.uint16(65535) if png.depth == 16 else np.uint8(255)
    if ct == 0:
        if png.depth < 8:
            s = (s * (255 // ((1 << png.depth) - 1))).astype(np.uint8)
        return s
    if ct == 3:
        idx = s[..., 0]
        if idx.max(initial=0) >= len(png.palette):
            raise ValueError("palette index out of range")
        rgb = png.palette[idx]
        if keep_alpha and png.trns is not None:
            alpha = np.full(256, 255, np.uint8)
            t = np.frombuffer(png.trns, np.uint8)[:256]
            alpha[:len(t)] = t
            return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
        return rgb
    if ct == 2:
        if keep_alpha and png.trns is not None:
            key = np.asarray(struct.unpack(">HHH", png.trns[:6]), np.int64)
            if png.depth == 8:
                key = key & 255
            opaque = (s.astype(np.int64) != key).any(axis=-1)
            alpha = np.where(opaque, maxv, 0).astype(s.dtype)
            return np.concatenate([s, alpha[..., None]], axis=-1)
        return s
    if ct == 4:
        g, a = s[..., :1], s[..., 1:]
        return np.concatenate([g, g, g, a], axis=-1) if keep_alpha else g
    return s if keep_alpha else s[..., :3]          # ct == 6


def _has_alpha_out(png: _Png) -> bool:
    """OpenCV's IMREAD_UNCHANGED type: 4 channels for gray+alpha and RGBA,
    and for RGB or palette images with a tRNS chunk."""
    return png.color_type in (4, 6) or \
        (png.color_type in (2, 3) and png.trns is not None)


def imread_unchanged(path) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for a PNG file; None when
    the file does not exist."""
    png = _read(path)
    if png is None:
        return None
    alpha = _has_alpha_out(png)
    img = _expand(png, keep_alpha=alpha)
    if img.shape[-1] == 1:
        return np.ascontiguousarray(img[..., 0])
    order = [2, 1, 0, 3][:img.shape[-1]]            # RGB(A) -> BGR(A)
    return np.ascontiguousarray(img[..., order])


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)`` for uint8 or uint16 BGR or
    BGRA (the alpha channel is ignored): (9798 R + 19235 G + 3735 B +
    2^14) >> 15 in the input's dtype."""
    x = img.astype(np.int64)
    g = (x[..., 2] * _CV_R + x[..., 1] * _CV_G + x[..., 0] * _CV_B
         + (1 << 14)) >> 15
    return g.astype(img.dtype)


def imread_gray(path) -> Optional[np.ndarray]:
    """airdos_tpu's TartanAirStereoSequence._imread_gray: the unchanged
    image, a colour one taken to gray as cv2.COLOR_BGR2GRAY does, as
    float32; None when the file does not exist."""
    im = imread_unchanged(path)
    if im is None:
        return None
    if im.ndim == 3:
        im = bgr_to_gray(im)
    return im.astype(np.float32)


def imread_grayscale(path) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for a PNG file: uint8;
    None when the file does not exist.  A colour image is taken to gray by
    libpng (png_set_rgb_to_gray with OpenCV's 0.299 / 0.587: weights
    9797, 19234, 3737 over 32768, truncated, and a gray pixel kept as it
    is) on the samples at their own depth; 16-bit samples then keep their
    high byte (png_set_strip_16)."""
    png = _read(path)
    if png is None:
        return None
    img = _expand(png, keep_alpha=False)
    if img.shape[-1] == 3:
        x = img.astype(np.int64)
        r, g, b = x[..., 0], x[..., 1], x[..., 2]
        if png.depth == 16:
            y = (r * _PNG_R + g * _PNG_G + b * _PNG_B + 16384) >> 15
        else:
            y = (r * _PNG_R + g * _PNG_G + b * _PNG_B) >> 15
        gray = np.where((r == g) & (r == b), r, y)
    else:
        gray = img[..., 0]
    if png.depth == 16:
        gray = gray >> 8
    return np.ascontiguousarray(gray.astype(np.uint8))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 or uint16 image: [H, W] gray, or [H, W, 3]
    BGR / [H, W, 4] BGRA in OpenCV's channel order; every row Sub-filtered
    and the whole deflated by zlib."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3) \
            or (img.ndim == 3 and img.shape[2] not in (3, 4)) \
            or 0 in img.shape[:2]:
        raise ValueError(f"cannot write a {img.dtype} image of shape "
                         f"{img.shape} as PNG")
    h, w = img.shape[:2]
    if img.ndim == 3:
        rgb = img[..., [2, 1, 0, 3][:img.shape[2]]]
        color_type, channels = (2, 3) if img.shape[2] == 3 else (6, 4)
    else:
        rgb, color_type, channels = img[..., None], 0, 1
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(rgb.astype(">u2" if depth == 16 else np.uint8))
    rows = rows.view(np.uint8).reshape(h, -1)
    bpp = channels * depth // 8
    sub = rows.copy()
    sub[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray) -> None:
    """Write img (see ``encode``) to path as a PNG file."""
    Path(path).write_bytes(encode(img))

