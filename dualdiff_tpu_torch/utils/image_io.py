"""Image files and resampling without PIL: PNG and baseline JPEG writers,
PIL's bicubic, bilinear and nearest resizes, and pad.

The JAX package's tools write through PIL, which the port does not assume.

* ``write_png``: 8-bit RGB, or grey for an (H, W) array (PIL's mode
  ``L``), zlib, every row filter 0; ``read_png`` reads such files back
  (filter 0 only).
* ``write_jpeg``: baseline JFIF as PIL writes by default: quality 75 (the
  IJG tables scaled as libjpeg scales them), 4:2:0 chroma (libjpeg's 2x2
  box average with its alternating rounding bias), the Annex K Huffman
  tables, byte stuffing.  The DCT is a float DCT, where libjpeg's default
  is its integer one, so the coefficients can differ by one step at a
  rounding edge.  ``jpeg_size`` reads the frame header.
* ``resize_bicubic`` / ``resize_bilinear``: PIL's ``BICUBIC`` /
  ``BILINEAR`` resampling of 8-bit images as PIL computes it: the
  separable kernel (bicubic with a = -0.5, support 2; the triangle,
  support 1) widened by the downscale factor and renormalised at the
  borders, its taps in PIL's 22-bit fixed point, the width first, each
  pass rounded to uint8 and clipped.
* ``resize_nearest``: PIL's ``NEAREST``: output pixel ``x`` takes source
  pixel ``floor((x + 0.5) * in / out)``.
* ``pad``: black borders, as PIL's paste onto a new black image.

Images are channels-last ``(H, W, 3)`` uint8 numpy arrays.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

__all__ = ["write_png", "read_png", "write_jpeg", "jpeg_size",
           "resize_bicubic", "resize_bilinear", "resize_nearest", "pad",
           "to_uint8"]


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8 as the JAX tools convert: ``(img * 255)``
    truncated."""
    return (np.asarray(img, np.float32) * 255).astype(np.uint8)


# ------------------------------------------------------------------- PNG --

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG; (H, W) uint8 -> an 8-bit grey
    one."""
    img = np.ascontiguousarray(img, np.uint8)
    grey = img.ndim == 2
    if grey:
        img = img[..., None]
    h, w, c = img.shape
    if c != 1 + 2 * (not grey):
        raise ValueError(f"write_png takes (H, W, 3) RGB or (H, W) grey, "
                         f"got {img.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                          0 if grey else 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or grey PNG whose rows all use filter 0
    (``write_png``'s) -> (H, W, 3) or (H, W) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    if depth != 8 or color not in (0, 2):
        raise ValueError(f"{path}: bit depth {depth}, colour type {color}; "
                         f"read_png takes 8-bit RGB or grey")
    c = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(h, 1 + c * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than 0")
    out = rows[:, 1:].reshape(h, w, c)
    return (out if c == 3 else out[..., 0]).copy()


# ------------------------------------------------------------------ JPEG --

# ITU T.81 Annex K: the IJG base quantisation tables, natural order
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])
# zigzag index -> natural index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3 Huffman tables: (code counts per length 1..16, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` + ``jpeg_add_quant_table`` with
    ``force_baseline``: natural order, 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) of each of the 256 symbols (length 0: unused)."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 -> (H/8, W/8, 64) row-major
    blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(h // 8, w // 8, 64)


def _quantise(blocks: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Level-shifted samples (..., 64) -> quantised coefficients in zigzag
    order, rounded half away from zero as libjpeg's ``quantize``."""
    x = blocks.reshape(*blocks.shape[:-1], 8, 8) - 128.0
    coef = np.einsum("ui,...ij,vj->...uv", _DCT, x, _DCT)
    coef = coef.reshape(*blocks.shape[:-1], 64) / q
    out = np.sign(coef) * np.floor(np.abs(coef) + 0.5)
    return out[..., _ZIGZAG].astype(np.int64)


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, its extra bits) of each value: negative values in
    one's complement of their size."""
    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v >= 0, v, v + (1 << size) - 1)
    return size, bits


def _entropy_code(coefs: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-code every block (``coefs`` (n, 64) zigzag, in scan order,
    ``comp`` its component per block) -> the stuffed scan bytes."""
    n = len(coefs)
    # DC: difference to the previous block of the same component
    dc = coefs[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        d = dc[sel]
        diff[sel] = np.diff(d, prepend=0)
    dc_size, dc_bits = _magnitude(diff)
    # (component, symbol) -> code, length
    dc_code = np.stack([t[0][0] for t in tables])
    dc_len = np.stack([t[0][1] for t in tables])
    ac_code = np.stack([t[1][0] for t in tables])
    ac_len = np.stack([t[1][1] for t in tables])
    items_block = [np.arange(n)]
    items_order = [np.zeros(n, np.int64)]
    items_code = [dc_code[comp, dc_size]]
    items_len = [dc_len[comp, dc_size]]
    items_val = [dc_bits]
    items_vlen = [dc_size]

    ac = coefs[:, 1:]
    blk, pos = np.nonzero(ac)  # row-major: in block order, then position
    prev = np.full(len(pos), -1)
    same = np.zeros(len(pos), bool)
    same[1:] = blk[1:] == blk[:-1]
    prev[1:] = np.where(same[1:], pos[:-1], -1)
    run = pos - prev - 1
    zrl = run // 16
    run = run % 16
    size, bits = _magnitude(ac[blk, pos])
    cb = comp[blk]
    # ZRLs (symbol 0xF0) before each coefficient that needs them
    z_item = np.repeat(np.arange(len(pos)), zrl)
    z_k = np.arange(len(z_item)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    items_block.append(blk[z_item])
    items_order.append(1 + 2 * 64 * pos[z_item] + z_k)
    items_code.append(ac_code[cb[z_item], 0xF0])
    items_len.append(ac_len[cb[z_item], 0xF0])
    items_val.append(np.zeros(len(z_item), np.int64))
    items_vlen.append(np.zeros(len(z_item), np.int64))
    sym = run * 16 + size
    items_block.append(blk)
    items_order.append(1 + 2 * 64 * pos + 64)
    items_code.append(ac_code[cb, sym])
    items_len.append(ac_len[cb, sym])
    items_val.append(bits)
    items_vlen.append(size)
    # EOB (symbol 0x00) where the block's last coefficient is zero
    eob = np.nonzero(ac[:, -1] == 0)[0]
    items_block.append(eob)
    items_order.append(np.full(len(eob), 2 * 64 * 64))
    items_code.append(ac_code[comp[eob], 0])
    items_len.append(ac_len[comp[eob], 0])
    items_val.append(np.zeros(len(eob), np.int64))
    items_vlen.append(np.zeros(len(eob), np.int64))

    blocks = np.concatenate(items_block)
    order = np.lexsort((np.concatenate(items_order), blocks))
    code = np.concatenate(items_code)[order]
    clen = np.concatenate(items_len)[order]
    val = np.concatenate(items_val)[order]
    vlen = np.concatenate(items_vlen)[order]
    if (clen == 0).any():
        raise ValueError("a symbol without a Huffman code")
    word = (code << vlen) | (val & ((1 << vlen) - 1))
    nbits = clen + vlen
    total = int(nbits.sum())
    start = np.cumsum(nbits) - nbits
    out = np.ones(total + (-total) % 8, np.uint8)  # pad with 1 bits
    for b in range(int(nbits.max())):
        sel = nbits > b
        out[start[sel] + b] = (word[sel] >> (nbits[sel] - 1 - b)) & 1
    return np.packbits(out).tobytes().replace(b"\xff", b"\xff\x00")


def _downsample_2x2(plane: np.ndarray) -> np.ndarray:
    """libjpeg's ``h2v2_downsample``: (a + b + c + d + bias) >> 2 with the
    bias 1, 2, 1, 2, ... along each row."""
    p = plane.astype(np.int64)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.tile([1, 2], s.shape[1] // 2 + 1)[:s.shape[1]]
    return ((s + bias) >> 2).astype(np.float64)


def write_jpeg(path: str, img: np.ndarray, quality: int = 75) -> None:
    """(H, W, 3) uint8 -> a baseline JFIF JPEG with 4:2:0 chroma."""
    img = np.asarray(img, np.uint8)
    h, w, _ = img.shape
    rgb = img.astype(np.float64)
    # JFIF YCbCr, rounded as libjpeg's fixed-point rgb_ycc_convert
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = (-0.168735892 * rgb[..., 0] - 0.331264108 * rgb[..., 1]
          + 0.5 * rgb[..., 2] + 128)
    cr = (0.5 * rgb[..., 0] - 0.418687589 * rgb[..., 1]
          - 0.081312411 * rgb[..., 2] + 128)
    planes = [np.clip(np.floor(p + 0.5), 0, 255) for p in (y, cb, cr)]
    # replicate the last row and column out to whole 16 x 16 MCUs
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    planes = [np.pad(p, ((0, H - h), (0, W - w)), mode="edge")
              for p in planes]
    yq = _quant_table(_Q_LUMA, quality)
    cq = _quant_table(_Q_CHROMA, quality)
    my, mx = H // 16, W // 16
    ly = _quantise(_blocks(planes[0]), yq)  # (2my, 2mx, 64)
    ly = ly.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(my, mx, 4, 64)
    cbs = _quantise(_blocks(_downsample_2x2(planes[1])), cq)
    crs = _quantise(_blocks(_downsample_2x2(planes[2])), cq)
    # scan order: per MCU Y00 Y01 Y10 Y11 Cb Cr
    mcu = np.concatenate([ly, cbs[:, :, None], crs[:, :, None]], axis=2)
    coefs = mcu.reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    luma = (_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA))
    chroma = (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))
    scan = _entropy_code(coefs, comp, [luma, chroma, chroma])

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">HH", marker, len(body) + 2) + body

    def dht(cls_id: int, spec) -> bytes:
        counts, symbols = spec
        return bytes([cls_id]) + bytes(counts) + bytes(symbols)

    out = [b"\xff\xd8",
           segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
           segment(0xFFDB, b"\x00" + bytes(yq[_ZIGZAG].tolist())
                   + b"\x01" + bytes(cq[_ZIGZAG].tolist())),
           segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                   + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
           segment(0xFFC4, dht(0x00, _DC_LUMA) + dht(0x10, _AC_LUMA)
                   + dht(0x01, _DC_CHROMA) + dht(0x11, _AC_CHROMA)),
           segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
           scan, b"\xff\xd9"]
    with open(path, "wb") as f:
        f.write(b"".join(out))


def jpeg_size(path: str) -> Tuple[int, int]:
    """(height, width) from a JPEG's SOF0 / SOF2 header."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG")
    pos = 2
    while pos + 4 <= len(data):
        marker, n = struct.unpack(">HH", data[pos:pos + 4])
        if marker in (0xFFC0, 0xFFC2):
            _, h, w = struct.unpack(">BHH", data[pos + 4:pos + 9])
            return h, w
        pos += 2 + n
    raise ValueError(f"{path}: no frame header")


# ------------------------------------------------------------ resampling --

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1, 1.0 - x, 0.0)


def _coefficients(in_size: int, out_size: int, kernel=_bicubic,
                  support: float = 2.0):
    """PIL's ``precompute_coeffs`` for ``kernel`` (its support widened by
    the downscale factor) and ``normalize_coeffs_8bpc``: -> (first input
    index (out,), taps (out, k) int64 in 2^-22 units, zero past each
    window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    t = np.arange(ksize)
    w = kernel((t[None] + xmin[:, None] - center[:, None] + 0.5)
               / filterscale)
    w = np.where(t[None] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0, w / np.where(total != 0, total, 1), w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one),
                 np.trunc(0.5 + w * one)).astype(np.int64)
    return xmin, k


def _resample_axis(x: np.ndarray, axis: int, out_size: int,
                   kernel=_bicubic, support: float = 2.0) -> np.ndarray:
    """One separable pass of PIL's 8-bit resampling along ``axis`` of a
    uint8 array: the sum from half a unit, shifted down, clipped."""
    x = np.moveaxis(x, axis, -1).astype(np.int64)
    xmin, k = _coefficients(x.shape[-1], out_size, kernel, support)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None],
                     x.shape[-1] - 1)
    acc = np.full(x.shape[:-1] + (out_size,), 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for t in range(k.shape[1]):
        acc += x[..., idx[:, t]] * k[:, t]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bicubic(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for ``size = (h, w)``: PIL's
    ``resize((w, h), BICUBIC)``, the width first, each pass rounded to
    uint8 (so the kernel's overshoot is clipped between the passes)."""
    h, w = (int(v) for v in size)
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = _resample_axis(out, 1, w)
    if out.shape[0] != h:
        out = _resample_axis(out, 0, h)
    return out


def resize_bilinear(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for ``size = (h, w)``: PIL's
    ``resize((w, h), BILINEAR)``, the width first, each pass rounded."""
    h, w = (int(v) for v in size)
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = _resample_axis(out, 1, w, _bilinear, 1.0)
    if out.shape[0] != h:
        out = _resample_axis(out, 0, h, _bilinear, 1.0)
    return out


def resize_nearest(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """(H, W, ...) -> (h, w, ...) for ``size = (h, w)``: PIL's
    ``resize((w, h), NEAREST)``."""
    h, w = (int(v) for v in size)
    img = np.asarray(img)
    rows = ((np.arange(h) + 0.5) * img.shape[0] / h).astype(np.int64)
    cols = ((np.arange(w) + 0.5) * img.shape[1] / w).astype(np.int64)
    return img[rows][:, cols]


def pad(img: np.ndarray, back_pad: Sequence[int]) -> np.ndarray:
    """(H, W, C) -> black borders of ``back_pad = (left, top, right,
    bottom)`` pixels."""
    left, top, right, bottom = (int(v) for v in back_pad)
    return np.pad(img, ((top, bottom), (left, right), (0, 0)))
