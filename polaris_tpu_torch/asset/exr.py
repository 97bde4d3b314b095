"""Self-contained OpenEXR (v2) reader/writer.

The reference loads EXR through OpenImageIO (README.md:19); this image has
no EXR bindings, so a from-scratch codec covers what shows up in the wild:

  * single-part SCANLINE images: NONE / RLE / ZIP / ZIPS / PIZ / PXR24 /
    B44 / B44A
  * single-part TILED images (ONE_LEVEL, MIPMAP, RIPMAP — level 0 is read),
    same compression set
  * HALF / FLOAT / UINT channels R/G/B(/A/Y)
  * crop windows (dataWindow != displayWindow): the returned image is the
    display window with data-window pixels composed in, zero elsewhere
  * graceful ExrError for the exotic tail: DWAA/DWAB, multi-part, deep

The PIZ codec (bitmap LUT + 2D integer wavelet + canonical Huffman with an
RLE escape symbol) follows the format as implemented by the OpenEXR
reference library (ImfPizCompressor / ImfWav / ImfHuf); both directions are
implemented here so the lossless round-trip is testable without external
bindings (tests/test_exr.py). PXR24 (ImfPxr24Compressor: per-channel
per-scanline delta byte planes + zlib; FLOAT truncated-with-rounding to 24
bits) likewise implements both directions.

The writer emits FLOAT or HALF scanline (and FLOAT tiled) images in any
supported compression (used by tests and for dumping HDR render output).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 20000630

# compression ids
NO_COMPRESSION = 0
RLE_COMPRESSION = 1
ZIPS_COMPRESSION = 2  # 1 scanline per chunk
ZIP_COMPRESSION = 3   # 16 scanlines per chunk
PIZ_COMPRESSION = 4   # 32 scanlines per chunk
PXR24_COMPRESSION = 5
B44_COMPRESSION = 6   # 32 scanlines per chunk, HALF 4x4 blocks -> 14 bytes
B44A_COMPRESSION = 7  # B44 + 3-byte flat blocks
DWAA_COMPRESSION = 8
DWAB_COMPRESSION = 9

PIXEL_UINT = 0
PIXEL_HALF = 1
PIXEL_FLOAT = 2

# tiled level modes
ONE_LEVEL = 0
MIPMAP_LEVELS = 1
RIPMAP_LEVELS = 2

_DTYPE = {PIXEL_HALF: np.float16, PIXEL_FLOAT: np.float32, PIXEL_UINT: np.uint32}
_LINES_PER_CHUNK = {
    NO_COMPRESSION: 1,
    RLE_COMPRESSION: 1,
    ZIPS_COMPRESSION: 1,
    ZIP_COMPRESSION: 16,
    PXR24_COMPRESSION: 16,
    PIZ_COMPRESSION: 32,
    B44_COMPRESSION: 32,
    B44A_COMPRESSION: 32,
}


class ExrError(ValueError):
    pass


def _read_cstr(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _predictor_undo(data: bytearray) -> bytes:
    """EXR zip post-processing: delta-decode then de-interleave."""
    # undo delta encoding
    for i in range(1, len(data)):
        data[i] = (data[i] + data[i - 1] - 128) & 0xFF
    # de-interleave: first half = even bytes, second half = odd bytes
    half = (len(data) + 1) // 2
    out = bytearray(len(data))
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return bytes(out)


def _predictor_apply(data: bytes) -> bytes:
    """Inverse of _predictor_undo (interleave + delta-encode)."""
    src = bytearray(len(data))
    half = (len(data) + 1) // 2
    src[:half] = data[0::2]
    src[half:] = data[1::2]
    out = bytearray(len(data))
    prev = 0
    for i, b in enumerate(src):
        if i == 0:
            out[0] = b
            prev = b
        else:
            out[i] = (b - prev + 128) & 0xFF
            prev = b
    return bytes(out)


# --------------------------------------------------------------------- RLE


def _rle_decode(raw: bytes) -> bytearray:
    """EXR run-length decode (signed count byte: <0 literal run, >=0 repeat
    of the next byte count+1 times); the zip predictor applies after."""
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        cnt = raw[i] - 256 if raw[i] > 127 else raw[i]
        i += 1
        if cnt < 0:
            out += raw[i : i - cnt]
            i += -cnt
        else:
            out += raw[i : i + 1] * (cnt + 1)
            i += 1
    return out


# --------------------------------------------------------------------- PIZ
#
# Format as implemented by the OpenEXR reference library:
#   chunk = minNonZero u16 | maxNonZero u16 | bitmap[min..max] |
#           hufLength i32 | huffman data
# pipeline (decode): huffman -> per-channel 2D integer wavelet decode ->
# reverse-LUT -> interleave channels per scanline.

_BITMAP_SIZE = 8192  # 65536 values / 8 bits
_HUF_ENCSIZE = 65537  # 16-bit symbols + the run-length escape
_HUF_DECBITS = 14


def _bitmap_from_data(data: np.ndarray):
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    present = np.zeros(65536, bool)
    present[data] = True
    present[0] = False  # zero is implicit in the LUT
    idx = np.nonzero(present)[0]
    np.bitwise_or.at(bitmap, idx >> 3, (1 << (idx & 7)).astype(np.uint8))
    return bitmap


def _forward_lut(bitmap: np.ndarray):
    """lut[data_value] -> compact code; returns (lut, maxValue)."""
    d = np.arange(65536)
    present = (bitmap[d >> 3] & (1 << (d & 7)).astype(np.uint8)) != 0
    present[0] = True
    lut = np.zeros(65536, np.uint16)
    k = np.cumsum(present) - 1
    lut[present] = k[present].astype(np.uint16)
    return lut, int(k[-1])


def _reverse_lut(bitmap: np.ndarray):
    """lut[compact code] -> data value; returns (lut, maxValue)."""
    d = np.arange(65536)
    present = (bitmap[d >> 3] & (1 << (d & 7)).astype(np.uint8)) != 0
    present[0] = True
    vals = d[present]
    lut = np.zeros(65536, np.uint16)
    lut[: len(vals)] = vals.astype(np.uint16)
    return lut, len(vals) - 1


# ----- 2D integer wavelet (ImfWav structure; 14-bit and 16-bit variants)

_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_M_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    m = ((as_ + bs) >> 1).astype(np.int16)
    d = (as_ - bs).astype(np.int16)
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (a.astype(np.int32) - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + _M_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_encode(a: np.ndarray, mx: int) -> None:
    """In-place 2D wavelet encode of a (ny, nx) uint16 array."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    ny, nx = a.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            q00 = a[np.ix_(ys, xs)]
            q01 = a[np.ix_(ys, xs + p)]
            q10 = a[np.ix_(ys + p, xs)]
            q11 = a[np.ix_(ys + p, xs + p)]
            i00, i01 = enc(q00, q01)  # horizontal pairs first
            i10, i11 = enc(q10, q11)
            r00, r10 = enc(i00, i10)  # then vertical
            r01, r11 = enc(i01, i11)
            a[np.ix_(ys, xs)] = r00
            a[np.ix_(ys, xs + p)] = r01
            a[np.ix_(ys + p, xs)] = r10
            a[np.ix_(ys + p, xs + p)] = r11
        if (nx & p) and len(ys):
            xe = len(xs) * p2
            i00, hp = enc(a[ys, xe], a[ys + p, xe])
            a[ys, xe] = i00
            a[ys + p, xe] = hp
        if ny & p:
            ye = len(ys) * p2
            if len(xs):
                i00, hp = enc(a[ye, xs], a[ye, xs + p])
                a[ye, xs] = i00
                a[ye, xs + p] = hp
        p, p2 = p2, p2 << 1


def _wav2_decode(a: np.ndarray, mx: int) -> None:
    """In-place inverse of _wav2_encode."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            q00 = a[np.ix_(ys, xs)]
            q01 = a[np.ix_(ys, xs + p)]
            q10 = a[np.ix_(ys + p, xs)]
            q11 = a[np.ix_(ys + p, xs + p)]
            i00, i10 = dec(q00, q10)  # vertical pairs first
            i01, i11 = dec(q01, q11)
            r00, r01 = dec(i00, i01)  # then horizontal
            r10, r11 = dec(i10, i11)
            a[np.ix_(ys, xs)] = r00
            a[np.ix_(ys, xs + p)] = r01
            a[np.ix_(ys + p, xs)] = r10
            a[np.ix_(ys + p, xs + p)] = r11
        if (nx & p) and len(ys):
            xe = len(xs) * p2
            i00, hp = dec(a[ys, xe], a[ys + p, xe])
            a[ys, xe] = i00
            a[ys + p, xe] = hp
        if ny & p:
            ye = len(ys) * p2
            if len(xs):
                i00, hp = dec(a[ye, xs], a[ye, xs + p])
                a[ye, xs] = i00
                a[ye, xs + p] = hp
        p2 = p
        p >>= 1


# ----- canonical Huffman with run-length escape (ImfHuf format)

_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN  # 6


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, val: int):
        self.c = (self.c << nbits) | val
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.buf.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def flush(self):
        if self.lc:
            self.buf.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0


def _canonical_codes(lengths: np.ndarray):
    """hufCanonicalCodeTable: assign canonical codes from code lengths.
    Returns dict symbol -> (code, length)."""
    n = np.zeros(59, np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = {}
    for sym in np.nonzero(lengths)[0]:
        l = int(lengths[sym])
        codes[int(sym)] = (int(n[l]), l)
        n[l] += 1
    return codes


def _huffman_lengths(freq: np.ndarray) -> np.ndarray:
    """Code lengths for the nonzero-frequency symbols (heap Huffman),
    clamped to the format's 58-bit maximum via a fixed-length fallback."""
    import heapq

    syms = np.nonzero(freq)[0]
    lengths = np.zeros(_HUF_ENCSIZE, np.uint8)
    if len(syms) == 0:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    heap = [(int(freq[s]), int(s), []) for s in syms]
    # the list in each entry collects the symbols under that subtree
    heap = [(f, s, [s]) for f, s, _ in heap]
    heapq.heapify(heap)
    depth = np.zeros(_HUF_ENCSIZE, np.uint8)
    while len(heap) > 1:
        f1, t1, s1 = heapq.heappop(heap)
        f2, t2, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, min(t1, t2), s1 + s2))
    if depth.max() > 58:
        fixed = max(1, int(np.ceil(np.log2(len(syms)))))
        depth[:] = 0
        depth[syms] = fixed
    return depth


def _pack_enc_table(lengths: np.ndarray, im: int, iM: int, bw: _BitWriter):
    i = im
    while i <= iM:
        l = int(lengths[i])
        if l == 0:
            zerun = 1
            while i < iM and zerun < 255 + _SHORTEST_LONG_RUN:
                if lengths[i + 1] > 0:
                    break
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= _SHORTEST_LONG_RUN:
                    bw.write(6, _LONG_ZEROCODE_RUN)
                    bw.write(8, zerun - _SHORTEST_LONG_RUN)
                else:
                    bw.write(6, _SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        bw.write(6, l)
        i += 1


def _huf_compress(data: np.ndarray) -> bytes:
    """data: uint16 array -> ImfHuf-format bytes (20-byte header, packed
    code-length table, bitstream). The run-length escape symbol is 65536."""
    n = len(data)
    if n == 0:
        return struct.pack("<IIIII", 0, 0, 0, 0, 0)
    rlc = _HUF_ENCSIZE - 1
    freq = np.zeros(_HUF_ENCSIZE, np.int64)
    freq[:65536] = np.bincount(data, minlength=65536)
    freq[rlc] = 1
    lengths = _huffman_lengths(freq)
    nz = np.nonzero(lengths)[0]
    im, iM = int(nz[0]), int(nz[-1])
    codes = _canonical_codes(lengths)

    tw = _BitWriter()
    _pack_enc_table(lengths, im, iM, tw)
    tw.flush()
    table = bytes(tw.buf)

    bw = _BitWriter()
    rl_code, rl_len = codes[rlc]
    # run-length encode repeats (cap 255 extra copies per run)
    i = 0
    nbits = 0
    while i < n:
        s = int(data[i])
        run = 0
        while i + run + 1 < n and data[i + run + 1] == s and run < 255:
            run += 1
        c, l = codes[s]
        if l + rl_len + 8 < l * (run + 1):
            bw.write(l, c)
            bw.write(rl_len, rl_code)
            bw.write(8, run)
            nbits += l + rl_len + 8
        else:
            for _ in range(run + 1):
                bw.write(l, c)
            nbits += l * (run + 1)
        i += run + 1
    bw.flush()
    head = struct.pack("<IIIII", im, iM, len(table), nbits, 0)
    return head + table + bytes(bw.buf)


def _huf_uncompress(raw: bytes, n_out: int) -> np.ndarray:
    if n_out == 0:
        return np.zeros(0, np.uint16)
    im, iM, _tlen, nbits, _ = struct.unpack_from("<IIIII", raw, 0)
    if iM >= _HUF_ENCSIZE:
        raise ExrError("corrupt huffman header")
    pos = 20
    # unpack the code-length table (6-bit lengths with zero-run escapes)
    lengths = np.zeros(_HUF_ENCSIZE, np.uint8)
    c = 0
    lc = 0
    i = im
    while i <= iM:
        while lc < 6:
            c = (c << 8) | raw[pos]
            pos += 1
            lc += 8
        l = (c >> (lc - 6)) & 0x3F
        lc -= 6
        if l == _LONG_ZEROCODE_RUN:
            while lc < 8:
                c = (c << 8) | raw[pos]
                pos += 1
                lc += 8
            i += ((c >> (lc - 8)) & 0xFF) + _SHORTEST_LONG_RUN
            lc -= 8
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    # remaining bits of the current byte are padding; data is byte-aligned
    codes = _canonical_codes(lengths)
    rlc = iM
    # 14-bit fast table + dict for long codes
    fast = [None] * (1 << _HUF_DECBITS)
    longs: Dict[Tuple[int, int], int] = {}
    for sym, (code, l) in codes.items():
        if l <= _HUF_DECBITS:
            base = code << (_HUF_DECBITS - l)
            for k in range(1 << (_HUF_DECBITS - l)):
                fast[base | k] = (sym, l)
        else:
            longs[(l, code)] = sym

    out = np.zeros(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    end = pos + (nbits + 7) // 8
    mask = (1 << _HUF_DECBITS) - 1

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | raw[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi == 0 or oi + cs > n_out:
                raise ExrError("corrupt huffman run")
            out[oi : oi + cs] = out[oi - 1]
            oi += cs
        else:
            out[oi] = sym
            oi += 1

    while pos < end and oi < n_out:
        c = (c << 8) | raw[pos]
        pos += 1
        lc += 8
        while lc >= _HUF_DECBITS and oi < n_out:
            entry = fast[(c >> (lc - _HUF_DECBITS)) & mask]
            if entry is not None:
                sym, l = entry
                lc -= l
                emit(sym)
            else:
                found = False
                for l in range(_HUF_DECBITS + 1, 59):
                    while lc < l and pos < end:
                        c = (c << 8) | raw[pos]
                        pos += 1
                        lc += 8
                    if lc < l:
                        break
                    code = (c >> (lc - l)) & ((1 << l) - 1)
                    sym = longs.get((l, code))
                    if sym is not None:
                        lc -= l
                        emit(sym)
                        found = True
                        break
                if not found:
                    raise ExrError("corrupt huffman data")
    # flush the tail bits
    shift = (8 - nbits) & 7
    c >>= shift
    lc -= shift
    while lc > 0 and oi < n_out:
        entry = fast[(c << (_HUF_DECBITS - lc)) & mask]
        if entry is None or entry[1] > lc:
            raise ExrError("corrupt huffman tail")
        sym, l = entry
        lc -= l
        emit(sym)
    if oi != n_out:
        raise ExrError(f"huffman output short: {oi} != {n_out}")
    return out


def _chan_shorts(channels, width: int):
    """Per-channel u16 count per scanline: HALF = 1 short, FLOAT/UINT = 2."""
    return [
        (cname, width * (1 if ptype == PIXEL_HALF else 2))
        for cname, ptype in channels
    ]


def _piz_uncompress(raw: bytes, chan_sorted, width: int, n_lines: int) -> bytes:
    # the native decoder (~100x the Python Huffman loop) handles production
    # env-map sizes; tests pin it bit-for-bit against the Python path below
    try:
        from ..native import piz_decode_native

        out = piz_decode_native(
            raw, [s for _, s in _chan_shorts(chan_sorted, width)], n_lines
        )
    except (ImportError, OSError):
        # toolchain quirks (no g++, dlopen failure) must never break file
        # loading — but a genuine decode failure (rc != 0 ValueError) must
        # propagate: the Python path would fail on the same corrupt chunk,
        # ~100x slower, and silently masking it hides native regressions
        out = None
    if out is not None:
        return out.astype("<u2").tobytes()
    return _piz_uncompress_py(raw, chan_sorted, width, n_lines)


def _piz_uncompress_py(raw: bytes, chan_sorted, width: int, n_lines: int) -> bytes:
    (min_nz,) = struct.unpack_from("<H", raw, 0)
    (max_nz,) = struct.unpack_from("<H", raw, 2)
    pos = 4
    bitmap = np.zeros(_BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(raw, np.uint8, nb, pos)
        pos += nb
    lut, maxv = _reverse_lut(bitmap)
    (hlen,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    shorts = _chan_shorts(chan_sorted, width)
    total = n_lines * sum(s for _, s in shorts)
    data = _huf_uncompress(raw[pos : pos + hlen], total)
    off = 0
    for _, nx_s in shorts:
        view = data[off : off + nx_s * n_lines].reshape(n_lines, nx_s)
        _wav2_decode(view, maxv)
        off += nx_s * n_lines
    data = lut[data]
    # interleave channels per scanline
    out = bytearray(total * 2)
    row_shorts = sum(s for _, s in shorts)
    off = 0
    dst_col = 0
    u16 = data.astype("<u2")
    outv = np.frombuffer(out, dtype="<u2").reshape(n_lines, row_shorts)
    for _, nx_s in shorts:
        outv[:, dst_col : dst_col + nx_s] = u16[off : off + nx_s * n_lines].reshape(
            n_lines, nx_s
        )
        dst_col += nx_s
        off += nx_s * n_lines
    return bytes(out)


def _piz_compress(uncompressed: bytes, chan_sorted, width: int, n_lines: int) -> bytes:
    shorts = _chan_shorts(chan_sorted, width)
    row_shorts = sum(s for _, s in shorts)
    src = np.frombuffer(uncompressed, dtype="<u2").reshape(n_lines, row_shorts)
    # de-interleave into per-channel planes
    planes = []
    col = 0
    for _, nx_s in shorts:
        planes.append(src[:, col : col + nx_s].astype(np.uint16))
        col += nx_s
    data = np.concatenate([p.reshape(-1) for p in planes])
    bitmap = _bitmap_from_data(data)
    lut, maxv = _forward_lut(bitmap)
    data = lut[data]
    off = 0
    for _, nx_s in shorts:
        view = data[off : off + nx_s * n_lines].reshape(n_lines, nx_s)
        _wav2_encode(view, maxv)
        off += nx_s * n_lines
    huf = _huf_compress(data)
    nz = np.nonzero(bitmap)[0]
    if len(nz):
        min_nz, max_nz = int(nz[0]), int(nz[-1])
        bm = bitmap[min_nz : max_nz + 1].tobytes()
    else:
        min_nz, max_nz = _BITMAP_SIZE - 1, 0  # empty range convention
        bm = b""
    return (
        struct.pack("<HH", min_nz, max_nz)
        + bm
        + struct.pack("<i", len(huf))
        + huf
    )


# ------------------------------------------------------------------ reader


# ---------------------------------------------------------------------------
# B44 / B44A (format per the OpenEXR spec's ImfB44Compressor: each HALF
# channel is split into 4x4 blocks; a block is 14 bytes — a 16-bit base
# value, a 6-bit shift and fifteen 6-bit biased running differences — or, in
# B44A files, 3 bytes (marker b[2] == 0xfc) for a constant block. Non-HALF
# channels are stored raw. Decoders validated bit-for-bit against files
# written by the official libOpenEXR, tests/fixtures/b44_*.exr.)

# the running-difference chain order: entry k updates s[_B44_TO[k]] from
# s[_B44_FROM[k]] (first down column 0 of the 4x4 block, then across rows)
_B44_TO = (4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)
_B44_FROM = (0, 4, 8, 0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14)


def _b44_unpack14(blocks: np.ndarray) -> np.ndarray:
    """Vectorized 14-byte block decode: (K, 14) uint16 bytes -> (K, 16)
    uint16 halfs (before the sign/complement undo)."""
    b = blocks.astype(np.uint32)
    s = np.zeros((blocks.shape[0], 16), np.uint32)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    # bytes 2..13 hold sixteen consecutive 6-bit fields (MSB first):
    # the shift, then the 15 biased running differences
    bits = np.unpackbits(blocks[:, 2:].astype(np.uint8), axis=1)
    fields = bits.reshape(blocks.shape[0], 16, 6) @ np.array(
        [32, 16, 8, 4, 2, 1], np.uint32
    )
    shift = fields[:, 0]
    bias = np.uint32(0x20) << shift
    r = fields[:, 1:]
    for k, (dst, src) in enumerate(zip(_B44_TO, _B44_FROM)):
        s[:, dst] = (s[:, src] + (r[:, k] << shift) - bias) & 0xFFFF
    return s.astype(np.uint16)


def _b44_sign_undo(s: np.ndarray) -> np.ndarray:
    """Invert the encoder's order-preserving transform: values with the top
    bit set were non-negative halfs (bit cleared restores them); values with
    it clear were negative/NaN halfs stored complemented."""
    return np.where(s & 0x8000, s & 0x7FFF, ~s).astype(np.uint16)


def _b44_uncompress(
    raw: bytes, chan_sorted, width: int, n_lines: int, may_flat: bool
) -> bytes:
    data = np.frombuffer(raw, np.uint8)
    pos = 0
    nbx = (width + 3) // 4
    nby = (n_lines + 3) // 4
    planes = []
    for cname, ptype in chan_sorted:
        if ptype != PIXEL_HALF:
            nb = width * n_lines * np.dtype(_DTYPE[ptype]).itemsize
            planes.append(
                np.frombuffer(raw, np.uint8, nb, pos).reshape(n_lines, -1)
            )
            pos += nb
            continue
        nblocks = nbx * nby
        if not may_flat:
            # plain B44: every block is 14 bytes — one vectorized unpack
            blk = data[pos : pos + 14 * nblocks].reshape(nblocks, 14)
            s = _b44_unpack14(blk)
            pos += 14 * nblocks
        else:
            # B44A: 3-byte constant blocks interleave, so walk sequentially
            # (collecting the dense blocks for one vectorized unpack)
            s = np.zeros((nblocks, 16), np.uint16)
            dense_idx = []
            dense_off = []
            for k in range(nblocks):
                if data[pos + 2] == 0xFC:  # constant block (B44A)
                    t0 = (int(data[pos]) << 8) | int(data[pos + 1])
                    s[k] = t0
                    pos += 3
                else:
                    dense_idx.append(k)
                    dense_off.append(pos)
                    pos += 14
            if dense_idx:
                off = np.asarray(dense_off)[:, None] + np.arange(14)
                s[np.asarray(dense_idx)] = _b44_unpack14(data[off])
        s = _b44_sign_undo(s)
        # s[row*4+col] lays out the 4x4 block row-major
        blocks4 = s.reshape(nby, nbx, 4, 4)
        grid = blocks4.transpose(0, 2, 1, 3).reshape(nby * 4, nbx * 4)
        planes.append(grid[:n_lines, :width].view(np.uint16))
    # interleave to the per-line channel-major layout fill() expects
    out = bytearray()
    for line in range(n_lines):
        for p in planes:
            out += p[line].tobytes()
    return bytes(out)


# ------------------------------------------------------------------- PXR24
# Format per ImfPxr24Compressor: per scanline, per channel (alphabetical),
# pixels become per-byte planes (MSB plane first) of the DELTA to the
# previous pixel in that channel-row (previous starts at 0); FLOAT channels
# are first truncated-with-rounding to 24 bits; the plane stream is zlib'd.


def _float_to_float24(f: np.ndarray) -> np.ndarray:
    """f32 -> 24-bit float bits (round-to-nearest; NaN kept NaN; finite
    values CLAMP to the largest finite float24 instead of rounding over
    into infinity — HDR fireflies near FLT_MAX stay finite on read-back).
    The decoder never calls this; only the writer's lossy truncation does.
    """
    i = np.ascontiguousarray(f, "<f4").view(np.uint32)
    s = i & 0x80000000
    e = i & 0x7F800000
    m = i & 0x007FFFFF
    inf_nan = e == 0x7F800000
    m_nan = np.where(m != 0, np.uint32(0x007FFFFF), m)
    rounded = (e | m).astype(np.uint64) + 0x80
    # 0x7F7FFFFF & 0x7FFFFF80 = 0x7F7FFF80, the max finite 24-bit float
    rounded = np.minimum(rounded, 0x7F7FFFFF).astype(np.uint32)
    out = np.where(inf_nan, (s | e | m_nan), s | (rounded & 0x7FFFFF80))
    return out >> 8


def _pxr24_uncompress(raw, chan_sorted, width, n_lines) -> bytes:
    data = np.frombuffer(zlib.decompress(raw), np.uint8)
    pos = 0
    out = bytearray()

    def planes(nb):
        nonlocal pos
        ps = [data[pos + k * width : pos + (k + 1) * width] for k in range(nb)]
        pos += nb * width
        return [p.astype(np.uint64) for p in ps]

    for _y in range(n_lines):
        for _cname, ptype in chan_sorted:
            if ptype == PIXEL_HALF:
                p0, p1 = planes(2)
                diff = (p0 << 8) | p1
                pix = (np.cumsum(diff) & 0xFFFF).astype("<u2")
                out += pix.tobytes()
            elif ptype == PIXEL_FLOAT:
                p0, p1, p2 = planes(3)
                diff = (p0 << 16) | (p1 << 8) | p2
                pix = (np.cumsum(diff) & 0xFFFFFF).astype(np.uint32)
                out += (pix << 8).astype("<u4").tobytes()
            else:  # UINT
                p0, p1, p2, p3 = planes(4)
                diff = (p0 << 24) | (p1 << 16) | (p2 << 8) | p3
                pix = (np.cumsum(diff) & 0xFFFFFFFF).astype("<u4")
                out += pix.tobytes()
    if pos != data.size:
        raise ExrError("pxr24 chunk size mismatch")
    return bytes(out)


def _pxr24_compress(raw: bytes, chan_sorted, width, n_lines) -> bytes:
    out = bytearray()
    pos = 0
    for _y in range(n_lines):
        for _cname, ptype in chan_sorted:
            if ptype == PIXEL_HALF:
                pix = np.frombuffer(raw, "<u2", width, pos).astype(np.int64)
                pos += 2 * width
                diff = np.diff(pix, prepend=0) & 0xFFFF
                out += (diff >> 8).astype(np.uint8).tobytes()
                out += (diff & 0xFF).astype(np.uint8).tobytes()
            elif ptype == PIXEL_FLOAT:
                f = np.frombuffer(raw, "<f4", width, pos)
                pos += 4 * width
                pix = _float_to_float24(f).astype(np.int64)
                diff = np.diff(pix, prepend=0) & 0xFFFFFF
                out += (diff >> 16).astype(np.uint8).tobytes()
                out += ((diff >> 8) & 0xFF).astype(np.uint8).tobytes()
                out += (diff & 0xFF).astype(np.uint8).tobytes()
            else:
                pix = np.frombuffer(raw, "<u4", width, pos).astype(np.int64)
                pos += 4 * width
                diff = np.diff(pix, prepend=0) & 0xFFFFFFFF
                for sh in (24, 16, 8, 0):
                    out += ((diff >> sh) & 0xFF).astype(np.uint8).tobytes()
    return zlib.compress(bytes(out))


def _decode_chunk(raw, chan_sorted, width, n_lines, compression):
    """Decode one chunk (scanline block or tile) to raw interleaved bytes."""
    expect = n_lines * sum(
        width * np.dtype(_DTYPE[t]).itemsize for _, t in chan_sorted
    )
    if compression == NO_COMPRESSION or len(raw) >= expect:
        return raw  # stored uncompressed (or compression didn't shrink)
    if compression in (ZIP_COMPRESSION, ZIPS_COMPRESSION):
        return _predictor_undo(bytearray(zlib.decompress(raw)))
    if compression == RLE_COMPRESSION:
        return _predictor_undo(_rle_decode(raw))
    if compression == PIZ_COMPRESSION:
        return _piz_uncompress(raw, chan_sorted, width, n_lines)
    if compression in (B44_COMPRESSION, B44A_COMPRESSION):
        return _b44_uncompress(
            raw, chan_sorted, width, n_lines,
            may_flat=compression == B44A_COMPRESSION,
        )
    if compression == PXR24_COMPRESSION:
        return _pxr24_uncompress(raw, chan_sorted, width, n_lines)
    raise ExrError(f"unsupported compression {compression}")


def _rf(x: float, rnd_up: bool) -> int:
    import math

    return int(math.ceil(x)) if rnd_up else int(math.floor(x))


def _level_size(d: int, l: int, rnd_up: bool) -> int:
    s = d / (1 << l)
    return max(1, _rf(s, rnd_up))


def _tile_chunk_count(w, h, xs, ys, mode, rnd_up):
    """Total offset-table entries for a tiled single-part file."""
    import math

    def nlev(d):
        return _rf(math.log2(max(1, d)), rnd_up) + 1

    def tiles(lw, lh):
        return ((lw + xs - 1) // xs) * ((lh + ys - 1) // ys)

    if mode == ONE_LEVEL:
        return tiles(w, h)
    if mode == MIPMAP_LEVELS:
        return sum(
            tiles(_level_size(w, l, rnd_up), _level_size(h, l, rnd_up))
            for l in range(nlev(max(w, h)))
        )
    if mode == RIPMAP_LEVELS:
        return sum(
            tiles(_level_size(w, lx, rnd_up), _level_size(h, ly, rnd_up))
            for ly in range(nlev(h))
            for lx in range(nlev(w))
        )
    raise ExrError(f"unknown tile level mode {mode}")


def read_exr(path: str) -> np.ndarray:
    """Read an EXR image to (H, W, 4) float32 RGBA (missing channels: A=1,
    Y replicated to RGB). Handles single-part scanline AND tiled images
    (level 0 of mip/rip-mapped files) in NONE/RLE/ZIP/ZIPS/PIZ compression."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ExrError(f"{path}: not an EXR file")
    tiled = bool(version & 0x200)
    if version & 0x1000:
        raise ExrError(f"{path}: multi-part EXR not supported")
    if version & 0x800:
        raise ExrError(f"{path}: deep data not supported")
    pos = 8

    channels: List[Tuple[str, int]] = []
    compression = NO_COMPRESSION
    data_window = None
    display_window = None
    tile_desc = None
    while True:
        name, pos = _read_cstr(buf, pos)
        if name == "":
            break
        typ, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        val = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while val[cp] != 0:
                cname, cp = _read_cstr(val, cp)
                ptype, _plin, _x, _y = struct.unpack_from("<iiii", val, cp)
                cp += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", val)
        elif name == "displayWindow":
            display_window = struct.unpack("<iiii", val)
        elif name == "tiles":
            txs, tys, tmode = struct.unpack("<IIB", val)
            tile_desc = (txs, tys, tmode & 0xF, bool(tmode >> 4))

    if data_window is None:
        raise ExrError(f"{path}: missing dataWindow")
    x0, y0, x1, y1 = data_window
    width = x1 - x0 + 1
    height = y1 - y0 + 1
    if compression not in _LINES_PER_CHUNK:
        names = {
            DWAA_COMPRESSION: "DWAA",
            DWAB_COMPRESSION: "DWAB",
        }
        raise ExrError(
            f"{path}: unsupported compression "
            f"{names.get(compression, compression)}"
        )

    # channels are stored alphabetically within a chunk
    chan_sorted = sorted(channels, key=lambda c: c[0])
    planes: Dict[str, np.ndarray] = {
        c: np.zeros((height, width), np.float32) for c, _ in channels
    }

    def fill(raw, cw, ch, px, py):
        """Scatter one decoded chunk (cw x ch pixels at (px, py)) into the
        channel planes."""
        cp = 0
        for line in range(ch):
            for cname, ptype in chan_sorted:
                dt = _DTYPE[ptype]
                nb = cw * np.dtype(dt).itemsize
                vals = np.frombuffer(raw, dtype=dt, count=cw, offset=cp)
                planes[cname][py + line, px : px + cw] = vals.astype(np.float32)
                cp += nb

    if tiled:
        if tile_desc is None:
            raise ExrError(f"{path}: tiled flag but no tiles attribute")
        txs, tys, lmode, rnd_up = tile_desc
        num_chunks = _tile_chunk_count(width, height, txs, tys, lmode, rnd_up)
        offsets = struct.unpack_from(f"<{num_chunks}q", buf, pos)
        for off in offsets:
            dx, dy, lx, ly, nbytes = struct.unpack_from("<iiiii", buf, off)
            raw = buf[off + 20 : off + 20 + nbytes]
            if lx != 0 or ly != 0:
                continue  # only level 0 (full resolution) is read
            px, py = dx * txs, dy * tys
            cw = min(txs, width - px)
            ch = min(tys, height - py)
            fill(
                _decode_chunk(raw, chan_sorted, cw, ch, compression),
                cw, ch, px, py,
            )
    else:
        lines_per_chunk = _LINES_PER_CHUNK[compression]
        num_chunks = (height + lines_per_chunk - 1) // lines_per_chunk
        offsets = struct.unpack_from(f"<{num_chunks}q", buf, pos)
        for off in offsets:
            (y,) = struct.unpack_from("<i", buf, off)
            (nbytes,) = struct.unpack_from("<i", buf, off + 4)
            raw = buf[off + 8 : off + 8 + nbytes]
            n_lines = min(lines_per_chunk, y1 - y + 1)
            raw = _decode_chunk(raw, chan_sorted, width, n_lines, compression)
            fill(raw, width, n_lines, 0, y - y0)

    out = np.zeros((height, width, 4), np.float32)
    out[..., 3] = 1.0
    names = {c for c, _ in channels}
    if "Y" in names and "R" not in names:
        for i in range(3):
            out[..., i] = planes["Y"]
    else:
        for i, c in enumerate("RGB"):
            if c in planes:
                out[..., i] = planes[c]
    if "A" in planes:
        out[..., 3] = planes["A"]

    # crop-window composition: the image a viewer sees is the DISPLAY
    # window; data-window pixels are positioned inside it and everything
    # else is transparent black (matches libOpenEXR's fill semantics —
    # pinned against it by tests/fixtures/crop_*.exr). Files where the two
    # windows coincide skip this (the common case and the old behavior).
    if display_window is not None and display_window != data_window:
        dx0, dy0, dx1, dy1 = display_window
        dw_w = dx1 - dx0 + 1
        dw_h = dy1 - dy0 + 1
        full = np.zeros((dw_h, dw_w, 4), np.float32)
        # intersection of the two windows, in each window's local coords
        ix0, iy0 = max(x0, dx0), max(y0, dy0)
        ix1, iy1 = min(x1, dx1), min(y1, dy1)
        if ix0 <= ix1 and iy0 <= iy1:
            full[iy0 - dy0 : iy1 - dy0 + 1, ix0 - dx0 : ix1 - dx0 + 1] = out[
                iy0 - y0 : iy1 - y0 + 1, ix0 - x0 : ix1 - x0 + 1
            ]
        return full
    return out


def write_exr(
    path: str,
    rgb: np.ndarray,
    compression: int = NO_COMPRESSION,
    pixel_type: int = PIXEL_FLOAT,
) -> None:
    """Write (H, W, 3) float32 as a scanline EXR in the requested
    compression (NONE/ZIP/ZIPS/PIZ/PXR24) and channel type. HALF
    (``pixel_type=PIXEL_HALF``) is the dominant interchange format the
    reference writes through OpenImageIO."""
    h, w, _ = rgb.shape
    head = struct.pack("<ii", MAGIC, 2) + _header_bytes(
        w, h, compression, pixel_type=pixel_type
    )
    lines_per_chunk = _LINES_PER_CHUNK[compression]
    num_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
    chans = [("B", pixel_type), ("G", pixel_type), ("R", pixel_type)]
    chunks = []
    for ci in range(num_chunks):
        y = ci * lines_per_chunk
        n_lines = min(lines_per_chunk, h - y)
        raw = _interleave_rgb(rgb[y : y + n_lines], pixel_type)
        data = _encode_chunk(raw, chans, w, n_lines, compression)
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    data_start = len(head) + 8 * num_chunks
    offsets = []
    off = data_start
    for c in chunks:
        offsets.append(off)
        off += len(c)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{num_chunks}q", *offsets))
        for c in chunks:
            f.write(c)


def write_exr_tiled(
    path: str,
    rgb: np.ndarray,
    tile_size: Tuple[int, int] = (64, 64),
    compression: int = NO_COMPRESSION,
) -> None:
    """Write (H, W, 3) float32 as a single-part TILED (ONE_LEVEL) FLOAT EXR."""
    h, w, _ = rgb.shape
    txs, tys = tile_size
    tiles_attr = struct.pack("<IIB", txs, tys, ONE_LEVEL)
    head = struct.pack("<ii", MAGIC, 2 | 0x200) + _header_bytes(
        w, h, compression, tiles_attr
    )
    chans = [("B", PIXEL_FLOAT), ("G", PIXEL_FLOAT), ("R", PIXEL_FLOAT)]
    nx = (w + txs - 1) // txs
    ny = (h + tys - 1) // tys
    chunks = []
    for dy in range(ny):
        for dx in range(nx):
            px, py = dx * txs, dy * tys
            cw = min(txs, w - px)
            ch = min(tys, h - py)
            raw = _interleave_rgb(rgb[py : py + ch, px : px + cw])
            data = _encode_chunk(raw, chans, cw, ch, compression)
            chunks.append(struct.pack("<iiiii", dx, dy, 0, 0, len(data)) + data)
    data_start = len(head) + 8 * len(chunks)
    offsets = []
    off = data_start
    for c in chunks:
        offsets.append(off)
        off += len(c)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{len(chunks)}q", *offsets))
        for c in chunks:
            f.write(c)


def _interleave_rgb(block: np.ndarray, pixel_type: int = PIXEL_FLOAT) -> bytes:
    """(h, w, 3) float32 -> per-scanline channel-planar bytes (B, G, R —
    alphabetical, as the format requires)."""
    dt = "<f2" if pixel_type == PIXEL_HALF else "<f4"
    out = b""
    for y in range(block.shape[0]):
        out += (
            block[y, :, 2].astype(dt).tobytes()
            + block[y, :, 1].astype(dt).tobytes()
            + block[y, :, 0].astype(dt).tobytes()
        )
    return out


def _encode_chunk(raw: bytes, chan_sorted, width, n_lines, compression) -> bytes:
    """Compress one chunk; stores raw when compression doesn't shrink (the
    decoder detects that by size, as the format specifies)."""
    if compression == NO_COMPRESSION:
        return raw
    if compression in (ZIP_COMPRESSION, ZIPS_COMPRESSION):
        comp = zlib.compress(bytes(_predictor_apply(raw)))
    elif compression == PIZ_COMPRESSION:
        comp = _piz_compress(raw, chan_sorted, width, n_lines)
    elif compression == PXR24_COMPRESSION:
        comp = _pxr24_compress(raw, chan_sorted, width, n_lines)
    else:
        raise ExrError(f"writer: unsupported compression {compression}")
    return comp if len(comp) < len(raw) else raw


def _header_bytes(
    w, h, compression, tiles_attr: bytes = None, pixel_type: int = PIXEL_FLOAT
) -> bytes:
    def attr(name: str, typ: str, val: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(val)) + val
        )

    chan = b""
    for c in ("B", "G", "R"):
        chan += c.encode() + b"\x00" + struct.pack("<iiii", pixel_type, 0, 1, 1)
    chan += b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", chan)
        + attr("compression", "compression", bytes([compression]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    )
    if tiles_attr is not None:
        header += attr("tiles", "tiledesc", tiles_attr)
    return header + b"\x00"
