// Native PIZ chunk decoder for the OpenEXR codec (asset/exr.py).
//
// The Python decoder is exact but its Huffman bit-loop runs at ~1 M
// symbols/s — minutes for a production 2k lat-long environment map. This
// is the same pipeline (bitmap LUT -> canonical Huffman with RLE escape ->
// per-channel 2D integer wavelet -> scanline interleave) in C++, ~100x
// faster, loaded via ctypes next to the SAH builder. The reference gets
// this from its native OpenImageIO dependency (README.md:19).
//
// Format reference: the OpenEXR library's ImfPizCompressor/ImfHuf/ImfWav.
// tests/test_exr.py pins this decoder bit-for-bit against the Python one.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int HUF_ENCSIZE = 65537;
constexpr int HUF_DECBITS = 14;
constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

// ---------------------------------------------------------------- wavelet

inline void wdec14(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
    int16_t ls = (int16_t)l;
    int16_t hs = (int16_t)h;
    int hi = hs;
    int ai = ls + (hi & 1) + (hi >> 1);
    int16_t as = (int16_t)ai;
    int16_t bs = (int16_t)(as - hi);
    a = (uint16_t)as;
    b = (uint16_t)bs;
}

constexpr int NBITS = 16;
constexpr int A_OFFSET = 1 << (NBITS - 1);
constexpr int M_OFFSET = 1 << (NBITS - 1);
constexpr int MOD_MASK = (1 << NBITS) - 1;

inline void wdec16(uint16_t l, uint16_t h, uint16_t &a, uint16_t &b) {
    int m = l;
    int d = h;
    int bb = (m - (d >> 1)) & MOD_MASK;
    int aa = (d + bb - A_OFFSET) & MOD_MASK;
    b = (uint16_t)bb;
    a = (uint16_t)aa;
}

void wav2_decode(uint16_t *in, int nx, int ox, int ny, int oy, uint16_t mx) {
    bool w14 = mx < (1 << 14);
    int n = (nx > ny) ? ny : nx;
    int p = 1;
    while (p <= n) p <<= 1;
    p >>= 1;
    int p2 = p;
    p >>= 1;
    uint16_t i00, i01, i10, i11;
    while (p >= 1) {
        uint16_t *py = in;
        uint16_t *ey = in + (long)oy * (ny - p2);
        int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
        for (; py <= ey; py += oy2) {
            uint16_t *px = py;
            uint16_t *ex = py + (long)ox * (nx - p2);
            for (; px <= ex; px += ox2) {
                uint16_t *p01 = px + ox1;
                uint16_t *p10 = px + oy1;
                uint16_t *p11 = p10 + ox1;
                if (w14) {
                    wdec14(*px, *p10, i00, i10);
                    wdec14(*p01, *p11, i01, i11);
                    wdec14(i00, i01, *px, *p01);
                    wdec14(i10, i11, *p10, *p11);
                } else {
                    wdec16(*px, *p10, i00, i10);
                    wdec16(*p01, *p11, i01, i11);
                    wdec16(i00, i01, *px, *p01);
                    wdec16(i10, i11, *p10, *p11);
                }
            }
            if (nx & p) {
                uint16_t *p10 = px + oy1;
                if (w14)
                    wdec14(*px, *p10, i00, *p10);
                else
                    wdec16(*px, *p10, i00, *p10);
                *px = i00;
            }
        }
        if (ny & p) {
            uint16_t *px = py;
            uint16_t *ex = py + (long)ox * (nx - p2);
            for (; px <= ex; px += ox2) {
                uint16_t *p01 = px + ox1;
                if (w14)
                    wdec14(*px, *p01, i00, *p01);
                else
                    wdec16(*px, *p01, i00, *p01);
                *px = i00;
            }
        }
        p2 = p;
        p >>= 1;
    }
}

// ---------------------------------------------------------------- huffman

struct FastEntry {
    int sym;  // -1 = long code
    int len;
};

int huf_uncompress(const uint8_t *raw, long raw_len, uint16_t *out,
                   long n_out) {
    if (n_out == 0) return 0;
    if (raw_len < 20) return -10;
    uint32_t im, iM, tlen, nbits;
    std::memcpy(&im, raw + 0, 4);
    std::memcpy(&iM, raw + 4, 4);
    std::memcpy(&tlen, raw + 8, 4);
    std::memcpy(&nbits, raw + 12, 4);
    (void)tlen;
    if (iM >= HUF_ENCSIZE) return -11;
    long pos = 20;

    // unpack code-length table
    std::vector<uint8_t> lengths(HUF_ENCSIZE, 0);
    {
        uint64_t c = 0;
        int lc = 0;
        for (uint32_t i = im; i <= iM;) {
            while (lc < 6) {
                if (pos >= raw_len) return -12;
                c = (c << 8) | raw[pos++];
                lc += 8;
            }
            int l = (int)((c >> (lc - 6)) & 0x3F);
            lc -= 6;
            if (l == LONG_ZEROCODE_RUN) {
                while (lc < 8) {
                    if (pos >= raw_len) return -12;
                    c = (c << 8) | raw[pos++];
                    lc += 8;
                }
                i += ((c >> (lc - 8)) & 0xFF) + SHORTEST_LONG_RUN;
                lc -= 8;
            } else if (l >= SHORT_ZEROCODE_RUN) {
                i += l - SHORT_ZEROCODE_RUN + 2;
            } else {
                lengths[i] = (uint8_t)l;
                i += 1;
            }
        }
    }

    // canonical codes (hufCanonicalCodeTable)
    std::vector<uint64_t> codes(HUF_ENCSIZE, 0);
    {
        uint64_t n[59] = {0};
        for (int i = 0; i < HUF_ENCSIZE; i++)
            if (lengths[i]) n[lengths[i]]++;
        uint64_t c = 0;
        for (int i = 58; i > 0; --i) {
            uint64_t nc = (c + n[i]) >> 1;
            n[i] = c;
            c = nc;
        }
        for (int i = 0; i < HUF_ENCSIZE; i++)
            if (lengths[i]) codes[i] = n[lengths[i]]++;
    }

    // decode tables
    std::vector<FastEntry> fast(1 << HUF_DECBITS, FastEntry{-1, 0});
    std::unordered_map<uint64_t, int> longs;
    for (int s = 0; s < HUF_ENCSIZE; s++) {
        int l = lengths[s];
        if (!l) continue;
        if (l <= HUF_DECBITS) {
            uint64_t base = codes[s] << (HUF_DECBITS - l);
            for (uint64_t k = 0; k < (1ull << (HUF_DECBITS - l)); k++)
                fast[base | k] = FastEntry{s, l};
        } else {
            longs[((uint64_t)l << 58) | codes[s]] = s;
        }
    }

    const int rlc = (int)iM;
    long oi = 0;
    uint64_t c = 0;
    int lc = 0;
    long end = pos + ((long)nbits + 7) / 8;
    if (end > raw_len) return -13;
    const uint64_t mask = (1 << HUF_DECBITS) - 1;

    auto emit = [&](int sym) -> int {
        if (sym == rlc) {
            if (lc < 8) {
                if (pos >= end) return -14;
                c = (c << 8) | raw[pos++];
                lc += 8;
            }
            lc -= 8;
            int cs = (int)((c >> lc) & 0xFF);
            if (oi == 0 || oi + cs > n_out) return -15;
            uint16_t v = out[oi - 1];
            for (int k = 0; k < cs; k++) out[oi + k] = v;
            oi += cs;
        } else {
            out[oi++] = (uint16_t)sym;
        }
        return 0;
    };

    while (pos < end && oi < n_out) {
        c = (c << 8) | raw[pos++];
        lc += 8;
        while (lc >= HUF_DECBITS && oi < n_out) {
            FastEntry e = fast[(c >> (lc - HUF_DECBITS)) & mask];
            if (e.sym >= 0) {
                lc -= e.len;
                int rc = emit(e.sym);
                if (rc) return rc;
            } else {
                bool found = false;
                for (int l = HUF_DECBITS + 1; l < 59; l++) {
                    while (lc < l && pos < end) {
                        c = (c << 8) | raw[pos++];
                        lc += 8;
                    }
                    if (lc < l) break;
                    uint64_t code = (c >> (lc - l)) & ((1ull << l) - 1);
                    auto it = longs.find(((uint64_t)l << 58) | code);
                    if (it != longs.end()) {
                        lc -= l;
                        int rc = emit(it->second);
                        if (rc) return rc;
                        found = true;
                        break;
                    }
                }
                if (!found) return -16;
            }
        }
    }
    int shift = (8 - (int)nbits) & 7;
    c >>= shift;
    lc -= shift;
    while (lc > 0 && oi < n_out) {
        FastEntry e = fast[(c << (HUF_DECBITS - lc)) & mask];
        if (e.sym < 0 || e.len > lc) return -17;
        lc -= e.len;
        int rc = emit(e.sym);
        if (rc) return rc;
    }
    return oi == n_out ? 0 : -18;
}

}  // namespace

extern "C" int polaris_piz_decode(
    const uint8_t *raw, long raw_len,
    const int32_t *chan_shorts,  // per channel: u16 count per scanline
    int n_chans, int n_lines,
    uint16_t *out  // n_lines * row_shorts, scanline-interleaved
) {
    if (raw_len < 4) return -1;
    uint16_t min_nz, max_nz;
    std::memcpy(&min_nz, raw + 0, 2);
    std::memcpy(&max_nz, raw + 2, 2);
    long pos = 4;

    // reverse LUT from the bitmap
    uint8_t bitmap[8192] = {0};
    if (min_nz <= max_nz) {
        long nb = (long)max_nz - min_nz + 1;
        if (pos + nb > raw_len) return -2;
        std::memcpy(bitmap + min_nz, raw + pos, nb);
        pos += nb;
    }
    std::vector<uint16_t> lut(65536, 0);
    int k = 0;
    for (int d = 0; d < 65536; d++)
        if (d == 0 || (bitmap[d >> 3] & (1 << (d & 7)))) lut[k++] = (uint16_t)d;
    uint16_t maxv = (uint16_t)(k - 1);

    int32_t hlen;
    if (pos + 4 > raw_len) return -3;
    std::memcpy(&hlen, raw + pos, 4);
    pos += 4;
    if (pos + hlen > raw_len) return -4;

    long row_shorts = 0;
    for (int ci = 0; ci < n_chans; ci++) row_shorts += chan_shorts[ci];
    long total = row_shorts * n_lines;

    std::vector<uint16_t> tmp(total);
    int rc = huf_uncompress(raw + pos, hlen, tmp.data(), total);
    if (rc) return rc;

    // per-channel wavelet decode + LUT
    long off = 0;
    for (int ci = 0; ci < n_chans; ci++) {
        int nx = chan_shorts[ci];
        wav2_decode(tmp.data() + off, nx, 1, n_lines, nx, maxv);
        off += (long)nx * n_lines;
    }
    for (long i = 0; i < total; i++) tmp[i] = lut[tmp[i]];

    // interleave channels per scanline
    off = 0;
    long col = 0;
    for (int ci = 0; ci < n_chans; ci++) {
        int nx = chan_shorts[ci];
        for (int y = 0; y < n_lines; y++)
            std::memcpy(out + (long)y * row_shorts + col,
                        tmp.data() + off + (long)y * nx,
                        (size_t)nx * 2);
        col += nx;
        off += (long)nx * n_lines;
    }
    return 0;
}
