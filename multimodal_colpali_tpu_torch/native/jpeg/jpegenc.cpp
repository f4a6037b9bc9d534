// A baseline JPEG encoder for 8-bit gray or RGB written to give libjpeg-
// turbo's bytes for the settings Pillow's Image.save(format="JPEG") uses: a
// JFIF 1.01 header (aspect 1:1), the standard quantization tables scaled to
// the quality (jcparam.c), the standard Huffman tables (no optimization),
// one interleaved sequential scan. RGB goes to YCbCr with the luma sampled
// (h, v) times the chroma (Pillow's 4:2:0 is (2, 2), 4:2:2 (2, 1), 4:4:4
// (1, 1); libjpeg takes any h, v of 1-4 with h * v <= 8); gray is one
// component. A positive restart interval puts an RSTn marker every that many
// MCUs (jcparam.c restart_interval).
//
// Each step follows libjpeg-turbo's C path: jccolor.c's fixed-point RGB ->
// YCbCr tables, jcsample.c's edge expansion and downsamplers (fullsize,
// h2v1 with its alternating 0, 1 bias, h2v2 with its 1, 2 bias, and
// int_downsample's rounded mean for the other ratios), jcprepct.c's bottom
// padding, jfdctint.c's accurate integer forward DCT, jcdctmgr.c's
// reciprocal quantization, jccoefct.c's dummy blocks at the right and bottom
// edges, jchuff.c's entropy coding and restarts, and jcmarker.c's markers.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// zig-zag index -> natural index (jutils.c jpeg_natural_order)
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// the JPEG standard's Annex K tables, natural order (jcparam.c)
const unsigned kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const unsigned kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman tables (jstdhuff.c), bits[1..16] then the symbols
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// a Huffman table in its encoding form (jchuff.c jpeg_make_c_derived_tbl)
struct HuffCodes {
  unsigned code[256] = {};
  int size[256] = {};
};

HuffCodes derive(const uint8_t* bits, const uint8_t* vals) {
  HuffCodes t;
  int sizes[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) sizes[p++] = l;
  sizes[p] = 0;
  unsigned code = 0;
  int si = sizes[0];
  p = 0;
  std::vector<unsigned> codes(257);
  while (sizes[p]) {
    while (sizes[p] == si) codes[p++] = code++;
    code <<= 1;
    si++;
  }
  for (int i = 0; i < p; i++) {
    t.code[vals[i]] = codes[i];
    t.size[vals[i]] = sizes[i];
  }
  return t;
}

// jcdctmgr.c compute_reciprocal: quantization as a multiply and shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  int b = 0;
  while ((1u << (b + 1)) <= divisor) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {uint32_t(fq), c, r};
}

// jfdctint.c jpeg_fdct_islow, in place on level-shifted samples
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    for (int ctr = 0; ctr < 8; ctr++) {
      int32_t* d = data + ctr * stride;
      int32_t tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      int32_t tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int odd_shift = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        d[0] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      } else {
        d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        d[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * step] = descale(z1 + tmp13 * F0765, odd_shift);
      d[6 * step] = descale(z1 + tmp12 * -F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      d[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      d[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      d[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      d[step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// A component plane, edge-padded to whole blocks and iMCU rows.
struct Plane {
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const { return px[size_t(y) * w + x]; }
};

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  void byte(int b) { out.push_back(uint8_t(b)); }
  void word(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(unsigned code, int size) {
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      int c = int((acc >> (nbits - 8)) & 0xFF);
      byte(c);
      if (c == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {  // fill the last byte with 1-bits (jchuff.c flush_bits)
    if (nbits) bits(0x7F, 7);
    nbits = 0;
    acc = 0;
  }
};

void write_dqt(Writer& w, int index, const unsigned* table) {
  w.word(0xFFDB);
  w.word(67);
  w.byte(index);
  for (int i = 0; i < 64; i++) w.byte(int(table[kNatural[i]]));
}

void write_dht(Writer& w, int index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; l++) n += bits[l];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + n);
  w.byte(index);
  for (int l = 1; l <= 16; l++) w.byte(bits[l]);
  for (int i = 0; i < n; i++) w.byte(vals[i]);
}

int nbits_of(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const int16_t* blk, int& last_dc, const HuffCodes& dc,
                  const HuffCodes& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nb = nbits_of(temp);
  w.bits(dc.code[nb], dc.size[nb]);
  if (nb) w.bits(unsigned(temp2), nb);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nb = nbits_of(temp);
    int i = (r << 4) + nb;
    w.bits(ac.code[i], ac.size[i]);
    w.bits(unsigned(temp2), nb);
    r = 0;
  }
  if (r > 0) w.bits(ac.code[0], ac.size[0]);
}

// the 8 x 8 block at block row by, column bx of a plane -> quantized coefficients
void dct_block(const Plane& p, int by, int bx, const Divisor* div, int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = int32_t(p.at(by * 8 + y, bx * 8 + x)) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t t = ws[i];
    bool neg = t < 0;
    uint64_t a = uint64_t(neg ? -t : t);
    uint32_t q = uint32_t(((a + div[i].corr) * div[i].recip) >> div[i].shift);
    out[i] = int16_t(neg ? -int32_t(q) : int32_t(q));
  }
}

int quality_scale(int quality) {  // jcparam.c jpeg_quality_scaling
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  return quality < 50 ? 5000 / quality : 200 - quality * 2;
}

}  // namespace

extern "C" {

// 8-bit pixels (h rows of w * ncomp bytes; ncomp 1 for gray, 3 for RGB) ->
// a malloc'd JFIF JPEG (*out, *out_len) at ``quality`` (1-100; Pillow's
// default 75), the luma sampled (h_samp, v_samp) times the chroma (RGB
// only), an RSTn marker every ``restart_interval`` MCUs if positive.
// 0 on success, 1 on bad arguments or no memory. Free *out with mmjpeg_free.
int mmjpeg_encode(const unsigned char* px, int w, int h, int ncomp, int quality, int h_samp,
                  int v_samp, int restart_interval, unsigned char** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535 || (ncomp != 1 && ncomp != 3)) return 1;
  if (ncomp == 1) h_samp = v_samp = 1;
  if (h_samp < 1 || h_samp > 4 || v_samp < 1 || v_samp > 4 || h_samp * v_samp + 2 > 10 ||
      restart_interval < 0 || restart_interval > 65535)
    return 1;
  try {
    // quantization tables (jcparam.c jpeg_add_quant_table, baseline)
    const int scale = quality_scale(quality);
    unsigned qt[2][64];
    for (int i = 0; i < 64; i++) {
      for (int t = 0; t < 2; t++) {
        long v = ((long)(t ? kChromQuant[i] : kLumQuant[i]) * scale + 50L) / 100L;
        qt[t][i] = unsigned(v <= 0 ? 1 : (v > 255 ? 255 : v));
      }
    }
    Divisor div[2][64];
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) div[t][i] = reciprocal(qt[t][i] << 3);

    // geometry (jcmaster.c initial_setup, per_scan_setup)
    const int max_h = h_samp, max_v = v_samp;
    int hs[3] = {h_samp, 1, 1}, vs[3] = {v_samp, 1, 1}, wb[3], hb[3];
    for (int c = 0; c < ncomp; c++) {
      wb[c] = (w * hs[c] + 8 * max_h - 1) / (8 * max_h);
      hb[c] = (h * vs[c] + 8 * max_v - 1) / (8 * max_v);
    }
    // one component: an MCU a block; else whole MCUs of max_h x max_v blocks
    const int mcus_x = ncomp == 1 ? wb[0] : (w + 8 * max_h - 1) / (8 * max_h);
    const int mcus_y = ncomp == 1 ? hb[0] : (h + 8 * max_v - 1) / (8 * max_v);

    // full-resolution planes: the rows down to whole row groups of max_v and
    // the columns right to each downsampler's input width, by copying the
    // last row / column (jcprepct.c, jcsample.c expand_right_edge)
    const int fh = (h + max_v - 1) / max_v * max_v;
    int fw = 0;
    for (int c = 0; c < ncomp; c++) fw = std::max(fw, wb[c] * 8 * (max_h / hs[c]));
    std::vector<uint8_t> full[3];
    for (int c = 0; c < ncomp; c++) full[c].resize(size_t(fw) * fh);
    if (ncomp == 1) {
      for (int y = 0; y < fh; y++) {
        const unsigned char* row = px + size_t(y < h ? y : h - 1) * w;
        for (int x = 0; x < fw; x++) full[0][size_t(y) * fw + x] = row[x < w ? x : w - 1];
      }
    } else {
      // RGB -> YCbCr (jccolor.c, SCALEBITS 16, tables by value)
      const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
      auto fix = [](double x) { return int32_t(x * 65536.0 + 0.5); };
      std::vector<int32_t> tab(8 * 256);
      for (int i = 0; i < 256; i++) {
        tab[i] = fix(0.29900) * i;
        tab[256 + i] = fix(0.58700) * i;
        tab[512 + i] = fix(0.11400) * i + ONE_HALF;
        tab[768 + i] = -fix(0.16874) * i;
        tab[1024 + i] = -fix(0.33126) * i;
        tab[1280 + i] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;  // B->Cb, R->Cr
        tab[1536 + i] = -fix(0.41869) * i;
        tab[1792 + i] = -fix(0.08131) * i;
      }
      for (int y = 0; y < fh; y++) {
        const unsigned char* row = px + size_t(y < h ? y : h - 1) * w * 3;
        for (int x = 0; x < fw; x++) {
          const unsigned char* p = row + 3 * (x < w ? x : w - 1);
          int r = p[0], g = p[1], b = p[2];
          size_t o = size_t(y) * fw + x;
          full[0][o] = uint8_t((tab[r] + tab[256 + g] + tab[512 + b]) >> 16);
          full[1][o] = uint8_t((tab[768 + r] + tab[1024 + g] + tab[1280 + b]) >> 16);
          full[2][o] = uint8_t((tab[1280 + r] + tab[1536 + g] + tab[1792 + b]) >> 16);
        }
      }
    }
    // each component downsampled (jcsample.c), then its bottom padded to
    // whole iMCU rows by copying its last row (jcprepct.c)
    Plane planes[3];
    for (int c = 0; c < ncomp; c++) {
      const int hx = max_h / hs[c], vx = max_v / vs[c], rows = fh / vx;
      Plane& p = planes[c];
      p.w = wb[c] * 8;
      p.h = mcus_y * vs[c] * 8;
      p.px.resize(size_t(p.w) * p.h);
      const uint8_t* f = full[c].data();
      for (int y = 0; y < p.h; y++) {
        const uint8_t* r0 = f + size_t(y < rows ? y : rows - 1) * vx * fw;
        uint8_t* o = p.px.data() + size_t(y) * p.w;
        if (hx == 1 && vx == 1) {  // fullsize_downsample
          memcpy(o, r0, p.w);
        } else if (hx == 2 && vx == 1) {  // h2v1_downsample
          int bias = 0;
          for (int x = 0; x < p.w; x++) {
            o[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + bias) >> 1);
            bias ^= 1;
          }
        } else if (hx == 2 && vx == 2) {  // h2v2_downsample
          const uint8_t* r1 = r0 + fw;
          int bias = 1;
          for (int x = 0; x < p.w; x++) {
            o[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
            bias ^= 3;
          }
        } else {  // int_downsample
          const int n = hx * vx;
          for (int x = 0; x < p.w; x++) {
            int sum = 0;
            for (int dy = 0; dy < vx; dy++)
              for (int dx = 0; dx < hx; dx++) sum += r0[size_t(dy) * fw + x * hx + dx];
            o[x] = uint8_t((sum + n / 2) / n);
          }
        }
      }
    }

    Writer wr;
    wr.out.reserve(size_t(w) * h / 2 + 1024);
    // markers (jcmarker.c): SOI, JFIF APP0, DQT, SOF0, DHT, DRI, SOS
    wr.word(0xFFD8);
    wr.word(0xFFE0);
    wr.word(16);
    for (char ch : {'J', 'F', 'I', 'F', '\0'}) wr.byte(ch);
    wr.byte(1);  // version 1.01
    wr.byte(1);
    wr.byte(0);  // density unit: none (aspect ratio 1:1)
    wr.word(1);
    wr.word(1);
    wr.byte(0);  // no thumbnail
    wr.byte(0);
    const int ntables = ncomp == 1 ? 1 : 2;
    for (int t = 0; t < ntables; t++) write_dqt(wr, t, qt[t]);
    wr.word(0xFFC0);
    wr.word(8 + 3 * ncomp);
    wr.byte(8);
    wr.word(h);
    wr.word(w);
    wr.byte(ncomp);
    for (int c = 0; c < ncomp; c++) {
      wr.byte(c + 1);
      wr.byte(hs[c] << 4 | vs[c]);
      wr.byte(c ? 1 : 0);
    }
    write_dht(wr, 0x00, kDcLumBits, kDcVals);
    write_dht(wr, 0x10, kAcLumBits, kAcLumVals);
    if (ncomp == 3) {
      write_dht(wr, 0x01, kDcChromBits, kDcVals);
      write_dht(wr, 0x11, kAcChromBits, kAcChromVals);
    }
    if (restart_interval) {
      wr.word(0xFFDD);
      wr.word(4);
      wr.word(restart_interval);
    }
    wr.word(0xFFDA);
    wr.word(6 + 2 * ncomp);
    wr.byte(ncomp);
    for (int c = 0; c < ncomp; c++) {
      wr.byte(c + 1);
      wr.byte(c ? 0x11 : 0x00);
    }
    wr.byte(0);
    wr.byte(63);
    wr.byte(0);

    const HuffCodes dc_l = derive(kDcLumBits, kDcVals), ac_l = derive(kAcLumBits, kAcLumVals);
    const HuffCodes dc_c = derive(kDcChromBits, kDcVals);
    const HuffCodes ac_c = derive(kAcChromBits, kAcChromVals);
    int last_dc[3] = {0, 0, 0}, to_go = restart_interval, next_rst = 0;
    int16_t blk[10][64];
    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval) {  // jchuff.c emit_restart
          if (to_go == 0) {
            wr.flush();
            wr.word(0xFFD0 + next_rst);
            last_dc[0] = last_dc[1] = last_dc[2] = 0;
            to_go = restart_interval;
            next_rst = (next_rst + 1) & 7;
          }
          to_go--;
        }
        for (int c = 0; c < ncomp; c++) {
          // past the plane's blocks, dummy blocks: at the right edge their
          // DC repeats the block before them, in a row below the plane the
          // last block of the row above (jccoefct.c compress_data)
          int n = 0;
          for (int yi = 0; yi < vs[c]; yi++) {
            const int by = my * vs[c] + yi;
            for (int xi = 0; xi < hs[c]; xi++, n++) {
              const int bx = mx * hs[c] + xi;
              if (by < hb[c] && bx < wb[c]) {
                dct_block(planes[c], by, bx, div[c ? 1 : 0], blk[n]);
              } else {
                memset(blk[n], 0, sizeof(blk[n]));
                blk[n][0] = by < hb[c] ? blk[n - 1][0] : blk[yi * hs[c] - 1][0];
              }
            }
          }
          for (int i = 0; i < n; i++)
            encode_block(wr, blk[i], last_dc[c], c ? dc_c : dc_l, c ? ac_c : ac_l);
        }
      }
    }
    wr.flush();
    wr.word(0xFFD9);

    unsigned char* buf = static_cast<unsigned char*>(malloc(wr.out.size()));
    if (!buf) return 1;
    memcpy(buf, wr.out.data(), wr.out.size());
    *out = buf;
    *out_len = wr.out.size();
    return 0;
  } catch (...) {
    return 1;
  }
}

void mmjpeg_free(void* p) { free(p); }

}  // extern "C"
