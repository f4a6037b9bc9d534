// A JPEG decoder behind libjpeg's interface (see jpeglib.h in this
// directory), written to give libjpeg-turbo's pixels: the markers, the
// Huffman entropy decoding (sequential and progressive, with restart
// markers), the accurate integer IDCT, fancy upsampling and the YCbCr
// tables follow jdmarker.c, jdhuff.c, jdphuff.c, jidctint.c, jdsample.c and
// jdcolor.c step for step, including how libjpeg treats a stream that ends
// early (zero bits, later blocks left empty).
//
// Unlike libjpeg it decodes the whole image in jpeg_start_decompress, into
// a coefficient buffer per component, and hands out rows of the finished
// RGB image from jpeg_read_scanlines. Internal errors are C++ exceptions,
// caught in the entry points, which then call the caller's error_exit (a
// longjmp in mmpdf.cpp) from a frame that holds no objects.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

extern "C" {
#include "jpeglib.h"
}

namespace {

struct Fail {};

[[noreturn]] void fail() { throw Fail(); }

// zig-zag index -> natural index, padded for corrupt runs past 63 as
// libjpeg's jpeg_natural_order is
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of the JPEG standard's Annex K.3, which libjpeg-turbo
// installs for a sequential stream that defines no Huffman table in a slot
// (jstdhuff.c).
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

thread_local int tl_failures = 0;

// A Huffman table as a DHT marker gives it, and its decoding form
// (jdhuff.c jpeg_make_d_derived_tbl).
struct Huff {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18];
  int32_t valoffset[18];

  void set(const uint8_t* b, const uint8_t* v, int count) {
    memcpy(bits, b, 17);
    memset(vals, 0, sizeof vals);
    memcpy(vals, v, count);
    defined = true;
  }

  void derive(bool is_dc) {
    if (!defined) fail();
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = bits[l];
      if (p + i > 256) fail();
      while (i--) huffsize[p++] = (uint8_t)l;
    }
    huffsize[p] = 0;
    int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while ((int)huffsize[p] == si) huffcode[p++] = code++;
      if ((int64_t)code >= ((int64_t)1 << si)) fail();
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - (int32_t)huffcode[p];
        p += bits[l];
        maxcode[l] = (int32_t)huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    if (is_dc)
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > 15) fail();
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;   // width_in_blocks, height_in_blocks
  int bw = 0, bh = 0;     // the buffer's blocks, padded to whole MCUs
  int dw = 0, dh = 0;     // downsampled_width, downsampled_height
  bool latched = false;   // quantization table copied at its first scan
  int16_t q[64] = {};     // natural order, as libjpeg's 16-bit IDCT multipliers
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  int coef_bits[64];      // progressive: bits known per zig-zag index, -1 none
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int16_t* block(int bx, int by) { return coef.data() + ((size_t)by * bw + bx) * 64; }
};

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0, pos = 0;

  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huff dc[4], ac[4];
  int restart_interval = 0;

  bool saw_sof = false, progressive = false;
  int width = 0, height = 0, ncomp = 0;
  Component comp[4];
  int hmax = 1, vmax = 1;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;

  // the current scan
  int scan_n = 0;
  Component* scan[4] = {};
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  bool multiple_scans = false;

  // the entropy-coded segment's bit reader (jdhuff.c jpeg_fill_bit_buffer)
  uint64_t buf = 0;
  int cnt = 0;               // bits of real data held in buf
  int marker = 0;            // a marker code met in the data, 0 if none
  size_t marker_end = 0;     // the position just after that marker
  bool insufficient = false;
  int eobrun = 0;
  int restarts_to_go = 0, next_restart = 0;

  std::vector<uint8_t> rgb;

  // -- marker segments (jdmarker.c) --

  int byte() {
    if (pos >= size) fail();
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // next_marker: skip to an 0xFF, past fill bytes, to a non-zero code. The
  // end of the data reads as EOI, as libjpeg's memory source supplies it.
  int next_marker() {
    for (;;) {
      if (pos >= size) return 0xD9;
      int c = data[pos++];
      while (c != 0xFF) {
        if (pos >= size) return 0xD9;
        c = data[pos++];
      }
      do {
        if (pos >= size) return 0xD9;
        c = data[pos++];
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    int len = word() - 2;
    if (len > 0) pos += (size_t)len;
    if (pos > size) pos = size;
  }

  void get_app(int m) {
    int len = word() - 2;
    if (len < 0) len = 0;
    size_t start = pos;
    const uint8_t* d = data + pos;
    size_t avail = size - pos < (size_t)len ? size - pos : (size_t)len;
    if (m == 0xE0 && avail >= 14 && !memcmp(d, "JFIF\0", 5)) saw_jfif = true;
    if (m == 0xEE && avail >= 12 && !memcmp(d, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    pos = start + (size_t)len;
    if (pos > size) pos = size;
  }

  void get_dqt() {
    int length = word() - 2;
    while (length > 0) {
      int n = byte();
      length--;
      int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) fail();
      uint16_t* t = qt[n];
      int count;
      if (prec) {
        if (length < 128) {
          for (int i = 0; i < 64; i++) t[i] = 1;
          count = length >> 1;
        } else {
          count = 64;
        }
      } else {
        if (length < 64) {
          for (int i = 0; i < 64; i++) t[i] = 1;
          count = length;
        } else {
          count = 64;
        }
      }
      for (int i = 0; i < count; i++) t[kNatural[i]] = (uint16_t)(prec ? word() : byte());
      qt_defined[n] = true;
      length -= count;
      if (prec) length -= count;
    }
    if (length != 0) fail();
  }

  void get_dht() {
    int length = word() - 2;
    while (length > 16) {
      int index = byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = (uint8_t)byte();
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail();
      uint8_t vals[256];
      for (int i = 0; i < count; i++) vals[i] = (uint8_t)byte();
      length -= count;
      bool is_ac = index & 0x10;
      if (is_ac) index -= 0x10;
      if (index < 0 || index >= 4) fail();
      (is_ac ? ac : dc)[index].set(bits, vals, count);
    }
    if (length != 0) fail();
  }

  void get_dri() {
    if (word() != 4) fail();
    restart_interval = word();
  }

  void get_sof(int m) {
    if (saw_sof) fail();
    // SOF0/1 sequential and SOF2 progressive Huffman; the arithmetic
    // (SOF9/10) and lossless or hierarchical processes are not decoded
    if (m != 0xC0 && m != 0xC1 && m != 0xC2) fail();
    progressive = m == 0xC2;
    int length = word() - 2;
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    length -= 6;
    if (height <= 0 || width <= 0 || ncomp <= 0) fail();
    if (length != ncomp * 3) fail();
    if (precision != 8 || ncomp > 4 || width > 65500 || height > 65500) fail();
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail();
    }
    saw_sof = true;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      if (comp[i].h > hmax) hmax = comp[i].h;
      if (comp[i].v > vmax) vmax = comp[i].v;
    }
    int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.wib = (int)(((int64_t)width * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = (int)(((int64_t)height * c.v + 8 * vmax - 1) / (8 * vmax));
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  void get_sos() {
    if (!saw_sof) fail();
    int length = word();
    int n = byte();
    if (n < 1 || n > 4 || length != n * 2 + 6) fail();
    int blocks = 0;
    for (int i = 0; i < n; i++) {
      int cc = byte();
      int t = byte();
      Component* c = nullptr;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == cc) c = &comp[k];
      if (!c) fail();
      for (int k = 0; k < i; k++)
        if (scan[k] == c) fail();
      c->dc_tbl = t >> 4;
      c->ac_tbl = t & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail();
      scan[i] = c;
      blocks += n == 1 ? 1 : c->h * c->v;
    }
    if (blocks > 10) fail();  // D_MAX_BLOCKS_IN_MCU
    scan_n = n;
    Ss = byte();
    Se = byte();
    int a = byte();
    Ah = a >> 4;
    Al = a & 15;
  }

  // Markers up to the next SOS (true) or EOI (false).
  bool read_markers() {
    for (;;) {
      int m = next_marker();
      switch (m) {
        case 0xD8:
          fail();  // a second SOI
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          get_sof(m);
          break;
        case 0xC4:
          get_dht();
          break;
        case 0xDB:
          get_dqt();
          break;
        case 0xDD:
          get_dri();
          break;
        case 0xDA:
          get_sos();
          return true;
        case 0xD9:
          return false;
        case 0xE0: case 0xEE:
          get_app(m);
          break;
        case 0xCC:  // DAC: arithmetic-coding conditioning
        case 0xDC:  // DNL
        case 0xFE:  // COM
          skip_segment();
          break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
          break;
        default:
          if (m >= 0xE1 && m <= 0xEF) {
            skip_segment();
            break;
          }
          fail();  // DHP, EXP, JPGn, RESn
      }
    }
  }

  void read_header() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail();
    pos = 2;
    if (!read_markers()) fail();  // no image
    multiple_scans = progressive || scan_n < ncomp;
  }

  // -- the entropy-coded data --

  void fill() {
    while (cnt <= 56 && !marker) {
      if (pos >= size) {  // the memory source's fake EOI
        marker = 0xD9;
        marker_end = size;
        break;
      }
      int c = data[pos];
      if (c == 0xFF) {
        size_t p = pos + 1;
        while (p < size && data[p] == 0xFF) p++;
        if (p < size && data[p] == 0) {
          pos = p + 1;
        } else {
          marker = p < size ? data[p] : 0xD9;
          marker_end = p < size ? p + 1 : size;
          pos = marker_end;
          break;
        }
      } else {
        pos++;
      }
      buf = (buf << 8) | (uint64_t)c;
      cnt += 8;
    }
  }

  uint32_t peek(int k) {
    if (cnt < k) fill();
    uint64_t mask = ((uint64_t)1 << k) - 1;
    if (cnt >= k) return (uint32_t)((buf >> (cnt - k)) & mask);
    return (uint32_t)((buf << (k - cnt)) & mask);  // zero bits past the data
  }

  void consume(int k) {
    if (k > cnt) {
      insufficient = true;
      cnt = 0;
    } else {
      cnt -= k;
    }
  }

  int get_bits(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    consume(k);
    return (int)v;
  }

  int decode(const Huff& h) {
    uint32_t bits = peek(16);
    for (int l = 1; l <= 16; l++) {
      int32_t code = (int32_t)(bits >> (16 - l));
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    consume(17);  // jpeg_huff_decode reads a 17th bit, then gives 0
    return 0;
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + (int)((unsigned)-1 << s) + 1 : r;
  }

  // jpeg_resync_to_restart's choice for a marker that is not the RSTn due
  void resync() {
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((next_restart + 1) & 7) ||
                 marker == 0xD0 + ((next_restart + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((next_restart - 1) & 7) ||
                 marker == 0xD0 + ((next_restart - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        marker = 0;
        return;
      }
      if (action == 3) return;
      pos = marker_end;
      marker = next_marker();
      marker_end = pos;
    }
  }

  void process_restart() {
    cnt = 0;
    if (!marker) {
      marker = next_marker();
      marker_end = pos;
    }
    if (marker == 0xD0 + next_restart) {
      marker = 0;
    } else {
      resync();
    }
    next_restart = (next_restart + 1) & 7;
    for (int i = 0; i < scan_n; i++) scan[i]->last_dc = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (!marker) insufficient = false;
  }

  void decode_sequential(int16_t* b, Component& c) {
    int s = decode(dc[c.dc_tbl]);
    if (s) s = extend(get_bits(s), s);
    s += c.last_dc;
    c.last_dc = s;
    b[0] = (int16_t)s;
    const Huff& t = ac[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      s = decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = get_bits(s);
        b[kNatural[k]] = (int16_t)extend(r, s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(int16_t* b, Component& c) {
    int s = decode(dc[c.dc_tbl]);
    if (s) s = extend(get_bits(s), s);
    s += c.last_dc;
    c.last_dc = s;
    b[0] = (int16_t)(int)((unsigned)s << Al);
  }

  void decode_dc_refine(int16_t* b) {
    if (get_bits(1)) b[0] = (int16_t)(b[0] | (1 << Al));
  }

  void decode_ac_first(int16_t* b, Component& c) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huff& t = ac[c.ac_tbl];
    for (int k = Ss; k <= Se; k++) {
      int s = decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = get_bits(s);
        b[kNatural[k]] = (int16_t)(int)((unsigned)extend(r, s) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        eobrun--;
        break;
      }
    }
  }

  void refine(int16_t* coef, int p1, int m1) {
    if (*coef != 0 && get_bits(1) && (*coef & p1) == 0)
      *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
  }

  void decode_ac_refine(int16_t* b, Component& c) {
    int p1 = 1 << Al;
    int m1 = (int)((unsigned)-1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      const Huff& t = ac[c.ac_tbl];
      for (; k <= Se; k++) {
        int s = decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t* coef = b + kNatural[k];
          if (*coef != 0) {
            refine(coef, p1, m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= Se);
        if (s) b[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) refine(b + kNatural[k], p1, m1);
      eobrun--;
    }
  }

  void decode_block(int16_t* b, Component& c) {
    if (!progressive) decode_sequential(b, c);
    else if (Ss == 0 && Ah == 0) decode_dc_first(b, c);
    else if (Ss == 0) decode_dc_refine(b);
    else if (Ah == 0) decode_ac_first(b, c);
    else decode_ac_refine(b, c);
  }

  void start_scan() {
    for (int i = 0; i < scan_n; i++) {
      Component& c = *scan[i];
      if (!c.latched) {
        if (!qt_defined[c.tq]) fail();
        memcpy(c.q, qt[c.tq], sizeof c.q);
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      c.last_dc = 0;
    }
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder
      bool dc_band = Ss == 0;
      bool bad = dc_band ? Se != 0 : (Ss > Se || Se > 63 || scan_n != 1);
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail();
      for (int i = 0; i < scan_n; i++) {
        Component& c = *scan[i];
        for (int k = Ss; k <= Se; k++) c.coef_bits[k] = Al;
        if (dc_band) {
          if (Ah == 0) dc[c.dc_tbl].derive(true);
        } else {
          ac[c.ac_tbl].derive(false);
        }
      }
    } else {
      for (int i = 0; i < scan_n; i++) {
        dc[scan[i]->dc_tbl].derive(true);
        ac[scan[i]->ac_tbl].derive(false);
      }
    }
    buf = 0;
    cnt = 0;
    marker = 0;
    insufficient = false;
    eobrun = 0;
    restarts_to_go = restart_interval;
    next_restart = 0;
  }

  void decode_scan() {
    start_scan();
    int mcus_x, mcus_y;
    if (scan_n == 1) {
      mcus_x = scan[0]->wib;
      mcus_y = scan[0]->hib;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) process_restart();
          restarts_to_go--;
        }
        if (insufficient) continue;  // libjpeg leaves the rest of the segment empty
        if (scan_n == 1) {
          decode_block(scan[0]->block(mx, my), *scan[0]);
          continue;
        }
        for (int i = 0; i < scan_n; i++) {
          Component& c = *scan[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++)
              decode_block(c.block(mx * c.h + bx, my * c.v + by), c);
        }
      }
    }
    // resume the marker parser at the marker that ended the entropy-coded
    // data (at the end if the data ran out)
    if (marker)
      pos = marker_end >= 2 && data[marker_end - 2] == 0xFF && data[marker_end - 1] == marker
                ? marker_end - 2
                : size;
  }

  // -- samples (jidctint.c, jdsample.c, jdcolor.c) --

  static uint8_t idct_range(int64_t v) {
    int w = (int)(v & 1023);
    if (w < 128) return (uint8_t)(w + 128);
    if (w < 512) return 255;
    if (w < 896) return 0;
    return (uint8_t)(w - 896);
  }

  // jidctint.c's 1-D pass over s[0..7] (one column of dequantized
  // coefficients, or one row of the first pass's output): the eight outputs
  // scaled by 2^13, before descaling.
  static void idct_1d(const int64_t* s, int64_t* out) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int64_t z1 = (s[2] + s[6]) * F0541;
    int64_t tmp2 = z1 + s[6] * -F1847, tmp3 = z1 + s[2] * F0765;
    int64_t tmp0 = (s[0] + s[4]) * 8192, tmp1 = (s[0] - s[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = s[7];
    tmp1 = s[5];
    tmp2 = s[3];
    tmp3 = s[1];
    z1 = tmp0 + tmp3;
    int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 = z3 * -F1961 + z5;
    z4 = z4 * -F0390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    out[0] = tmp10 + tmp3;
    out[7] = tmp10 - tmp3;
    out[1] = tmp11 + tmp2;
    out[6] = tmp11 - tmp2;
    out[2] = tmp12 + tmp1;
    out[5] = tmp12 - tmp1;
    out[3] = tmp13 + tmp0;
    out[4] = tmp13 - tmp0;
  }

  // jidctint.c jpeg_idct_islow: columns (PASS1_BITS = 2 kept), then rows,
  // each with its shortcut for all-zero AC terms
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
    auto descale = [](int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; };
    int64_t ws[64], s[8], o[8];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        for (int r = 0; r < 8; r++) ws[8 * r + c] = ((int64_t)ip[0] * q[c]) * 4;
        continue;
      }
      for (int k = 0; k < 8; k++) s[k] = (int64_t)ip[8 * k] * q[8 * k + c];
      idct_1d(s, o);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = (int)descale(o[r], 11);
    }
    for (int r = 0; r < 8; r++) {
      const int64_t* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = idct_range(descale(wp[0], 5));
        for (int c = 0; c < 8; c++) op[c] = v;
        continue;
      }
      idct_1d(wp, o);
      for (int c = 0; c < 8; c++) op[c] = idct_range(descale(o[c], 18));
    }
  }

  // A component's samples at the image's size (jdsample.c): fancy
  // (triangle) upsampling for 2:1 horizontally (if wider than 2 samples),
  // 1:2 vertically and 2:2 (if wider than 2); replication for any other
  // integral ratio. Rows and columns past the component's own size repeat
  // its last, as libjpeg's context rows and edge cases do.
  std::vector<uint8_t> upsampled(const Component& c) {
    int pw = c.wib * 8;
    std::vector<uint8_t> plane((size_t)pw * c.hib * 8);
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                   plane.data() + (size_t)by * 8 * pw + bx * 8, pw);
    if (hmax % c.h || vmax % c.v) fail();
    int fh = hmax / c.h, fv = vmax / c.v;
    auto P = [&](int y, int x) -> int {
      if (y < 0) y = 0;
      if (y > c.dh - 1) y = c.dh - 1;
      if (x < 0) x = 0;
      if (x > c.dw - 1) x = c.dw - 1;
      return plane[(size_t)y * pw + x];
    };
    std::vector<uint8_t> out((size_t)width * height);
    for (int y = 0; y < height; y++) {
      uint8_t* o = out.data() + (size_t)y * width;
      if (fh == 1 && fv == 1) {
        for (int x = 0; x < width; x++) o[x] = (uint8_t)P(y, x);
      } else if (fh == 2 && fv == 1 && c.dw > 2) {
        for (int x = 0; x < width; x++) {
          int j = x >> 1;
          o[x] = (uint8_t)((x & 1) ? (3 * P(y, j) + P(y, j + 1) + 2) >> 2
                                   : (3 * P(y, j) + P(y, j - 1) + 1) >> 2);
        }
      } else if (fh == 1 && fv == 2) {
        int i = y >> 1, other = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++) o[x] = (uint8_t)((3 * P(i, x) + P(other, x) + bias) >> 2);
      } else if (fh == 2 && fv == 2 && c.dw > 2) {
        int i = y >> 1, other = (y & 1) ? i + 1 : i - 1;
        for (int x = 0; x < width; x++) {
          int j = x >> 1;
          int here = 3 * P(i, j) + P(other, j);
          o[x] = (uint8_t)((x & 1) ? (3 * here + 3 * P(i, j + 1) + P(other, j + 1) + 7) >> 4
                                   : (3 * here + 3 * P(i, j - 1) + P(other, j - 1) + 8) >> 4);
        }
      } else {
        for (int x = 0; x < width; x++) o[x] = (uint8_t)P(y / fv, x / fh);
      }
    }
    return out;
  }

  void decode_image() {
    // libjpeg's guess of the color space (jdapimin.c default_decompress_parms)
    bool ycc;
    if (ncomp == 1) {
      ycc = false;
    } else if (ncomp == 3) {
      if (saw_jfif) {
        ycc = true;
      } else if (saw_adobe) {
        ycc = adobe_transform != 0;
      } else {
        ycc = !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
      }
    } else {
      fail();  // no conversion from 2 or 4 components to RGB
    }
    if (!progressive) {
      // jdhuff.c jinit_huff_decoder: the standard tables fill empty slots
      if (!dc[0].defined) dc[0].set(kDcLumBits, kDcVals, 12);
      if (!dc[1].defined) dc[1].set(kDcChromBits, kDcVals, 12);
      if (!ac[0].defined) ac[0].set(kAcLumBits, kAcLumVals, 162);
      if (!ac[1].defined) ac[1].set(kAcChromBits, kAcChromVals, 162);
    }
    for (;;) {
      decode_scan();
      bool more = read_markers();
      if (!more) break;
      if (!multiple_scans) fail();  // JERR_EOI_EXPECTED
    }
    if (progressive) {
      // jdcoefct.c smoothing_ok: libjpeg would smooth blocks whose first
      // coefficients a truncated or partial progression left unknown
      bool useful = false, ok = true;
      for (int i = 0; i < ncomp; i++) {
        const Component& c = comp[i];
        if (!c.latched || c.coef_bits[0] < 0) ok = false;
        for (int k = 0; k < 10 && c.latched; k++)
          if (c.q[kNatural[k]] == 0) ok = false;
        for (int k = 1; k < 10; k++)
          if (c.coef_bits[k] != 0) useful = true;
      }
      if (ok && useful) fail();
    }
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < ncomp; i++) {
      // a component no scan carried has no coefficients: mid-gray, as with libjpeg
      if (comp[i].coef.empty()) comp[i].coef.assign((size_t)comp[i].bw * comp[i].bh * 64, 0);
      planes[i] = upsampled(comp[i]);
    }
    size_t n = (size_t)width * height;
    rgb.resize(n * 3);
    if (ncomp == 1) {
      for (size_t p = 0; p < n; p++) rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = planes[0][p];
      return;
    }
    if (!ycc) {
      for (size_t p = 0; p < n; p++)
        for (int k = 0; k < 3; k++) rgb[3 * p + k] = planes[k][p];
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SB = 16;
    const int64_t half = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (double)(1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t p = 0; p < n; p++) {
      int y = planes[0][p], cb = planes[1][p], cr = planes[2][p];
      rgb[3 * p] = clamp(y + cr_r[cr]);
      rgb[3 * p + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
      rgb[3 * p + 2] = clamp(y + cb_b[cb]);
    }
  }
};

Decoder* state(j_decompress_ptr cinfo) { return static_cast<Decoder*>(cinfo->decoder); }

// Count the failure, then leave through the caller's error_exit.
void raise_error(j_decompress_ptr cinfo) {
  tl_failures++;
  cinfo->err->error_exit((j_common_ptr)cinfo);
}

}  // namespace

extern "C" {

struct jpeg_error_mgr* jpeg_std_error(struct jpeg_error_mgr* err) {
  err->error_exit = nullptr;
  return err;
}

void jpeg_create_decompress(j_decompress_ptr cinfo) {
  cinfo->decoder = new (std::nothrow) Decoder();
  cinfo->output_width = cinfo->output_height = cinfo->output_scanline = 0;
}

void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* buf, size_t size) {
  if (Decoder* d = state(cinfo)) {
    d->data = buf;
    d->size = size;
  }
}

int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image) {
  (void)require_image;
  bool ok = false;
  if (Decoder* d = state(cinfo)) {
    try {
      d->read_header();
      ok = true;
    } catch (...) {
    }
  }
  if (!ok) raise_error(cinfo);
  cinfo->out_color_space = JCS_RGB;
  return 1;  // JPEG_HEADER_OK
}

boolean jpeg_start_decompress(j_decompress_ptr cinfo) {
  bool ok = false;
  Decoder* d = state(cinfo);
  if (d && cinfo->out_color_space == JCS_RGB) {
    try {
      d->decode_image();
      ok = true;
    } catch (...) {
    }
  }
  if (!ok) raise_error(cinfo);
  cinfo->output_width = (JDIMENSION)d->width;
  cinfo->output_height = (JDIMENSION)d->height;
  cinfo->output_scanline = 0;
  return TRUE;
}

JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY rows, JDIMENSION n) {
  Decoder* d = state(cinfo);
  JDIMENSION done = 0;
  while (done < n && cinfo->output_scanline < cinfo->output_height) {
    memcpy(rows[done], d->rgb.data() + (size_t)cinfo->output_scanline * d->width * 3,
           (size_t)d->width * 3);
    cinfo->output_scanline++;
    done++;
  }
  return done;
}

boolean jpeg_finish_decompress(j_decompress_ptr cinfo) {
  (void)cinfo;
  return TRUE;
}

void jpeg_destroy_decompress(j_decompress_ptr cinfo) {
  delete state(cinfo);
  cinfo->decoder = nullptr;
}

int mmpdf_jpeg_failures(void) { return tl_failures; }

// A whole JPEG in memory -> malloc'd RGB rows (*out, *w x *h x 3), the
// pixels jpeg_read_scanlines gives. 0 on success; 1 where the stream does
// not decode (nothing is allocated then). Free *out with mmjpeg_free.
int mmjpeg_decode_rgb(const unsigned char* buf, size_t size, unsigned char** out, int* w,
                      int* h) {
  *out = nullptr;
  *w = *h = 0;
  Decoder d;
  d.data = buf;
  d.size = size;
  try {
    d.read_header();
    d.decode_image();
  } catch (...) {
    return 1;
  }
  size_t n = d.rgb.size();
  unsigned char* rgb = static_cast<unsigned char*>(malloc(n ? n : 1));
  if (!rgb) return 1;
  memcpy(rgb, d.rgb.data(), n);
  *out = rgb;
  *w = d.width;
  *h = d.height;
  return 0;
}

}  // extern "C"
