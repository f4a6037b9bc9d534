// mmpdf: minimal host-side PDF parser/rasterizer/text-extractor.
//
// TPU-native replacement for the reference's poppler (pdf2image
// convert_from_path, reference functions.py:678-713) and pypdfium2
// (Docling's parse backend, reference functions.py:22). The ingestion hot
// path needs: page count, page raster at a DPI scale (feeding the device
// preprocessing/patchify pipeline), and the text layer (feeding the chunker
// and the check_ocr "does this page have text?" probe, reference
// functions.py:133-148).
//
// Scope (documented, tested): classic xref tables and xref streams, object
// streams, FlateDecode (zlib) and DCTDecode (libjpeg) filters, page tree
// with inheritance, content-stream interpreter for text (BT/ET, Tf, Td, TD,
// Tm, T*, TL, Tj, TJ, ', ") and graphics (q/Q, cm, re+f fills, Do image
// XObjects), DeviceRGB/DeviceGray 8-bit images, text rendered with a
// built-in 8x13 bitmap font (layout-faithful, not glyph-faithful).
// Encrypted PDFs and embedded vector fonts are out of scope; they degrade
// gracefully (raster still shows images/boxes, text extraction may be empty).
//
// C API at the bottom; Python binds with ctypes (ingest/rasterize.py).

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>
#include <algorithm>
#include <array>
#include <functional>

#include <zlib.h>

extern "C" {
#include <jpeglib.h>
#include <setjmp.h>
}

namespace mmpdf {

// ---------------------------------------------------------------------------
// Object model
// ---------------------------------------------------------------------------

struct Obj;
using ObjPtr = std::shared_ptr<Obj>;

struct Obj {
  enum Kind { Null, Bool, Num, Str, Name, Arr, Dict, Stream, Ref } kind = Null;
  bool b = false;
  double num = 0;
  std::string str;                     // Str / Name payload
  std::vector<ObjPtr> arr;
  std::map<std::string, ObjPtr> dict;  // Dict / Stream
  size_t stream_start = 0;             // offset of raw stream bytes in file
  bool slash = false;                  // Name came from a /slash (operand, not operator)
  int ref_num = 0, ref_gen = 0;

  bool is(Kind k) const { return kind == k; }
  double as_num(double d = 0) const { return kind == Num ? num : d; }
};

static ObjPtr mk(Obj::Kind k) { auto o = std::make_shared<Obj>(); o->kind = k; return o; }

// ---------------------------------------------------------------------------
// Lexer / parser
// ---------------------------------------------------------------------------

struct Lexer {
  const uint8_t* d;
  size_t n, p = 0;
  Lexer(const uint8_t* data, size_t len, size_t pos = 0) : d(data), n(len), p(pos) {}

  static bool is_ws(int c) { return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\f' || c == 0; }
  static bool is_delim(int c) { return strchr("()<>[]{}/%", c) != nullptr; }

  void skip_ws() {
    while (p < n) {
      if (is_ws(d[p])) { p++; }
      else if (d[p] == '%') { while (p < n && d[p] != '\n' && d[p] != '\r') p++; }
      else break;
    }
  }

  bool match(const char* kw) {
    skip_ws();
    size_t len = strlen(kw);
    if (p + len <= n && memcmp(d + p, kw, len) == 0) { p += len; return true; }
    return false;
  }

  std::string token() {
    skip_ws();
    if (p >= n) return "";
    size_t s = p;
    if (is_delim(d[p])) {
      if (d[p] == '<' && p + 1 < n && d[p + 1] == '<') { p += 2; return "<<"; }
      if (d[p] == '>' && p + 1 < n && d[p + 1] == '>') { p += 2; return ">>"; }
      p++;
      return std::string(1, (char)d[s]);
    }
    while (p < n && !is_ws(d[p]) && !is_delim(d[p])) p++;
    return std::string((const char*)d + s, p - s);
  }
};

struct Parser {
  Lexer lx;
  explicit Parser(Lexer l) : lx(l) {}

  ObjPtr parse() {
    lx.skip_ws();
    if (lx.p >= lx.n) return mk(Obj::Null);
    uint8_t c = lx.d[lx.p];
    if (c == '/') return parse_name();
    if (c == '(') return parse_lit_string();
    if (c == '<') {
      if (lx.p + 1 < lx.n && lx.d[lx.p + 1] == '<') return parse_dict_or_stream();
      return parse_hex_string();
    }
    if (c == '[') return parse_array();
    std::string t = lx.token();
    if (t == "true") { auto o = mk(Obj::Bool); o->b = true; return o; }
    if (t == "false") { auto o = mk(Obj::Bool); o->b = false; return o; }
    if (t == "null") return mk(Obj::Null);
    if (!t.empty() && (isdigit((uint8_t)t[0]) || t[0] == '-' || t[0] == '+' || t[0] == '.')) {
      if (isdigit((uint8_t)t[0])) {  // reference lookahead: "num gen R"
        size_t save = lx.p;
        std::string t2 = lx.token();
        std::string t3 = lx.token();
        if (t3 == "R" && !t2.empty() && isdigit((uint8_t)t2[0])) {
          auto o = mk(Obj::Ref);
          o->ref_num = atoi(t.c_str());
          o->ref_gen = atoi(t2.c_str());
          return o;
        }
        lx.p = save;
      }
      auto o = mk(Obj::Num);
      o->num = atof(t.c_str());
      return o;
    }
    auto o = mk(Obj::Name);  // bare keyword/operator; caller decides
    o->str = t;
    return o;
  }

  ObjPtr parse_name() {
    lx.p++;
    std::string s;
    while (lx.p < lx.n && !Lexer::is_ws(lx.d[lx.p]) && !Lexer::is_delim(lx.d[lx.p])) {
      char ch = (char)lx.d[lx.p++];
      if (ch == '#' && lx.p + 1 < lx.n && isxdigit(lx.d[lx.p]) && isxdigit(lx.d[lx.p + 1])) {
        auto hex = [](int c) { return c <= '9' ? c - '0' : (tolower(c) - 'a' + 10); };
        ch = (char)(hex(lx.d[lx.p]) * 16 + hex(lx.d[lx.p + 1]));
        lx.p += 2;
      }
      s += ch;
    }
    auto o = mk(Obj::Name);
    o->str = s;
    o->slash = true;
    return o;
  }

  ObjPtr parse_lit_string() {
    lx.p++;
    std::string s;
    int depth = 1;
    while (lx.p < lx.n && depth > 0) {
      char ch = (char)lx.d[lx.p++];
      if (ch == '\\' && lx.p < lx.n) {
        char e = (char)lx.d[lx.p++];
        switch (e) {
          case 'n': s += '\n'; break;
          case 'r': s += '\r'; break;
          case 't': s += '\t'; break;
          case 'b': s += '\b'; break;
          case 'f': s += '\f'; break;
          case '\n': break;
          case '\r': if (lx.p < lx.n && lx.d[lx.p] == '\n') lx.p++; break;
          default:
            if (e >= '0' && e <= '7') {
              int v = e - '0';
              for (int k = 0; k < 2 && lx.p < lx.n && lx.d[lx.p] >= '0' && lx.d[lx.p] <= '7'; k++)
                v = v * 8 + (lx.d[lx.p++] - '0');
              s += (char)v;
            } else s += e;
        }
      } else if (ch == '(') { depth++; s += ch; }
      else if (ch == ')') { if (--depth > 0) s += ch; }
      else s += ch;
    }
    auto o = mk(Obj::Str);
    o->str = s;
    return o;
  }

  ObjPtr parse_hex_string() {
    lx.p++;
    std::string s;
    int hi = -1;
    while (lx.p < lx.n && lx.d[lx.p] != '>') {
      int c = lx.d[lx.p++];
      int v;
      if (isdigit(c)) v = c - '0';
      else if (isxdigit(c)) v = tolower(c) - 'a' + 10;
      else continue;
      if (hi < 0) hi = v;
      else { s += (char)(hi * 16 + v); hi = -1; }
    }
    if (hi >= 0) s += (char)(hi * 16);
    if (lx.p < lx.n) lx.p++;
    auto o = mk(Obj::Str);
    o->str = s;
    return o;
  }

  ObjPtr parse_array() {
    lx.p++;
    auto o = mk(Obj::Arr);
    while (true) {
      lx.skip_ws();
      if (lx.p >= lx.n || lx.d[lx.p] == ']') { if (lx.p < lx.n) lx.p++; break; }
      o->arr.push_back(parse());
    }
    return o;
  }

  ObjPtr parse_dict_or_stream() {
    lx.p += 2;
    auto o = mk(Obj::Dict);
    while (true) {
      lx.skip_ws();
      if (lx.p + 1 < lx.n && lx.d[lx.p] == '>' && lx.d[lx.p + 1] == '>') { lx.p += 2; break; }
      if (lx.p >= lx.n) break;
      ObjPtr key = parse();
      if (!key->is(Obj::Name)) break;
      o->dict[key->str] = parse();
    }
    size_t save = lx.p;
    if (lx.match("stream")) {
      if (lx.p < lx.n && lx.d[lx.p] == '\r') lx.p++;
      if (lx.p < lx.n && lx.d[lx.p] == '\n') lx.p++;
      o->kind = Obj::Stream;
      o->stream_start = lx.p;
    } else {
      lx.p = save;
    }
    return o;
  }
};

// ---------------------------------------------------------------------------
// Filters
// ---------------------------------------------------------------------------

static bool flate_decode(const std::string& in, std::string& out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = (Bytef*)in.data();
  zs.avail_in = (uInt)in.size();
  char buf[1 << 15];
  int rc;
  do {
    zs.next_out = (Bytef*)buf;
    zs.avail_out = sizeof(buf);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) { inflateEnd(&zs); return rc == Z_BUF_ERROR && zs.avail_in == 0; }
    out.append(buf, sizeof(buf) - zs.avail_out);
  } while (rc != Z_STREAM_END && zs.avail_in > 0);
  inflateEnd(&zs);
  return true;
}

// PNG predictors (used by xref streams and some images).
static void png_unpredict(std::string& data, int columns, int colors) {
  int bpp = colors;
  int rowlen = columns * colors;
  std::string out;
  out.reserve(data.size());
  std::vector<uint8_t> prev(rowlen, 0);
  size_t pos = 0;
  while (pos + 1 + rowlen <= data.size() + 1 && pos < data.size()) {
    int ft = (uint8_t)data[pos++];
    int avail = (int)std::min((size_t)rowlen, data.size() - pos);
    std::vector<uint8_t> row((uint8_t*)data.data() + pos, (uint8_t*)data.data() + pos + avail);
    row.resize(rowlen, 0);
    pos += avail;
    for (int i = 0; i < rowlen; i++) {
      int a = i >= bpp ? row[i - bpp] : 0;
      int b = prev[i];
      int c = i >= bpp ? prev[i - bpp] : 0;
      switch (ft) {
        case 0: break;
        case 1: row[i] = (uint8_t)(row[i] + a); break;
        case 2: row[i] = (uint8_t)(row[i] + b); break;
        case 3: row[i] = (uint8_t)(row[i] + (a + b) / 2); break;
        case 4: {
          int pp = a + b - c, pa = abs(pp - a), pb = abs(pp - b), pc = abs(pp - c);
          row[i] = (uint8_t)(row[i] + (pa <= pb && pa <= pc ? a : (pb <= pc ? b : c)));
          break;
        }
      }
    }
    out.append((char*)row.data(), rowlen);
    prev = row;
  }
  data = out;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};
static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

// DCTDecode -> RGB8 (or Gray8 expanded to RGB by caller).
static bool jpeg_decode(const std::string& in, std::vector<uint8_t>& rgb,
                        int& w, int& h, int& channels) {
  jpeg_decompress_struct cinfo{};
  JpegErr jerr{};
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) { jpeg_destroy_decompress(&cinfo); return false; }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (const unsigned char*)in.data(), in.size());
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  channels = 3;
  rgb.resize((size_t)w * h * 3);
  while ((int)cinfo.output_scanline < h) {
    uint8_t* row = rgb.data() + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// Document: xref, object resolution
// ---------------------------------------------------------------------------

struct Document {
  std::vector<uint8_t> data;
  // obj num -> (offset, in_objstm?, objstm_num, idx)
  struct XEntry { size_t off = 0; bool in_stm = false; int stm_num = 0; int idx = 0; };
  std::map<int, XEntry> xref;
  ObjPtr trailer;
  std::map<int, ObjPtr> cache;
  std::vector<ObjPtr> pages;
  std::string error;
  // per-/Font decoded FontRes (see get_font; void to keep Document above
  // the font machinery in the file)
  std::map<Obj*, std::shared_ptr<void>> font_cache;

  ObjPtr resolve(const ObjPtr& o) {
    if (!o) return mk(Obj::Null);
    if (o->is(Obj::Ref)) return get(o->ref_num);
    return o;
  }

  ObjPtr dget(const ObjPtr& d, const std::string& k) {
    if (!d || (!d->is(Obj::Dict) && !d->is(Obj::Stream))) return mk(Obj::Null);
    auto it = d->dict.find(k);
    if (it == d->dict.end()) return mk(Obj::Null);
    return resolve(it->second);
  }

  std::string stream_bytes(const ObjPtr& s) {
    if (!s || !s->is(Obj::Stream)) return "";
    size_t len = (size_t)dget(s, "Length")->as_num(0);
    if (s->stream_start + len > data.size()) len = data.size() - s->stream_start;
    std::string raw((const char*)data.data() + s->stream_start, len);
    // filter chain
    std::vector<std::string> filters;
    ObjPtr f = dget(s, "Filter");
    if (f->is(Obj::Name)) filters.push_back(f->str);
    else if (f->is(Obj::Arr)) for (auto& x : f->arr) { auto r = resolve(x); if (r->is(Obj::Name)) filters.push_back(r->str); }
    for (auto& name : filters) {
      if (name == "FlateDecode" || name == "Fl") {
        std::string out;
        if (!flate_decode(raw, out)) return "";
        raw = out;
        ObjPtr dp = dget(s, "DecodeParms");
        if (dp->is(Obj::Dict)) {
          int pred = (int)dget(dp, "Predictor")->as_num(1);
          if (pred >= 10) {
            int cols = (int)dget(dp, "Columns")->as_num(1);
            int colors = (int)dget(dp, "Colors")->as_num(1);
            png_unpredict(raw, cols, colors);
          }
        }
      } else if (name == "DCTDecode" || name == "DCT") {
        // leave encoded; image drawing decodes it
        break;
      } else if (name == "ASCIIHexDecode" || name == "AHx") {
        std::string out;
        int hi = -1;
        for (char ch : raw) {
          int v;
          if (isdigit((uint8_t)ch)) v = ch - '0';
          else if (isxdigit((uint8_t)ch)) v = tolower(ch) - 'a' + 10;
          else if (ch == '>') break;
          else continue;
          if (hi < 0) hi = v; else { out += (char)(hi * 16 + v); hi = -1; }
        }
        raw = out;
      } else {
        return "";  // unsupported filter
      }
    }
    return raw;
  }

  ObjPtr get(int num) {
    auto c = cache.find(num);
    if (c != cache.end()) return c->second;
    auto it = xref.find(num);
    if (it == xref.end()) return mk(Obj::Null);
    ObjPtr result = mk(Obj::Null);
    if (!it->second.in_stm) {
      Lexer lx(data.data(), data.size(), it->second.off);
      lx.token();  // obj number
      lx.token();  // gen
      lx.token();  // "obj"
      Parser ps(lx);
      result = ps.parse();
    } else {
      ObjPtr stm = get(it->second.stm_num);
      if (stm->is(Obj::Stream)) {
        std::string bytes = stream_bytes(stm);
        int n = (int)dget(stm, "N")->as_num(0);
        int first = (int)dget(stm, "First")->as_num(0);
        Lexer hl((const uint8_t*)bytes.data(), bytes.size());
        std::vector<std::pair<int, int>> offsets;
        for (int i = 0; i < n; i++) {
          int onum = atoi(hl.token().c_str());
          int ooff = atoi(hl.token().c_str());
          offsets.push_back({onum, ooff});
        }
        for (int i = 0; i < n; i++) {
          if (offsets[i].first == num) {
            Lexer ol((const uint8_t*)bytes.data(), bytes.size(), first + offsets[i].second);
            Parser ps(ol);
            result = ps.parse();
            break;
          }
        }
      }
    }
    cache[num] = result;
    return result;
  }

  bool load(const uint8_t* bytes, size_t len) {
    data.assign(bytes, bytes + len);
    // find startxref
    size_t tail = len > 2048 ? len - 2048 : 0;
    std::string t((const char*)data.data() + tail, len - tail);
    size_t sx = t.rfind("startxref");
    if (sx == std::string::npos) { error = "no startxref"; return false; }
    long off = atol(t.c_str() + sx + 9);
    std::vector<long> seen;
    while (off > 0 && (size_t)off < len) {
      if (std::find(seen.begin(), seen.end(), off) != seen.end()) break;
      seen.push_back(off);
      off = load_xref_section((size_t)off);
    }
    if (!trailer) { error = "no trailer"; return false; }
    ObjPtr root = dget(trailer, "Root");
    ObjPtr page_tree = dget(root, "Pages");
    collect_pages(page_tree, 0);
    return !pages.empty();
  }

  // returns /Prev offset or 0
  long load_xref_section(size_t off) {
    Lexer lx(data.data(), data.size(), off);
    if (lx.match("xref")) {
      // classic table
      while (true) {
        lx.skip_ws();
        if (lx.match("trailer")) {
          Parser ps(lx);
          ObjPtr tr = ps.parse();
          if (!trailer) trailer = tr;
          else for (auto& kv : tr->dict) if (!trailer->dict.count(kv.first)) trailer->dict[kv.first] = kv.second;
          ObjPtr prev = dget(tr, "Prev");
          // handle hybrid /XRefStm
          ObjPtr xstm = dget(tr, "XRefStm");
          if (xstm->is(Obj::Num)) load_xref_section((size_t)xstm->num);
          return prev->is(Obj::Num) ? (long)prev->num : 0;
        }
        std::string a = lx.token(), b = lx.token();
        if (a.empty()) return 0;
        int start = atoi(a.c_str()), count = atoi(b.c_str());
        for (int i = 0; i < count; i++) {
          std::string o = lx.token(), g = lx.token(), ty = lx.token();
          (void)g;
          if (ty == "n" && !xref.count(start + i)) {
            XEntry e;
            e.off = (size_t)atol(o.c_str());
            xref[start + i] = e;
          }
        }
      }
    }
    // xref stream
    Lexer lx2(data.data(), data.size(), off);
    lx2.token(); lx2.token(); lx2.token();  // num gen obj
    Parser ps(lx2);
    ObjPtr s = ps.parse();
    if (!s->is(Obj::Stream)) return 0;
    if (!trailer) trailer = s;
    else for (auto& kv : s->dict) if (!trailer->dict.count(kv.first)) trailer->dict[kv.first] = kv.second;
    std::string bytes = stream_bytes(s);
    ObjPtr wobj = dget(s, "W");
    if (!wobj->is(Obj::Arr) || wobj->arr.size() < 3) return 0;
    int w0 = (int)resolve(wobj->arr[0])->as_num(0);
    int w1 = (int)resolve(wobj->arr[1])->as_num(0);
    int w2 = (int)resolve(wobj->arr[2])->as_num(0);
    int rowlen = w0 + w1 + w2;
    std::vector<std::pair<int, int>> sections;  // (start, count)
    ObjPtr idx = dget(s, "Index");
    if (idx->is(Obj::Arr)) {
      for (size_t i = 0; i + 1 < idx->arr.size(); i += 2)
        sections.push_back({(int)resolve(idx->arr[i])->as_num(0), (int)resolve(idx->arr[i + 1])->as_num(0)});
    } else {
      sections.push_back({0, (int)dget(s, "Size")->as_num(0)});
    }
    auto read_field = [&](const uint8_t* p, int w, long dflt) -> long {
      if (w == 0) return dflt;
      long v = 0;
      for (int i = 0; i < w; i++) v = (v << 8) | p[i];
      return v;
    };
    size_t pos = 0;
    for (auto& sec : sections) {
      for (int i = 0; i < sec.second && pos + rowlen <= bytes.size(); i++, pos += rowlen) {
        const uint8_t* p = (const uint8_t*)bytes.data() + pos;
        long type = read_field(p, w0, 1);
        long f2 = read_field(p + w0, w1, 0);
        long f3 = read_field(p + w0 + w1, w2, 0);
        int num = sec.first + i;
        if (xref.count(num)) continue;
        if (type == 1) { XEntry e; e.off = (size_t)f2; xref[num] = e; }
        else if (type == 2) { XEntry e; e.in_stm = true; e.stm_num = (int)f2; e.idx = (int)f3; xref[num] = e; }
      }
    }
    ObjPtr prev = dget(s, "Prev");
    return prev->is(Obj::Num) ? (long)prev->num : 0;
  }

  void collect_pages(const ObjPtr& node, int depth) {
    if (!node || depth > 64) return;
    ObjPtr type = dget(node, "Type");
    if (type->is(Obj::Name) && type->str == "Pages") {
      ObjPtr kids = dget(node, "Kids");
      if (kids->is(Obj::Arr))
        for (auto& k : kids->arr) {
          ObjPtr child = resolve(k);
          // inherit Resources/MediaBox
          for (const char* key : {"Resources", "MediaBox", "Rotate"}) {
            if (!child->dict.count(key) && node->dict.count(key))
              child->dict[key] = node->dict.at(key);
          }
          collect_pages(child, depth + 1);
        }
    } else if (type->is(Obj::Name) && type->str == "Page") {
      pages.push_back(node);
    }
  }
};

// ---------------------------------------------------------------------------
// Built-in 8x13 bitmap font (ASCII 32..126) - coarse, layout-faithful glyphs.
// Each glyph: 13 rows of 8 bits, generated from simple stroke rules.
// ---------------------------------------------------------------------------

struct Font8x13 {
  uint8_t glyphs[95][13];
  Font8x13() {
    memset(glyphs, 0, sizeof(glyphs));
    auto g = [&](char c) -> uint8_t* { return glyphs[c - 32]; };
    auto hline = [&](uint8_t* gl, int row, int x0 = 1, int x1 = 6) {
      for (int x = x0; x <= x1; x++) gl[row] |= (0x80 >> x);
    };
    auto vline = [&](uint8_t* gl, int col, int r0 = 1, int r1 = 11) {
      for (int r = r0; r <= r1; r++) gl[r] |= (0x80 >> col);
    };
    auto px = [&](uint8_t* gl, int r, int c) { gl[r] |= (0x80 >> c); };
    // Letters: box-ish skeleton forms. Enough for visual layout & OCR-free
    // rasters; exact typography is out of scope.
    for (char c = 'A'; c <= 'Z'; c++) {
      uint8_t* gl = g(c);
      switch (c) {
        case 'A': vline(gl,1,3,11); vline(gl,6,3,11); hline(gl,2,2,5); hline(gl,6); break;
        case 'B': vline(gl,1); hline(gl,1,1,5); hline(gl,6,1,5); hline(gl,11,1,5); vline(gl,6,2,5); vline(gl,6,7,10); break;
        case 'C': hline(gl,1,2,6); hline(gl,11,2,6); vline(gl,1,2,10); break;
        case 'D': vline(gl,1); hline(gl,1,1,5); hline(gl,11,1,5); vline(gl,6,2,10); break;
        case 'E': vline(gl,1); hline(gl,1); hline(gl,6,1,4); hline(gl,11); break;
        case 'F': vline(gl,1); hline(gl,1); hline(gl,6,1,4); break;
        case 'G': hline(gl,1,2,6); vline(gl,1,2,10); hline(gl,11,2,6); vline(gl,6,7,10); hline(gl,7,4,6); break;
        case 'H': vline(gl,1); vline(gl,6); hline(gl,6); break;
        case 'I': hline(gl,1); hline(gl,11); vline(gl,4,2,10); break;
        case 'J': hline(gl,1); vline(gl,5,1,10); px(gl,11,2); px(gl,11,3); px(gl,11,4); px(gl,10,1); break;
        case 'K': vline(gl,1); px(gl,6,2); px(gl,5,3); px(gl,4,4); px(gl,3,5); px(gl,2,6); px(gl,7,3); px(gl,8,4); px(gl,9,5); px(gl,10,6); px(gl,11,6); break;
        case 'L': vline(gl,1); hline(gl,11); break;
        case 'M': vline(gl,1); vline(gl,7); px(gl,2,2); px(gl,3,3); px(gl,3,5); px(gl,2,6); px(gl,4,4); break;
        case 'N': vline(gl,1); vline(gl,6); px(gl,3,2); px(gl,5,3); px(gl,7,4); px(gl,9,5); break;
        case 'O': vline(gl,1,2,10); vline(gl,6,2,10); hline(gl,1,2,5); hline(gl,11,2,5); break;
        case 'P': vline(gl,1); hline(gl,1,1,5); hline(gl,6,1,5); vline(gl,6,2,5); break;
        case 'Q': vline(gl,1,2,9); vline(gl,6,2,8); hline(gl,1,2,5); hline(gl,10,2,5); px(gl,9,5); px(gl,10,6); px(gl,11,7); break;
        case 'R': vline(gl,1); hline(gl,1,1,5); hline(gl,6,1,5); vline(gl,6,2,5); px(gl,7,4); px(gl,8,5); px(gl,9,5); px(gl,10,6); px(gl,11,6); break;
        case 'S': hline(gl,1,2,6); vline(gl,1,2,5); hline(gl,6,2,5); vline(gl,6,7,10); hline(gl,11,1,5); break;
        case 'T': hline(gl,1,0,7); vline(gl,4,2,11); break;
        case 'U': vline(gl,1,1,10); vline(gl,6,1,10); hline(gl,11,2,5); break;
        case 'V': vline(gl,1,1,7); vline(gl,7,1,7); px(gl,8,2); px(gl,9,3); px(gl,10,4); px(gl,9,5); px(gl,8,6); px(gl,11,4); break;
        case 'W': vline(gl,1); vline(gl,7); px(gl,10,2); px(gl,9,3); px(gl,8,4); px(gl,9,5); px(gl,10,6); px(gl,7,4); break;
        case 'X': px(gl,1,1); px(gl,2,2); px(gl,3,3); px(gl,4,4); px(gl,5,4); px(gl,6,4); px(gl,7,4); px(gl,8,3); px(gl,9,2); px(gl,10,1); px(gl,11,1);
                  px(gl,1,7); px(gl,2,6); px(gl,3,5); px(gl,8,5); px(gl,9,6); px(gl,10,7); px(gl,11,7); break;
        case 'Y': px(gl,1,1); px(gl,2,2); px(gl,3,3); px(gl,1,7); px(gl,2,6); px(gl,3,5); vline(gl,4,4,11); break;
        case 'Z': hline(gl,1); hline(gl,11); px(gl,9,2); px(gl,7,3); px(gl,5,4); px(gl,3,5); px(gl,2,6); break;
      }
    }
    // Lowercase: distinct x-height forms (rows 4..11), ascenders reach row 1,
    // descenders row 12 - so OCR over the shared atlas is case-exact.
    { uint8_t* gl = g('a'); hline(gl,4,2,5); vline(gl,6,5,10); hline(gl,7,2,5); vline(gl,1,8,10); hline(gl,11,2,6); }
    { uint8_t* gl = g('b'); vline(gl,1,1,11); hline(gl,4,2,5); vline(gl,6,5,10); hline(gl,11,2,5); }
    { uint8_t* gl = g('c'); hline(gl,4,2,6); vline(gl,1,5,10); hline(gl,11,2,6); }
    { uint8_t* gl = g('d'); vline(gl,6,1,11); hline(gl,4,2,5); vline(gl,1,5,10); hline(gl,11,2,5); }
    { uint8_t* gl = g('e'); hline(gl,4,2,5); vline(gl,1,5,10); vline(gl,6,5,7); hline(gl,7,2,5); hline(gl,11,2,6); }
    { uint8_t* gl = g('f'); hline(gl,1,4,6); vline(gl,3,2,11); hline(gl,6,1,5); }
    { uint8_t* gl = g('g'); hline(gl,4,2,5); vline(gl,1,5,9); hline(gl,10,2,5); vline(gl,6,4,11); hline(gl,12,2,5); }
    { uint8_t* gl = g('h'); vline(gl,1,1,11); hline(gl,4,2,5); vline(gl,6,5,11); }
    { uint8_t* gl = g('i'); px(gl,2,3); vline(gl,3,5,11); }
    { uint8_t* gl = g('j'); px(gl,2,4); vline(gl,4,5,12); px(gl,12,2); px(gl,12,3); }
    { uint8_t* gl = g('k'); vline(gl,1,1,11); px(gl,5,5); px(gl,6,4); px(gl,7,2); px(gl,7,3); px(gl,8,4); px(gl,9,5); px(gl,10,6); px(gl,11,6); }
    { uint8_t* gl = g('l'); vline(gl,3,1,10); px(gl,11,4); }
    { uint8_t* gl = g('m'); hline(gl,4,2,6); vline(gl,1,4,11); vline(gl,4,5,11); vline(gl,7,5,11); }
    { uint8_t* gl = g('n'); hline(gl,4,2,5); vline(gl,1,4,11); vline(gl,6,5,11); }
    { uint8_t* gl = g('o'); hline(gl,4,2,5); hline(gl,11,2,5); vline(gl,1,5,10); vline(gl,6,5,10); }
    { uint8_t* gl = g('p'); hline(gl,4,2,5); vline(gl,1,4,12); vline(gl,6,5,9); hline(gl,10,2,5); }
    { uint8_t* gl = g('q'); hline(gl,4,2,5); vline(gl,6,4,12); vline(gl,1,5,9); hline(gl,10,2,5); }
    { uint8_t* gl = g('r'); vline(gl,1,4,11); px(gl,5,2); hline(gl,4,3,5); px(gl,5,6); }
    { uint8_t* gl = g('s'); hline(gl,4,2,6); vline(gl,1,5,6); hline(gl,7,2,5); vline(gl,6,8,10); hline(gl,11,1,5); }
    { uint8_t* gl = g('t'); vline(gl,3,1,10); hline(gl,4,1,6); px(gl,11,4); px(gl,11,5); }
    { uint8_t* gl = g('u'); vline(gl,1,4,10); vline(gl,6,4,10); hline(gl,11,2,5); }
    { uint8_t* gl = g('v'); vline(gl,1,4,8); vline(gl,6,4,8); px(gl,9,2); px(gl,9,5); px(gl,10,3); px(gl,10,4); px(gl,11,3); }
    { uint8_t* gl = g('w'); vline(gl,1,4,10); vline(gl,4,6,10); vline(gl,7,4,10); hline(gl,11,2,3); hline(gl,11,5,6); }
    { uint8_t* gl = g('x'); px(gl,4,1); px(gl,5,2); px(gl,6,3); px(gl,7,3); px(gl,8,4); px(gl,9,4); px(gl,10,5); px(gl,11,6);
                            px(gl,4,6); px(gl,5,5); px(gl,6,4); px(gl,8,3); px(gl,9,3); px(gl,10,2); px(gl,11,1); }
    { uint8_t* gl = g('y'); vline(gl,1,4,9); hline(gl,10,2,5); vline(gl,6,4,11); hline(gl,12,2,5); }
    { uint8_t* gl = g('z'); hline(gl,4,1,6); px(gl,5,5); px(gl,6,4); px(gl,7,4); px(gl,8,3); px(gl,9,3); px(gl,10,2); hline(gl,11,1,6); }
    // Digits: each shape distinct (previously one shared rounded box).
    { uint8_t* gl = g('0'); vline(gl,1,3,9); vline(gl,6,3,9); hline(gl,2,2,5); hline(gl,10,2,5); }
    { uint8_t* gl = g('1'); vline(gl,4,2,10); px(gl,3,3); hline(gl,11,2,6); }
    { uint8_t* gl = g('2'); hline(gl,2,2,5); px(gl,3,1); vline(gl,6,3,5); px(gl,6,5); px(gl,7,4); px(gl,8,3); px(gl,9,2); px(gl,10,1); hline(gl,11,1,6); }
    { uint8_t* gl = g('3'); hline(gl,2,1,5); vline(gl,6,3,5); hline(gl,6,3,5); vline(gl,6,7,9); hline(gl,10,1,5); }
    { uint8_t* gl = g('4'); vline(gl,1,2,7); hline(gl,8,1,7); vline(gl,5,2,11); }
    { uint8_t* gl = g('5'); hline(gl,2,1,6); vline(gl,1,2,5); hline(gl,6,1,5); vline(gl,6,7,9); hline(gl,10,1,5); }
    { uint8_t* gl = g('6'); hline(gl,2,2,6); vline(gl,1,3,9); hline(gl,6,2,5); vline(gl,6,7,9); hline(gl,10,2,5); }
    { uint8_t* gl = g('7'); hline(gl,2); px(gl,4,6); px(gl,6,5); px(gl,8,4); px(gl,10,3); }
    { uint8_t* gl = g('8'); hline(gl,2,2,5); vline(gl,1,3,5); vline(gl,6,3,5); hline(gl,6,2,5); vline(gl,1,7,9); vline(gl,6,7,9); hline(gl,10,2,5); }
    { uint8_t* gl = g('9'); hline(gl,2,2,5); vline(gl,1,3,5); vline(gl,6,3,9); hline(gl,6,2,5); hline(gl,10,1,5); }
    { uint8_t* gl = g('.'); px(gl,10,3); px(gl,11,3); }
    { uint8_t* gl = g(','); px(gl,10,3); px(gl,11,3); px(gl,12,2); }
    { uint8_t* gl = g('-'); hline(gl,6,2,5); }
    { uint8_t* gl = g('_'); hline(gl,12); }
    { uint8_t* gl = g(':'); px(gl,4,3); px(gl,5,3); px(gl,9,3); px(gl,10,3); }
    { uint8_t* gl = g(';'); px(gl,4,3); px(gl,5,3); px(gl,9,3); px(gl,10,3); px(gl,11,2); }
    { uint8_t* gl = g('('); for (int r=2;r<=10;r++) px(gl,r, r<5?5-(r-2):(r>8?5-(10-r):2)); }
    { uint8_t* gl = g(')'); for (int r=2;r<=10;r++) px(gl,r, r<5?2+(r-2):(r>8?2+(10-r):5)); }
    { uint8_t* gl = g('/'); for (int r=1;r<=11;r++) px(gl,r, 7-(r*6)/11); }
    { uint8_t* gl = g('%'); px(gl,2,1); px(gl,2,2); px(gl,3,1); px(gl,3,2);
      for (int r=2;r<=10;r++) px(gl,r, 7-(r*6)/10);
      px(gl,9,6); px(gl,9,7); px(gl,10,6); px(gl,10,7); }
    { uint8_t* gl = g('?'); hline(gl,1,2,5); px(gl,2,6); px(gl,3,6); px(gl,5,5); px(gl,6,4); px(gl,7,4); px(gl,10,4); px(gl,11,4); }
    { uint8_t* gl = g('!'); vline(gl,4,1,8); px(gl,10,4); px(gl,11,4); }
    { uint8_t* gl = g('\''); px(gl,1,3); px(gl,2,3); }
    { uint8_t* gl = g('"'); px(gl,1,2); px(gl,2,2); px(gl,1,5); px(gl,2,5); }
    { uint8_t* gl = g('+'); hline(gl,6,2,6); vline(gl,4,4,8); }
    { uint8_t* gl = g('='); hline(gl,5,2,6); hline(gl,8,2,6); }
    { uint8_t* gl = g('*'); px(gl,4,4); px(gl,5,2); px(gl,5,6); px(gl,6,3); px(gl,6,5); px(gl,7,4); }
  }
};

static const Font8x13 kFont;

// ---------------------------------------------------------------------------
// Glyph names -> Unicode (Adobe Glyph List subset)
//
// Real-world PDFs address glyphs by NAME in /Encoding /Differences arrays
// (reference corpus: pypdfium decodes these, functions.py:22). This covers
// the ASCII range, the common Latin-1 punctuation/typography names writers
// emit (matplotlib Type3, TeX), f-ligatures, and the uniXXXX / uXXXX[XX]
// conventions. Unknown names return -1 (callers skip them for text and
// fall back to the atlas for raster).
// ---------------------------------------------------------------------------

static int glyph_name_to_unicode(const std::string& n) {
  static const std::map<std::string, int>* kMap = [] {
    auto* m = new std::map<std::string, int>;
    const char* names32[] = {  // ASCII 32..126 in order
      "space", "exclam", "quotedbl", "numbersign", "dollar", "percent",
      "ampersand", "quotesingle", "parenleft", "parenright", "asterisk",
      "plus", "comma", "hyphen", "period", "slash", "zero", "one", "two",
      "three", "four", "five", "six", "seven", "eight", "nine", "colon",
      "semicolon", "less", "equal", "greater", "question", "at",
      "A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L", "M",
      "N", "O", "P", "Q", "R", "S", "T", "U", "V", "W", "X", "Y", "Z",
      "bracketleft", "backslash", "bracketright", "asciicircum",
      "underscore", "grave",
      "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
      "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z",
      "braceleft", "bar", "braceright", "asciitilde"};
    for (int i = 0; i < 95; i++) (*m)[names32[i]] = 32 + i;
    struct NV { const char* n; int v; };
    static const NV extra[] = {
      {"quoteleft", 0x2018}, {"quoteright", 0x2019},
      {"quotedblleft", 0x201C}, {"quotedblright", 0x201D},
      {"quotesinglbase", 0x201A}, {"quotedblbase", 0x201E},
      {"endash", 0x2013}, {"emdash", 0x2014}, {"bullet", 0x2022},
      {"dagger", 0x2020}, {"daggerdbl", 0x2021}, {"ellipsis", 0x2026},
      {"fi", 0xFB01}, {"fl", 0xFB02}, {"ff", 0xFB00}, {"ffi", 0xFB03},
      {"ffl", 0xFB04}, {"degree", 0x00B0}, {"plusminus", 0x00B1},
      {"mu", 0x00B5}, {"multiply", 0x00D7}, {"divide", 0x00F7},
      {"minus", 0x2212}, {"periodcentered", 0x00B7}, {"middot", 0x00B7},
      {"copyright", 0x00A9}, {"registered", 0x00AE}, {"trademark", 0x2122},
      {"section", 0x00A7}, {"paragraph", 0x00B6}, {"cent", 0x00A2},
      {"sterling", 0x00A3}, {"yen", 0x00A5}, {"Euro", 0x20AC},
      {"florin", 0x0192}, {"fraction", 0x2044}, {"percent", 0x0025},
      {"perthousand", 0x2030}, {"guilsinglleft", 0x2039},
      {"guilsinglright", 0x203A}, {"guillemotleft", 0x00AB},
      {"guillemotright", 0x00BB}, {"exclamdown", 0x00A1},
      {"questiondown", 0x00BF}, {"circumflex", 0x02C6}, {"tilde", 0x02DC},
      {"macron", 0x00AF}, {"breve", 0x02D8}, {"dotaccent", 0x02D9},
      {"dieresis", 0x00A8}, {"ring", 0x02DA}, {"cedilla", 0x00B8},
      {"hungarumlaut", 0x02DD}, {"ogonek", 0x02DB}, {"caron", 0x02C7},
      {"Agrave", 0xC0}, {"Aacute", 0xC1}, {"Acircumflex", 0xC2},
      {"Atilde", 0xC3}, {"Adieresis", 0xC4}, {"Aring", 0xC5}, {"AE", 0xC6},
      {"Ccedilla", 0xC7}, {"Egrave", 0xC8}, {"Eacute", 0xC9},
      {"Ecircumflex", 0xCA}, {"Edieresis", 0xCB}, {"Igrave", 0xCC},
      {"Iacute", 0xCD}, {"Icircumflex", 0xCE}, {"Idieresis", 0xCF},
      {"Eth", 0xD0}, {"Ntilde", 0xD1}, {"Ograve", 0xD2}, {"Oacute", 0xD3},
      {"Ocircumflex", 0xD4}, {"Otilde", 0xD5}, {"Odieresis", 0xD6},
      {"Oslash", 0xD8}, {"Ugrave", 0xD9}, {"Uacute", 0xDA},
      {"Ucircumflex", 0xDB}, {"Udieresis", 0xDC}, {"Yacute", 0xDD},
      {"Thorn", 0xDE}, {"germandbls", 0xDF},
      {"agrave", 0xE0}, {"aacute", 0xE1}, {"acircumflex", 0xE2},
      {"atilde", 0xE3}, {"adieresis", 0xE4}, {"aring", 0xE5}, {"ae", 0xE6},
      {"ccedilla", 0xE7}, {"egrave", 0xE8}, {"eacute", 0xE9},
      {"ecircumflex", 0xEA}, {"edieresis", 0xEB}, {"igrave", 0xEC},
      {"iacute", 0xED}, {"icircumflex", 0xEE}, {"idieresis", 0xEF},
      {"eth", 0xF0}, {"ntilde", 0xF1}, {"ograve", 0xF2}, {"oacute", 0xF3},
      {"ocircumflex", 0xF4}, {"otilde", 0xF5}, {"odieresis", 0xF6},
      {"oslash", 0xF8}, {"ugrave", 0xF9}, {"uacute", 0xFA},
      {"ucircumflex", 0xFB}, {"udieresis", 0xFC}, {"yacute", 0xFD},
      {"thorn", 0xFE}, {"ydieresis", 0xFF},
      {"Gamma", 0x0393}, {"Delta", 0x0394}, {"Theta", 0x0398},
      {"Lambda", 0x039B}, {"Xi", 0x039E}, {"Pi", 0x03A0},
      {"Sigma", 0x03A3}, {"Phi", 0x03A6}, {"Psi", 0x03A8},
      {"Omega", 0x03A9}, {"alpha", 0x03B1}, {"beta", 0x03B2},
      {"gamma", 0x03B3}, {"delta", 0x03B4}, {"epsilon", 0x03B5},
      {"lambda", 0x03BB}, {"pi", 0x03C0}, {"sigma", 0x03C3},
      {"tau", 0x03C4}, {"phi", 0x03C6}, {"omega", 0x03C9},
      {"nbspace", 0x00A0}, {"softhyphen", 0x00AD}, {"brokenbar", 0xA6},
      {"currency", 0xA4}, {"onequarter", 0xBC}, {"onehalf", 0xBD},
      {"threequarters", 0xBE}, {"onesuperior", 0xB9},
      {"twosuperior", 0xB2}, {"threesuperior", 0xB3},
      {"ordfeminine", 0xAA}, {"ordmasculine", 0xBA}, {"logicalnot", 0xAC},
      {"Lslash", 0x0141}, {"lslash", 0x0142}, {"OE", 0x0152},
      {"oe", 0x0153}, {"Scaron", 0x0160}, {"scaron", 0x0161},
      {"Ydieresis", 0x0178}, {"Zcaron", 0x017D}, {"zcaron", 0x017E},
      {"dotlessi", 0x0131},
    };
    for (auto& e : extra) (*m)[e.n] = e.v;
    return m;
  }();
  auto it = kMap->find(n);
  if (it != kMap->end()) return it->second;
  // uniXXXX / uXXXX / uXXXXXX hex conventions
  auto hexval = [](const std::string& h) -> long {
    if (h.empty()) return -1;
    for (char c : h) if (!isxdigit((uint8_t)c)) return -1;
    return strtol(h.c_str(), nullptr, 16);
  };
  if (n.size() == 7 && n.compare(0, 3, "uni") == 0) {
    long v = hexval(n.substr(3));
    if (v >= 0) return (int)v;
  }
  if ((n.size() >= 5 && n.size() <= 7) && n[0] == 'u') {
    long v = hexval(n.substr(1));
    if (v >= 0) return (int)v;
  }
  // gXX / cidXX subset names carry no unicode
  return -1;
}

// WinAnsiEncoding high range (128..255) as Unicode; 32..126 is ASCII in
// every standard PDF base encoding. StandardEncoding/MacRomanEncoding
// differ up there but agree on ASCII - papers overwhelmingly either stay
// in ASCII or carry /Differences / /ToUnicode, so WinAnsi is the fallback.
static const uint16_t kWinAnsiHigh[128] = {
  0x20AC, 0, 0x201A, 0x0192, 0x201E, 0x2026, 0x2020, 0x2021,
  0x02C6, 0x2030, 0x0160, 0x2039, 0x0152, 0, 0x017D, 0,
  0, 0x2018, 0x2019, 0x201C, 0x201D, 0x2022, 0x2013, 0x2014,
  0x02DC, 0x2122, 0x0161, 0x203A, 0x0153, 0, 0x017E, 0x0178,
  0x00A0, 0x00A1, 0x00A2, 0x00A3, 0x00A4, 0x00A5, 0x00A6, 0x00A7,
  0x00A8, 0x00A9, 0x00AA, 0x00AB, 0x00AC, 0x00AD, 0x00AE, 0x00AF,
  0x00B0, 0x00B1, 0x00B2, 0x00B3, 0x00B4, 0x00B5, 0x00B6, 0x00B7,
  0x00B8, 0x00B9, 0x00BA, 0x00BB, 0x00BC, 0x00BD, 0x00BE, 0x00BF,
  0x00C0, 0x00C1, 0x00C2, 0x00C3, 0x00C4, 0x00C5, 0x00C6, 0x00C7,
  0x00C8, 0x00C9, 0x00CA, 0x00CB, 0x00CC, 0x00CD, 0x00CE, 0x00CF,
  0x00D0, 0x00D1, 0x00D2, 0x00D3, 0x00D4, 0x00D5, 0x00D6, 0x00D7,
  0x00D8, 0x00D9, 0x00DA, 0x00DB, 0x00DC, 0x00DD, 0x00DE, 0x00DF,
  0x00E0, 0x00E1, 0x00E2, 0x00E3, 0x00E4, 0x00E5, 0x00E6, 0x00E7,
  0x00E8, 0x00E9, 0x00EA, 0x00EB, 0x00EC, 0x00ED, 0x00EE, 0x00EF,
  0x00F0, 0x00F1, 0x00F2, 0x00F3, 0x00F4, 0x00F5, 0x00F6, 0x00F7,
  0x00F8, 0x00F9, 0x00FA, 0x00FB, 0x00FC, 0x00FD, 0x00FE, 0x00FF};

static void utf8_append(std::string& out, int cp) {
  if (cp < 0) return;
  if (cp < 0x80) out += (char)cp;
  else if (cp < 0x800) {
    out += (char)(0xC0 | (cp >> 6));
    out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += (char)(0xE0 | (cp >> 12));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  } else {
    out += (char)(0xF0 | (cp >> 18));
    out += (char)(0x80 | ((cp >> 12) & 0x3F));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  }
}

// ---------------------------------------------------------------------------
// /ToUnicode CMap parsing (bfchar / bfrange)
//
// The authoritative text-decode table subset writers embed (pdfTeX, Word,
// matplotlib fonttype 42 - reference corpus per functions.py:22). The CMap
// is PostScript-ish; the lexer already tokenizes hex strings and names, so
// a light pass over tokens suffices.
// ---------------------------------------------------------------------------

static std::string utf16be_to_utf8(const std::string& s) {
  std::string out;
  for (size_t i = 0; i + 1 < s.size(); i += 2) {
    unsigned cp = ((uint8_t)s[i] << 8) | (uint8_t)s[i + 1];
    if (cp >= 0xD800 && cp < 0xDC00 && i + 3 < s.size()) {
      unsigned lo = ((uint8_t)s[i + 2] << 8) | (uint8_t)s[i + 3];
      if (lo >= 0xDC00 && lo < 0xE000) {
        cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
        i += 2;
      }
    }
    utf8_append(out, (int)cp);
  }
  return out;
}

static long hex_code(const std::string& bytes) {
  long v = 0;
  for (unsigned char c : bytes) v = (v << 8) | c;
  return v;
}

static void parse_tounicode(const std::string& cmap,
                            std::map<long, std::string>& out) {
  Lexer lx((const uint8_t*)cmap.data(), cmap.size());
  Parser ps(lx);
  std::vector<ObjPtr> window;
  auto tok = [&]() -> ObjPtr { return ps.parse(); };
  while (ps.lx.p < ps.lx.n) {
    ObjPtr o = tok();
    if (o->is(Obj::Null) && ps.lx.p >= ps.lx.n) break;
    if (o->is(Obj::Name) && !o->slash && o->str == "beginbfchar") {
      while (ps.lx.p < ps.lx.n) {
        ObjPtr a = tok();
        if (a->is(Obj::Name) && !a->slash && a->str == "endbfchar") break;
        ObjPtr b = tok();
        if (a->is(Obj::Str) && b->is(Obj::Str))
          out[hex_code(a->str)] = utf16be_to_utf8(b->str);
      }
    } else if (o->is(Obj::Name) && !o->slash && o->str == "beginbfrange") {
      while (ps.lx.p < ps.lx.n) {
        ObjPtr a = tok();
        if (a->is(Obj::Name) && !a->slash && a->str == "endbfrange") break;
        ObjPtr b = tok();
        ObjPtr c = tok();
        if (!a->is(Obj::Str) || !b->is(Obj::Str)) continue;
        long lo = hex_code(a->str), hi = hex_code(b->str);
        if (hi - lo > 65535) continue;
        if (c->is(Obj::Str)) {
          std::string base = c->str;  // UTF-16BE, last code unit increments
          for (long k = lo; k <= hi; k++) {
            std::string u = base;
            if (u.size() >= 2) {
              unsigned last = ((uint8_t)u[u.size() - 2] << 8) |
                              (uint8_t)u[u.size() - 1];
              last += (unsigned)(k - lo);
              u[u.size() - 2] = (char)(last >> 8);
              u[u.size() - 1] = (char)(last & 0xFF);
            }
            out[k] = utf16be_to_utf8(u);
          }
        } else if (c->is(Obj::Arr)) {
          for (long k = lo; k <= hi && (size_t)(k - lo) < c->arr.size(); k++)
            if (c->arr[k - lo]->is(Obj::Str))
              out[k] = utf16be_to_utf8(c->arr[k - lo]->str);
        }
      }
    }
  }
  (void)window;
}

struct Canvas {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // row-major, origin top-left
  void init(int W, int H) { w = W; h = H; rgb.assign((size_t)w * h * 3, 255); }
  void put(int x, int y, uint8_t r, uint8_t g, uint8_t b) {
    if (x < 0 || y < 0 || x >= w || y >= h) return;
    size_t i = ((size_t)y * w + x) * 3;
    rgb[i] = r; rgb[i + 1] = g; rgb[i + 2] = b;
  }
};

// ---------------------------------------------------------------------------
// Embedded TrueType (FontFile2) parsing + glyph outlines
//
// Glyph-faithful rendering of embedded-font pages (the poppler role,
// reference functions.py:678-694): subsetted TrueType programs carry the
// real outlines; rasterizing them is what makes the page image ColPali
// embeds look like the real page. sfnt tables: head (unitsPerEm, loca
// format), maxp (numGlyphs), loca, glyf (simple + composite), cmap
// (formats 0/4/6/12, for SIMPLE TrueType fonts addressed by character
// code), hmtx/hhea (advance fallback). No hinting - outlines are exact
// at 144 DPI and the fill is antialiased.
// ---------------------------------------------------------------------------

struct TrueTypeFont {
  std::string d;
  bool ok = false;
  int units_per_em = 1000;
  bool long_loca = false;
  int num_glyphs = 0;
  size_t loca = 0, loca_len = 0, glyf = 0, glyf_len = 0;
  size_t hmtx = 0, hmtx_len = 0;
  int num_hmetrics = 0;
  std::map<uint32_t, uint16_t> cmap;  // unicode (or code) -> gid

  uint16_t u16(size_t o) const {
    if (o + 2 > d.size()) return 0;
    return ((uint8_t)d[o] << 8) | (uint8_t)d[o + 1];
  }
  int16_t s16(size_t o) const { return (int16_t)u16(o); }
  uint32_t u32(size_t o) const {
    if (o + 4 > d.size()) return 0;
    return ((uint32_t)(uint8_t)d[o] << 24) | ((uint32_t)(uint8_t)d[o + 1] << 16) |
           ((uint32_t)(uint8_t)d[o + 2] << 8) | (uint8_t)d[o + 3];
  }

  void parse(std::string bytes) {
    d = std::move(bytes);
    if (d.size() < 12) return;
    uint32_t tag = u32(0);
    size_t base = 0;
    if (tag == 0x74746366) {  // 'ttcf' collection: first font
      if (u32(8) < 1) return;
      base = u32(12);
    }
    if (u32(base) != 0x00010000 && u32(base) != 0x74727565 /*'true'*/)
      return;
    int n_tables = u16(base + 4);
    size_t head = 0, maxp = 0, cmap_off = 0, hhea = 0;
    for (int i = 0; i < n_tables; i++) {
      size_t rec = base + 12 + 16 * (size_t)i;
      uint32_t t = u32(rec);
      size_t off = u32(rec + 8), len = u32(rec + 12);
      if (off + len > d.size()) continue;
      switch (t) {
        case 0x68656164: head = off; break;          // head
        case 0x6D617870: maxp = off; break;          // maxp
        case 0x6C6F6361: loca = off; loca_len = len; break;   // loca
        case 0x676C7966: glyf = off; glyf_len = len; break;   // glyf
        case 0x636D6170: cmap_off = off; break;      // cmap
        case 0x68686561: hhea = off; break;          // hhea
        case 0x686D7478: hmtx = off; hmtx_len = len; break;   // hmtx
      }
    }
    if (!head || !maxp || !loca || !glyf) return;
    units_per_em = u16(head + 18);
    if (units_per_em <= 0) units_per_em = 1000;
    long_loca = s16(head + 50) != 0;
    num_glyphs = u16(maxp + 4);
    if (hhea) num_hmetrics = u16(hhea + 34);
    if (cmap_off) parse_cmap(cmap_off);
    ok = true;
  }

  void parse_cmap(size_t off) {
    int n = u16(off + 2);
    size_t best = 0;
    int best_score = -1;
    for (int i = 0; i < n; i++) {
      size_t rec = off + 4 + 8 * (size_t)i;
      int plat = u16(rec), enc = u16(rec + 2);
      size_t sub = off + u32(rec + 4);
      int score = -1;
      if (plat == 3 && enc == 10) score = 5;
      else if (plat == 3 && enc == 1) score = 4;
      else if (plat == 0) score = 3;
      else if (plat == 3 && enc == 0) score = 2;  // symbol (F0xx)
      else if (plat == 1 && enc == 0) score = 1;
      if (score > best_score) { best_score = score; best = sub; }
    }
    if (!best) return;
    int fmt = u16(best);
    if (fmt == 0) {
      for (int c = 0; c < 256; c++) {
        uint8_t g = (uint8_t)d[best + 6 + c];
        if (g) cmap[c] = g;
      }
    } else if (fmt == 4) {
      int segs = u16(best + 6) / 2;
      size_t ends = best + 14, starts = ends + 2 * (size_t)segs + 2,
             deltas = starts + 2 * (size_t)segs,
             ranges = deltas + 2 * (size_t)segs;
      for (int s = 0; s < segs; s++) {
        int e = u16(ends + 2 * (size_t)s), st = u16(starts + 2 * (size_t)s);
        int delta = s16(deltas + 2 * (size_t)s);
        int ro = u16(ranges + 2 * (size_t)s);
        if (st == 0xFFFF) continue;
        for (int c = st; c <= e && c - st < 20000; c++) {
          int g;
          if (ro == 0) g = (c + delta) & 0xFFFF;
          else {
            size_t gi = ranges + 2 * (size_t)s + ro + 2 * (size_t)(c - st);
            g = u16(gi);
            if (g) g = (g + delta) & 0xFFFF;
          }
          if (g) cmap[c] = (uint16_t)g;
        }
      }
    } else if (fmt == 6) {
      int first = u16(best + 6), cnt = u16(best + 8);
      for (int i = 0; i < cnt; i++) {
        int g = u16(best + 10 + 2 * (size_t)i);
        if (g) cmap[first + i] = (uint16_t)g;
      }
    } else if (fmt == 12) {
      uint32_t ngroups = u32(best + 12);
      for (uint32_t i = 0; i < ngroups && i < 20000; i++) {
        size_t g = best + 16 + 12 * (size_t)i;
        uint32_t sc = u32(g), ec = u32(g + 4), sg = u32(g + 8);
        for (uint32_t c = sc; c <= ec && c - sc < 20000; c++)
          cmap[c] = (uint16_t)(sg + (c - sc));
      }
    }
  }

  uint16_t gid_for_unicode(uint32_t cp) const {
    auto it = cmap.find(cp);
    if (it != cmap.end()) return it->second;
    it = cmap.find(0xF000 + cp);  // symbol-font convention
    if (it != cmap.end()) return it->second;
    return 0;
  }

  double advance(int gid) const {  // in font units
    if (!hmtx || !num_hmetrics) return units_per_em * 0.5;
    int i = gid < num_hmetrics ? gid : num_hmetrics - 1;
    return u16(hmtx + 4 * (size_t)i);
  }

  struct Pt { double x, y; bool on; };

  bool glyph_range(int gid, size_t& off, size_t& len) const {
    if (gid < 0 || gid >= num_glyphs) return false;
    size_t a, b;
    if (long_loca) {
      if (loca + 4 * (size_t)(gid + 1) + 4 > d.size()) return false;
      a = u32(loca + 4 * (size_t)gid);
      b = u32(loca + 4 * (size_t)(gid + 1));
    } else {
      if (loca + 2 * (size_t)(gid + 1) + 2 > d.size()) return false;
      a = 2 * (size_t)u16(loca + 2 * (size_t)gid);
      b = 2 * (size_t)u16(loca + 2 * (size_t)(gid + 1));
    }
    if (b < a || glyf + b > d.size()) return false;
    off = glyf + a;
    len = b - a;
    return true;
  }

  // contours in FONT UNITS (y-up); composites resolved recursively
  bool outline(int gid, std::vector<std::vector<Pt>>& out, int depth = 0) const {
    if (depth > 5) return false;
    size_t off, len;
    if (!glyph_range(gid, off, len)) return false;
    if (len == 0) return true;  // empty glyph (space)
    int ncont = s16(off);
    if (ncont >= 0) {
      // simple glyph
      std::vector<int> ends(ncont);
      for (int i = 0; i < ncont; i++) ends[i] = u16(off + 10 + 2 * (size_t)i);
      int npts = ncont ? ends.back() + 1 : 0;
      if (npts <= 0 || npts > 10000) return true;
      size_t p = off + 10 + 2 * (size_t)ncont;
      int ins = u16(p);
      p += 2 + ins;
      std::vector<uint8_t> flags;
      flags.reserve(npts);
      while ((int)flags.size() < npts && p < d.size()) {
        uint8_t f = d[p++];
        flags.push_back(f);
        if (f & 8) {  // repeat
          int r = (uint8_t)d[p++];
          for (int k = 0; k < r && (int)flags.size() < npts; k++)
            flags.push_back(f);
        }
      }
      std::vector<double> xs(npts), ys(npts);
      double v = 0;
      for (int i = 0; i < npts; i++) {
        uint8_t f = flags[i];
        if (f & 2) {
          uint8_t dx = d[p++];
          v += (f & 16) ? dx : -(double)dx;
        } else if (!(f & 16)) {
          v += s16(p); p += 2;
        }
        xs[i] = v;
      }
      v = 0;
      for (int i = 0; i < npts; i++) {
        uint8_t f = flags[i];
        if (f & 4) {
          uint8_t dy = d[p++];
          v += (f & 32) ? dy : -(double)dy;
        } else if (!(f & 32)) {
          v += s16(p); p += 2;
        }
        ys[i] = v;
      }
      int start = 0;
      for (int c = 0; c < ncont; c++) {
        std::vector<Pt> cont;
        for (int i = start; i <= ends[c] && i < npts; i++)
          cont.push_back({xs[i], ys[i], (flags[i] & 1) != 0});
        start = ends[c] + 1;
        if (cont.size() >= 2) out.push_back(std::move(cont));
      }
      return true;
    }
    // composite
    size_t p = off + 10;
    while (p + 4 <= d.size()) {
      int flags = u16(p), sub_gid = u16(p + 2);
      p += 4;
      double dx = 0, dy = 0;
      if (flags & 1) {  // ARG_1_AND_2_ARE_WORDS
        if (flags & 2) { dx = s16(p); dy = s16(p + 2); }
        p += 4;
      } else {
        if (flags & 2) { dx = (int8_t)d[p]; dy = (int8_t)d[p + 1]; }
        p += 2;
      }
      double a = 1, b2 = 0, c2 = 0, dd = 1;
      if (flags & 8) {  // WE_HAVE_A_SCALE
        a = dd = s16(p) / 16384.0; p += 2;
      } else if (flags & 0x40) {  // X_AND_Y_SCALE
        a = s16(p) / 16384.0; dd = s16(p + 2) / 16384.0; p += 4;
      } else if (flags & 0x80) {  // 2x2
        a = s16(p) / 16384.0; b2 = s16(p + 2) / 16384.0;
        c2 = s16(p + 4) / 16384.0; dd = s16(p + 6) / 16384.0; p += 8;
      }
      std::vector<std::vector<Pt>> sub;
      if (outline(sub_gid, sub, depth + 1)) {
        for (auto& cont : sub) {
          for (auto& pt : cont) {
            double x = pt.x * a + pt.y * c2 + dx;
            double y = pt.x * b2 + pt.y * dd + dy;
            pt.x = x; pt.y = y;
          }
          out.push_back(std::move(cont));
        }
      }
      if (!(flags & 0x20)) break;  // MORE_COMPONENTS
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// Embedded CFF (FontFile3: Type1C / CIDFontType0C / OpenType-wrapped)
//
// The pdfTeX mainstream embeds Type1 fonts compacted to CFF; glyph-faithful
// rendering of those pages (the poppler role, reference functions.py:678-713)
// needs a Type2 charstring interpreter. Covers: INDEX/DICT structures,
// charset formats 0/1/2 (gid<->SID/CID), built-in Encoding formats 0/1 +
// standard encoding, Private/local + global subrs with bias, CID-keyed
// fonts (ROS + FDArray/FDSelect formats 0/3), FontMatrix, and the full
// Type2 path operator set incl. flex variants. Cubics are flattened to
// polylines in charstring units; the renderer applies FontMatrix and the
// text matrix and feeds the antialiased PathFiller (same backbone as
// TrueType glyphs). No hinting - exact outlines at 144 DPI.
// ---------------------------------------------------------------------------

// SIDs 0-228 of the CFF standard strings (ISOAdobe); expert-font strings
// (229-390) are omitted - subset text fonts never reference them, and any
// SID >= 391 resolves through the font's own String INDEX.
static const char* kCffStdStrings[] = {
  ".notdef", "space", "exclam", "quotedbl", "numbersign", "dollar",
  "percent", "ampersand", "quoteright", "parenleft", "parenright",
  "asterisk", "plus", "comma", "hyphen", "period", "slash", "zero", "one",
  "two", "three", "four", "five", "six", "seven", "eight", "nine", "colon",
  "semicolon", "less", "equal", "greater", "question", "at", "A", "B", "C",
  "D", "E", "F", "G", "H", "I", "J", "K", "L", "M", "N", "O", "P", "Q",
  "R", "S", "T", "U", "V", "W", "X", "Y", "Z", "bracketleft", "backslash",
  "bracketright", "asciicircum", "underscore", "quoteleft", "a", "b", "c",
  "d", "e", "f", "g", "h", "i", "j", "k", "l", "m", "n", "o", "p", "q",
  "r", "s", "t", "u", "v", "w", "x", "y", "z", "braceleft", "bar",
  "braceright", "asciitilde", "exclamdown", "cent", "sterling", "fraction",
  "yen", "florin", "section", "currency", "quotesingle", "quotedblleft",
  "guillemotleft", "guilsinglleft", "guilsinglright", "fi", "fl", "endash",
  "dagger", "daggerdbl", "periodcentered", "paragraph", "bullet",
  "quotesinglbase", "quotedblbase", "quotedblright", "guillemotright",
  "ellipsis", "perthousand", "questiondown", "grave", "acute",
  "circumflex", "tilde", "macron", "breve", "dotaccent", "dieresis",
  "ring", "cedilla", "hungarumlaut", "ogonek", "caron", "emdash", "AE",
  "ordfeminine", "Lslash", "Oslash", "OE", "ordmasculine", "ae",
  "dotlessi", "lslash", "oslash", "oe", "germandbls", "onesuperior",
  "logicalnot", "mu", "trademark", "Eth", "onehalf", "plusminus", "Thorn",
  "onequarter", "divide", "brokenbar", "degree", "thorn", "threequarters",
  "twosuperior", "registered", "minus", "eth", "multiply",
  "threesuperior", "copyright", "Aacute", "Acircumflex", "Adieresis",
  "Agrave", "Aring", "Atilde", "Ccedilla", "Eacute", "Ecircumflex",
  "Edieresis", "Egrave", "Iacute", "Icircumflex", "Idieresis", "Igrave",
  "Ntilde", "Oacute", "Ocircumflex", "Odieresis", "Ograve", "Otilde",
  "Scaron", "Uacute", "Ucircumflex", "Udieresis", "Ugrave", "Yacute",
  "Ydieresis", "Zcaron", "aacute", "acircumflex", "adieresis", "agrave",
  "aring", "atilde", "ccedilla", "eacute", "ecircumflex", "edieresis",
  "egrave", "iacute", "icircumflex", "idieresis", "igrave", "ntilde",
  "oacute", "ocircumflex", "odieresis", "ograve", "otilde", "scaron",
  "uacute", "ucircumflex", "udieresis", "ugrave", "yacute", "ydieresis",
  "zcaron",
};
static const int kCffNumStdStrings =
    (int)(sizeof(kCffStdStrings) / sizeof(kCffStdStrings[0]));

struct CffFont {
  std::string d;
  bool ok = false;
  bool is_cid = false;
  double fm[6] = {0.001, 0, 0, 0.001, 0, 0};  // FontMatrix

  struct Index {  // absolute offsets into d; off.size() == count+1
    std::vector<size_t> off;
    size_t count() const { return off.empty() ? 0 : off.size() - 1; }
    bool get(size_t i, size_t& o, size_t& l) const {
      if (i + 1 >= off.size() || off[i + 1] < off[i]) return false;
      o = off[i];
      l = off[i + 1] - off[i];
      return true;
    }
  };
  Index charstrings, gsubrs, strings, lsubrs;
  std::vector<Index> fd_lsubrs;        // CID: local subrs per font DICT
  std::vector<uint8_t> fd_of_gid;      // CID: FDSelect
  std::vector<uint16_t> charset_sid;   // gid -> SID (or CID)
  std::map<uint32_t, uint16_t> cid2gid;
  std::map<std::string, uint16_t> name2gid;
  std::map<int, uint16_t> code2gid;    // built-in Encoding

  uint8_t u8(size_t o) const { return o < d.size() ? (uint8_t)d[o] : 0; }
  uint16_t u16(size_t o) const {
    return o + 2 <= d.size() ? (((uint8_t)d[o] << 8) | (uint8_t)d[o + 1]) : 0;
  }
  uint32_t u24(size_t o) const {
    return o + 3 <= d.size()
               ? (((uint32_t)(uint8_t)d[o] << 16) |
                  ((uint32_t)(uint8_t)d[o + 1] << 8) | (uint8_t)d[o + 2])
               : 0;
  }
  uint32_t u32(size_t o) const {
    return o + 4 <= d.size()
               ? (((uint32_t)(uint8_t)d[o] << 24) |
                  ((uint32_t)(uint8_t)d[o + 1] << 16) |
                  ((uint32_t)(uint8_t)d[o + 2] << 8) | (uint8_t)d[o + 3])
               : 0;
  }
  size_t offat(size_t o, int osz) const {
    switch (osz) {
      case 1: return u8(o);
      case 2: return u16(o);
      case 3: return u24(o);
      default: return u32(o);
    }
  }

  // read an INDEX at p; advances p past it
  Index read_index(size_t& p) const {
    Index ix;
    size_t count = u16(p);
    p += 2;
    if (!count) { ix.off.clear(); return ix; }
    int osz = u8(p);
    p += 1;
    if (osz < 1 || osz > 4) return ix;
    size_t data = p + (count + 1) * (size_t)osz - 1;  // offsets are 1-based
    ix.off.reserve(count + 1);
    for (size_t i = 0; i <= count; i++) {
      size_t o = data + offat(p + i * (size_t)osz, osz);
      if (o > d.size()) o = d.size();
      ix.off.push_back(o);
    }
    p = ix.off.back();
    return ix;
  }

  // DICT: key -> operand list; two-byte ops keyed as 0x0c00|b1
  std::map<int, std::vector<double>> parse_dict(size_t o, size_t len) const {
    std::map<int, std::vector<double>> out;
    std::vector<double> st;
    size_t p = o, end = std::min(d.size(), o + len);
    while (p < end) {
      uint8_t b0 = u8(p);
      if (b0 <= 21) {  // operator
        int key = b0;
        p += 1;
        if (b0 == 12) { key = 0x0c00 | u8(p); p += 1; }
        out[key] = st;
        st.clear();
      } else if (b0 >= 32 && b0 <= 246) {
        st.push_back((int)b0 - 139);
        p += 1;
      } else if (b0 >= 247 && b0 <= 250) {
        st.push_back((b0 - 247) * 256 + u8(p + 1) + 108);
        p += 2;
      } else if (b0 >= 251 && b0 <= 254) {
        st.push_back(-((int)(b0 - 251) * 256) - u8(p + 1) - 108);
        p += 2;
      } else if (b0 == 28) {
        st.push_back((int16_t)u16(p + 1));
        p += 3;
      } else if (b0 == 29) {
        st.push_back((int32_t)u32(p + 1));
        p += 5;
      } else if (b0 == 30) {  // real: BCD nibbles
        std::string s;
        p += 1;
        bool done = false;
        while (p < end && !done) {
          uint8_t b = u8(p++);
          for (int half = 0; half < 2; half++) {
            int nib = half ? (b & 15) : (b >> 4);
            if (nib <= 9) s += (char)('0' + nib);
            else if (nib == 10) s += '.';
            else if (nib == 11) s += 'E';
            else if (nib == 12) s += "E-";
            else if (nib == 14) s += '-';
            else if (nib == 15) { done = true; break; }
          }
        }
        st.push_back(s.empty() ? 0.0 : atof(s.c_str()));
      } else {
        p += 1;  // reserved
      }
    }
    return out;
  }

  std::string sid_name(int sid) const {
    if (sid >= 0 && sid < kCffNumStdStrings) return kCffStdStrings[sid];
    size_t i = (size_t)(sid - 391), o, l;
    if (sid >= 391 && strings.get(i, o, l)) return d.substr(o, l);
    return "";
  }

  void parse(std::string bytes) {
    d = std::move(bytes);
    if (d.size() < 4) return;
    // OpenType wrapper ('OTTO'): extract the 'CFF ' table
    if (u32(0) == 0x4F54544F) {
      int n_tables = u16(4);
      for (int i = 0; i < n_tables; i++) {
        size_t rec = 12 + 16 * (size_t)i;
        if (u32(rec) == 0x43464620) {  // 'CFF '
          size_t off = u32(rec + 8), len = u32(rec + 12);
          if (off + len <= d.size()) d = d.substr(off, len);
          break;
        }
      }
      if (d.size() < 4 || u32(0) == 0x4F54544F) return;  // no CFF table
    }
    size_t p = u8(2);  // hdrSize
    if (p < 4 || p >= d.size()) return;
    read_index(p);  // Name INDEX (unused)
    Index top_ix = read_index(p);
    strings = read_index(p);
    gsubrs = read_index(p);
    size_t to, tl;
    if (!top_ix.get(0, to, tl)) return;
    auto top = parse_dict(to, tl);
    auto num1 = [&](int key, double dflt) {
      auto it = top.find(key);
      return it != top.end() && !it->second.empty() ? it->second[0] : dflt;
    };
    if (top.count(0x0c1e)) is_cid = true;  // ROS
    if (top.count(0x0c07) && top[0x0c07].size() == 6)
      for (int i = 0; i < 6; i++) fm[i] = top[0x0c07][i];
    size_t cs_off = (size_t)num1(17, 0);  // CharStrings
    if (!cs_off || cs_off >= d.size()) return;
    size_t q = cs_off;
    charstrings = read_index(q);
    size_t n = charstrings.count();
    if (!n) return;
    // Private DICT (non-CID) -> local subrs
    auto read_private = [&](double sz, double off, Index& out_subrs) {
      size_t po = (size_t)off, pl = (size_t)sz;
      if (!po || po >= d.size()) return;
      auto priv = parse_dict(po, pl);
      auto it = priv.find(19);  // Subrs: offset relative to Private start
      if (it != priv.end() && !it->second.empty()) {
        size_t so = po + (size_t)it->second[0];
        if (so && so < d.size()) out_subrs = read_index(so);
      }
    };
    if (top.count(18) && top[18].size() == 2)
      read_private(top[18][0], top[18][1], lsubrs);
    // charset: gid -> SID/CID
    charset_sid.assign(n, 0);
    size_t ch_off = (size_t)num1(15, 0);
    if (ch_off > 2 && ch_off < d.size()) {
      int fmt = u8(ch_off);
      if (fmt == 0) {
        for (size_t g = 1; g < n; g++)
          charset_sid[g] = u16(ch_off + 1 + 2 * (g - 1));
      } else if (fmt == 1 || fmt == 2) {
        size_t g = 1, r = ch_off + 1;
        while (g < n && r + 2 < d.size()) {
          int first = u16(r);
          size_t nleft = fmt == 1 ? u8(r + 2) : u16(r + 2);
          r += fmt == 1 ? 3 : 4;
          for (size_t k = 0; k <= nleft && g < n; k++)
            charset_sid[g++] = (uint16_t)(first + k);
        }
      }
    } else {
      // 0 = ISOAdobe (identity); expert charsets treated the same
      for (size_t g = 0; g < n; g++) charset_sid[g] = (uint16_t)g;
    }
    if (is_cid) {
      for (size_t g = 0; g < n; g++)
        if (!cid2gid.count(charset_sid[g])) cid2gid[charset_sid[g]] = (uint16_t)g;
      // FDArray / FDSelect
      fd_of_gid.assign(n, 0);
      size_t fda = top.count(0x0c24) && !top[0x0c24].empty()
                       ? (size_t)top[0x0c24][0] : 0;
      if (fda && fda < d.size()) {
        size_t fp = fda;
        Index fdix = read_index(fp);
        for (size_t i = 0; i < fdix.count(); i++) {
          size_t fo, fl;
          Index sub;
          if (fdix.get(i, fo, fl)) {
            auto fd = parse_dict(fo, fl);
            if (fd.count(18) && fd[18].size() == 2)
              read_private(fd[18][0], fd[18][1], sub);
          }
          fd_lsubrs.push_back(sub);
        }
      }
      size_t fds = top.count(0x0c25) && !top[0x0c25].empty()
                       ? (size_t)top[0x0c25][0] : 0;
      if (fds && fds < d.size()) {
        int fmt = u8(fds);
        if (fmt == 0) {
          for (size_t g = 0; g < n; g++) fd_of_gid[g] = u8(fds + 1 + g);
        } else if (fmt == 3) {
          int nr = u16(fds + 1);
          for (int r = 0; r < nr; r++) {
            size_t rec = fds + 3 + 3 * (size_t)r;
            size_t first = u16(rec), next = u16(rec + 3);
            uint8_t fd = u8(rec + 2);
            for (size_t g = first; g < next && g < n; g++) fd_of_gid[g] = fd;
          }
        }
      }
    } else {
      for (size_t g = 0; g < n; g++) {
        std::string nm = sid_name(charset_sid[g]);
        if (!nm.empty() && !name2gid.count(nm)) name2gid[nm] = (uint16_t)g;
      }
      // built-in Encoding (code -> gid)
      size_t enc = (size_t)num1(16, 0);
      if (enc > 1 && enc < d.size()) {
        int fmt = u8(enc) & 0x7F;
        bool supp = (u8(enc) & 0x80) != 0;
        size_t after = enc;
        if (fmt == 0) {
          int nc = u8(enc + 1);
          for (int i = 0; i < nc; i++) code2gid[u8(enc + 2 + i)] = (uint16_t)(i + 1);
          after = enc + 2 + nc;
        } else if (fmt == 1) {
          int nr = u8(enc + 1);
          int g = 1;
          for (int r = 0; r < nr; r++) {
            int first = u8(enc + 2 + 2 * r), nleft = u8(enc + 3 + 2 * r);
            for (int k = 0; k <= nleft && g < (int)n; k++)
              code2gid[first + k] = (uint16_t)g++;
          }
          after = enc + 2 + 2 * (size_t)nr;
        }
        if (supp) {
          int ns = u8(after);
          for (int s = 0; s < ns; s++) {
            int code = u8(after + 1 + 3 * s);
            int sid = u16(after + 2 + 3 * s);
            std::string nm = sid_name(sid);
            auto it = name2gid.find(nm);
            if (it != name2gid.end()) code2gid[code] = it->second;
          }
        }
      } else {
        // standard encoding: codes 32..126 are SIDs 1..95 by construction
        for (int c = 32; c <= 126; c++) {
          auto it = name2gid.find(kCffStdStrings[c - 31]);
          if (it != name2gid.end()) code2gid[c] = it->second;
        }
      }
    }
    ok = true;
  }

  size_t nglyphs() const { return charstrings.count(); }

  // ---- Type2 charstring interpreter -> flattened contours (charstring
  // units, y-up); FontMatrix applied by the renderer.
  struct T2 {
    std::vector<double> st;
    double x = 0, y = 0;
    int nstems = 0;
    bool width_done = false;
    double trans[32] = {0};
    std::vector<std::vector<std::pair<double, double>>>* out = nullptr;
    std::vector<std::pair<double, double>> cur;
    const Index* local = nullptr;
    bool stopped = false;
  };

  static int bias(const Index& ix) {
    size_t c = ix.count();
    return c < 1240 ? 107 : (c < 33900 ? 1131 : 32768);
  }

  void t2_moveto(T2& c, double nx, double ny) const {
    if (c.cur.size() >= 2) c.out->push_back(std::move(c.cur));
    c.cur.clear();
    c.x = nx;
    c.y = ny;
    c.cur.push_back({nx, ny});
  }
  void t2_lineto(T2& c, double nx, double ny) const {
    c.x = nx;
    c.y = ny;
    c.cur.push_back({nx, ny});
  }
  void t2_curveto(T2& c, double x1, double y1, double x2, double y2,
                  double x3, double y3) const {
    const int N = 8;
    double x0 = c.x, y0 = c.y;
    for (int i = 1; i <= N; i++) {
      double t = (double)i / N, u = 1 - t;
      c.cur.push_back({u * u * u * x0 + 3 * u * u * t * x1 +
                           3 * u * t * t * x2 + t * t * t * x3,
                       u * u * u * y0 + 3 * u * u * t * y1 +
                           3 * u * t * t * y2 + t * t * t * y3});
    }
    c.x = x3;
    c.y = y3;
  }
  // drop the leading width operand on the first stack-clearing operator
  void t2_width(T2& c, size_t even_args) const {
    if (!c.width_done) {
      c.width_done = true;
      if (c.st.size() > even_args && (c.st.size() - even_args) % 2 == 1)
        c.st.erase(c.st.begin());
      else if (even_args == 0 && (c.st.size() % 2) == 1)
        c.st.erase(c.st.begin());
    }
  }

  bool t2_run(size_t off, size_t len, T2& c, int depth) const {
    if (depth > 10) return false;
    size_t p = off, end = std::min(d.size(), off + len);
    while (p < end && !c.stopped) {
      uint8_t b0 = u8(p);
      if (b0 >= 32 && b0 <= 246) { c.st.push_back((int)b0 - 139); p += 1; }
      else if (b0 >= 247 && b0 <= 250) {
        c.st.push_back((b0 - 247) * 256 + u8(p + 1) + 108);
        p += 2;
      } else if (b0 >= 251 && b0 <= 254) {
        c.st.push_back(-((int)(b0 - 251) * 256) - u8(p + 1) - 108);
        p += 2;
      } else if (b0 == 28) {
        c.st.push_back((int16_t)u16(p + 1));
        p += 3;
      } else if (b0 == 255) {
        c.st.push_back((int32_t)u32(p + 1) / 65536.0);
        p += 5;
      } else {
        p += 1;
        switch (b0) {
          case 1: case 3: case 18: case 23:  // h/vstem(hm)
            if (!c.width_done) {
              c.width_done = true;
              if (c.st.size() % 2 == 1) c.st.erase(c.st.begin());
            }
            c.nstems += (int)c.st.size() / 2;
            c.st.clear();
            break;
          case 19: case 20: {  // hintmask / cntrmask
            if (!c.width_done) {
              c.width_done = true;
              if (c.st.size() % 2 == 1) c.st.erase(c.st.begin());
            }
            c.nstems += (int)c.st.size() / 2;  // implicit vstems
            c.st.clear();
            p += (size_t)(c.nstems + 7) / 8;
            break;
          }
          case 21:  // rmoveto
            t2_width(c, 2);
            if (c.st.size() >= 2)
              t2_moveto(c, c.x + c.st[c.st.size() - 2],
                        c.y + c.st[c.st.size() - 1]);
            c.st.clear();
            break;
          case 22:  // hmoveto
            t2_width(c, 1);
            if (!c.st.empty()) t2_moveto(c, c.x + c.st.back(), c.y);
            c.st.clear();
            break;
          case 4:  // vmoveto
            t2_width(c, 1);
            if (!c.st.empty()) t2_moveto(c, c.x, c.y + c.st.back());
            c.st.clear();
            break;
          case 5:  // rlineto
            for (size_t i = 0; i + 1 < c.st.size(); i += 2)
              t2_lineto(c, c.x + c.st[i], c.y + c.st[i + 1]);
            c.st.clear();
            break;
          case 6: case 7: {  // hlineto / vlineto (alternating)
            bool horiz = b0 == 6;
            for (size_t i = 0; i < c.st.size(); i++) {
              if (horiz) t2_lineto(c, c.x + c.st[i], c.y);
              else t2_lineto(c, c.x, c.y + c.st[i]);
              horiz = !horiz;
            }
            c.st.clear();
            break;
          }
          case 8:  // rrcurveto
            for (size_t i = 0; i + 5 < c.st.size(); i += 6)
              t2_curveto(c, c.x + c.st[i], c.y + c.st[i + 1],
                         c.x + c.st[i] + c.st[i + 2],
                         c.y + c.st[i + 1] + c.st[i + 3],
                         c.x + c.st[i] + c.st[i + 2] + c.st[i + 4],
                         c.y + c.st[i + 1] + c.st[i + 3] + c.st[i + 5]);
            c.st.clear();
            break;
          case 24: {  // rcurveline
            size_t i = 0;
            while (c.st.size() - i >= 8) {
              t2_curveto(c, c.x + c.st[i], c.y + c.st[i + 1],
                         c.x + c.st[i] + c.st[i + 2],
                         c.y + c.st[i + 1] + c.st[i + 3],
                         c.x + c.st[i] + c.st[i + 2] + c.st[i + 4],
                         c.y + c.st[i + 1] + c.st[i + 3] + c.st[i + 5]);
              i += 6;
            }
            if (c.st.size() - i >= 2)
              t2_lineto(c, c.x + c.st[i], c.y + c.st[i + 1]);
            c.st.clear();
            break;
          }
          case 25: {  // rlinecurve
            size_t i = 0;
            while (c.st.size() - i > 6) {
              t2_lineto(c, c.x + c.st[i], c.y + c.st[i + 1]);
              i += 2;
            }
            if (c.st.size() - i >= 6)
              t2_curveto(c, c.x + c.st[i], c.y + c.st[i + 1],
                         c.x + c.st[i] + c.st[i + 2],
                         c.y + c.st[i + 1] + c.st[i + 3],
                         c.x + c.st[i] + c.st[i + 2] + c.st[i + 4],
                         c.y + c.st[i + 1] + c.st[i + 3] + c.st[i + 5]);
            c.st.clear();
            break;
          }
          case 26: {  // vvcurveto
            size_t i = 0;
            double dx1 = 0;
            if (c.st.size() % 4 == 1) { dx1 = c.st[0]; i = 1; }
            for (; i + 3 < c.st.size(); i += 4) {
              double x1 = c.x + dx1, y1 = c.y + c.st[i];
              double x2 = x1 + c.st[i + 1], y2 = y1 + c.st[i + 2];
              t2_curveto(c, x1, y1, x2, y2, x2, y2 + c.st[i + 3]);
              dx1 = 0;
            }
            c.st.clear();
            break;
          }
          case 27: {  // hhcurveto
            size_t i = 0;
            double dy1 = 0;
            if (c.st.size() % 4 == 1) { dy1 = c.st[0]; i = 1; }
            for (; i + 3 < c.st.size(); i += 4) {
              double x1 = c.x + c.st[i], y1 = c.y + dy1;
              double x2 = x1 + c.st[i + 1], y2 = y1 + c.st[i + 2];
              t2_curveto(c, x1, y1, x2, y2, x2 + c.st[i + 3], y2);
              dy1 = 0;
            }
            c.st.clear();
            break;
          }
          case 30: case 31: {  // vhcurveto / hvcurveto (alternating)
            bool horiz = b0 == 31;
            size_t i = 0;
            while (c.st.size() - i >= 4) {
              bool last = c.st.size() - i == 5;
              double a = c.st[i], b = c.st[i + 1], cc = c.st[i + 2],
                     dd = c.st[i + 3];
              double x1, y1, x2, y2, x3, y3;
              if (horiz) {
                x1 = c.x + a; y1 = c.y;
                x2 = x1 + b; y2 = y1 + cc;
                y3 = y2 + dd;
                x3 = last ? x2 + c.st[i + 4] : x2;
              } else {
                x1 = c.x; y1 = c.y + a;
                x2 = x1 + b; y2 = y1 + cc;
                x3 = x2 + dd;
                y3 = last ? y2 + c.st[i + 4] : y2;
              }
              t2_curveto(c, x1, y1, x2, y2, x3, y3);
              horiz = !horiz;
              i += 4;
            }
            c.st.clear();
            break;
          }
          case 10: case 29: {  // callsubr / callgsubr
            if (c.st.empty()) break;
            const Index& ix =
                b0 == 10 ? (c.local ? *c.local : lsubrs) : gsubrs;
            long idx = (long)c.st.back() + bias(ix);
            c.st.pop_back();
            size_t so, sl;
            if (idx >= 0 && ix.get((size_t)idx, so, sl))
              t2_run(so, sl, c, depth + 1);
            break;
          }
          case 11:  // return
            return true;
          case 14:  // endchar (seac-style accents not composed)
            t2_width(c, 0);
            if (c.cur.size() >= 2) c.out->push_back(std::move(c.cur));
            c.cur.clear();
            c.st.clear();
            c.stopped = true;
            return true;
          case 12: {  // escape
            uint8_t b1 = u8(p);
            p += 1;
            if (b1 == 35 && c.st.size() >= 13) {  // flex
              double x0 = c.x, y0 = c.y;
              double x1 = x0 + c.st[0], y1 = y0 + c.st[1];
              double x2 = x1 + c.st[2], y2 = y1 + c.st[3];
              double x3 = x2 + c.st[4], y3 = y2 + c.st[5];
              t2_curveto(c, x1, y1, x2, y2, x3, y3);
              double x4 = x3 + c.st[6], y4 = y3 + c.st[7];
              double x5 = x4 + c.st[8], y5 = y4 + c.st[9];
              t2_curveto(c, x4, y4, x5, y5, x5 + c.st[10], y5 + c.st[11]);
            } else if (b1 == 34 && c.st.size() >= 7) {  // hflex
              double y0 = c.y;
              double x1 = c.x + c.st[0], y1 = y0;
              double x2 = x1 + c.st[1], y2 = y1 + c.st[2];
              double x3 = x2 + c.st[3], y3 = y2;
              t2_curveto(c, x1, y1, x2, y2, x3, y3);
              double x4 = x3 + c.st[4], y4 = y2;
              double x5 = x4 + c.st[5], y5 = y0;
              t2_curveto(c, x4, y4, x5, y5, x5 + c.st[6], y0);
            } else if (b1 == 36 && c.st.size() >= 9) {  // hflex1
              double y0 = c.y;
              double x1 = c.x + c.st[0], y1 = c.y + c.st[1];
              double x2 = x1 + c.st[2], y2 = y1 + c.st[3];
              double x3 = x2 + c.st[4], y3 = y2;
              t2_curveto(c, x1, y1, x2, y2, x3, y3);
              double x4 = x3 + c.st[5], y4 = y2;
              double x5 = x4 + c.st[6], y5 = y4 + c.st[7];
              t2_curveto(c, x4, y4, x5, y5, x5 + c.st[8], y0);
            } else if (b1 == 37 && c.st.size() >= 11) {  // flex1
              double x0 = c.x, y0 = c.y;
              double dx = c.st[0] + c.st[2] + c.st[4] + c.st[6] + c.st[8];
              double dy = c.st[1] + c.st[3] + c.st[5] + c.st[7] + c.st[9];
              double x1 = x0 + c.st[0], y1 = y0 + c.st[1];
              double x2 = x1 + c.st[2], y2 = y1 + c.st[3];
              double x3 = x2 + c.st[4], y3 = y2 + c.st[5];
              t2_curveto(c, x1, y1, x2, y2, x3, y3);
              double x4 = x3 + c.st[6], y4 = y3 + c.st[7];
              double x5 = x4 + c.st[8], y5 = y4 + c.st[9];
              double x6, y6;
              if (std::abs(dx) > std::abs(dy)) { x6 = x5 + c.st[10]; y6 = y0; }
              else { x6 = x0; y6 = y5 + c.st[10]; }
              t2_curveto(c, x4, y4, x5, y5, x6, y6);
            } else if (b1 == 12 && c.st.size() >= 2) {  // div
              double b = c.st.back(); c.st.pop_back();
              double a = c.st.back(); c.st.pop_back();
              c.st.push_back(b != 0 ? a / b : 0);
              break;  // arithmetic: do NOT clear the stack
            }
            c.st.clear();
            break;
          }
          default:
            c.st.clear();  // unknown operator: stay in sync
            break;
        }
      }
      if (c.st.size() > 96) c.st.clear();  // runaway guard
    }
    return true;
  }

  // contours in charstring units (y-up); FontMatrix applied by caller
  bool outline(int gid,
               std::vector<std::vector<std::pair<double, double>>>& out) const {
    size_t o, l;
    if (gid < 0 || !charstrings.get((size_t)gid, o, l)) return false;
    T2 c;
    c.out = &out;
    if (is_cid && (size_t)gid < fd_of_gid.size()) {
      uint8_t fd = fd_of_gid[gid];
      if (fd < fd_lsubrs.size()) c.local = &fd_lsubrs[fd];
    }
    t2_run(o, l, c, 0);
    if (c.cur.size() >= 2) out.push_back(std::move(c.cur));
    return true;
  }
};

// ---------------------------------------------------------------------------
// Embedded Type1 (FontFile) parsing + charstring outlines
//
// Pre-CFF Type1 programs (dvips-era LaTeX, pre-2000 producers): eexec
// decryption (r=55665), charstring decryption (r=4330, lenIV skip),
// /Subrs + /CharStrings extraction, the Type1 operator set incl.
// othersubr flex (1/2/0), hint replacement (3), seac accent composition
// and div. PFB segment headers and hex-eexec bodies both handled.
// Outlines land in font units (FontMatrix applied by the renderer, same
// contract as CffFont).
// ---------------------------------------------------------------------------

// StandardEncoding accent codes used by seac (base codes are ASCII and
// covered by kCffStdStrings[code-31])
static const struct { int code; const char* name; } kStdEncAccents[] = {
  {193, "grave"}, {194, "acute"}, {195, "circumflex"}, {196, "tilde"},
  {197, "macron"}, {198, "breve"}, {199, "dotaccent"}, {200, "dieresis"},
  {202, "ring"}, {203, "cedilla"}, {205, "hungarumlaut"}, {206, "ogonek"},
  {207, "caron"}, {225, "AE"}, {241, "ae"}, {233, "Oslash"},
  {249, "oslash"}, {161, "exclamdown"}, {191, "questiondown"},
};

static std::string std_enc_name(int code) {
  if (code >= 32 && code <= 126) return kCffStdStrings[code - 31];
  for (auto& a : kStdEncAccents)
    if (a.code == code) return a.name;
  return "";
}

struct Type1Font {
  bool ok = false;
  double fm[6] = {0.001, 0, 0, 0.001, 0, 0};
  std::vector<std::string> names;        // gid -> glyph name
  std::map<std::string, int> name2gid;
  std::vector<std::string> charstrings;  // decrypted, lenIV-stripped
  std::vector<std::string> subrs;
  std::map<int, std::string> builtin_enc;  // code -> glyph name

  static std::string decrypt(const std::string& in, uint16_t r, int skip) {
    const uint16_t c1 = 52845, c2 = 22719;
    std::string out;
    out.reserve(in.size());
    for (unsigned char c : in) {
      out += (char)(c ^ (r >> 8));
      r = (uint16_t)((c + r) * c1 + c2);
    }
    return skip > 0 && (int)out.size() >= skip ? out.substr(skip) : out;
  }

  void parse(const std::string& raw_in) {
    std::string raw;
    if (!raw_in.empty() && (uint8_t)raw_in[0] == 0x80) {
      // PFB: 0x80 0x01/0x02 + u32le length segments
      size_t p = 0;
      while (p + 6 <= raw_in.size() && (uint8_t)raw_in[p] == 0x80) {
        uint8_t t = raw_in[p + 1];
        uint32_t len = (uint8_t)raw_in[p + 2] | ((uint8_t)raw_in[p + 3] << 8) |
                       ((uint8_t)raw_in[p + 4] << 16) |
                       ((uint8_t)raw_in[p + 5] << 24);
        if (t == 3) break;
        if (p + 6 + len > raw_in.size()) break;
        raw += raw_in.substr(p + 6, len);
        p += 6 + len;
      }
    } else {
      raw = raw_in;
    }
    size_t ee = raw.find("eexec");
    if (ee == std::string::npos) return;
    std::string clear = raw.substr(0, ee);
    size_t bs = ee + 5;
    while (bs < raw.size() && (raw[bs] == '\r' || raw[bs] == '\n' ||
                               raw[bs] == ' ' || raw[bs] == '\t'))
      bs++;
    std::string body = raw.substr(bs);
    // hex-eexec detection: first 4 bytes all hex digits
    bool hex = body.size() >= 4;
    for (int i = 0; i < 4 && hex; i++)
      hex = isxdigit((unsigned char)body[i]) != 0;
    if (hex) {
      std::string bin;
      int hi = -1;
      for (unsigned char c : body) {
        if (!isxdigit(c)) continue;
        int v = c <= '9' ? c - '0' : (c | 32) - 'a' + 10;
        if (hi < 0) hi = v;
        else { bin += (char)((hi << 4) | v); hi = -1; }
      }
      body = bin;
    }
    std::string dec = decrypt(body, 55665, 4);
    // lenIV (default 4)
    int leniv = 4;
    size_t lp = dec.find("/lenIV");
    if (lp != std::string::npos) leniv = atoi(dec.c_str() + lp + 6);
    // FontMatrix from the cleartext
    size_t fmp = clear.find("/FontMatrix");
    if (fmp != std::string::npos) {
      size_t br = clear.find('[', fmp);
      if (br != std::string::npos) {
        double v[6];
        if (sscanf(clear.c_str() + br + 1, "%lf %lf %lf %lf %lf %lf",
                   &v[0], &v[1], &v[2], &v[3], &v[4], &v[5]) == 6)
          for (int i = 0; i < 6; i++) fm[i] = v[i];
      }
    }
    // built-in encoding: "dup <code> /<name> put" entries
    size_t ep = clear.find("/Encoding");
    if (ep != std::string::npos) {
      size_t end = clear.find("readonly def", ep);
      if (end == std::string::npos) end = clear.size();
      size_t q = ep;
      while ((q = clear.find("dup ", q)) != std::string::npos && q < end) {
        int code = atoi(clear.c_str() + q + 4);
        size_t sl = clear.find('/', q);
        if (sl == std::string::npos || sl > end) break;
        size_t se = sl + 1;
        while (se < clear.size() && !isspace((unsigned char)clear[se]))
          se++;
        if (code >= 0 && code < 256)
          builtin_enc[code] = clear.substr(sl + 1, se - sl - 1);
        q = se;
      }
    }
    // binary entries: "<prefix> <len> <RDtoken> <len bytes>"
    auto read_entries = [&](size_t start, size_t stop,
                            const char* intro,
                            std::function<void(const std::string&,
                                               std::string)> emit) {
      size_t p = start;
      while (p < stop) {
        size_t ip = dec.find(intro, p);
        if (ip == std::string::npos || ip >= stop) break;
        p = ip + strlen(intro);
        // key: for CharStrings "/name", for Subrs the index after "dup "
        std::string key;
        if (intro[0] == '/') {
          size_t ke = p;
          while (ke < stop && !isspace((unsigned char)dec[ke])) ke++;
          key = dec.substr(p, ke - p);
          p = ke;
        } else {
          while (p < stop && isspace((unsigned char)dec[p])) p++;
          size_t ke = p;
          while (ke < stop && isdigit((unsigned char)dec[ke])) ke++;
          key = dec.substr(p, ke - p);
          p = ke;
        }
        while (p < stop && isspace((unsigned char)dec[p])) p++;
        if (p >= stop || !isdigit((unsigned char)dec[p])) continue;
        long len = atol(dec.c_str() + p);
        while (p < stop && isdigit((unsigned char)dec[p])) p++;
        while (p < stop && isspace((unsigned char)dec[p])) p++;
        // RD token (RD or -|), then exactly one space, then the bytes
        while (p < stop && !isspace((unsigned char)dec[p])) p++;
        p++;  // the single separator space
        if (len < 0 || p + (size_t)len > stop) break;
        emit(key, decrypt(dec.substr(p, len), 4330, leniv));
        p += len;
      }
    };
    size_t sp = dec.find("/Subrs");
    size_t cp = dec.find("/CharStrings");
    if (sp != std::string::npos) {
      int n = atoi(dec.c_str() + sp + 6);
      subrs.assign(std::max(0, n), "");
      read_entries(sp, cp == std::string::npos ? dec.size() : cp, "dup ",
                   [&](const std::string& k, std::string v) {
                     int i = atoi(k.c_str());
                     if (i >= 0 && i < (int)subrs.size())
                       subrs[i] = std::move(v);
                   });
    }
    if (cp == std::string::npos) return;
    read_entries(cp + 12, dec.size(), "/",
                 [&](const std::string& k, std::string v) {
                   if (k.empty() || name2gid.count(k)) return;
                   name2gid[k] = (int)names.size();
                   names.push_back(k);
                   charstrings.push_back(std::move(v));
                 });
    ok = !charstrings.empty();
  }

  struct T1 {
    std::vector<double> st;   // charstring stack
    std::vector<double> ps;   // PostScript interpreter stack (othersubrs)
    double x = 0, y = 0;
    bool flex = false;
    std::vector<std::pair<double, double>> flex_pts;
    std::vector<std::vector<std::pair<double, double>>>* out = nullptr;
    std::vector<std::pair<double, double>> cur;
    bool stopped = false;
    double seac[5] = {0};
    bool has_seac = false;
  };

  void t1_moveto(T1& c, double nx, double ny) const {
    if (c.flex) {
      c.x = nx; c.y = ny;
      c.flex_pts.push_back({nx, ny});
      return;
    }
    if (c.cur.size() >= 2) c.out->push_back(std::move(c.cur));
    c.cur.clear();
    c.x = nx; c.y = ny;
    c.cur.push_back({nx, ny});
  }
  void t1_lineto(T1& c, double nx, double ny) const {
    c.x = nx; c.y = ny;
    c.cur.push_back({nx, ny});
  }
  void t1_curveto(T1& c, double x1, double y1, double x2, double y2,
                  double x3, double y3) const {
    const int N = 8;
    double x0 = c.x, y0 = c.y;
    for (int i = 1; i <= N; i++) {
      double t = (double)i / N, u = 1 - t;
      c.cur.push_back({u * u * u * x0 + 3 * u * u * t * x1 +
                           3 * u * t * t * x2 + t * t * t * x3,
                       u * u * u * y0 + 3 * u * u * t * y1 +
                           3 * u * t * t * y2 + t * t * t * y3});
    }
    c.x = x3; c.y = y3;
  }

  bool t1_run(const std::string& cs, T1& c, int depth) const {
    if (depth > 10) return false;
    size_t p = 0;
    while (p < cs.size() && !c.stopped) {
      uint8_t b0 = cs[p];
      if (b0 >= 32 && b0 <= 246) { c.st.push_back((int)b0 - 139); p += 1; }
      else if (b0 >= 247 && b0 <= 250) {
        c.st.push_back((b0 - 247) * 256 + (uint8_t)cs[p + 1] + 108);
        p += 2;
      } else if (b0 >= 251 && b0 <= 254) {
        c.st.push_back(-((int)(b0 - 251) * 256) - (uint8_t)cs[p + 1] - 108);
        p += 2;
      } else if (b0 == 255) {  // Type1: plain 32-bit integer
        if (p + 5 > cs.size()) break;
        int32_t v = ((uint8_t)cs[p + 1] << 24) | ((uint8_t)cs[p + 2] << 16) |
                    ((uint8_t)cs[p + 3] << 8) | (uint8_t)cs[p + 4];
        c.st.push_back(v);
        p += 5;
      } else {
        p += 1;
        switch (b0) {
          case 13:  // hsbw: sbx wx
            if (c.st.size() >= 2) { c.x = c.st[0]; c.y = 0; }
            c.st.clear();
            break;
          case 9:  // closepath
            if (c.cur.size() >= 2) c.out->push_back(c.cur);
            // keep the current point: Type1 allows a following rmoveto
            if (!c.cur.empty()) {
              auto keep = c.cur.front();
              c.cur.clear();
              (void)keep;
            }
            c.st.clear();
            break;
          case 1: case 3:  // hstem / vstem
            c.st.clear();
            break;
          case 21:  // rmoveto
            if (c.st.size() >= 2)
              t1_moveto(c, c.x + c.st[c.st.size() - 2],
                        c.y + c.st[c.st.size() - 1]);
            c.st.clear();
            break;
          case 22:  // hmoveto
            if (!c.st.empty()) t1_moveto(c, c.x + c.st.back(), c.y);
            c.st.clear();
            break;
          case 4:  // vmoveto
            if (!c.st.empty()) t1_moveto(c, c.x, c.y + c.st.back());
            c.st.clear();
            break;
          case 5:  // rlineto
            if (c.st.size() >= 2)
              t1_lineto(c, c.x + c.st[0], c.y + c.st[1]);
            c.st.clear();
            break;
          case 6:  // hlineto (single segment in Type1)
            if (!c.st.empty()) t1_lineto(c, c.x + c.st[0], c.y);
            c.st.clear();
            break;
          case 7:  // vlineto
            if (!c.st.empty()) t1_lineto(c, c.x, c.y + c.st[0]);
            c.st.clear();
            break;
          case 8:  // rrcurveto
            if (c.st.size() >= 6)
              t1_curveto(c, c.x + c.st[0], c.y + c.st[1],
                         c.x + c.st[0] + c.st[2], c.y + c.st[1] + c.st[3],
                         c.x + c.st[0] + c.st[2] + c.st[4],
                         c.y + c.st[1] + c.st[3] + c.st[5]);
            c.st.clear();
            break;
          case 30:  // vhcurveto: dy1 dx2 dy2 dx3
            if (c.st.size() >= 4)
              t1_curveto(c, c.x, c.y + c.st[0],
                         c.x + c.st[1], c.y + c.st[0] + c.st[2],
                         c.x + c.st[1] + c.st[3], c.y + c.st[0] + c.st[2]);
            c.st.clear();
            break;
          case 31:  // hvcurveto: dx1 dx2 dy2 dy3
            if (c.st.size() >= 4)
              t1_curveto(c, c.x + c.st[0], c.y,
                         c.x + c.st[0] + c.st[1], c.y + c.st[2],
                         c.x + c.st[0] + c.st[1], c.y + c.st[2] + c.st[3]);
            c.st.clear();
            break;
          case 10: {  // callsubr (no bias in Type1)
            if (c.st.empty()) break;
            int i = (int)c.st.back();
            c.st.pop_back();
            if (i >= 0 && i < (int)subrs.size())
              t1_run(subrs[i], c, depth + 1);
            break;
          }
          case 11:
            return true;
          case 14:  // endchar
            if (c.cur.size() >= 2) c.out->push_back(std::move(c.cur));
            c.cur.clear();
            c.stopped = true;
            return true;
          case 12: {  // escape
            uint8_t b1 = p < cs.size() ? cs[p] : 0;
            p += 1;
            switch (b1) {
              case 0: case 1: case 2:  // dotsection / vstem3 / hstem3
                c.st.clear();
                break;
              case 6:  // seac: asb adx ady bchar achar
                if (c.st.size() >= 5) {
                  for (int i = 0; i < 5; i++) c.seac[i] = c.st[i];
                  c.has_seac = true;
                  c.stopped = true;
                }
                c.st.clear();
                return true;
              case 7:  // sbw: sbx sby wx wy
                if (c.st.size() >= 2) { c.x = c.st[0]; c.y = c.st[1]; }
                c.st.clear();
                break;
              case 12: {  // div
                if (c.st.size() >= 2) {
                  double b = c.st.back(); c.st.pop_back();
                  double a = c.st.back(); c.st.pop_back();
                  c.st.push_back(b != 0 ? a / b : 0);
                }
                break;
              }
              case 16: {  // callothersubr
                if (c.st.size() < 2) { c.st.clear(); break; }
                int idx = (int)c.st.back(); c.st.pop_back();
                int n = (int)c.st.back(); c.st.pop_back();
                if (idx == 1) {  // begin flex
                  c.flex = true;
                  c.flex_pts.clear();
                } else if (idx == 2) {
                  // each flex point already collected via rmoveto
                } else if (idx == 0) {  // end flex
                  c.flex = false;
                  if (c.flex_pts.size() >= 7) {
                    auto& P = c.flex_pts;
                    // P[0] is the reference point; P[1..6] are the two
                    // curves' controls/endpoints
                    double sx = c.cur.empty() ? P[1].first : c.cur.back().first;
                    double sy = c.cur.empty() ? P[1].second : c.cur.back().second;
                    c.x = sx; c.y = sy;
                    t1_curveto(c, P[1].first, P[1].second, P[2].first,
                               P[2].second, P[3].first, P[3].second);
                    t1_curveto(c, P[4].first, P[4].second, P[5].first,
                               P[5].second, P[6].first, P[6].second);
                    c.ps.push_back(P[6].second);  // y for the pops
                    c.ps.push_back(P[6].first);   // x (popped first)
                  }
                } else if (idx == 3) {  // hint replacement
                  c.ps.push_back(3);
                  for (int k = 0; k < n && !c.st.empty(); k++)
                    c.st.pop_back();
                } else {
                  for (int k = 0; k < n && !c.st.empty(); k++)
                    c.st.pop_back();
                }
                break;
              }
              case 17:  // pop: PS stack -> charstring stack
                if (!c.ps.empty()) {
                  c.st.push_back(c.ps.back());
                  c.ps.pop_back();
                } else {
                  c.st.push_back(0);
                }
                break;
              case 33:  // setcurrentpoint
                if (c.st.size() >= 2) { c.x = c.st[0]; c.y = c.st[1]; }
                c.st.clear();
                break;
              default:
                c.st.clear();
                break;
            }
            break;
          }
          default:
            c.st.clear();
            break;
        }
      }
      if (c.st.size() > 48) c.st.clear();
    }
    return true;
  }

  // contours in font units; seac composes base + accent recursively
  bool outline(int gid,
               std::vector<std::vector<std::pair<double, double>>>& out,
               int depth = 0) const {
    if (gid < 0 || gid >= (int)charstrings.size() || depth > 3) return false;
    T1 c;
    c.out = &out;
    t1_run(charstrings[gid], c, 0);
    if (c.cur.size() >= 2) out.push_back(std::move(c.cur));
    if (c.has_seac) {
      // asb adx ady bchar achar: compose standard-encoding glyphs
      auto find = [&](int code) {
        auto it = name2gid.find(std_enc_name(code));
        return it != name2gid.end() ? it->second : -1;
      };
      int bg = find((int)c.seac[3]), ag = find((int)c.seac[4]);
      if (bg >= 0) outline(bg, out, depth + 1);
      if (ag >= 0) {
        std::vector<std::vector<std::pair<double, double>>> acc;
        outline(ag, acc, depth + 1);
        double dx = c.seac[1] - c.seac[0], dy = c.seac[2];
        for (auto& cont : acc) {
          for (auto& pt : cont) { pt.first += dx; pt.second += dy; }
          out.push_back(std::move(cont));
        }
      }
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// Antialiased scanline polygon fill (nonzero / even-odd winding)
//
// The raster backbone for real glyph outlines AND general vector paths
// (m/l/c..f) - the poppler fidelity role. 4 sub-scanlines per pixel row,
// fractional x-coverage at span ends, coverage-blended into the canvas.
// ---------------------------------------------------------------------------

struct PathFiller {
  struct Edge { double x0, y0, x1, y1; int w; };  // w: +1 down, -1 up
  std::vector<Edge> edges;
  double min_y = 1e30, max_y = -1e30;

  void add_contour(const std::vector<std::pair<double, double>>& pts) {
    size_t n = pts.size();
    if (n < 2) return;
    for (size_t i = 0; i < n; i++) {
      auto& a = pts[i];
      auto& b = pts[(i + 1) % n];
      if (a.second == b.second) continue;
      Edge e;
      if (a.second < b.second) e = {a.first, a.second, b.first, b.second, 1};
      else e = {b.first, b.second, a.first, a.second, -1};
      edges.push_back(e);
      min_y = std::min(min_y, e.y0);
      max_y = std::max(max_y, e.y1);
    }
  }

  // blend into canvas rgb with per-pixel coverage
  void fill(Canvas& cv, const double* rgb, bool evenodd) {
    if (edges.empty() || !cv.w || !cv.h) return;
    int y_lo = std::max(0, (int)std::floor(min_y));
    int y_hi = std::min(cv.h - 1, (int)std::ceil(max_y));
    if (y_lo > y_hi) return;
    std::vector<double> cov((size_t)cv.w);
    std::vector<std::pair<double, int>> xs;  // crossing x, winding
    const int SS = 4;
    uint8_t cr = (uint8_t)std::lround(rgb[0] * 255),
            cg = (uint8_t)std::lround(rgb[1] * 255),
            cb = (uint8_t)std::lround(rgb[2] * 255);
    for (int y = y_lo; y <= y_hi; y++) {
      std::fill(cov.begin(), cov.end(), 0.0);
      bool any = false;
      for (int s = 0; s < SS; s++) {
        double sy = y + (s + 0.5) / SS;
        xs.clear();
        for (auto& e : edges) {
          if (sy < e.y0 || sy >= e.y1) continue;
          double t = (sy - e.y0) / (e.y1 - e.y0);
          xs.push_back({e.x0 + t * (e.x1 - e.x0), e.w});
        }
        if (xs.size() < 2) continue;
        std::sort(xs.begin(), xs.end());
        int wind = 0;
        for (size_t i = 0; i + 1 < xs.size(); i++) {
          wind += xs[i].second;
          bool inside = evenodd ? ((i % 2) == 0) : (wind != 0);
          if (!inside) continue;
          double xa = std::max(0.0, xs[i].first);
          double xb = std::min((double)cv.w, xs[i + 1].first);
          if (xb <= xa) continue;
          any = true;
          int ia = (int)std::floor(xa), ib = (int)std::floor(xb);
          if (ia == ib) {
            cov[ia] += (xb - xa) / SS;
          } else {
            cov[ia] += (ia + 1 - xa) / SS;
            for (int x = ia + 1; x < ib; x++) cov[x] += 1.0 / SS;
            if (ib < cv.w) cov[ib] += (xb - ib) / SS;
          }
        }
      }
      if (!any) continue;
      size_t row = (size_t)y * cv.w * 3;
      for (int x = 0; x < cv.w; x++) {
        double a = std::min(1.0, cov[x]);
        if (a <= 0.003) continue;
        uint8_t* px = &cv.rgb[row + 3 * (size_t)x];
        px[0] = (uint8_t)std::lround(px[0] * (1 - a) + cr * a);
        px[1] = (uint8_t)std::lround(px[1] * (1 - a) + cg * a);
        px[2] = (uint8_t)std::lround(px[2] * (1 - a) + cb * a);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Font resources
//
// Per-/Font decode + render model (the pypdfium text role, reference
// functions.py:22, and the poppler raster role, functions.py:678-713):
//  - simple fonts (Type1/TrueType): /Encoding base + /Differences glyph
//    names, /Widths + /FirstChar advances, optional /ToUnicode CMap;
//  - Type0/Identity-H composites (pdfTeX/Word/matplotlib-42 mainstream):
//    2-byte codes = CIDs, /W widths, CIDToGIDMap, /ToUnicode;
//  - Type3: /CharProcs content streams under /FontMatrix (matplotlib's
//    default pdf.fonttype=3), names decoded via the AGL table.
// Embedded TrueType programs (/FontFile2) and CFF programs (/FontFile3:
// Type1C / CIDFontType0C / OpenType) provide glyph-faithful raster;
// raw Type1 programs (/FontFile) fall back to the atlas (layout stays
// exact: advances come from /Widths, not the atlas).
// ---------------------------------------------------------------------------

struct FontRes {
  enum Kind { kSimple, kType0, kType3 } kind = kSimple;
  bool two_byte = false;
  std::map<long, std::string> to_unicode;  // authoritative when present
  int code_unicode[256];                   // simple-font fallback decode
  std::string code_glyphname[256];         // Differences names (T3 + TT)
  std::map<long, double> widths;           // code/CID -> advance, text units
  double default_width = 0.5;
  std::shared_ptr<TrueTypeFont> tt;
  std::shared_ptr<CffFont> cff;            // FontFile3 (Type1C/CID/OpenType)
  std::shared_ptr<Type1Font> t1;           // FontFile (raw Type1)
  std::string cid_to_gid;                  // raw 2-byte map; empty=identity
  ObjPtr char_procs, t3_res;               // Type3
  double fm[6] = {0.001, 0, 0, 0.001, 0, 0};  // Type3 FontMatrix

  FontRes() {
    for (int i = 0; i < 256; i++)
      code_unicode[i] = (i >= 32 && i < 127) ? i
                        : (i >= 128 ? (kWinAnsiHigh[i - 128] ? kWinAnsiHigh[i - 128] : -1)
                                    : -1);
  }

  std::string unicode_for(long code) const {
    auto it = to_unicode.find(code);
    if (it != to_unicode.end()) return it->second;
    std::string out;
    if (!two_byte && code >= 0 && code < 256) {
      if (!code_glyphname[code].empty()) {
        int cp = glyph_name_to_unicode(code_glyphname[code]);
        if (cp >= 0) { utf8_append(out, cp); return out; }
        return out;  // named glyph with unknown unicode: drop, not garbage
      }
      if (code_unicode[code] >= 0) utf8_append(out, code_unicode[code]);
    }
    return out;
  }

  double advance_for(long code) const {
    auto it = widths.find(code);
    if (it != widths.end()) return it->second;
    return default_width;
  }

  int gid_for(long code, const std::string& unicode) const {
    if (t1) {
      // raw Type1: /Differences name, then the font's built-in
      // encoding, then standard-encoding-by-code
      if (code >= 0 && code < 256 && !code_glyphname[code].empty()) {
        auto it = t1->name2gid.find(code_glyphname[code]);
        if (it != t1->name2gid.end()) return it->second;
      }
      auto ie = t1->builtin_enc.find((int)code);
      if (ie != t1->builtin_enc.end()) {
        auto it = t1->name2gid.find(ie->second);
        if (it != t1->name2gid.end()) return it->second;
      }
      auto it = t1->name2gid.find(std_enc_name((int)code));
      if (it != t1->name2gid.end()) return it->second;
      return -1;  // 0 is a real gid for Type1 (no reserved .notdef slot)
    }
    if (cff) {
      if (kind == kType0) {
        // CIDFontType0: CID -> GID through the CFF charset (the
        // CIDToGIDMap entry applies only to CIDFontType2, PDF 9.7.4.2)
        if (cff->is_cid) {
          auto it = cff->cid2gid.find((uint32_t)code);
          return it != cff->cid2gid.end() ? it->second : 0;
        }
        return code >= 0 && code < (long)cff->nglyphs() ? (int)code : 0;
      }
      // simple Type1C: /Differences glyph name wins, then the font's
      // built-in encoding, then standard-encoding-by-code
      if (code >= 0 && code < 256 && !code_glyphname[code].empty()) {
        auto it = cff->name2gid.find(code_glyphname[code]);
        if (it != cff->name2gid.end()) return it->second;
      }
      auto ic = cff->code2gid.find((int)code);
      if (ic != cff->code2gid.end()) return ic->second;
      return 0;
    }
    if (!tt) return 0;
    if (kind == kType0) {
      long cid = code;
      if (!cid_to_gid.empty()) {
        size_t o = 2 * (size_t)cid;
        if (o + 1 < cid_to_gid.size())
          return ((uint8_t)cid_to_gid[o] << 8) | (uint8_t)cid_to_gid[o + 1];
        return 0;
      }
      return (int)cid;  // Identity
    }
    // simple TrueType: prefer the unicode the encoding names
    if (!unicode.empty()) {
      // first cp of the utf8 string
      uint32_t cp = (uint8_t)unicode[0];
      if (cp >= 0xF0 && unicode.size() >= 4)
        cp = ((cp & 7) << 18) | (((uint8_t)unicode[1] & 0x3F) << 12) |
             (((uint8_t)unicode[2] & 0x3F) << 6) | ((uint8_t)unicode[3] & 0x3F);
      else if (cp >= 0xE0 && unicode.size() >= 3)
        cp = ((cp & 15) << 12) | (((uint8_t)unicode[1] & 0x3F) << 6) |
             ((uint8_t)unicode[2] & 0x3F);
      else if (cp >= 0xC0 && unicode.size() >= 2)
        cp = ((cp & 31) << 6) | ((uint8_t)unicode[1] & 0x3F);
      int g = tt->gid_for_unicode(cp);
      if (g) return g;
    }
    int g = tt->gid_for_unicode((uint32_t)code);
    if (g) return g;
    if (tt->cmap.empty() && code < tt->num_glyphs) return (int)code;
    return 0;
  }
};

static std::shared_ptr<FontRes> build_font(Document& doc, const ObjPtr& f) {
  auto fr = std::make_shared<FontRes>();
  ObjPtr st = doc.dget(f, "Subtype");
  std::string subtype = st->is(Obj::Name) ? st->str : "";
  ObjPtr tu = doc.dget(f, "ToUnicode");
  if (tu->is(Obj::Stream)) parse_tounicode(doc.stream_bytes(tu), fr->to_unicode);

  auto load_fontfile2 = [&](const ObjPtr& descr) {
    ObjPtr ff2 = doc.dget(descr, "FontFile2");
    if (ff2->is(Obj::Stream)) {
      auto tt = std::make_shared<TrueTypeFont>();
      tt->parse(doc.stream_bytes(ff2));
      if (tt->ok) fr->tt = tt;
    }
    // FontFile3: CFF programs (Subtype Type1C / CIDFontType0C /
    // OpenType); pdfTeX's Type1 embeds arrive compacted to Type1C
    ObjPtr ff3 = doc.dget(descr, "FontFile3");
    if (!fr->tt && ff3->is(Obj::Stream)) {
      auto cf = std::make_shared<CffFont>();
      cf->parse(doc.stream_bytes(ff3));
      if (cf->ok) fr->cff = cf;
    }
    // FontFile: raw Type1 programs (dvips-era producers)
    ObjPtr ff1 = doc.dget(descr, "FontFile");
    if (!fr->tt && !fr->cff && ff1->is(Obj::Stream)) {
      auto t1 = std::make_shared<Type1Font>();
      t1->parse(doc.stream_bytes(ff1));
      if (t1->ok) {
        fr->t1 = t1;
        // the font's built-in encoding improves text decode when the
        // PDF carries no /Differences (glyph names resolve via AGL)
        for (auto& kv : t1->builtin_enc)
          if (kv.first >= 0 && kv.first < 256 &&
              fr->code_glyphname[kv.first].empty() &&
              kv.second != ".notdef")
            fr->code_glyphname[kv.first] = kv.second;
      }
    }
  };

  if (subtype == "Type0") {
    fr->kind = FontRes::kType0;
    fr->two_byte = true;  // Identity-H/V and CMap-encoded both use 2-byte
    fr->default_width = 1.0;
    ObjPtr desc = doc.dget(f, "DescendantFonts");
    ObjPtr cid = desc->is(Obj::Arr) && !desc->arr.empty()
                     ? doc.resolve(desc->arr[0]) : mk(Obj::Null);
    double dw = doc.dget(cid, "DW")->as_num(1000.0);
    fr->default_width = dw / 1000.0;
    ObjPtr W = doc.dget(cid, "W");
    if (W->is(Obj::Arr)) {
      size_t i = 0;
      while (i < W->arr.size()) {
        long c0 = (long)doc.resolve(W->arr[i])->as_num();
        if (i + 1 >= W->arr.size()) break;
        ObjPtr nxt = doc.resolve(W->arr[i + 1]);
        if (nxt->is(Obj::Arr)) {
          for (size_t k = 0; k < nxt->arr.size(); k++)
            fr->widths[c0 + (long)k] =
                doc.resolve(nxt->arr[k])->as_num() / 1000.0;
          i += 2;
        } else {
          if (i + 2 >= W->arr.size()) break;
          long c1 = (long)nxt->as_num();
          double w = doc.resolve(W->arr[i + 2])->as_num() / 1000.0;
          if (c1 - c0 <= 65535)
            for (long c = c0; c <= c1; c++) fr->widths[c] = w;
          i += 3;
        }
      }
    }
    ObjPtr c2g = doc.dget(cid, "CIDToGIDMap");
    if (c2g->is(Obj::Stream)) fr->cid_to_gid = doc.stream_bytes(c2g);
    load_fontfile2(doc.dget(cid, "FontDescriptor"));
    return fr;
  }

  if (subtype == "Type3") {
    fr->kind = FontRes::kType3;
    fr->char_procs = doc.dget(f, "CharProcs");
    fr->t3_res = doc.dget(f, "Resources");
    ObjPtr m = doc.dget(f, "FontMatrix");
    if (m->is(Obj::Arr) && m->arr.size() == 6)
      for (int i = 0; i < 6; i++) fr->fm[i] = doc.resolve(m->arr[i])->as_num();
  }

  // simple (Type1 / TrueType) + the Type3 encoding/width path
  int first = (int)doc.dget(f, "FirstChar")->as_num(0);
  ObjPtr w = doc.dget(f, "Widths");
  if (w->is(Obj::Arr)) {
    double unit = fr->kind == FontRes::kType3 ? 1000.0 * fr->fm[0] : 1.0;
    for (size_t i = 0; i < w->arr.size(); i++) {
      double ww = doc.resolve(w->arr[i])->as_num() / 1000.0 * unit;
      if (ww > 0) fr->widths[first + (long)i] = ww;
    }
  }
  ObjPtr enc = doc.dget(f, "Encoding");
  if (enc->is(Obj::Name)) {
    // base encodings agree with the built-in table on ASCII; WinAnsi high
    // range is the constructor default already
  } else if (enc->is(Obj::Dict)) {
    ObjPtr diff = doc.dget(enc, "Differences");
    if (diff->is(Obj::Arr)) {
      int code = 0;
      for (auto& el : diff->arr) {
        ObjPtr r = doc.resolve(el);
        if (r->is(Obj::Num)) code = (int)r->num;
        else if (r->is(Obj::Name) && code >= 0 && code < 256)
          fr->code_glyphname[code++] = r->str;
      }
    }
  }
  load_fontfile2(doc.dget(f, "FontDescriptor"));
  return fr;
}

static std::shared_ptr<FontRes> get_font(Document& doc,
                                         const ObjPtr& resources,
                                         const std::string& name) {
  ObjPtr fonts = doc.dget(resources, "Font");
  ObjPtr f = doc.dget(fonts, name);
  if (!f->is(Obj::Dict) && !f->is(Obj::Stream)) return nullptr;
  auto it = doc.font_cache.find(f.get());
  if (it != doc.font_cache.end())
    return std::static_pointer_cast<FontRes>(it->second);
  auto fr = build_font(doc, f);
  doc.font_cache[f.get()] = fr;
  return fr;
}

// ---------------------------------------------------------------------------
// Content-stream interpreter: raster + text extraction
// ---------------------------------------------------------------------------

struct Mat {
  // [a b 0; c d 0; e f 1]
  double a = 1, b = 0, c = 0, d = 1, e = 0, f = 0;
  static Mat mul(const Mat& m, const Mat& n) {
    Mat r;
    r.a = m.a * n.a + m.b * n.c;
    r.b = m.a * n.b + m.b * n.d;
    r.c = m.c * n.a + m.d * n.c;
    r.d = m.c * n.b + m.d * n.d;
    r.e = m.e * n.a + m.f * n.c + n.e;
    r.f = m.e * n.b + m.f * n.d + n.f;
    return r;
  }
  void apply(double x, double y, double& ox, double& oy) const {
    ox = a * x + c * y + e;
    oy = b * x + d * y + f;
  }
};

struct TextRun {
  double x, y, size;
  std::string text;
  double x_end = 0;  // estimated advance end (text-join heuristics)
};

struct ExtractedImage {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;
  double x0 = 0, y0 = 0, x1 = 0, y1 = 0;  // device-space bbox at scale
};

struct PageRender {
  Document* doc;
  ObjPtr page;
  double scale;        // device pixels per PDF unit
  double mb[4] = {0, 0, 612, 792};
  Canvas canvas;
  std::vector<TextRun> runs;
  std::vector<ExtractedImage> images;
  // ruled lines (table borders / booktabs rules): near-axis-aligned stroked
  // segments and thin filled rects, in page units, y-down (like runs) -
  // second structure signal for the table detector (ingest/tables.py)
  std::vector<std::array<double, 4>> rules;
  bool raster = true;
  bool collect_images = false;
  bool collect_rules = false;

  void add_rule(double x0, double y0, double x1, double y1) {
    if (x1 < x0) { std::swap(x0, x1); std::swap(y0, y1); }
    double dx = std::abs(x1 - x0), dy = std::abs(y1 - y0);
    if ((dx > 1.5 && dy > 1.5) || (dx < 2.0 && dy < 2.0)) return;
    rules.push_back({x0 / scale, y0 / scale, x1 / scale, y1 / scale});
  }

  void load_mediabox() {
    ObjPtr m = doc->dget(page, "MediaBox");
    if (m->is(Obj::Arr) && m->arr.size() == 4)
      for (int i = 0; i < 4; i++) mb[i] = doc->resolve(m->arr[i])->as_num();
  }

  // PDF y-up -> canvas y-down
  void dev(const Mat& ctm, double x, double y, double& px, double& py) {
    double ux, uy;
    ctm.apply(x, y, ux, uy);
    px = (ux - mb[0]) * scale;
    py = (mb[3] - uy) * scale;
  }

  void run() {
    load_mediabox();
    if (raster) {
      canvas.init((int)std::lround((mb[2] - mb[0]) * scale),
                  (int)std::lround((mb[3] - mb[1]) * scale));
    }
    std::string content;
    ObjPtr c = doc->dget(page, "Contents");
    if (c->is(Obj::Stream)) content = doc->stream_bytes(c);
    else if (c->is(Obj::Arr)) {
      for (auto& x : c->arr) {
        ObjPtr s = doc->resolve(x);
        if (s->is(Obj::Stream)) { content += doc->stream_bytes(s); content += "\n"; }
      }
    }
    interpret(content, doc->dget(page, "Resources"), 0);
  }

  void interpret(const std::string& content, ObjPtr resources, int depth,
                 const Mat* init_ctm = nullptr,
                 const double* init_rgb = nullptr) {
    if (depth > 8) return;
    std::vector<ObjPtr> stack;
    struct GS {
      Mat ctm;
      std::shared_ptr<FontRes> font;
      double lw;
      double fill[3], stroke[3];
    };
    std::vector<GS> gs_stack;
    Mat ctm;  // identity: PDF units
    if (init_ctm) ctm = *init_ctm;
    Mat tm, tlm;
    double tfs = 12, leading = 0, char_spacing = 0, word_spacing = 0, tz = 100;
    double fill_rgb[3] = {0, 0, 0};
    double stroke_rgb[3] = {0, 0, 0};
    double line_w = 1.0;
    if (init_rgb) for (int i = 0; i < 3; i++) fill_rgb[i] = init_rgb[i];
    std::shared_ptr<FontRes> font;  // current /Font resource (Tf)
    bool in_text = false;
    (void)in_text;
    // current path (m/l segments, device coords) for stroked-rule capture
    double path_cur_x = 0, path_cur_y = 0;
    bool path_has_cur = false;
    std::vector<std::array<double, 4>> path_segs;
    // general vector path (device coords) for filled/stroked raster -
    // glyph-faithful Type3 charprocs and figure graphics ride this
    std::vector<std::vector<std::pair<double, double>>> path_polys;
    auto poly_start = [&](double px, double py) {
      path_polys.push_back({{px, py}});
    };
    auto poly_line = [&](double px, double py) {
      if (path_polys.empty()) path_polys.push_back({});
      path_polys.back().push_back({px, py});
    };
    auto path_clear = [&]() {
      pending_rects.clear();
      path_segs.clear();
      path_polys.clear();
      path_has_cur = false;
    };
    auto fill_polys = [&](bool evenodd) {
      if (!raster || path_polys.empty()) return;
      if (getenv("MMPDF_DEBUG")) {
        double x0=1e30,y0=1e30,x1=-1e30,y1=-1e30; size_t np=0;
        for (auto& c : path_polys) for (auto& p : c) {
          x0=std::min(x0,p.first); x1=std::max(x1,p.first);
          y0=std::min(y0,p.second); y1=std::max(y1,p.second); np++;
        }
        fprintf(stderr, "[fill] rgb=%.2f,%.2f,%.2f eo=%d polys=%zu pts=%zu bbox=(%.0f,%.0f)-(%.0f,%.0f) depth=%d\n",
                fill_rgb[0], fill_rgb[1], fill_rgb[2], (int)evenodd,
                path_polys.size(), np, x0, y0, x1, y1, depth);
      }
      PathFiller pf;
      for (auto& c : path_polys) pf.add_contour(c);
      pf.fill(canvas, fill_rgb, evenodd);
    };
    auto stroke_polys = [&]() {
      if (!raster || path_polys.empty()) return;
      // stroke = fill a quad per segment (no joins/caps - figure lines
      // and rules don't need them at 144 DPI)
      double sw = std::abs(ctm.a);
      double hw = std::max(0.5, 0.5 * line_w * sw * scale);
      PathFiller pf;
      for (auto& c : path_polys) {
        for (size_t i = 0; i + 1 < c.size(); i++) {
          double dx = c[i + 1].first - c[i].first;
          double dy = c[i + 1].second - c[i].second;
          double len = std::sqrt(dx * dx + dy * dy);
          if (len < 1e-9) continue;
          double nx = -dy / len * hw, ny = dx / len * hw;
          // consistently wound so overlapping quads at joins reinforce
          // (mixed winding would cancel under the nonzero rule)
          std::vector<std::pair<double, double>> quad = {
              {c[i].first + nx, c[i].second + ny},
              {c[i + 1].first + nx, c[i + 1].second + ny},
              {c[i + 1].first - nx, c[i + 1].second - ny},
              {c[i].first - nx, c[i].second - ny}};
          double area = 0;
          for (size_t k = 0; k < 4; k++) {
            auto& p0 = quad[k];
            auto& p1 = quad[(k + 1) % 4];
            area += p0.first * p1.second - p1.first * p0.second;
          }
          if (area < 0) std::reverse(quad.begin(), quad.end());
          pf.add_contour(quad);
        }
      }
      // each quad is its own contour: even-odd would cancel overlaps at
      // joins, nonzero keeps them solid
      pf.fill(canvas, stroke_rgb, false);
    };

    Lexer lx((const uint8_t*)content.data(), content.size());
    Parser ps(lx);
    while (ps.lx.p < ps.lx.n) {
      ObjPtr o = ps.parse();
      if (o->is(Obj::Null) && ps.lx.p >= ps.lx.n) break;
      if (!o->is(Obj::Name) || o->str.empty() || o->slash) { stack.push_back(o); continue; }
      // bare non-slash token = operator
      const std::string& op = o->str;
      auto popn = [&](int k) -> std::vector<ObjPtr> {
        std::vector<ObjPtr> v;
        for (int i = 0; i < k && !stack.empty(); i++) { v.push_back(stack.back()); stack.pop_back(); }
        std::reverse(v.begin(), v.end());
        return v;
      };
      if (op == "q") {
        gs_stack.push_back({ctm, font, line_w,
                            {fill_rgb[0], fill_rgb[1], fill_rgb[2]},
                            {stroke_rgb[0], stroke_rgb[1], stroke_rgb[2]}});
      }
      else if (op == "Q") {
        if (!gs_stack.empty()) {
          const GS& g = gs_stack.back();
          ctm = g.ctm;
          font = g.font;
          line_w = g.lw;
          for (int i = 0; i < 3; i++) {
            fill_rgb[i] = g.fill[i];
            stroke_rgb[i] = g.stroke[i];
          }
          gs_stack.pop_back();
        }
      }
      else if (op == "cm") {
        auto v = popn(6);
        if (v.size() == 6) {
          Mat m;
          m.a = v[0]->as_num(); m.b = v[1]->as_num(); m.c = v[2]->as_num();
          m.d = v[3]->as_num(); m.e = v[4]->as_num(); m.f = v[5]->as_num();
          ctm = Mat::mul(m, ctm);
        }
      }
      else if (op == "BT") { tm = Mat(); tlm = Mat(); in_text = true; }
      else if (op == "ET") { in_text = false; }
      else if (op == "Tf") {
        auto v = popn(2);
        if (v.size() == 2) {
          tfs = v[1]->as_num(12);
          if (v[0]->is(Obj::Name))
            font = get_font(*doc, resources, v[0]->str);
        }
      }
      else if (op == "TL") { auto v = popn(1); if (!v.empty()) leading = v[0]->as_num(); }
      else if (op == "Tc") { auto v = popn(1); if (!v.empty()) char_spacing = v[0]->as_num(); }
      else if (op == "Tw") { auto v = popn(1); if (!v.empty()) word_spacing = v[0]->as_num(); }
      else if (op == "Tz") { auto v = popn(1); if (!v.empty()) tz = v[0]->as_num(100); }
      else if (op == "Td") {
        auto v = popn(2);
        if (v.size() == 2) {
          Mat m; m.e = v[0]->as_num(); m.f = v[1]->as_num();
          tlm = Mat::mul(m, tlm);
          tm = tlm;
        }
      }
      else if (op == "TD") {
        auto v = popn(2);
        if (v.size() == 2) {
          leading = -v[1]->as_num();
          Mat m; m.e = v[0]->as_num(); m.f = v[1]->as_num();
          tlm = Mat::mul(m, tlm);
          tm = tlm;
        }
      }
      else if (op == "Tm") {
        auto v = popn(6);
        if (v.size() == 6) {
          tlm.a = v[0]->as_num(); tlm.b = v[1]->as_num(); tlm.c = v[2]->as_num();
          tlm.d = v[3]->as_num(); tlm.e = v[4]->as_num(); tlm.f = v[5]->as_num();
          tm = tlm;
        }
      }
      else if (op == "T*") {
        Mat m; m.f = -leading;
        tlm = Mat::mul(m, tlm);
        tm = tlm;
      }
      else if (op == "Tj" || op == "'" || op == "\"") {
        if (op != "Tj") { Mat m; m.f = -leading; tlm = Mat::mul(m, tlm); tm = tlm; }
        auto v = popn(op == "\"" ? 3 : 1);
        if (!v.empty() && v.back()->is(Obj::Str))
          show_text(v.back()->str, ctm, tm, tfs, char_spacing, word_spacing,
                    tz, fill_rgb, font, resources, depth);
      }
      else if (op == "TJ") {
        auto v = popn(1);
        if (!v.empty() && v[0]->is(Obj::Arr)) {
          for (auto& el : v[0]->arr) {
            if (el->is(Obj::Str))
              show_text(el->str, ctm, tm, tfs, char_spacing, word_spacing,
                        tz, fill_rgb, font, resources, depth);
            else if (el->is(Obj::Num)) {
              Mat m; m.e = -el->num / 1000.0 * tfs * (tz / 100.0);
              tm = Mat::mul(m, tm);
            }
          }
        }
      }
      else if (op == "rg" || op == "sc" || op == "scn") {
        auto v = popn(3);
        if (v.size() == 3)
          for (int i = 0; i < 3; i++) fill_rgb[i] = v[i]->as_num();
      }
      else if (op == "RG" || op == "SC" || op == "SCN") {
        auto v = popn(3);
        if (v.size() == 3)
          for (int i = 0; i < 3; i++) stroke_rgb[i] = v[i]->as_num();
      }
      else if (op == "g") {
        auto v = popn(1);
        if (!v.empty()) fill_rgb[0] = fill_rgb[1] = fill_rgb[2] = v[0]->as_num();
      }
      else if (op == "G") {
        auto v = popn(1);
        if (!v.empty())
          stroke_rgb[0] = stroke_rgb[1] = stroke_rgb[2] = v[0]->as_num();
      }
      else if (op == "k" || op == "K") {
        auto v = popn(4);
        if (v.size() == 4) {
          double* t = op == "k" ? fill_rgb : stroke_rgb;
          for (int i = 0; i < 3; i++)
            t[i] = std::max(0.0, 1.0 - v[i]->as_num() - v[3]->as_num());
        }
      }
      else if (op == "w") {
        auto v = popn(1);
        if (!v.empty()) line_w = v[0]->as_num(1.0);
      }
      else if (op == "re") {
        auto v = popn(4);
        if (v.size() == 4) {
          pending_rects.push_back({v[0]->as_num(), v[1]->as_num(), v[2]->as_num(), v[3]->as_num()});
          double x = v[0]->as_num(), y = v[1]->as_num();
          double rw = v[2]->as_num(), rh = v[3]->as_num();
          double p0x, p0y, p1x, p1y, p2x, p2y, p3x, p3y;
          dev(ctm, x, y, p0x, p0y);
          dev(ctm, x + rw, y, p1x, p1y);
          dev(ctm, x + rw, y + rh, p2x, p2y);
          dev(ctm, x, y + rh, p3x, p3y);
          path_polys.push_back({{p0x, p0y}, {p1x, p1y}, {p2x, p2y}, {p3x, p3y}});
        }
      }
      else if (op == "m") {
        auto v = popn(2);
        if (v.size() == 2) {
          dev(ctm, v[0]->as_num(), v[1]->as_num(), path_cur_x, path_cur_y);
          path_has_cur = true;
          poly_start(path_cur_x, path_cur_y);
        }
      }
      else if (op == "l") {
        auto v = popn(2);
        if (v.size() == 2) {
          double px, py;
          dev(ctm, v[0]->as_num(), v[1]->as_num(), px, py);
          if (path_has_cur)
            path_segs.push_back({path_cur_x, path_cur_y, px, py});
          path_cur_x = px;
          path_cur_y = py;
          path_has_cur = true;
          poly_line(px, py);
        }
      }
      else if (op == "c" || op == "v" || op == "y") {
        auto v = popn(op == "c" ? 6 : 4);
        if ((op == "c" && v.size() == 6) || (op != "c" && v.size() == 4)) {
          // cubic bezier in user space: control points per op form,
          // flattened to 12 device-space segments
          double ux0 = 0, uy0 = 0;  // current point back in user space:
          // keep it simple - flatten in device space instead (the CTM is
          // affine, so the device-space bezier of mapped control points
          // equals the mapped bezier)
          (void)ux0; (void)uy0;
          double c1x, c1y, c2x, c2y, ex, ey;
          if (op == "c") {
            dev(ctm, v[0]->as_num(), v[1]->as_num(), c1x, c1y);
            dev(ctm, v[2]->as_num(), v[3]->as_num(), c2x, c2y);
            dev(ctm, v[4]->as_num(), v[5]->as_num(), ex, ey);
          } else if (op == "v") {
            c1x = path_cur_x; c1y = path_cur_y;
            dev(ctm, v[0]->as_num(), v[1]->as_num(), c2x, c2y);
            dev(ctm, v[2]->as_num(), v[3]->as_num(), ex, ey);
          } else {  // y
            dev(ctm, v[0]->as_num(), v[1]->as_num(), c1x, c1y);
            dev(ctm, v[2]->as_num(), v[3]->as_num(), ex, ey);
            c2x = ex; c2y = ey;
          }
          double sx = path_cur_x, sy = path_cur_y;
          const int N = 12;
          for (int i = 1; i <= N; i++) {
            double t = (double)i / N, u = 1 - t;
            double bx = u * u * u * sx + 3 * u * u * t * c1x +
                        3 * u * t * t * c2x + t * t * t * ex;
            double by = u * u * u * sy + 3 * u * u * t * c1y +
                        3 * u * t * t * c2y + t * t * t * ey;
            poly_line(bx, by);
          }
          path_cur_x = ex;
          path_cur_y = ey;
          path_has_cur = true;
        }
      }
      else if (op == "h") {
        if (!path_polys.empty() && path_polys.back().size() >= 2) {
          poly_line(path_polys.back().front().first,
                    path_polys.back().front().second);
          path_cur_x = path_polys.back().front().first;
          path_cur_y = path_polys.back().front().second;
        }
      }
      else if (op == "f" || op == "F" || op == "f*" || op == "b" || op == "B") {
        fill_polys(op == "f*");
        if (op == "b" || op == "B") stroke_polys();
        if (collect_rules) {
          // a THIN filled rect is a rule (the common \hline encoding)
          for (auto& r : pending_rects) {
            double ax, ay, bx, by;
            dev(ctm, r[0], r[1], ax, ay);
            dev(ctm, r[0] + r[2], r[1] + r[3], bx, by);
            double x0 = std::min(ax, bx), x1 = std::max(ax, bx);
            double y0 = std::min(ay, by), y1 = std::max(ay, by);
            if (y1 - y0 <= 2.5 * scale)
              add_rule(x0, 0.5 * (y0 + y1), x1, 0.5 * (y0 + y1));
            else if (x1 - x0 <= 2.5 * scale)
              add_rule(0.5 * (x0 + x1), y0, 0.5 * (x0 + x1), y1);
          }
        }
        path_clear();
      }
      else if (op == "S" || op == "s") {
        stroke_polys();
        if (collect_rules) {
          for (auto& sgm : path_segs) add_rule(sgm[0], sgm[1], sgm[2], sgm[3]);
          for (auto& r : pending_rects) {
            // stroked rect: its four edges are rules
            double ax, ay, bx, by;
            dev(ctm, r[0], r[1], ax, ay);
            dev(ctm, r[0] + r[2], r[1] + r[3], bx, by);
            add_rule(ax, ay, bx, ay);
            add_rule(ax, by, bx, by);
            add_rule(ax, ay, ax, by);
            add_rule(bx, ay, bx, by);
          }
        }
        path_clear();
      }
      else if (op == "W" || op == "W*") {
        // clipping unimplemented: keep the path pending so the following
        // path-paint op (usually n) clears it
      }
      else if (op == "n") {
        path_clear();
      }
      else if (op == "Do") {
        auto v = popn(1);
        if (!v.empty() && v[0]->is(Obj::Name)) {
          ObjPtr xobjs = doc->dget(resources, "XObject");
          ObjPtr xo = doc->dget(xobjs, v[0]->str);
          if (xo->is(Obj::Stream)) {
            ObjPtr st = doc->dget(xo, "Subtype");
            if (st->is(Obj::Name) && st->str == "Image") {
              if (raster || collect_images) draw_image(xo, ctm);
            } else if (st->is(Obj::Name) && st->str == "Form") {
              ObjPtr res2 = doc->dget(xo, "Resources");
              if (!res2->is(Obj::Dict)) res2 = resources;
              auto save = gs_stack;
              Mat savectm = ctm;
              ObjPtr mtx = doc->dget(xo, "Matrix");
              if (mtx->is(Obj::Arr) && mtx->arr.size() == 6) {
                Mat m;
                m.a = doc->resolve(mtx->arr[0])->as_num(); m.b = doc->resolve(mtx->arr[1])->as_num();
                m.c = doc->resolve(mtx->arr[2])->as_num(); m.d = doc->resolve(mtx->arr[3])->as_num();
                m.e = doc->resolve(mtx->arr[4])->as_num(); m.f = doc->resolve(mtx->arr[5])->as_num();
                ctm = Mat::mul(m, ctm);
              }
              // the form inherits the CURRENT graphics state: content is
              // interpreted under ctm (matplotlib draws its minus-sign
              // glyph as a form under a 0.01-scale cm - with a fresh
              // identity it would paint glyph units onto the page)
              interpret(doc->stream_bytes(xo), res2, depth + 1, &ctm,
                        fill_rgb);
              ctm = savectm;
              gs_stack = save;
            }
          }
        }
      }
      else {
        // unknown operator: clear operand stack (keeps us in sync)
        stack.clear();
      }
    }
  }

  std::vector<std::array<double, 4>> pending_rects;

  void show_text(const std::string& s, const Mat& ctm, Mat& tm, double tfs,
                 double cs, double ws, double tz, const double* rgb,
                 const std::shared_ptr<FontRes>& font,
                 const ObjPtr& resources, int depth) {
    // record run at current position
    Mat trm = Mat::mul(tm, ctm);
    double x0, y0;
    dev(trm, 0, 0, x0, y0);
    std::string decoded;
    size_t step = (font && font->two_byte) ? 2 : 1;
    for (size_t i = 0; i + step <= s.size(); i += step) {
      long code = step == 2
                      ? (((uint8_t)s[i] << 8) | (uint8_t)s[i + 1])
                      : (uint8_t)s[i];
      std::string uni;
      if (font) uni = font->unicode_for(code);
      else if (code >= 32 && code < 127) uni = std::string(1, (char)code);
      decoded += uni;
      int gid = font ? font->gid_for(code, uni) : 0;
      if (raster) {
        if (font && font->tt && (gid > 0 || code == 0)) {
          draw_tt_glyph(*font, gid, tm, ctm, tfs, tz, rgb);
        } else if (font && font->cff && gid > 0) {
          draw_cff_glyph(*font, gid, tm, ctm, tfs, tz, rgb);
        } else if (font && font->t1 && gid >= 0) {
          draw_t1_glyph(*font, gid, tm, ctm, tfs, tz, rgb);
        } else if (font && font->kind == FontRes::kType3) {
          draw_t3_glyph(*font, code, tm, ctm, tfs, tz, rgb, resources,
                        depth);
        } else {
          // atlas fallback: layout-faithful box for the decoded char
          unsigned char ch = !uni.empty() ? (uint8_t)uni[0]
                                          : (unsigned char)code;
          if (ch >= 32 && ch < 127) {
            Mat trm2 = Mat::mul(tm, ctm);
            double gx, gy;
            dev(trm2, 0, 0, gx, gy);
            double px_size = tfs * scale * std::abs(trm2.d != 0 ? trm2.d : 1);
            draw_glyph(ch, gx, gy, px_size, rgb);
          }
        }
      }
      double w;
      if (font) {
        auto it = font->widths.find(code);
        if (it != font->widths.end()) w = it->second;
        else if (font->tt && gid > 0)
          w = font->tt->advance(gid) / (double)font->tt->units_per_em;
        else w = font->default_width;
      } else {
        w = 0.5;  // metric-less fallback (standard-14 without /Widths)
      }
      double adv = w * tfs + cs + (step == 1 && code == ' ' ? ws : 0);
      Mat m; m.e = adv * (tz / 100.0);
      tm = Mat::mul(m, tm);
    }
    size_t run_idx = (size_t)-1;
    if (!decoded.empty()) {
      runs.push_back({x0 / scale, y0 / scale, tfs, decoded});
      run_idx = runs.size() - 1;
    }
    if (run_idx != (size_t)-1) {
      // record where the run's advance ended: extract_text uses the gap
      // to the next same-line run to decide whether a space separates
      // them (writers like matplotlib split one word into several show
      // ops at kern adjustments; joining those with a blanket space
      // corrupts words)
      Mat end_trm = Mat::mul(tm, ctm);
      double x1, y1;
      dev(end_trm, 0, 0, x1, y1);
      runs[run_idx].x_end = x1 / scale;
    }
  }

  // embedded-TrueType glyph: real outlines from the subset font program,
  // antialiased nonzero fill (the poppler glyph-fidelity role)
  void draw_tt_glyph(const FontRes& f, int gid, const Mat& tm,
                     const Mat& ctm, double tfs, double tz,
                     const double* rgb) {
    std::vector<std::vector<TrueTypeFont::Pt>> conts;
    if (!f.tt->outline(gid, conts) || conts.empty()) return;
    double su = tfs / (double)f.tt->units_per_em;
    Mat G;
    G.a = su * tz / 100.0;
    G.d = su;
    Mat T = Mat::mul(G, Mat::mul(tm, ctm));
    PathFiller pf;
    std::vector<std::pair<double, double>> poly;
    auto emit = [&](double fx, double fy) {
      double px, py;
      dev(T, fx, fy, px, py);
      poly.push_back({px, py});
    };
    for (auto& c : conts) {
      poly.clear();
      size_t n = c.size();
      if (n < 2) continue;
      // rotate the contour so it begins at an on-curve point
      // (synthesize the midpoint of the first off-curve pair if the
      // contour is all-off-curve, as TrueType permits)
      std::vector<TrueTypeFont::Pt> pts;
      size_t s0 = n;
      for (size_t i = 0; i < n; i++)
        if (c[i].on) { s0 = i; break; }
      if (s0 < n) {
        for (size_t i = 0; i < n; i++) pts.push_back(c[(s0 + i) % n]);
      } else {
        pts.push_back({(c[0].x + c[1].x) / 2, (c[0].y + c[1].y) / 2, true});
        for (size_t i = 1; i < n; i++) pts.push_back(c[i]);
        pts.push_back(c[0]);
      }
      pts.push_back(pts[0]);  // close
      double curx = pts[0].x, cury = pts[0].y;
      emit(curx, cury);
      size_t j = 1;
      while (j < pts.size()) {
        if (pts[j].on) {
          emit(pts[j].x, pts[j].y);
          curx = pts[j].x; cury = pts[j].y;
          j += 1;
          continue;
        }
        // off-curve control: endpoint is the next on-curve point or the
        // implied midpoint of two consecutive off-curve points
        double cx = pts[j].x, cy = pts[j].y, nx, ny;
        if (j + 1 < pts.size() && !pts[j + 1].on) {
          nx = (cx + pts[j + 1].x) / 2;
          ny = (cy + pts[j + 1].y) / 2;
          j += 1;
        } else if (j + 1 < pts.size()) {
          nx = pts[j + 1].x; ny = pts[j + 1].y;
          j += 2;
        } else {
          nx = pts[0].x; ny = pts[0].y;
          j += 1;
        }
        const int N = 6;
        for (int t = 1; t <= N; t++) {
          double tt2 = (double)t / N, u = 1 - tt2;
          emit(u * u * curx + 2 * u * tt2 * cx + tt2 * tt2 * nx,
               u * u * cury + 2 * u * tt2 * cy + tt2 * tt2 * ny);
        }
        curx = nx; cury = ny;
      }
      pf.add_contour(poly);
    }
    pf.fill(canvas, rgb, false);
  }

  // flattened-outline glyph fill under a FontMatrix (shared by the CFF
  // and raw-Type1 paths; the pdfTeX/dvips glyph-fidelity role)
  void fill_glyph_contours(
      const std::vector<std::vector<std::pair<double, double>>>& conts,
      const double* fm, const Mat& tm, const Mat& ctm, double tfs,
      double tz, const double* rgb) {
    Mat FM;
    FM.a = fm[0]; FM.b = fm[1]; FM.c = fm[2];
    FM.d = fm[3]; FM.e = fm[4]; FM.f = fm[5];
    Mat S;
    S.a = tfs * tz / 100.0;
    S.d = tfs;
    Mat T = Mat::mul(FM, Mat::mul(S, Mat::mul(tm, ctm)));
    PathFiller pf;
    std::vector<std::pair<double, double>> poly;
    for (auto& c : conts) {
      poly.clear();
      poly.reserve(c.size());
      for (auto& pt : c) {
        double px, py;
        dev(T, pt.first, pt.second, px, py);
        poly.push_back({px, py});
      }
      if (poly.size() >= 2) pf.add_contour(poly);
    }
    pf.fill(canvas, rgb, false);
  }

  void draw_cff_glyph(const FontRes& f, int gid, const Mat& tm,
                      const Mat& ctm, double tfs, double tz,
                      const double* rgb) {
    std::vector<std::vector<std::pair<double, double>>> conts;
    if (!f.cff->outline(gid, conts) || conts.empty()) return;
    fill_glyph_contours(conts, f.cff->fm, tm, ctm, tfs, tz, rgb);
  }

  void draw_t1_glyph(const FontRes& f, int gid, const Mat& tm,
                     const Mat& ctm, double tfs, double tz,
                     const double* rgb) {
    std::vector<std::vector<std::pair<double, double>>> conts;
    if (!f.t1->outline(gid, conts) || conts.empty()) return;
    fill_glyph_contours(conts, f.t1->fm, tm, ctm, tfs, tz, rgb);
  }

  // Type3 glyph: run the /CharProcs content stream under
  // FontMatrix * [tfs] * tm * ctm (matplotlib's default pdf.fonttype=3)
  void draw_t3_glyph(const FontRes& f, long code, const Mat& tm,
                     const Mat& ctm, double tfs, double tz,
                     const double* rgb, const ObjPtr& resources,
                     int depth) {
    if (code < 0 || code >= 256) return;
    const std::string& name = f.code_glyphname[code];
    if (name.empty() || !f.char_procs) return;
    ObjPtr proc = doc->dget(f.char_procs, name);
    if (!proc->is(Obj::Stream)) return;
    if (getenv("MMPDF_DEBUG"))
      fprintf(stderr, "[t3] glyph %s tm=(%.1f,%.1f)\n", name.c_str(), tm.e, tm.f);
    Mat FM;
    FM.a = f.fm[0]; FM.b = f.fm[1]; FM.c = f.fm[2];
    FM.d = f.fm[3]; FM.e = f.fm[4]; FM.f = f.fm[5];
    Mat S;
    S.a = tfs * tz / 100.0;
    S.d = tfs;
    Mat g = Mat::mul(FM, Mat::mul(S, Mat::mul(tm, ctm)));
    ObjPtr res = f.t3_res && f.t3_res->is(Obj::Dict) ? f.t3_res : resources;
    interpret(doc->stream_bytes(proc), res, depth + 1, &g, rgb);
  }

  void draw_glyph(unsigned char ch, double x, double baseline_y, double px_size,
                  const double* rgb) {
    if (ch < 32 || ch > 126) return;
    const uint8_t* gl = kFont.glyphs[ch - 32];
    // scale 8x13 cell to px_size (height ~ font size)
    double cell_h = px_size;
    double cell_w = px_size * 8.0 / 13.0;
    int ih = std::max(1, (int)std::lround(cell_h));
    int iw = std::max(1, (int)std::lround(cell_w));
    uint8_t r = (uint8_t)std::lround(rgb[0] * 255), g = (uint8_t)std::lround(rgb[1] * 255),
            b = (uint8_t)std::lround(rgb[2] * 255);
    for (int py = 0; py < ih; py++) {
      int srow = py * 13 / ih;
      for (int px = 0; px < iw; px++) {
        int scol = px * 8 / iw;
        if (gl[srow] & (0x80 >> scol))
          canvas.put((int)x + px, (int)(baseline_y - cell_h * 10.0 / 13.0) + py, r, g, b);
      }
    }
  }

  void fill_rect(double x, double y, double w, double h, const Mat& ctm, const double* rgb) {
    double x0, y0, x1, y1;
    dev(ctm, x, y, x0, y0);
    dev(ctm, x + w, y + h, x1, y1);
    if (x0 > x1) std::swap(x0, x1);
    if (y0 > y1) std::swap(y0, y1);
    uint8_t r = (uint8_t)std::lround(rgb[0] * 255), g = (uint8_t)std::lround(rgb[1] * 255),
            b = (uint8_t)std::lround(rgb[2] * 255);
    for (int py = (int)y0; py <= (int)y1; py++)
      for (int px = (int)x0; px <= (int)x1; px++) canvas.put(px, py, r, g, b);
  }

  void draw_image(const ObjPtr& img, const Mat& ctm) {
    int iw = (int)doc->dget(img, "Width")->as_num(0);
    int ih = (int)doc->dget(img, "Height")->as_num(0);
    if (iw <= 0 || ih <= 0) return;
    int bpc = (int)doc->dget(img, "BitsPerComponent")->as_num(8);
    ObjPtr cs = doc->dget(img, "ColorSpace");
    int ncomp = (cs->is(Obj::Name) && cs->str == "DeviceGray") ? 1 : 3;

    std::vector<uint8_t> pix;
    // figure filter
    bool is_jpeg = false;
    ObjPtr f = doc->dget(img, "Filter");
    auto has = [&](const char* n) {
      if (f->is(Obj::Name)) return f->str == n;
      if (f->is(Obj::Arr))
        for (auto& x : f->arr) { auto rr = doc->resolve(x); if (rr->is(Obj::Name) && rr->str == n) return true; }
      return false;
    };
    is_jpeg = has("DCTDecode") || has("DCT");
    std::string bytes = doc->stream_bytes(img);
    if (is_jpeg) {
      int w2, h2, ch2;
      if (!jpeg_decode(bytes, pix, w2, h2, ch2)) return;
      iw = w2; ih = h2; ncomp = 3;
    } else {
      if (bpc != 8) return;  // 1-bit masks etc. unsupported
      pix.assign(bytes.begin(), bytes.end());
      if ((size_t)iw * ih * ncomp > pix.size()) return;
    }

    // image space (0..1)^2 maps through ctm; sample nearest-neighbor.
    double x00, y00, x10, y10, x01, y01;
    dev(ctm, 0, 0, x00, y00);
    dev(ctm, 1, 0, x10, y10);
    dev(ctm, 0, 1, x01, y01);
    double minx = std::min({x00, x10, x01, x10 + x01 - x00});
    double maxx = std::max({x00, x10, x01, x10 + x01 - x00});
    double miny = std::min({y00, y10, y01, y10 + y01 - y00});
    double maxy = std::max({y00, y10, y01, y10 + y01 - y00});
    if (collect_images) {
      ExtractedImage ex;
      ex.w = iw; ex.h = ih;
      ex.x0 = minx; ex.y0 = miny; ex.x1 = maxx; ex.y1 = maxy;
      ex.rgb.resize((size_t)iw * ih * 3);
      for (size_t p = 0; p < (size_t)iw * ih; p++) {
        size_t si = p * ncomp;
        ex.rgb[p * 3] = pix[si];
        ex.rgb[p * 3 + 1] = ncomp == 3 ? pix[si + 1] : pix[si];
        ex.rgb[p * 3 + 2] = ncomp == 3 ? pix[si + 2] : pix[si];
      }
      images.push_back(std::move(ex));
    }
    if (!raster) return;
    // inverse map: for axis-aligned ctm (b=c=0) this is exact; otherwise we
    // approximate with the bounding box (rotation is rare in papers).
    // Downscales AREA-AVERAGE over the source footprint of each device
    // pixel: nearest-neighbor dropped whole source rows/columns (a scanned
    // page embedded at 200 DPI rendered at 144 loses 28% of its rows -
    // thin glyph strokes vanish entirely, which breaks the OCR path).
    // Upscales keep nearest (pixel replication is fine there).
    double sx_ratio = (maxx - minx) > 0 ? iw / (maxx - minx) : 1.0;
    double sy_ratio = (maxy - miny) > 0 ? ih / (maxy - miny) : 1.0;
    bool box_filter = sx_ratio > 1.0 || sy_ratio > 1.0;
    for (int py = std::max(0, (int)miny); py < std::min(canvas.h, (int)std::ceil(maxy)); py++) {
      double v0 = (maxy - miny) > 0 ? ((double)py - miny) / (maxy - miny) : 0;
      double v1 = (maxy - miny) > 0 ? ((double)py + 1 - miny) / (maxy - miny) : 1;
      int sy0 = std::min(ih - 1, std::max(0, (int)(v0 * ih)));
      int sy1 = box_filter ? std::min(ih, std::max(sy0 + 1, (int)std::ceil(v1 * ih))) : sy0 + 1;
      for (int px = std::max(0, (int)minx); px < std::min(canvas.w, (int)std::ceil(maxx)); px++) {
        double u0 = (maxx - minx) > 0 ? ((double)px - minx) / (maxx - minx) : 0;
        double u1 = (maxx - minx) > 0 ? ((double)px + 1 - minx) / (maxx - minx) : 1;
        int sx0 = std::min(iw - 1, std::max(0, (int)(u0 * iw)));
        int sx1 = box_filter ? std::min(iw, std::max(sx0 + 1, (int)std::ceil(u1 * iw))) : sx0 + 1;
        uint32_t ar = 0, ag = 0, ab = 0, n = 0;
        for (int sy = sy0; sy < sy1; sy++)
          for (int sx = sx0; sx < sx1; sx++) {
            size_t si = ((size_t)sy * iw + sx) * ncomp;
            ar += pix[si];
            ag += ncomp == 3 ? pix[si + 1] : pix[si];
            ab += ncomp == 3 ? pix[si + 2] : pix[si];
            n++;
          }
        canvas.put(px, py, (uint8_t)(ar / n), (uint8_t)(ag / n), (uint8_t)(ab / n));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Geometric reading order (the Docling layout-model role in the reference,
// functions.py:58-131). Real papers are two-column, and a writer may emit
// the content stream in visual-line order (col1-line1, col2-line1, ...);
// joining runs in content order then garbles every chunk. Detect column
// bands from the x-coverage of the page's text runs and return run indices
// column-major via a recursive XY-cut:
//   - "wide" runs (titles / abstracts / footers spanning the gutter) act as
//     vertical band separators;
//   - within a band, the left column is emitted before the right, each
//     recursively re-cut (3-column layouts split again on recursion);
//   - short aligned fragments (table cells) must NOT trigger column
//     ordering - each side must look like body text (>=3 lines whose median
//     width is several em) - detect_tables owns grids (ingest/tables.py).
// When no multi-column structure is found the permutation is the IDENTITY,
// so single-column pages keep their exact historical content-stream output.
// ---------------------------------------------------------------------------

struct ReadingOrder {
  const std::vector<TextRun>& runs;
  std::vector<size_t> order;
  bool split_found = false;

  explicit ReadingOrder(const std::vector<TextRun>& r) : runs(r) {
    std::vector<size_t> idx(runs.size());
    for (size_t i = 0; i < idx.size(); i++) idx[i] = i;
    region(idx, 0);
    if (!split_found) {
      order.resize(runs.size());
      for (size_t i = 0; i < order.size(); i++) order[i] = i;
    }
  }

  static double median(std::vector<double> v) {
    if (v.empty()) return 12.0;
    size_t m = v.size() / 2;
    std::nth_element(v.begin(), v.begin() + m, v.end());
    return v[m];
  }

  double run_end(size_t i) const { return std::max(runs[i].x_end, runs[i].x); }

  // distinct visual lines among idx (y clustered within 0.5*ms) and the
  // median line extent (first x to last x_end per line)
  void line_stats(const std::vector<size_t>& idx, double ms,
                  int* n_lines, double* med_width) const {
    std::vector<std::pair<double, size_t>> ys;
    ys.reserve(idx.size());
    for (size_t i : idx) ys.push_back({runs[i].y, i});
    std::sort(ys.begin(), ys.end());
    std::vector<double> widths;
    double lx0 = 0, lx1 = 0, anchor = -1e18;
    for (auto& p : ys) {
      size_t i = p.second;
      if (p.first - anchor > 0.5 * ms) {
        if (anchor > -1e17) widths.push_back(lx1 - lx0);
        lx0 = runs[i].x; lx1 = run_end(i); anchor = p.first;
      } else {
        lx0 = std::min(lx0, runs[i].x);
        lx1 = std::max(lx1, run_end(i));
      }
    }
    if (anchor > -1e17) widths.push_back(lx1 - lx0);
    *n_lines = (int)widths.size();
    *med_width = median(widths);
  }

  void emit(const std::vector<size_t>& idx) {
    for (size_t i : idx) order.push_back(i);
  }

  void region(const std::vector<size_t>& idx, int depth) {
    if (idx.size() < 6 || depth > 4) { emit(idx); return; }
    double x0 = 1e18, x1 = -1e18;
    std::vector<double> sizes;
    sizes.reserve(idx.size());
    for (size_t i : idx) {
      x0 = std::min(x0, runs[i].x);
      x1 = std::max(x1, run_end(i));
      sizes.push_back(runs[i].size);
    }
    double ms = std::max(1.0, median(sizes));
    double W = x1 - x0;
    if (W < 8 * ms) { emit(idx); return; }
    // x-coverage histogram over ALL runs in the region: the gutter is a
    // LOW-coverage band (a few runs - title, abstract, footer - may cross
    // it; they become band separators), with real column mass on each side
    double bin = std::max(0.25 * ms, 1.0);
    int nb = (int)(W / bin) + 1;
    std::vector<int> cov(nb, 0);
    for (size_t i : idx) {
      int b0 = (int)((runs[i].x - x0) / bin);
      int b1 = (int)((run_end(i) - x0) / bin);
      for (int b = std::max(0, b0); b <= std::min(nb - 1, b1); b++) cov[b]++;
    }
    int nlines = 0;
    double lwidth = 0;
    line_stats(idx, ms, &nlines, &lwidth);
    int cross_max = std::max(1, std::min(3, nlines / 4));
    const int side_min = 3;
    // prefix/suffix coverage maxima: a gutter needs >= side_min coverage
    // somewhere on each side
    std::vector<int> pmax(nb), smax(nb);
    for (int b = 0; b < nb; b++)
      pmax[b] = std::max(cov[b], b ? pmax[b - 1] : 0);
    for (int b = nb - 1; b >= 0; b--)
      smax[b] = std::max(cov[b], b + 1 < nb ? smax[b + 1] : 0);
    double best_gap = 0, cut = 0;
    double gap_min = std::max(1.2 * ms, 6.0);
    for (int b = 0; b < nb;) {
      if (cov[b] > cross_max) { b++; continue; }
      int e = b;
      while (e < nb && cov[e] <= cross_max) e++;
      double g = (e - b) * bin;
      bool internal = b > 0 && e < nb &&
                      pmax[b - 1] >= side_min && smax[e] >= side_min;
      if (internal && g >= gap_min && g > best_gap) {
        best_gap = g;
        cut = x0 + 0.5 * (b + e) * bin;
      }
      b = e + 1;
    }
    if (best_gap <= 0) { emit(idx); return; }
    // Runs spanning the cut point become band separators (title/abstract/
    // footer lines). Kern-split writers (TJ arrays) show one such line as
    // MANY short runs, so absorb same-line neighbors connected to a
    // crossing run through small gaps - but never across a gutter-sized
    // gap (two independent column runs on one baseline must stay columns).
    double absorb = std::min(1.5 * ms, 0.6 * best_gap);
    std::vector<size_t> widev, left, right;
    {
      std::vector<size_t> byy(idx);
      std::stable_sort(byy.begin(), byy.end(), [&](size_t a, size_t b) {
        return runs[a].y < runs[b].y;
      });
      size_t c0 = 0;
      for (size_t k = 0; k <= byy.size(); k++) {
        bool flush = k == byy.size() ||
                     (k > c0 && runs[byy[k]].y - runs[byy[c0]].y > 0.5 * ms);
        if (!flush) continue;
        std::vector<size_t> line(byy.begin() + c0, byy.begin() + k);
        c0 = k;
        std::sort(line.begin(), line.end(), [&](size_t a, size_t b) {
          return runs[a].x < runs[b].x;
        });
        // connected components along x; a component containing a
        // crossing run is a separator
        size_t s0 = 0;
        for (size_t m = 0; m <= line.size(); m++) {
          bool cflush = m == line.size() ||
                        (m > s0 && runs[line[m]].x - run_end(line[m - 1]) > absorb);
          if (!cflush) continue;
          bool crosses = false;
          for (size_t q = s0; q < m; q++)
            if (runs[line[q]].x <= cut && run_end(line[q]) >= cut) crosses = true;
          for (size_t q = s0; q < m; q++) {
            if (crosses) widev.push_back(line[q]);
            else {
              double c = 0.5 * (runs[line[q]].x + run_end(line[q]));
              (c < cut ? left : right).push_back(line[q]);
            }
          }
          s0 = m;
        }
        if (k < byy.size()) c0 = k;
      }
    }
    int nl_l = 0, nl_r = 0;
    double w_l = 0, w_r = 0;
    line_stats(left, ms, &nl_l, &w_l);
    line_stats(right, ms, &nl_r, &w_r);
    // each side must look like body text (several lines of substantial
    // width) - short aligned fragments are a table, not columns
    if (left.size() < 3 || right.size() < 3 || nl_l < 3 || nl_r < 3 ||
        w_l < 6 * ms || w_r < 6 * ms) { emit(idx); return; }
    split_found = true;
    // crossing runs separate the region into vertical bands; stable y-sort
    // keeps kern-split title segments in content order
    std::vector<size_t> seps = widev;
    std::stable_sort(seps.begin(), seps.end(),
                     [&](size_t a, size_t b) { return runs[a].y < runs[b].y; });
    auto by_y = [&](std::vector<size_t>& v) {
      std::stable_sort(v.begin(), v.end(),
                       [&](size_t a, size_t b) { return runs[a].y < runs[b].y; });
    };
    by_y(left);
    by_y(right);
    double prev = -1e18;
    for (size_t j = 0; j <= seps.size(); j++) {
      double next = j < seps.size() ? runs[seps[j]].y - 0.25 * ms : 1e18;
      std::vector<size_t> lb, rb;
      for (size_t i : left)
        if (runs[i].y > prev && runs[i].y <= next) lb.push_back(i);
      for (size_t i : right)
        if (runs[i].y > prev && runs[i].y <= next) rb.push_back(i);
      region(lb, depth + 1);
      region(rb, depth + 1);
      if (j < seps.size()) order.push_back(seps[j]);
      prev = next;
    }
  }
};

}  // namespace mmpdf

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

struct mmpdf_doc {
  mmpdf::Document doc;
};

mmpdf_doc* mmpdf_open(const uint8_t* data, size_t len) {
  auto* h = new mmpdf_doc();
  if (!h->doc.load(data, len)) {
    delete h;
    return nullptr;
  }
  return h;
}

void mmpdf_close(mmpdf_doc* h) { delete h; }

int mmpdf_page_count(mmpdf_doc* h) { return (int)h->doc.pages.size(); }

// Returns malloc'd RGB8 buffer (caller frees with mmpdf_free); fills w/h.
uint8_t* mmpdf_render_page(mmpdf_doc* h, int page, double dpi, int* w, int* out_h) {
  if (page < 0 || page >= (int)h->doc.pages.size()) return nullptr;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.scale = dpi / 72.0;
  pr.raster = true;
  pr.run();
  *w = pr.canvas.w;
  *out_h = pr.canvas.h;
  uint8_t* buf = (uint8_t*)malloc(pr.canvas.rgb.size());
  memcpy(buf, pr.canvas.rgb.data(), pr.canvas.rgb.size());
  return buf;
}

// Returns malloc'd UTF-8-ish text (caller frees). Runs are emitted in
// geometric reading order (column-major when a multi-column layout is
// detected - the Docling layout role, reference functions.py:58-131 -
// otherwise exact content order), newline-separated per run, double
// newline between y-jumps.
char* mmpdf_extract_text(mmpdf_doc* h, int page) {
  if (page < 0 || page >= (int)h->doc.pages.size()) return nullptr;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.scale = 1.0;
  pr.raster = false;
  pr.run();
  mmpdf::ReadingOrder ro(pr.runs);
  std::string out;
  double last_y = 1e18;
  double last_size = 12;
  double last_x_end = 0;
  for (size_t oi : ro.order) {
    auto& r = pr.runs[oi];
    if (!out.empty()) {
      if (std::abs(r.y - last_y) > last_size * 1.6) out += "\n\n";
      else if (std::abs(r.y - last_y) > 1e-6) out += "\n";
      else {
        // same line: a space only when a real gap separates the runs.
        // Kern-split show ops (matplotlib et al.) start within a
        // fraction of the estimated previous advance end; genuine word
        // or column gaps exceed it.
        double gap = r.x - last_x_end;
        if (gap > 0.18 * last_size) out += " ";
      }
    }
    out += r.text;
    last_y = r.y;
    last_size = r.size;
    last_x_end = r.x_end;
  }
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = 0;
  return buf;
}

double mmpdf_page_width(mmpdf_doc* h, int page) {
  if (page < 0 || page >= (int)h->doc.pages.size()) return 0;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.load_mediabox();
  return pr.mb[2] - pr.mb[0];
}

double mmpdf_page_height(mmpdf_doc* h, int page) {
  if (page < 0 || page >= (int)h->doc.pages.size()) return 0;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.load_mediabox();
  return pr.mb[3] - pr.mb[1];
}

void mmpdf_free(void* p) { free(p); }

// Embedded-image extraction: fills *count and returns a malloc'd flat array
// of descriptors; pixel buffers are malloc'd separately. Free with
// mmpdf_free_images.
typedef struct {
  int w, h;
  double x0, y0, x1, y1;  // page bbox (PDF units when dpi=72)
  uint8_t* rgb;
} mmpdf_image_desc;

mmpdf_image_desc* mmpdf_extract_images(mmpdf_doc* h, int page, int* count) {
  *count = 0;
  if (page < 0 || page >= (int)h->doc.pages.size()) return nullptr;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.scale = 1.0;
  pr.raster = false;
  pr.collect_images = true;
  pr.run();
  if (pr.images.empty()) return nullptr;
  auto* out = (mmpdf_image_desc*)malloc(sizeof(mmpdf_image_desc) * pr.images.size());
  for (size_t i = 0; i < pr.images.size(); i++) {
    auto& ex = pr.images[i];
    out[i].w = ex.w;
    out[i].h = ex.h;
    out[i].x0 = ex.x0; out[i].y0 = ex.y0; out[i].x1 = ex.x1; out[i].y1 = ex.y1;
    out[i].rgb = (uint8_t*)malloc(ex.rgb.size());
    memcpy(out[i].rgb, ex.rgb.data(), ex.rgb.size());
  }
  *count = (int)pr.images.size();
  return out;
}

void mmpdf_free_images(mmpdf_image_desc* arr, int count) {
  if (!arr) return;
  for (int i = 0; i < count; i++) free(arr[i].rgb);
  free(arr);
}

// Ruled lines (x0,y0,x1,y1 in PDF units, top-left origin): near-axis
// stroked segments and thin filled rects - the border/booktabs-rule signal
// the table detector uses for borderless/irregular tables (the TableFormer
// role, reference functions.py:85-93). Free with mmpdf_free.
typedef struct {
  double x0, y0, x1, y1;
} mmpdf_rule;

mmpdf_rule* mmpdf_extract_rules(mmpdf_doc* h, int page, int* count) {
  *count = 0;
  if (page < 0 || page >= (int)h->doc.pages.size()) return nullptr;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.scale = 1.0;
  pr.raster = false;
  pr.collect_rules = true;
  pr.run();
  if (pr.rules.empty()) return nullptr;
  auto* out = (mmpdf_rule*)malloc(sizeof(mmpdf_rule) * pr.rules.size());
  for (size_t i = 0; i < pr.rules.size(); i++) {
    out[i].x0 = pr.rules[i][0];
    out[i].y0 = pr.rules[i][1];
    out[i].x1 = pr.rules[i][2];
    out[i].y1 = pr.rules[i][3];
  }
  *count = (int)pr.rules.size();
  return out;
}

// Positioned text runs (x, y in PDF units, top-left origin): the layout
// signal for table-structure detection (columns = x positions repeating
// across rows). Free with mmpdf_free_runs.
typedef struct {
  double x, y, size;
  char* text;
} mmpdf_text_run;

mmpdf_text_run* mmpdf_extract_runs(mmpdf_doc* h, int page, int* count) {
  *count = 0;
  if (page < 0 || page >= (int)h->doc.pages.size()) return nullptr;
  mmpdf::PageRender pr;
  pr.doc = &h->doc;
  pr.page = h->doc.pages[page];
  pr.scale = 1.0;
  pr.raster = false;
  pr.run();
  if (pr.runs.empty()) return nullptr;
  // merge kern-split show ops (matplotlib et al. split one word into
  // several Tj at kern adjustments): consecutive same-line runs whose
  // gap stays below the extract_text space threshold are ONE run -
  // downstream consumers (detect_tables cell assembly, caption match)
  // must see whole words, not fragments
  std::vector<mmpdf::TextRun> merged;
  for (auto& r : pr.runs) {
    if (!merged.empty()) {
      auto& p = merged.back();
      double gap = r.x - p.x_end;
      if (std::abs(r.y - p.y) < 1e-6 && gap <= 0.18 * p.size &&
          gap > -0.5 * p.size) {
        p.text += r.text;
        p.x_end = r.x_end;
        continue;
      }
    }
    merged.push_back(r);
  }
  auto* out = (mmpdf_text_run*)malloc(sizeof(mmpdf_text_run) * merged.size());
  for (size_t i = 0; i < merged.size(); i++) {
    auto& r = merged[i];
    out[i].x = r.x;
    out[i].y = r.y;
    out[i].size = r.size;
    out[i].text = (char*)malloc(r.text.size() + 1);
    memcpy(out[i].text, r.text.data(), r.text.size());
    out[i].text[r.text.size()] = 0;
  }
  *count = (int)merged.size();
  return out;
}

void mmpdf_free_runs(mmpdf_text_run* arr, int count) {
  if (!arr) return;
  for (int i = 0; i < count; i++) free(arr[i].text);
  free(arr);
}

// The built-in 8x13 glyph atlas: 95 glyphs (ASCII 32..126), 13 bytes per
// glyph top-to-bottom, MSB = leftmost of 8 columns. The host OCR stage
// (ingest/ocr.py) classifies scanned glyphs against this same atlas, so the
// rasterizer and the recognizer share one font resource. Static storage; do
// not free.
const uint8_t* mmpdf_font_atlas(void) {
  return &mmpdf::kFont.glyphs[0][0];
}

}  // extern "C"
