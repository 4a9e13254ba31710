// tiledecode.cpp — threaded batch decoder for whole-slide-image tiles, with
// its own baseline JPEG decoder: it links zlib and pthread, not libjpeg.
//
// Host side of the port's slide feed (io/native.py builds it with g++ and
// loads it with ctypes). Decodes N JPEG (or deflate) tile blobs into one
// preallocated buffer on a std::thread pool.
//
// The JPEG decoder takes baseline sequential Huffman streams of 8-bit
// samples (SOF0/SOF1): DQT at 8 and 16 bits, DHT, DRI and RSTn, abbreviated
// streams whose tables come first in a separate tables-only stream (TIFF
// JPEGTables), and 1 or 3 components (grayscale; YCbCr 4:4:4, 4:2:2, 4:2:0;
// RGB by Adobe transform 0 or component ids 'R','G','B'). For those it
// reproduces libjpeg(-turbo)'s output bit for bit: the Huffman decode with
// its zero-bit fill past a premature marker, libjpeg's restart resync, the
// ISLOW integer IDCT (jidctint.c, in libjpeg-turbo's x86-64 form), the fancy
// h2v1/h2v2 upsampling (jdsample.c) with its edge rows and columns, the
// merged upsampling (jdmerge.c, the same numbers as nearest chroma) and the
// fixed-point YCbCr->RGB conversion (jdcolor.c). Anything else —
// progressive, arithmetic-coded, lossless or hierarchical frames, 12-bit
// samples, 2 or 4 components (CMYK, YCCK), other sampling layouts, scans
// of fewer components than the frame, missing tables, an invalid Huffman
// code — is refused per tile with a status code; the caller decodes such a
// tile another way (io/tiff.py: PIL).
//
// C ABI (the JAX package's native/tiledecode.cpp, plus the status form):
//   int decode_jpeg_batch(const char** blobs, const size_t* sizes, int n,
//                         const char* tables, size_t tables_len,
//                         int tile_h, int tile_w, void* out, int threads);
//   int decode_jpeg_batch_opts(...same..., int fancy);  // fancy=0: libjpeg's
//                         // merged upsampler, i.e. nearest chroma
//   int decode_jpeg_batch_planar(const char** blobs, const size_t* sizes,
//                         int n, const char* tables, size_t tables_len,
//                         int tile_h, int tile_w, void* out_y, void* out_cbcr,
//                         unsigned char* ok /*nullable*/, int threads);
//                         // raw 4:2:0 planes (jpeg_read_raw_data's samples)
//   int decode_deflate_batch(const char** blobs, const size_t* sizes, int n,
//                            int tile_h, int tile_w, void* out, int threads);
//   int decode_jpeg_batch_status(...as decode_jpeg_batch..., int form,
//                         void* out0, void* out1, int* status, int threads);
//                         // form 0 fancy RGB, 1 nearest RGB, 2 planar;
//                         // status[i] = 0 or the tile's refusal code
// Each returns the number of tiles that failed (0 on success). threads <= 0
// means one thread per core.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Refusal codes (io/native.py names them).
enum Status : int {
  kOk = 0,
  kCorrupt = 1,         // malformed stream; libjpeg would stop with an error
  kProgressive = 2,     // SOF2
  kArithmetic = 3,      // SOF9 / SOF10
  kPrecision = 4,       // not 8-bit samples
  kColor = 5,           // 2 or 4+ components (CMYK, YCCK)
  kSampling = 6,        // a sampling layout other than 4:4:4 / 4:2:2 / 4:2:0
  kMultiScan = 7,       // a scan of fewer components than the frame
  kDimensions = 8,      // header beyond 2x the tile + 32 on a side
  kNotPlanar = 9,       // planar form: not plain 4:2:0 YCbCr of even size
  kUnsupportedSof = 10, // lossless / hierarchical frames
  kBadCode = 11,        // a Huffman code no table holds (libjpeg: warning)
  kMissingTable = 12,   // a scan names a Huffman table that is not defined
};

constexpr int kMarkerEOI = 0xD9;

// zigzag index -> natural index, with libjpeg's 16 guard entries for a
// corrupt run length that steps past the last coefficient
constexpr uint8_t kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

// jdhuff.c's derived table; look[] resolves codes of up to 9 bits by
// replaying the bit-serial search on each 9-bit prefix, so it agrees with
// that search by construction.
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[512];  // (length << 8) | symbol; 0: longer than 9 bits
};

bool derive_huff(const HuffSpec& s, bool dc, HuffTable* t) {
  uint8_t size[257];
  uint32_t code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = s.bits[l];
    if (p + i > 256) return false;
    while (i--) size[p++] = static_cast<uint8_t>(l);
  }
  size[p] = 0;
  const int nsym = p;
  uint32_t c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) return false;  // codes overran their length
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(code[p]);
      p += s.bits[l];
      t->maxcode[l] = static_cast<int32_t>(code[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->vals, s.vals, 256);
  if (dc) {
    for (int i = 0; i < nsym; ++i)
      if (s.vals[i] > 15) return false;
  }
  for (int v = 0; v < 512; ++v) {
    t->look[v] = 0;
    for (int l = 1; l <= 9; ++l) {
      const int32_t cc = v >> (9 - l);
      if (cc <= t->maxcode[l]) {
        t->look[v] = static_cast<uint16_t>(
            (l << 8) | t->vals[(cc + t->valoffset[l]) & 0xFF]);
        break;
      }
    }
  }
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;  // scan's DC / AC table numbers
};

// Parser state across the tables-only stream and the tile's stream.
struct Stream {
  HuffSpec dc[4], ac[4];
  uint16_t q[4][64] = {};
  bool qdef[4] = {};
  // reset by each SOI
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  // frame and scan
  bool saw_sof = false;
  int precision = 8, height = 0, width = 0, nf = 0;
  Component comp[10];
  int ns = 0;
  int scan_comp[4] = {};  // frame index of each scan component
};

// libjpeg's next_marker: skip to the next FF xx with xx neither 00 (a
// stuffed data byte) nor FF (fill); the end of the data reads as EOI, as
// jpeg_mem_src's fake EOI makes it.
int next_marker(const uint8_t*& p, const uint8_t* end) {
  for (;;) {
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) return kMarkerEOI;
    const int c = *p++;
    if (c != 0) return c;
  }
}

bool read_u16(const uint8_t*& p, const uint8_t* end, int* v) {
  if (end - p < 2) return false;
  *v = (p[0] << 8) | p[1];
  p += 2;
  return true;
}

void skip_segment(const uint8_t*& p, const uint8_t* end, int length) {
  length -= 2;
  if (length > 0) p = (end - p > length) ? p + length : end;
}

int parse_dqt(Stream& st, const uint8_t*& p, const uint8_t* end) {
  int length;
  if (!read_u16(p, end, &length)) return kCorrupt;
  length -= 2;
  while (length > 0) {
    if (p >= end) return kCorrupt;
    const int n = *p & 0x0F, prec = *p >> 4;
    ++p;
    if (n >= 4) return kCorrupt;
    for (int i = 0; i < 64; ++i) {
      int v;
      if (prec) {
        if (!read_u16(p, end, &v)) return kCorrupt;
      } else {
        if (p >= end) return kCorrupt;
        v = *p++;
      }
      st.q[n][kNatural[i]] = static_cast<uint16_t>(v);
    }
    st.qdef[n] = true;
    length -= 64 + 1;
    if (prec) length -= 64;
  }
  return length == 0 ? kOk : kCorrupt;
}

int parse_dht(Stream& st, const uint8_t*& p, const uint8_t* end) {
  int length;
  if (!read_u16(p, end, &length)) return kCorrupt;
  length -= 2;
  while (length > 16) {
    if (end - p < 17) return kCorrupt;
    int index = *p++;
    HuffSpec s;
    int count = 0;
    for (int i = 1; i <= 16; ++i) {
      s.bits[i] = *p++;
      count += s.bits[i];
    }
    length -= 1 + 16;
    if (count > 256 || count > length || end - p < count) return kCorrupt;
    std::memcpy(s.vals, p, count);
    p += count;
    length -= count;
    s.defined = true;
    if (index & 0x10) {
      index -= 0x10;
      if (index < 0 || index >= 4) return kCorrupt;
      st.ac[index] = s;
    } else {
      if (index >= 4) return kCorrupt;
      st.dc[index] = s;
    }
  }
  return length == 0 ? kOk : kCorrupt;
}

int parse_sof(Stream& st, const uint8_t*& p, const uint8_t* end) {
  int length;
  if (!read_u16(p, end, &length) || end - p < 6) return kCorrupt;
  st.precision = p[0];
  st.height = (p[1] << 8) | p[2];
  st.width = (p[3] << 8) | p[4];
  st.nf = p[5];
  p += 6;
  length -= 8;
  if (st.saw_sof) return kCorrupt;
  if (st.height <= 0 || st.width <= 0 || st.nf <= 0) return kCorrupt;
  if (length != st.nf * 3 || st.nf > 10 || end - p < length) return kCorrupt;
  for (int i = 0; i < st.nf; ++i) {
    st.comp[i].id = p[0];
    st.comp[i].h = p[1] >> 4;
    st.comp[i].v = p[1] & 15;
    st.comp[i].tq = p[2];
    p += 3;
  }
  st.saw_sof = true;
  return kOk;
}

int parse_sos(Stream& st, const uint8_t*& p, const uint8_t* end) {
  int length;
  if (!st.saw_sof) return kCorrupt;
  if (!read_u16(p, end, &length) || p >= end) return kCorrupt;
  const int n = *p++;
  if (length != n * 2 + 6 || n < 1 || n > 4 || end - p < 2 * n + 3)
    return kCorrupt;
  st.ns = n;
  bool used[10] = {};
  for (int i = 0; i < n; ++i) {
    const int cc = p[0], c = p[1];
    p += 2;
    int ci = 0;
    while (ci < st.nf && (st.comp[ci].id != cc || used[ci])) ++ci;
    if (ci == st.nf) return kCorrupt;
    used[ci] = true;
    st.scan_comp[i] = ci;
    st.comp[ci].td = c >> 4;
    st.comp[ci].ta = c & 15;
  }
  p += 3;  // Ss, Se, Ah/Al: a sequential scan reads them as the full range
  return kOk;
}

void examine_appn(Stream& st, int marker, const uint8_t*& p,
                  const uint8_t* end) {
  int length;
  if (!read_u16(p, end, &length)) {
    p = end;
    return;
  }
  length -= 2;
  int take = length >= 14 ? 14 : (length > 0 ? length : 0);
  if (end - p < take) take = static_cast<int>(end - p);
  const uint8_t* b = p;
  if (marker == 0xE0 && take >= 14 && b[0] == 'J' && b[1] == 'F' &&
      b[2] == 'I' && b[3] == 'F' && b[4] == 0) {
    st.jfif = true;
  }
  if (marker == 0xEE && take >= 12 && b[0] == 'A' && b[1] == 'd' &&
      b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
    st.adobe = true;
    st.adobe_transform = b[11];
  }
  p += take;
  length -= take;
  if (length > 0) p = (end - p > length) ? p + length : end;
}

int parse_dac(const uint8_t*& p, const uint8_t* end) {
  int length;
  if (!read_u16(p, end, &length)) return kCorrupt;
  length -= 2;
  while (length > 0) {
    if (end - p < 2) return kCorrupt;
    const int index = p[0], val = p[1];
    p += 2;
    length -= 2;
    if (index >= 32) return kCorrupt;
    if (index < 16 && (val & 0x0F) > (val >> 4)) return kCorrupt;
  }
  return length == 0 ? kOk : kCorrupt;
}

// The markers libjpeg reads alike before and after the scan (tables,
// restart interval, application data, comments): returns kOk, a refusal,
// or -1 when `m` is none of them.
int table_marker(Stream& st, int m, const uint8_t*& p, const uint8_t* end) {
  switch (m) {
    case 0xC4:
      return parse_dht(st, p, end);
    case 0xDB:
      return parse_dqt(st, p, end);
    case 0xCC:
      return parse_dac(p, end);
    case 0xDD: {
      int length, ri;
      if (!read_u16(p, end, &length) || length != 4 || !read_u16(p, end, &ri))
        return kCorrupt;
      st.restart_interval = ri;
      return kOk;
    }
    case 0xE0:
    case 0xEE:
      examine_appn(st, m, p, end);
      return kOk;
    case 0xDC:  // DNL
    case 0xFE:  // COM
    case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6:
    case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC:
    case 0xED: case 0xEF: {
      int length;
      if (!read_u16(p, end, &length)) return kCorrupt;
      skip_segment(p, end, length);
      return kOk;
    }
    case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
    case 0xD6: case 0xD7: case 0x01:
      return kOk;  // parameterless
    default:
      return -1;
  }
}

enum class Reached { kSos, kEoi };

// libjpeg's read_markers over one stream, from its SOI: returns kOk with
// *reached set to the SOS (scan header parsed, p at the entropy-coded data)
// or the EOI, else a refusal.
int read_markers(Stream& st, const uint8_t*& p, const uint8_t* end,
                 Reached* reached) {
  if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) return kCorrupt;
  p += 2;
  st.restart_interval = 0;
  st.jfif = st.adobe = false;
  st.adobe_transform = 0;
  st.saw_sof = false;
  for (;;) {
    const int m = next_marker(p, end);
    int rc = kOk;
    switch (m) {
      case 0xC0:
      case 0xC1:
        rc = parse_sof(st, p, end);
        break;
      case 0xC2:
        return kProgressive;
      case 0xC9:
      case 0xCA:
        return kArithmetic;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return kUnsupportedSof;
      case 0xD8:
        return kCorrupt;  // a second SOI
      case kMarkerEOI:
        *reached = Reached::kEoi;
        return kOk;
      case 0xDA:
        rc = parse_sos(st, p, end);
        if (rc == kOk) {
          *reached = Reached::kSos;
          return kOk;
        }
        break;
      default:
        rc = table_marker(st, m, p, end);
        if (rc < 0) return kCorrupt;
    }
    if (rc != kOk) return rc;
  }
}

// Bit reader of libjpeg's jdhuff.c over the entropy-coded data: bytes are
// un-stuffed (FF 00 -> FF, FF fill bytes skipped); at a marker it stops
// and feeds zero bits, and the first zero bit consumed sets
// `insufficient`, which makes the following MCUs all-zero.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // MSB-aligned
  int bits = 0;      // valid bits in buf, the last `fake` of them zeros
  int fake = 0;
  int marker = 0;  // unread marker, 0 = none
  bool insufficient = false;

  void fill() {
    while (bits <= 56) {
      int c;
      if (marker) {
        c = 0;
        fake += 8;
      } else if (p >= end) {
        marker = kMarkerEOI;
        continue;
      } else {
        c = *p++;
        if (c == 0xFF) {
          while (p < end && *p == 0xFF) ++p;
          if (p >= end) {
            marker = kMarkerEOI;
            continue;
          }
          const int c2 = *p++;
          if (c2 != 0) {
            marker = c2;
            continue;
          }
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }
  void consume(int n) {
    if (n > bits - fake) insufficient = true;
    buf <<= n;
    bits -= n;
    if (fake > bits) fake = bits;
  }
  uint32_t get(int n) {  // n in 1..16
    if (bits < n) fill();
    const uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    consume(n);
    return v;
  }
  // jpeg_huff_decode; returns -1 for a code no table length holds
  int decode(const HuffTable& t) {
    if (bits < 16) fill();
    const uint16_t e = t.look[buf >> (64 - 9)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(buf >> (64 - l));
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) return -1;
      code = static_cast<int32_t>(buf >> (64 - l));
    }
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  void discard() {  // process_restart: drop the buffered bits
    buf = 0;
    bits = fake = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// The ISLOW integer IDCT (jidctint.c) in the form libjpeg-turbo runs on
// x86-64 (its SSE2/AVX2 jsimd_idct_islow, which Pillow's and the system's
// builds both take): dequantized coefficients and the sums in0 + in4,
// in0 - in4, in7 + in3, in5 + in1 held in 16 bits, the column outputs
// saturated to 16 bits, the 32-bit products and sums wrapping, and the
// output clamped to [0, 255]; a block whose coefficient rows 1-7 are all
// zero takes the column shortcut (dequantized row 0 shifted left by 2 in
// 16 bits). Wherever no 16-bit value overflows — every stream an encoder
// writes — this equals jidctint.c with its range-limit table; the two part
// only on corrupt data (say a truncated tile's zero-filled codes), where
// this is what libjpeg-turbo computes. The file is built with -fwrapv.
namespace idct {
constexpr int kF0298 = 2446, kF0390 = 3196, kF0541 = 4433, kF0765 = 6270,
              kF0899 = 7373, kF1175 = 9633, kF1501 = 12299, kF1847 = 15137,
              kF1961 = 16069, kF2053 = 16819, kF2562 = 20995, kF3072 = 25172;

inline int16_t s16(int v) { return static_cast<int16_t>(v); }
inline int16_t sat16(int v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

// one 1-D pass over in[0..7] (stride 1); results before descaling
inline void pass(const int16_t* d, int out[8]) {
  const int tmp3 = d[2] * (kF0541 + kF0765) + d[6] * kF0541;
  const int tmp2 = d[2] * kF0541 + d[6] * (kF0541 - kF1847);
  const int tmp0 = static_cast<int>(s16(d[0] + d[4])) << 13;
  const int tmp1 = static_cast<int>(s16(d[0] - d[4])) << 13;
  const int t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
  const int t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const int z3 = s16(d[7] + d[3]), z4 = s16(d[5] + d[1]);
  const int z3p = z3 * (kF1175 - kF1961) + z4 * kF1175;
  const int z4p = z3 * kF1175 + z4 * (kF1175 - kF0390);
  const int o0 = d[7] * (kF0298 - kF0899) + d[1] * (-kF0899) + z3p;
  const int o3 = d[7] * (-kF0899) + d[1] * (kF1501 - kF0899) + z4p;
  const int o1 = d[5] * (kF2053 - kF2562) + d[3] * (-kF2562) + z4p;
  const int o2 = d[5] * (-kF2562) + d[3] * (kF3072 - kF2562) + z3p;
  out[0] = t10 + o3;
  out[7] = t10 - o3;
  out[1] = t11 + o2;
  out[6] = t11 - o2;
  out[2] = t12 + o1;
  out[5] = t12 - o1;
  out[3] = t13 + o0;
  out[4] = t13 - o0;
}

inline uint8_t out8(int v) {  // descale by 18, saturate, recentre
  v = (v + (1 << 17)) >> 18;
  return static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
}

// the value of every pixel of a block whose only nonzero coefficient is DC
inline uint8_t dc_only(int coef, int q) {
  const int16_t w = s16(static_cast<int>(s16(coef * q)) << 2);
  return out8(static_cast<int>(w) << 13);
}

void islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t ws[64];  // ws[8 * c + r]: column c, row r
  bool rows_zero = true;
  for (int k = 8; k < 64; ++k) rows_zero &= in[k] == 0;
  if (rows_zero) {
    for (int c = 0; c < 8; ++c) {
      const int16_t w = s16(static_cast<int>(s16(in[c] * q[c])) << 2);
      for (int r = 0; r < 8; ++r) ws[8 * c + r] = w;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t d[8];
      for (int r = 0; r < 8; ++r) d[r] = s16(in[8 * r + c] * q[8 * r + c]);
      int o[8];
      pass(d, o);
      for (int r = 0; r < 8; ++r) ws[8 * c + r] = sat16((o[r] + (1 << 10)) >> 11);
    }
  }
  for (int r = 0; r < 8; ++r) {
    int16_t d[8];
    for (int c = 0; c < 8; ++c) d[c] = ws[8 * c + r];
    int o[8];
    pass(d, o);
    uint8_t* op = out + r * stride;
    for (int c = 0; c < 8; ++c) op[c] = out8(o[c]);
  }
}
}  // namespace idct

// jdcolor.c's YCbCr->RGB tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + 32768) >> 16);
      cb_b[i] = static_cast<int>((116130 * x + 32768) >> 16);
      cr_g[i] = static_cast<int>(-46802 * x);
      cb_g[i] = static_cast<int>(-22554 * x + 32768);
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

struct Plane {
  std::vector<uint8_t> px;
  int stride = 0, rows = 0;
  int dw = 0, dh = 0;  // downsampled_width / downsampled_height
  const uint8_t* row(int r) const { return px.data() + static_cast<size_t>(r) * stride; }
};

enum class Form { kFancy, kNearest, kPlanar };

struct Decoded {
  int width = 0, height = 0, nf = 0;
  bool ycc = false;      // 3 components converted as YCbCr (else RGB)
  int rh[3] = {1, 1, 1}; // per component: max_h / h, max_v / v
  int rv[3] = {1, 1, 1};
  Plane plane[3];
};

// After the scan's last MCU, what jpeg_finish_decompress reads up to EOI
// must parse; a second scan or frame is an error there.
int check_trailer(Stream& st, BitReader& br) {
  int m = br.marker;
  const uint8_t* p = br.p;
  for (;;) {
    if (m == 0) m = next_marker(p, br.end);
    if (m == kMarkerEOI) return kOk;
    const int rc = table_marker(st, m, p, br.end);
    if (rc != kOk) return kCorrupt;
    m = 0;
  }
}

// jpeg_resync_to_restart (jdmarker.c) after a marker other than the
// expected RSTn: returns the marker left unread (0: resume decoding).
int resync(int marker, int desired, const uint8_t*& p, const uint8_t* end) {
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;
    } else if (marker == 0xD0 + ((desired + 1) & 7) ||
               marker == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (marker == 0xD0 + ((desired - 1) & 7) ||
               marker == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) return 0;
    if (action == 3) return marker;
    marker = next_marker(p, end);
  }
}

int decode_jpeg(const uint8_t* data, size_t len, const uint8_t* tables,
                size_t tables_len, int tile_h, int tile_w, Form form,
                Decoded* out) {
  Stream st;
  if (tables != nullptr && tables_len > 4) {
    const uint8_t* p = tables;
    Reached r;
    const int rc = read_markers(st, p, tables + tables_len, &r);
    if (rc != kOk) return rc;
    if (r != Reached::kEoi) st = Stream();  // not tables-only: drop them
  }
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  Reached reached;
  int rc = read_markers(st, p, end, &reached);
  if (rc != kOk) return rc;
  if (reached != Reached::kSos) return kCorrupt;  // no image
  if (st.width > 65500 || st.height > 65500) return kCorrupt;
  if (st.width > 2 * tile_w + 32 || st.height > 2 * tile_h + 32)
    return kDimensions;
  if (st.precision != 8) return kPrecision;
  for (int i = 0; i < st.nf; ++i)
    if (st.comp[i].h < 1 || st.comp[i].h > 4 || st.comp[i].v < 1 ||
        st.comp[i].v > 4)
      return kCorrupt;
  if (st.nf != 1 && st.nf != 3) return kColor;
  if (st.ns != st.nf) return kMultiScan;
  int max_h = 1, max_v = 1;
  for (int i = 0; i < st.nf; ++i) {
    if (st.comp[i].h > max_h) max_h = st.comp[i].h;
    if (st.comp[i].v > max_v) max_v = st.comp[i].v;
  }
  out->nf = st.nf;
  out->width = st.width;
  out->height = st.height;
  if (st.nf == 3) {
    if (st.jfif) {
      out->ycc = true;
    } else if (st.adobe) {
      out->ycc = st.adobe_transform != 0;
    } else {
      out->ycc = !(st.comp[0].id == 'R' && st.comp[1].id == 'G' &&
                   st.comp[2].id == 'B');
    }
    const Component &y = st.comp[0], &cb = st.comp[1], &cr = st.comp[2];
    if (y.h != max_h || y.v != max_v || cb.h != cr.h || cb.v != cr.v ||
        max_h % cb.h || max_v % cb.v)
      return kSampling;
    const int rh = max_h / cb.h, rv = max_v / cb.v;
    if (rh > 2 || rv > 2 || (rh == 1 && rv == 2)) return kSampling;
    out->rh[1] = out->rh[2] = rh;
    out->rv[1] = out->rv[2] = rv;
  }
  if (form == Form::kPlanar &&
      (st.nf != 3 || !out->ycc || out->rh[1] != 2 || out->rv[1] != 2 ||
       st.comp[0].h != 2 || st.comp[0].v != 2 || st.width % 2 ||
       st.height % 2))
    return kNotPlanar;

  // tables of the scan, quantizers latched at its start
  HuffTable dct[4], act[4];
  bool dct_ok[4] = {}, act_ok[4] = {};
  for (int i = 0; i < st.ns; ++i) {
    const Component& c = st.comp[st.scan_comp[i]];
    if (c.td >= 4 || c.ta >= 4) return kMissingTable;
    if (!st.dc[c.td].defined || !st.ac[c.ta].defined) return kMissingTable;
    if (!dct_ok[c.td]) {
      if (!derive_huff(st.dc[c.td], true, &dct[c.td])) return kCorrupt;
      dct_ok[c.td] = true;
    }
    if (!act_ok[c.ta]) {
      if (!derive_huff(st.ac[c.ta], false, &act[c.ta])) return kCorrupt;
      act_ok[c.ta] = true;
    }
    if (c.tq >= 4 || !st.qdef[c.tq]) return kCorrupt;
  }
  int16_t quant[3][64];
  for (int ci = 0; ci < st.nf; ++ci)
    for (int k = 0; k < 64; ++k)
      quant[ci][k] = static_cast<int16_t>(st.q[st.comp[ci].tq][k]);

  // MCU geometry (jdinput.c)
  const bool interleaved = st.ns > 1;
  int mcus_per_row, mcu_rows, blocks_in_mcu = 0;
  if (interleaved) {
    mcus_per_row = (st.width + 8 * max_h - 1) / (8 * max_h);
    mcu_rows = (st.height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < st.ns; ++i) {
      const Component& c = st.comp[st.scan_comp[i]];
      blocks_in_mcu += c.h * c.v;
    }
    if (blocks_in_mcu > 10) return kCorrupt;
  } else {
    const Component& c = st.comp[0];
    const int wb = (st.width * c.h + 8 * max_h - 1) / (8 * max_h);
    const int hb = (st.height * c.v + 8 * max_v - 1) / (8 * max_v);
    mcus_per_row = wb;
    mcu_rows = hb;
  }
  for (int ci = 0; ci < st.nf; ++ci) {
    const Component& c = st.comp[ci];
    Plane& pl = out->plane[ci];
    pl.dw = (st.width * c.h + max_h - 1) / max_h;
    pl.dh = (st.height * c.v + max_v - 1) / max_v;
    pl.stride = interleaved ? mcus_per_row * c.h * 8 : mcus_per_row * 8;
    pl.rows = interleaved ? mcu_rows * c.v * 8 : mcu_rows * 8;
    pl.px.assign(static_cast<size_t>(pl.stride) * pl.rows, 0);
  }

  // the scan (jdhuff.c decode_mcu, jdcoefct.c decompress_onepass)
  BitReader br{p, end};
  int last_dc[4] = {};
  int restarts_to_go = st.restart_interval;
  int next_restart = 0;
  alignas(16) int16_t blk[64];
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcus_per_row; ++mx) {
      if (st.restart_interval) {
        if (restarts_to_go == 0) {
          br.discard();
          if (br.marker == 0) br.marker = next_marker(br.p, br.end);
          if (br.marker == 0xD0 + next_restart) {
            br.marker = 0;
          } else {
            br.marker = resync(br.marker, next_restart, br.p, br.end);
          }
          next_restart = (next_restart + 1) & 7;
          for (int& d : last_dc) d = 0;
          restarts_to_go = st.restart_interval;
          if (br.marker == 0) br.insufficient = false;
        }
      }
      const bool skip = br.insufficient;
      for (int si = 0; si < st.ns; ++si) {
        const int ci = st.scan_comp[si];
        const Component& c = st.comp[ci];
        const int bh = interleaved ? c.h : 1, bv = interleaved ? c.v : 1;
        Plane& pl = out->plane[ci];
        for (int by = 0; by < bv; ++by) {
          for (int bx = 0; bx < bh; ++bx) {
            uint8_t* dst = pl.px.data() +
                           static_cast<size_t>((my * bv + by) * 8) * pl.stride +
                           (mx * bh + bx) * 8;
            if (skip) {
              // all-zero coefficients: the IDCT gives 128 everywhere
              for (int r = 0; r < 8; ++r) std::memset(dst + r * pl.stride, 128, 8);
              continue;
            }
            std::memset(blk, 0, sizeof(blk));
            bool ac = false;
            int s = br.decode(dct[c.td]);
            if (s < 0) return kBadCode;
            if (s) s = extend(static_cast<int>(br.get(s)), s);
            last_dc[si] = static_cast<int>(static_cast<uint32_t>(last_dc[si]) +
                                           static_cast<uint32_t>(s));
            blk[0] = static_cast<int16_t>(last_dc[si]);
            const HuffTable& at = act[c.ta];
            for (int k = 1; k < 64; ++k) {
              s = br.decode(at);
              if (s < 0) return kBadCode;
              const int r = s >> 4;
              s &= 15;
              if (s) {
                k += r;
                s = extend(static_cast<int>(br.get(s)), s);
                blk[kNatural[k]] = static_cast<int16_t>(s);
                ac = true;
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            if (!ac) {
              const uint8_t v = idct::dc_only(blk[0], quant[ci][0]);
              for (int r = 0; r < 8; ++r) std::memset(dst + r * pl.stride, v, 8);
            } else {
              idct::islow(blk, quant[ci], dst, pl.stride);
            }
          }
        }
      }
      if (st.restart_interval) --restarts_to_go;
    }
  }
  return check_trailer(st, br);
}

// One output row of component ci, upsampled to the image width: nearest
// (libjpeg's merged / h2v1 / h2v2 replication) or fancy (jdsample.c's
// triangle filters; libjpeg takes them only where downsampled_width > 2).
void upsample_row(const Decoded& d, int ci, int y, bool fancy, int width,
                  uint8_t* dst, int* colsum) {
  const Plane& pl = d.plane[ci];
  const int rh = d.rh[ci], rv = d.rv[ci];
  if (rh == 1 && rv == 1) {
    std::memcpy(dst, pl.row(y), width);
    return;
  }
  const int dw = pl.dw;
  if (!fancy || dw <= 2) {
    const uint8_t* src = pl.row(y / rv);
    for (int x = 0; x < width; ++x) dst[x] = src[x >> 1];
    return;
  }
  if (rv == 1) {  // h2v1
    const uint8_t* in = pl.row(y);
    for (int x = 0; x < width; ++x) {
      const int c = x >> 1;
      const int v3 = 3 * in[c];
      if (x & 1) {
        const int nx = c + 1 < dw ? in[c + 1] : in[c];
        dst[x] = static_cast<uint8_t>((v3 + nx + 2) >> 2);
      } else {
        const int pv = c > 0 ? in[c - 1] : in[c];
        dst[x] = static_cast<uint8_t>((v3 + pv + 1) >> 2);
      }
    }
    return;
  }
  // h2v2: rows clamped to [0, downsampled_height)
  const int r = y >> 1;
  int far = (y & 1) ? r + 1 : r - 1;
  if (far < 0) far = 0;
  if (far > pl.dh - 1) far = pl.dh - 1;
  const uint8_t* n = pl.row(r);
  const uint8_t* f = pl.row(far);
  for (int c = 0; c < dw; ++c) colsum[c] = 3 * n[c] + f[c];
  for (int x = 0; x < width; ++x) {
    const int c = x >> 1;
    const int t3 = 3 * colsum[c];
    if (x & 1) {
      const int nx = c + 1 < dw ? colsum[c + 1] : colsum[c];
      dst[x] = static_cast<uint8_t>((t3 + nx + 7) >> 4);
    } else {
      const int pv = c > 0 ? colsum[c - 1] : colsum[c];
      dst[x] = static_cast<uint8_t>((t3 + pv + 8) >> 4);
    }
  }
}

int decode_one_rgb(const uint8_t* data, size_t len, const uint8_t* tables,
                   size_t tables_len, int tile_h, int tile_w, uint8_t* dst,
                   bool fancy) {
  Decoded d;
  const int rc = decode_jpeg(data, len, tables, tables_len, tile_h, tile_w,
                             fancy ? Form::kFancy : Form::kNearest, &d);
  if (rc != kOk) return rc;
  const int w = d.width, h = d.height;
  const int copy_w = w < tile_w ? w : tile_w;
  const int copy_h = h < tile_h ? h : tile_h;
  std::vector<uint8_t> cb(w), cr(w);
  std::vector<int> colsum(w);
  for (int y = 0; y < copy_h; ++y) {
    uint8_t* o = dst + static_cast<size_t>(y) * tile_w * 3;
    const uint8_t* c0 = d.plane[0].row(y);
    if (d.nf == 1) {
      for (int x = 0; x < copy_w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
      continue;
    }
    upsample_row(d, 1, y, fancy, w, cb.data(), colsum.data());
    upsample_row(d, 2, y, fancy, w, cr.data(), colsum.data());
    if (d.ycc) {
      for (int x = 0; x < copy_w; ++x) {
        const int yy = c0[x], b = cb[x], r = cr[x];
        o[3 * x] = clamp255(yy + kYcc.cr_r[r]);
        o[3 * x + 1] = clamp255(yy + ((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
        o[3 * x + 2] = clamp255(yy + kYcc.cb_b[b]);
      }
    } else {
      for (int x = 0; x < copy_w; ++x) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = cb[x];
        o[3 * x + 2] = cr[x];
      }
    }
  }
  // pad right/bottom with white if the encoded tile is smaller than the grid
  if (w < tile_w) {
    for (int y = 0; y < tile_h; ++y)
      std::memset(dst + (static_cast<size_t>(y) * tile_w + w) * 3, 255,
                  static_cast<size_t>(tile_w - w) * 3);
  }
  if (h < tile_h)
    std::memset(dst + static_cast<size_t>(h) * tile_w * 3, 255,
                static_cast<size_t>(tile_h - h) * tile_w * 3);
  return kOk;
}

// Raw 4:2:0 planes: dst_y (tile_h, tile_w), dst_cbcr (ceil(tile_h/2),
// ceil(tile_w/2), 2) interleaved Cb, Cr; an undersized tile is padded with
// white (Y 255, Cb = Cr = 128), as the RGB form pads.
int decode_one_planar(const uint8_t* data, size_t len, const uint8_t* tables,
                      size_t tables_len, int tile_h, int tile_w,
                      uint8_t* dst_y, uint8_t* dst_cbcr) {
  Decoded d;
  const int rc = decode_jpeg(data, len, tables, tables_len, tile_h, tile_w,
                             Form::kPlanar, &d);
  if (rc != kOk) return rc;
  const int w = d.width, h = d.height;
  const int copy_w = w < tile_w ? w : tile_w;
  const int copy_h = h < tile_h ? h : tile_h;
  for (int y = 0; y < tile_h; ++y) {
    uint8_t* row = dst_y + static_cast<size_t>(y) * tile_w;
    if (y < copy_h) {
      std::memcpy(row, d.plane[0].row(y), copy_w);
      if (copy_w < tile_w) std::memset(row + copy_w, 255, tile_w - copy_w);
    } else {
      std::memset(row, 255, tile_w);
    }
  }
  const int cw_out = (tile_w + 1) / 2, ch_out = (tile_h + 1) / 2;
  const int cw_in = (w + 1) / 2, ch_in = (h + 1) / 2;
  const int ccopy_w = cw_in < cw_out ? cw_in : cw_out;
  const int ccopy_h = ch_in < ch_out ? ch_in : ch_out;
  for (int y = 0; y < ch_out; ++y) {
    uint8_t* row = dst_cbcr + static_cast<size_t>(y) * cw_out * 2;
    if (y < ccopy_h) {
      const uint8_t* cb = d.plane[1].row(y);
      const uint8_t* cr = d.plane[2].row(y);
      for (int x = 0; x < ccopy_w; ++x) {
        row[2 * x] = cb[x];
        row[2 * x + 1] = cr[x];
      }
      for (int x = ccopy_w; x < cw_out; ++x) row[2 * x] = row[2 * x + 1] = 128;
    } else {
      std::memset(row, 128, static_cast<size_t>(cw_out) * 2);
    }
  }
  return kOk;
}

bool decode_one_deflate(const uint8_t* data, size_t len, int tile_h,
                        int tile_w, uint8_t* dst) {
  uLongf out_len = static_cast<uLongf>(tile_h) * tile_w * 3;
  const int rc = uncompress(dst, &out_len, data, static_cast<uLong>(len));
  if (rc != Z_OK && rc != Z_BUF_ERROR) return false;
  if (out_len < static_cast<uLongf>(tile_h) * tile_w * 3) {
    std::memset(dst + out_len, 255,
                static_cast<size_t>(tile_h) * tile_w * 3 - out_len);
  }
  return true;
}

// Runs work(i) for i in [0, n) on `threads` threads (<= 0: one per core);
// work returns a status; returns how many were not kOk. An exception (a
// failed allocation) fails that tile only.
int run_pool(int n, int threads, const std::function<int(int)>& work) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  if (threads > n) threads = n > 0 ? n : 1;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto body = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int rc;
      try {
        rc = work(i);
      } catch (...) {
        rc = kCorrupt;
      }
      if (rc != kOk) failures.fetch_add(1);
    }
  };
  if (threads == 1) {
    body();
    return failures.load();
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(body);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // namespace

extern "C" {

int decode_jpeg_batch_status(const char** blobs, const size_t* sizes, int n,
                             const char* tables, size_t tables_len,
                             int tile_h, int tile_w, int form, void* out0,
                             void* out1, int* status, int threads) {
  uint8_t* o0 = static_cast<uint8_t*>(out0);
  uint8_t* o1 = static_cast<uint8_t*>(out1);
  const uint8_t* tbl = reinterpret_cast<const uint8_t*>(tables);
  const size_t rgb_bytes = static_cast<size_t>(tile_h) * tile_w * 3;
  const size_t y_bytes = static_cast<size_t>(tile_h) * tile_w;
  const size_t c_bytes =
      static_cast<size_t>((tile_h + 1) / 2) * ((tile_w + 1) / 2) * 2;
  return run_pool(n, threads, [&](int i) {
    const uint8_t* blob = reinterpret_cast<const uint8_t*>(blobs[i]);
    int rc;
    try {
      rc = form == 2 ? decode_one_planar(blob, sizes[i], tbl, tables_len, tile_h,
                                         tile_w, o0 + y_bytes * i, o1 + c_bytes * i)
                     : decode_one_rgb(blob, sizes[i], tbl, tables_len, tile_h,
                                      tile_w, o0 + rgb_bytes * i, form == 0);
    } catch (...) {
      rc = kCorrupt;
    }
    if (status != nullptr) status[i] = rc;
    return rc;
  });
}

int decode_jpeg_batch_opts(const char** blobs, const size_t* sizes, int n,
                           const char* tables, size_t tables_len, int tile_h,
                           int tile_w, void* out, int threads, int fancy) {
  return decode_jpeg_batch_status(blobs, sizes, n, tables, tables_len, tile_h,
                                  tile_w, fancy ? 0 : 1, out, nullptr,
                                  nullptr, threads);
}

int decode_jpeg_batch(const char** blobs, const size_t* sizes, int n,
                      const char* tables, size_t tables_len, int tile_h,
                      int tile_w, void* out, int threads) {
  return decode_jpeg_batch_opts(blobs, sizes, n, tables, tables_len, tile_h,
                                tile_w, out, threads, /*fancy=*/1);
}

// `ok` (nullable): per-tile success flags, so a batch with one non-4:2:0
// tile still hands back every plane pair that decoded.
int decode_jpeg_batch_planar(const char** blobs, const size_t* sizes, int n,
                             const char* tables, size_t tables_len, int tile_h,
                             int tile_w, void* out_y, void* out_cbcr,
                             unsigned char* ok, int threads) {
  std::vector<int> status(n > 0 ? n : 1);
  const int failed = decode_jpeg_batch_status(blobs, sizes, n, tables,
                                              tables_len, tile_h, tile_w, 2,
                                              out_y, out_cbcr, status.data(),
                                              threads);
  if (ok != nullptr)
    for (int i = 0; i < n; ++i) ok[i] = status[i] == kOk ? 1 : 0;
  return failed;
}

int decode_deflate_batch(const char** blobs, const size_t* sizes, int n,
                         int tile_h, int tile_w, void* out, int threads) {
  uint8_t* dst0 = static_cast<uint8_t*>(out);
  const size_t tile_bytes = static_cast<size_t>(tile_h) * tile_w * 3;
  return run_pool(n, threads, [&](int i) {
    return decode_one_deflate(reinterpret_cast<const uint8_t*>(blobs[i]),
                              sizes[i], tile_h, tile_w, dst0 + tile_bytes * i)
               ? kOk
               : kCorrupt;
  });
}

}  // extern "C"
