// The port's image decoder core: PNG row unfiltering and baseline JPEG.
//
// Built at first use by dalle_tpu_torch/data/image_codec.py and called
// through ctypes (which releases the GIL, so decode threads run in
// parallel). The bytes are untrusted: every read is checked against the
// buffer's end, and a fault is reported as a return code with a message,
// never by crashing the process.
//
// The JPEG path follows libjpeg(-turbo)'s default decode, so that its
// output stays near PIL's: the integer "islow" inverse DCT, "fancy"
// triangle upsampling of the chroma (h2v1, h2v2, h1v2; replication where
// libjpeg replicates), edge rows replicated as its context rows are, and
// its fixed-point YCbCr -> RGB tables.
//
// Return codes: 0 ok, -1 corrupt or truncated data, -2 a format this core
// does not decode (progressive, arithmetic, lossless, 12-bit, CMYK, ...).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kOk = 0, kCorrupt = -1, kUnsupported = -2;
const int64_t kMaxPixels = 178956970;   // PIL's decompression-bomb limit

struct Fail {
  int code;
  char msg[200];
};

[[noreturn]] void fail(int code, const char* msg) {
  Fail f;
  f.code = code;
  std::snprintf(f.msg, sizeof f.msg, "%s", msg);
  throw f;
}

int report(const Fail& f, char* err, int errlen) {
  if (err != nullptr && errlen > 0) std::snprintf(err, errlen, "%s", f.msg);
  return f.code;
}

// ---------------------------------------------------------------------------
// PNG: undo the per-row filters of an inflated, non-interlaced 8-bit image
// ---------------------------------------------------------------------------

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void png_unfilter_impl(const uint8_t* data, int64_t n, int32_t width, int32_t height,
                       int32_t bpp, uint8_t* out) {
  if (width <= 0 || height <= 0 || bpp < 1 || bpp > 8) fail(kCorrupt, "bad PNG geometry");
  const int64_t stride = int64_t(width) * bpp;
  if (n < height * (stride + 1)) fail(kCorrupt, "PNG image data is truncated");
  std::vector<uint8_t> zero(stride, 0);
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* row = data + y * (stride + 1);
    const int ftype = row[0];
    const uint8_t* src = row + 1;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = y > 0 ? out + (y - 1) * stride : zero.data();
    switch (ftype) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) dst[i] = uint8_t(src[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + ((left + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? dst[i - bpp] : 0;
          int ul = i >= bpp ? up[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(left, up[i], ul));
        }
        break;
      default:
        fail(kCorrupt, "PNG row has an unknown filter type");
    }
  }
}

// ---------------------------------------------------------------------------
// baseline JPEG
// ---------------------------------------------------------------------------

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];
  int nvals = 0;
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;            // blocks across and down in the plane
  int dw = 0, dh = 0;            // downsampled size (libjpeg's downsampled_width/height)
  std::vector<uint8_t> plane;    // bw*8 x bh*8 samples
  int pred = 0;
  bool seen = false;
};

struct Reader {
  const uint8_t* p;
  int64_t n, pos = 0;
  uint8_t u8() {
    if (pos >= n) fail(kCorrupt, "JPEG data is truncated");
    return p[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
};

struct BitReader {
  const uint8_t* p;
  int64_t n, pos;
  uint32_t acc = 0;
  int bits = 0;
  bool marker = false;   // a marker was reached: further bits are zeros

  void fill() {
    while (bits <= 24) {
      uint32_t byte = 0;
      if (!marker) {
        if (pos >= n) fail(kCorrupt, "JPEG data is truncated");
        byte = p[pos];
        if (byte == 0xFF) {
          if (pos + 1 >= n) fail(kCorrupt, "JPEG data is truncated");
          uint8_t next = p[pos + 1];
          if (next == 0x00) {
            pos += 2;
          } else if (next == 0xFF) {
            pos += 1;        // fill bytes before a marker
            continue;
          } else {
            marker = true;   // libjpeg pads with zeros up to the marker
            byte = 0;
          }
        } else {
          pos += 1;
        }
      }
      acc |= byte << (24 - bits);
      bits += 8;
    }
  }
  int bit() {
    if (bits == 0) fill();
    int b = int(acc >> 31);
    acc <<= 1;
    --bits;
    return b;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (bits < k) fill();
    int v = int(acc >> (32 - k));
    acc <<= k;
    bits -= k;
    return v;
  }
  void reset() {
    acc = 0;
    bits = 0;
    marker = false;
  }
};

int decode_huff(BitReader& br, const Huffman& h) {
  int code = br.bit();
  int l = 1;
  while (code > h.maxcode[l]) {
    code = (code << 1) | br.bit();
    if (++l > 16) fail(kCorrupt, "bad Huffman code in JPEG data");
  }
  int idx = h.valptr[l] + code - h.mincode[l];
  if (idx < 0 || idx >= h.nvals) fail(kCorrupt, "bad Huffman code in JPEG data");
  return h.vals[idx];
}

int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// libjpeg's jidctint.c (the "islow" method), with its range-limit table
const int kConstBits = 13, kPass1Bits = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return int32_t((x + (int64_t(1) << (n - 1))) >> n); }

uint8_t idct_limit(int32_t v) {
  // post-IDCT table of libjpeg: index v & 1023 of the centred sample
  int x = v & 1023;
  if (x < 128) return uint8_t(x + 128);
  if (x < 512) return 255;
  if (x < 896) return 0;
  return uint8_t(x - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int32_t dc = (int32_t(in[0]) * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qp[16], z3 = int64_t(in[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qp[0];
    z3 = int64_t(in[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qp[56];
    tmp1 = int64_t(in[40]) * qp[40];
    tmp2 = int64_t(in[24]) * qp[24];
    tmp3 = int64_t(in[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

struct Jpeg {
  Reader rd;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool have_frame = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[4];

  explicit Jpeg(const uint8_t* p, int64_t n) { rd.p = p, rd.n = n; }

  void read_dqt(int len) {
    int64_t end = rd.pos + len;
    while (rd.pos < end) {
      int pq_tq = rd.u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail(kCorrupt, "bad JPEG quantization table");
      for (int i = 0; i < 64; ++i) qt[tq][kZigzag[i]] = uint16_t(pq ? rd.u16() : rd.u8());
      qdef[tq] = true;
    }
    if (rd.pos != end) fail(kCorrupt, "bad JPEG quantization table length");
  }

  void read_dht(int len) {
    int64_t end = rd.pos + len;
    while (rd.pos < end) {
      int tc_th = rd.u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(kCorrupt, "bad JPEG Huffman table");
      Huffman& h = tc ? ac[th] : dc[th];
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = rd.u8();
      if (total > 256) fail(kCorrupt, "bad JPEG Huffman table");
      for (int i = 0; i < total; ++i) h.vals[i] = rd.u8();
      h.nvals = total;
      int code = 0, k = 0;
      for (int l = 1; l <= 16; ++l) {
        h.valptr[l] = k;
        h.mincode[l] = code;
        code += counts[l];
        k += counts[l];
        h.maxcode[l] = counts[l] ? code - 1 : -1;
        if (code > (1 << l)) fail(kCorrupt, "bad JPEG Huffman table");
        code <<= 1;
      }
      h.maxcode[17] = 0x7fffffff;
      h.defined = true;
    }
    if (rd.pos != end) fail(kCorrupt, "bad JPEG Huffman table length");
  }

  void read_sof(int marker, int len) {
    if (have_frame) fail(kCorrupt, "two JPEG frames");
    if (marker != 0xC0 && marker != 0xC1) {
      if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
        fail(kUnsupported, "progressive JPEG");
      if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
        fail(kUnsupported, "lossless JPEG");
      fail(kUnsupported, "arithmetic-coded JPEG");
    }
    int64_t end = rd.pos + len;
    int precision = rd.u8();
    height = rd.u16();
    width = rd.u16();
    ncomp = rd.u8();
    if (precision != 8) fail(kUnsupported, "JPEG with other than 8-bit samples");
    if (height == 0) fail(kUnsupported, "JPEG whose height comes in a DNL marker");
    if (width == 0) fail(kCorrupt, "JPEG of width 0");
    if (int64_t(width) * height > kMaxPixels) fail(kCorrupt, "JPEG is too large");
    if (ncomp != 1 && ncomp != 3) fail(kUnsupported, "JPEG with other than 1 or 3 components");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = rd.u8();
      int hv = rd.u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = rd.u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(kCorrupt, "bad JPEG component");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    if (rd.pos != end) fail(kCorrupt, "bad JPEG frame header length");
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail(kUnsupported, "JPEG with fractional sampling");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
    }
    have_frame = true;
  }

  void decode_block(BitReader& br, Component& c, uint8_t* out, int stride) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof coef);
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int t = decode_huff(br, hd);
    if (t > 11) fail(kCorrupt, "bad JPEG DC coefficient");
    int diff = t ? extend(br.get(t), t) : 0;
    c.pred += diff;
    coef[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs = decode_huff(br, ha);
      int r = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (r != 15) break;   // end of block
        k += 16;
        continue;
      }
      k += r;
      if (k > 63) fail(kCorrupt, "bad JPEG AC coefficient run");
      coef[kZigzag[k]] = int16_t(extend(br.get(s), s));
      ++k;
    }
    idct_islow(coef, qt[c.tq], out, stride);
  }

  void read_scan(int len) {
    int64_t end = rd.pos + len;
    if (!have_frame) fail(kCorrupt, "JPEG scan before its frame header");
    int ns = rd.u8();
    if (ns < 1 || ns > ncomp) fail(kCorrupt, "bad JPEG scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = rd.u8(), tables = rd.u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) found = &comp[j];
      if (found == nullptr || found->seen) fail(kCorrupt, "bad JPEG scan component");
      found->seen = true;
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        fail(kCorrupt, "JPEG scan names an undefined Huffman table");
      if (!qdef[found->tq]) fail(kCorrupt, "JPEG component names an undefined quantization table");
      found->pred = 0;
      sc[i] = found;
    }
    int ss = rd.u8(), se = rd.u8(), ahal = rd.u8();
    if (ss != 0 || se != 63 || ahal != 0) fail(kUnsupported, "progressive JPEG");
    if (rd.pos != end) fail(kCorrupt, "bad JPEG scan header length");

    BitReader br{rd.p, rd.n, rd.pos};
    int units_x, units_y;
    if (ns == 1) {   // a non-interleaved scan: one block per unit
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    const int64_t total = int64_t(units_x) * units_y;
    int next_rst = 0;
    for (int64_t u = 0; u < total; ++u) {
      if (restart && u > 0 && u % restart == 0) {
        // the restart marker RSTn, n counting 0..7: skip the bits left,
        // find the marker, reset the predictions
        br.reset();
        int64_t p = br.pos;
        while (p < rd.n && rd.p[p] != 0xFF) ++p;    // stray bytes (corrupt)
        while (p + 1 < rd.n && rd.p[p] == 0xFF && rd.p[p + 1] == 0xFF) ++p;
        if (p + 1 >= rd.n) fail(kCorrupt, "JPEG data is truncated");
        if (rd.p[p + 1] != 0xD0 + next_rst) fail(kCorrupt, "JPEG restart marker out of order");
        br.pos = p + 2;
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
      const int ux = int(u % units_x), uy = int(u / units_x);
      if (ns == 1) {
        Component& c = *sc[0];
        const int stride = c.bw * 8;
        decode_block(br, c, c.plane.data() + size_t(uy) * 8 * stride + ux * 8, stride);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          const int stride = c.bw * 8;
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              size_t row = size_t(uy * c.v + by) * 8, col = size_t(ux * c.h + bx) * 8;
              decode_block(br, c, c.plane.data() + row * stride + col, stride);
            }
        }
      }
    }
    // resume marker parsing after the entropy-coded data
    int64_t p = br.pos;
    for (;;) {
      if (p + 1 >= rd.n) fail(kCorrupt, "JPEG data is truncated");
      if (rd.p[p] == 0xFF && rd.p[p + 1] != 0x00 && rd.p[p + 1] != 0xFF &&
          !(rd.p[p + 1] >= 0xD0 && rd.p[p + 1] <= 0xD7))
        break;
      ++p;
    }
    rd.pos = p;
  }

  void parse() {
    if (rd.u8() != 0xFF || rd.u8() != 0xD8) fail(kCorrupt, "not a JPEG");
    for (;;) {
      int b = rd.u8();
      if (b != 0xFF) fail(kCorrupt, "bad JPEG marker");
      int m = rd.u8();
      while (m == 0xFF) m = rd.u8();
      if (m == 0xD9) break;   // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = rd.u16() - 2;
      if (len < 0 || rd.pos + len > rd.n) fail(kCorrupt, "JPEG data is truncated");
      if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xDD) {
        if (len != 2) fail(kCorrupt, "bad JPEG restart interval");
        restart = rd.u16();
      } else if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m, len);
      } else if (m == 0xCC) {
        fail(kUnsupported, "arithmetic-coded JPEG");
      } else if (m == 0xDA) {
        read_scan(len);
      } else {
        if (m == 0xE0 && len >= 5 && std::memcmp(rd.p + rd.pos, "JFIF\0", 5) == 0) jfif = true;
        if (m == 0xEE && len >= 12 && std::memcmp(rd.p + rd.pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = rd.p[rd.pos + 11];
        }
        rd.pos += len;   // APPn, COM and the rest
      }
    }
    if (!have_frame) fail(kCorrupt, "JPEG without a frame");
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].seen) fail(kCorrupt, "JPEG component missing from every scan");
  }

  // a component's row r of downsampled samples, edge rows replicated as
  // libjpeg's context rows are
  const uint8_t* row(const Component& c, int r) const {
    if (r < 0) r = 0;
    if (r >= c.dh) r = c.dh - 1;
    return c.plane.data() + size_t(r) * c.bw * 8;
  }

  // the component upsampled to (vmax/v)*dh rows by (hmax/h)*dw columns
  std::vector<uint8_t> upsample(const Component& c, int& ow) const {
    const int fx = hmax / c.h, fy = vmax / c.v;
    ow = c.dw * fx;
    const int oh = c.dh * fy;
    std::vector<uint8_t> out(size_t(ow) * oh);
    const bool fancy = c.dw > 2;
    if (fx == 1 && fy == 1) {
      for (int y = 0; y < oh; ++y) std::memcpy(&out[size_t(y) * ow], row(c, y), ow);
    } else if (fx == 2 && fy == 1 && fancy) {
      for (int y = 0; y < c.dh; ++y) {
        const uint8_t* in = row(c, y);
        uint8_t* o = &out[size_t(y) * ow];
        int iv = in[0];
        *o++ = uint8_t(iv);
        *o++ = uint8_t((iv * 3 + in[1] + 2) >> 2);
        int x = 1;
        for (int col = c.dw - 2; col > 0; --col, ++x) {
          iv = in[x] * 3;
          *o++ = uint8_t((iv + in[x - 1] + 1) >> 2);
          *o++ = uint8_t((iv + in[x + 1] + 2) >> 2);
        }
        iv = in[x];
        *o++ = uint8_t((iv * 3 + in[x - 1] + 1) >> 2);
        *o++ = uint8_t(iv);
      }
    } else if (fx == 2 && fy == 2 && fancy) {
      for (int y = 0; y < c.dh; ++y) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* in0 = row(c, y);
          const uint8_t* in1 = row(c, v == 0 ? y - 1 : y + 1);
          uint8_t* o = &out[size_t(2 * y + v) * ow];
          int thiscs = in0[0] * 3 + in1[0];
          int nextcs = in0[1] * 3 + in1[1];
          *o++ = uint8_t((thiscs * 4 + 8) >> 4);
          *o++ = uint8_t((thiscs * 3 + nextcs + 7) >> 4);
          int lastcs = thiscs;
          thiscs = nextcs;
          int x = 2;
          for (int col = c.dw - 2; col > 0; --col, ++x) {
            nextcs = in0[x] * 3 + in1[x];
            *o++ = uint8_t((thiscs * 3 + lastcs + 8) >> 4);
            *o++ = uint8_t((thiscs * 3 + nextcs + 7) >> 4);
            lastcs = thiscs;
            thiscs = nextcs;
          }
          *o++ = uint8_t((thiscs * 3 + lastcs + 8) >> 4);
          *o++ = uint8_t((thiscs * 4 + 7) >> 4);
        }
      }
    } else if (fx == 1 && fy == 2) {
      // libjpeg-turbo's h1v2 triangle filter
      for (int y = 0; y < c.dh; ++y)
        for (int v = 0; v < 2; ++v) {
          const uint8_t* in0 = row(c, y);
          const uint8_t* in1 = row(c, v == 0 ? y - 1 : y + 1);
          const int bias = v == 0 ? 1 : 2;
          uint8_t* o = &out[size_t(2 * y + v) * ow];
          for (int x = 0; x < c.dw; ++x) o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
        }
    } else {
      // replication, as libjpeg's box upsampling
      for (int y = 0; y < oh; ++y) {
        const uint8_t* in = row(c, y / fy);
        uint8_t* o = &out[size_t(y) * ow];
        for (int x = 0; x < ow; ++x) o[x] = in[x / fx];
      }
    }
    return out;
  }

  void finish(uint8_t* out) {
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < height; ++y)
        std::memcpy(out + size_t(y) * width, c.plane.data() + size_t(y) * c.bw * 8, width);
      return;
    }
    int w0, w1, w2;
    std::vector<uint8_t> p0 = upsample(comp[0], w0);
    std::vector<uint8_t> p1 = upsample(comp[1], w1);
    std::vector<uint8_t> p2 = upsample(comp[2], w2);
    if (w0 < width || w1 < width || w2 < width) fail(kCorrupt, "bad JPEG sampling");
    // RGB unless YCbCr: libjpeg's rule (JFIF means YCbCr; Adobe's transform
    // flag; else the component ids 'R', 'G', 'B')
    bool rgb = false;
    if (!jfif) {
      if (adobe) rgb = adobe_transform == 0;
      else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }
    // jdcolor.c's tables: SCALEBITS 16, ONE_HALF 1 << 15
    static int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    static bool tables = false;
    if (!tables) {
      const int64_t one_half = int64_t(1) << 15;
      auto fix = [](double v) { return int64_t(v * 65536.0 + 0.5); };
      for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = int32_t((fix(1.40200) * x + one_half) >> 16);
        cb_b[i] = int32_t((fix(1.77200) * x + one_half) >> 16);
        cr_g[i] = int32_t(-fix(0.71414) * x);
        cb_g[i] = int32_t(-fix(0.34414) * x + one_half);
      }
      tables = true;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height; ++y) {
      const uint8_t* a = &p0[size_t(y) * w0];
      const uint8_t* b = &p1[size_t(y) * w1];
      const uint8_t* c = &p2[size_t(y) * w2];
      uint8_t* o = out + size_t(y) * width * 3;
      for (int x = 0; x < width; ++x, o += 3) {
        if (rgb) {
          o[0] = a[x], o[1] = b[x], o[2] = c[x];
          continue;
        }
        int yy = a[x], cb = b[x], cr = c[x];
        o[0] = clamp(yy + cr_r[cr]);
        o[1] = clamp(yy + int((int64_t(cb_g[cb]) + cr_g[cr]) >> 16));
        o[2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

}  // namespace

extern "C" {

int png_unfilter(const uint8_t* data, int64_t n, int32_t width, int32_t height, int32_t bpp,
                 uint8_t* out, char* err, int32_t errlen) {
  try {
    png_unfilter_impl(data, n, width, height, bpp, out);
    return kOk;
  } catch (const Fail& f) {
    return report(f, err, errlen);
  } catch (...) {
    std::snprintf(err, errlen, "PNG decode failed");
    return kCorrupt;
  }
}

// The frame's size and component count, read from the headers alone.
int jpeg_info(const uint8_t* data, int64_t n, int32_t* width, int32_t* height,
              int32_t* ncomp, char* err, int32_t errlen) {
  try {
    Reader rd{data, n};
    if (rd.u8() != 0xFF || rd.u8() != 0xD8) fail(kCorrupt, "not a JPEG");
    for (;;) {
      if (rd.u8() != 0xFF) fail(kCorrupt, "bad JPEG marker");
      int m = rd.u8();
      while (m == 0xFF) m = rd.u8();
      if (m == 0xD9 || m == 0xDA) fail(kCorrupt, "JPEG without a frame header");
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = rd.u16() - 2;
      if (len < 0 || rd.pos + len > rd.n) fail(kCorrupt, "JPEG data is truncated");
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        Jpeg j(data, n);
        j.rd.pos = rd.pos;
        j.read_sof(m, len);
        *width = j.width;
        *height = j.height;
        *ncomp = j.ncomp;
        return kOk;
      }
      rd.pos += len;
    }
  } catch (const Fail& f) {
    return report(f, err, errlen);
  } catch (...) {
    std::snprintf(err, errlen, "JPEG decode failed");
    return kCorrupt;
  }
}

// Decode into out: height x width x ncomp samples (RGB for 3 components).
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t width, int32_t height,
                int32_t ncomp, char* err, int32_t errlen) {
  try {
    Jpeg j(data, n);
    j.parse();
    if (j.width != width || j.height != height || j.ncomp != ncomp)
      fail(kCorrupt, "JPEG headers changed between reads");
    j.finish(out);
    return kOk;
  } catch (const Fail& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    std::snprintf(err, errlen, "JPEG too large to decode");
    return kCorrupt;
  } catch (...) {
    std::snprintf(err, errlen, "JPEG decode failed");
    return kCorrupt;
  }
}

}  // extern "C"
