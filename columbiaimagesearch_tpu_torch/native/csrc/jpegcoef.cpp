// jpegcoef: JPEG entropy decoder to quantized DCT coefficients, with no
// libjpeg. Host half of the device JPEG decode
// (columbiaimagesearch_tpu_torch/models/jpeg_device.py).
//
// It implements the contract of imgpipe_read_coeffs_batch
// (native/imgpipe.cpp:284-440): the same layouts, status codes, 4:2:0
// test, shared-chroma-table test, natural-order msub x msub corner and
// thread pool. The coefficients of a JPEG are fixed by its bitstream, so
// this reader follows libjpeg-turbo's reading rules where they decide a
// value: the marker reader (jdmarker.c), the colour-space guess
// (jdapimin.c default_decompress_parms), the sequential and progressive
// Huffman decoders (jdhuff.c, jdphuff.c) with their restart handling, and
// the memory source, which feeds a fake EOI (FF D9) once the data ends.
// Past a marker the bit reader yields zero bits; the MCU in which a bit
// past the data is first consumed is completed with zeros and the rest of
// that segment is left as it is (all zero for a fresh block).
//
// Frames: SOF0, SOF1 and SOF2 (baseline, extended sequential, and
// progressive with spectral selection and successive approximation),
// DRI/RSTn, 8- and 16-bit DQT, any Huffman tables (in a sequential frame,
// slots 0 and 1 default to the standard tables when the file defines
// none, as libjpeg-turbo's sequential decoder does). Frames libjpeg-turbo refuses (lossless, hierarchical,
// 12-bit) return -1 as it does; arithmetic-coded frames (SOF9, SOF10),
// which it decodes, return -3 here and take the pixel path.
//
// Layouts (C-contiguous):
//   ycoef  int16  [n, max_bh, max_bw, msub*msub]
//   ccoef  int16  [n, 2, max_bh/2, max_bw/2, msub*msub]
//   qtab   uint16 [n, 2, msub*msub]   (luma table, chroma table)
//   dims   int32  [n, 6]  h, w, bh, bw, cbh, cbw
//   status int32  [n]     0 ok; -1 decode fail; -2 empty; -3 unsupported;
//                         -4 grid exceeds bucket
//
// C ABI only; bound with ctypes (columbiaimagesearch_tpu_torch/native/
// imgpipe.py).

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

struct Fail {};  // libjpeg's ERREXIT: status -1

// Zigzag index -> natural index, with 16 extra entries of 63 so that a
// corrupt run length past the block lands on the last coefficient.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of ITU-T T.81 K.3 (libjpeg-turbo jstdhuff.c).
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVal[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChrVal[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVal[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVal[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

enum {
  M_SOF0 = 0xc0, M_SOF1 = 0xc1, M_SOF2 = 0xc2, M_SOF3 = 0xc3, M_DHT = 0xc4,
  M_SOF5 = 0xc5, M_SOF6 = 0xc6, M_SOF7 = 0xc7, M_JPG = 0xc8, M_SOF9 = 0xc9,
  M_SOF10 = 0xca, M_SOF11 = 0xcb, M_DAC = 0xcc, M_SOF13 = 0xcd,
  M_SOF14 = 0xce, M_SOF15 = 0xcf, M_RST0 = 0xd0, M_RST7 = 0xd7,
  M_SOI = 0xd8, M_EOI = 0xd9, M_SOS = 0xda, M_DQT = 0xdb, M_DNL = 0xdc,
  M_DRI = 0xdd, M_APP0 = 0xe0, M_APP14 = 0xee, M_APP15 = 0xef,
  M_COM = 0xfe, M_TEM = 0x01
};

// The memory source: the buffer, then FF D9 repeated, as libjpeg's
// jpeg_mem_src inserts a fake EOI each time it runs dry.
struct Source {
  const uint8_t* buf;
  int64_t len;
  int64_t pos = 0;
  int byte() {
    int64_t p = pos++;
    if (p < len) return buf[p];
    return ((p - len) & 1) ? 0xD9 : 0xFF;
  }
  int two() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(int64_t n) {
    if (n > 0) pos += n;
  }
};

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t val[256] = {0};
};

struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
  uint16_t look[256];  // (length << 8) | symbol for codes of <= 8 bits
};

// jpeg_make_d_derived_tbl (jdhuff.c): the same validity checks.
void derive(const HuffTable& t, bool is_dc, Derived* d) {
  if (!t.defined) throw Fail();
  char huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) throw Fail();
    while (i--) huffsize[p++] = char(l);
  }
  huffsize[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (int(huffsize[p]) == si) {
      huffcode[p++] = code;
      code++;
    }
    if (int64_t(code) >= (int64_t(1) << si)) throw Fail();
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      d->valoffset[l] = p - int32_t(huffcode[p]);
      p += t.bits[l];
      d->maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;
  memcpy(d->val, t.val, sizeof(d->val));
  memset(d->look, 0, sizeof(d->look));
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int lookbits = int(huffcode[p]) << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--)
        d->look[lookbits++] = uint16_t((l << 8) | t.val[p]);
    }
  }
  if (is_dc) {
    for (int i = 0; i < nsym; i++)
      if (t.val[i] > 15) throw Fail();
  }
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;          // width/height in blocks
  int bw_pad = 0, bh_pad = 0;  // rounded up to the sampling factors
  bool latched = false;
  // [bh_pad, bw_pad, 64], natural order. calloc: pages a truncated or
  // partial scan never writes stay untouched, so a huge header costs no
  // memory until its data does.
  std::unique_ptr<int16_t, decltype(&std::free)> coef{nullptr, &std::free};
  int16_t* block(int by, int bx) {
    return coef.get() + (size_t(by) * bw_pad + bx) * 64;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* buf, int64_t len) { src_.buf = buf; src_.len = len; }

  // jpeg_read_header: markers up to the first SOS, then initial_setup
  // and the colour-space guess. Throws Fail where libjpeg errors.
  void read_header() {
    if (read_markers() != M_SOS) throw Fail();  // EOI before any image
    initial_setup();
  }

  // The 4:2:0 YCbCr test of imgpipe.cpp:355-363.
  bool ycc420() const {
    if (ncomp_ != 3) return false;
    bool ycc;
    if (saw_jfif_) {
      ycc = true;
    } else if (saw_adobe_) {
      ycc = adobe_transform_ != 0;
    } else {
      const int c0 = comps_[0].id, c1 = comps_[1].id, c2 = comps_[2].id;
      ycc = !(c0 == 82 && c1 == 71 && c2 == 66);
    }
    return ycc && comps_[0].h == 2 && comps_[0].v == 2 &&
           comps_[1].h == 1 && comps_[1].v == 1 && comps_[2].h == 1 &&
           comps_[2].v == 1;
  }

  bool arithmetic() const { return arith_; }

  // jpeg_read_coefficients: every scan to EOI into the block arrays.
  void read_coefficients() {
    // jinit_huff_decoder fills empty slots 0 and 1 with the standard
    // tables; the progressive decoder does not.
    if (!progressive_) {
      std_table(&dc_[0], kDcLumBits, kDcLumVal);
      std_table(&ac_[0], kAcLumBits, kAcLumVal);
      std_table(&dc_[1], kDcChrBits, kDcChrVal);
      std_table(&ac_[1], kAcChrBits, kAcChrVal);
    }
    for (int ci = 0; ci < ncomp_; ci++) {
      Comp& c = comps_[ci];
      c.coef.reset(static_cast<int16_t*>(
          std::calloc(size_t(c.bh_pad) * c.bw_pad * 64, sizeof(int16_t))));
      if (!c.coef) throw Fail();  // libjpeg: JERR_OUT_OF_MEMORY
    }
    for (;;) {
      decode_scan();
      const int m = read_markers();
      if (m == M_EOI) return;
      if (!multi_scan_) throw Fail();  // JERR_EOI_EXPECTED
    }
  }

  int height() const { return height_; }
  int width() const { return width_; }
  Comp& comp(int i) { return comps_[i]; }
  // The table in a component's slot after the whole read (JAX reads
  // cinfo.quant_tbl_ptrs after jpeg_read_coefficients), or null.
  const uint16_t* qtable(int ci) const {
    const int t = comps_[ci].tq;
    if (t < 0 || t >= 4 || !qdef_[t]) return nullptr;
    return qt_[t];
  }

 private:
  Source src_;
  int unread_ = 0;
  bool saw_soi_ = false, saw_sof_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool progressive_ = false, arith_ = false;
  int precision_ = 8, height_ = 0, width_ = 0, ncomp_ = 0;
  std::vector<Comp> comps_;
  int max_h_ = 1, max_v_ = 1;
  bool multi_scan_ = false;
  int restart_interval_ = 0;
  uint16_t qt_[4][64];
  bool qdef_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  // The current scan.
  int ns_ = 0;
  Comp* scomp_[4] = {nullptr, nullptr, nullptr, nullptr};
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int next_restart_ = 0;
  // Bit reader state.
  uint64_t bbuf_ = 0;
  int bits_ = 0;
  bool insufficient_ = false;

  static void std_table(HuffTable* t, const uint8_t* bits,
                        const uint8_t* val) {
    if (t->defined) return;
    t->defined = true;
    memcpy(t->bits, bits, 17);
    int n = 0;
    for (int i = 1; i <= 16; i++) n += bits[i];
    memset(t->val, 0, sizeof(t->val));
    memcpy(t->val, val, size_t(n));
  }

  // ---------------------------------------------------------- markers

  void next_marker() {
    for (;;) {
      int c = src_.byte();
      while (c != 0xFF) c = src_.byte();
      do {
        c = src_.byte();
      } while (c == 0xFF);
      if (c != 0) {
        unread_ = c;
        return;
      }
    }
  }

  // read_markers (jdmarker.c): returns M_SOS or M_EOI.
  int read_markers() {
    for (;;) {
      if (unread_ == 0) {
        if (!saw_soi_) {
          const int c = src_.byte(), c2 = src_.byte();
          if (c != 0xFF || c2 != M_SOI) throw Fail();
          unread_ = c2;
        } else {
          next_marker();
        }
      }
      const int m = unread_;
      switch (m) {
        case M_SOI:
          if (saw_soi_) throw Fail();
          saw_soi_ = true;
          restart_interval_ = 0;
          saw_jfif_ = saw_adobe_ = false;
          adobe_transform_ = 0;
          break;
        case M_SOF0:
        case M_SOF1:
          get_sof(false, false);
          break;
        case M_SOF2:
          get_sof(true, false);
          break;
        case M_SOF9:
          get_sof(false, true);
          break;
        case M_SOF10:
          get_sof(true, true);
          break;
        case M_SOF3: case M_SOF5: case M_SOF6: case M_SOF7: case M_JPG:
        case M_SOF11: case M_SOF13: case M_SOF14: case M_SOF15:
          throw Fail();  // JERR_SOF_UNSUPPORTED
        case M_SOS:
          get_sos();
          unread_ = 0;
          return M_SOS;
        case M_EOI:
          unread_ = 0;
          return M_EOI;
        case M_DAC:
          get_dac();
          break;
        case M_DHT:
          get_dht();
          break;
        case M_DQT:
          get_dqt();
          break;
        case M_DRI:
          get_dri();
          break;
        case M_COM:
        case M_DNL:
          skip_variable();
          break;
        case M_TEM:
          break;
        default:
          if (m >= M_APP0 && m <= M_APP15) {
            if (m == M_APP0 || m == M_APP14) get_interesting_appn(m);
            else skip_variable();
          } else if (m >= M_RST0 && m <= M_RST7) {
            // parameterless
          } else {
            throw Fail();  // JERR_UNKNOWN_MARKER
          }
      }
      unread_ = 0;
    }
  }

  void skip_variable() {
    int64_t length = src_.two() - 2;
    src_.skip(length);
  }

  void get_interesting_appn(int m) {
    int64_t length = src_.two() - 2;
    uint8_t b[14];
    int numtoread = length >= 14 ? 14 : (length > 0 ? int(length) : 0);
    for (int i = 0; i < numtoread; i++) b[i] = uint8_t(src_.byte());
    length -= numtoread;
    if (m == M_APP0) {
      if (numtoread >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' &&
          b[3] == 'F' && b[4] == 0)
        saw_jfif_ = true;
    } else {
      if (numtoread >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' &&
          b[3] == 'b' && b[4] == 'e') {
        saw_adobe_ = true;
        adobe_transform_ = b[11];
      }
    }
    src_.skip(length);
  }

  void get_sof(bool prog, bool arith) {
    progressive_ = prog;
    arith_ = arith;
    int64_t length = src_.two();
    precision_ = src_.byte();
    height_ = src_.two();
    width_ = src_.two();
    ncomp_ = src_.byte();
    length -= 8;
    if (saw_sof_) throw Fail();
    if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) throw Fail();
    if (length != int64_t(ncomp_) * 3) throw Fail();
    comps_.clear();
    comps_.resize(size_t(ncomp_));
    for (int ci = 0; ci < ncomp_; ci++) {
      Comp& c = comps_[ci];
      c.id = src_.byte();
      const int hv = src_.byte();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = src_.byte();
    }
    saw_sof_ = true;
  }

  void get_sos() {
    if (!saw_sof_) throw Fail();
    const int length = src_.two();
    const int n = src_.byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) throw Fail();
    ns_ = n;
    for (int i = 0; i < 4; i++) scomp_[i] = nullptr;
    for (int i = 0; i < n; i++) {
      const int cc = src_.byte();
      const int c = src_.byte();
      int found = -1;
      for (int ci = 0; ci < ncomp_ && ci < 4; ci++) {
        if (cc == comps_[ci].id && !scomp_[ci]) {
          found = ci;
          break;
        }
      }
      if (found < 0) throw Fail();  // JERR_BAD_COMPONENT_ID
      scomp_[i] = &comps_[found];
      scomp_[i]->dc_tbl = (c >> 4) & 15;
      scomp_[i]->ac_tbl = c & 15;
    }
    ss_ = src_.byte();
    se_ = src_.byte();
    const int a = src_.byte();
    ah_ = (a >> 4) & 15;
    al_ = a & 15;
    next_restart_ = 0;
  }

  void get_dac() {
    int64_t length = src_.two() - 2;
    while (length > 0) {
      const int index = src_.byte();
      const int val = src_.byte();
      length -= 2;
      if (index < 0 || index >= 32) throw Fail();
      if (index < 16) {
        if ((val & 0x0F) > (val >> 4)) throw Fail();
      } else if (val < 1 || val > 63) {
        throw Fail();
      }
    }
    if (length != 0) throw Fail();
  }

  void get_dht() {
    int64_t length = src_.two() - 2;
    while (length > 16) {
      int index = src_.byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = uint8_t(src_.byte());
        count += bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || int64_t(count) > length) throw Fail();
      uint8_t val[256];
      for (int i = 0; i < count; i++) val[i] = uint8_t(src_.byte());
      memset(val + count, 0, size_t(256 - count));
      length -= count;
      HuffTable* t;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) throw Fail();
        t = &ac_[index];
      } else {
        if (index < 0 || index >= 4) throw Fail();
        t = &dc_[index];
      }
      t->defined = true;
      memcpy(t->bits, bits, sizeof(bits));
      memcpy(t->val, val, sizeof(val));
    }
    if (length != 0) throw Fail();
  }

  void get_dqt() {
    int64_t length = src_.two() - 2;
    while (length > 0) {
      length--;
      int n = src_.byte();
      const int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) throw Fail();
      qdef_[n] = true;
      for (int i = 0; i < 64; i++) {
        const int tmp = prec ? src_.two() : src_.byte();
        qt_[n][kNatural[i]] = uint16_t(tmp);
      }
      length -= 64;
      if (prec) length -= 64;
    }
    if (length != 0) throw Fail();
  }

  void get_dri() {
    if (src_.two() != 4) throw Fail();
    restart_interval_ = src_.two();
  }

  // initial_setup (jdinput.c), at the first SOS.
  void initial_setup() {
    if (height_ > 65500 || width_ > 65500) throw Fail();
    if (precision_ != 8) throw Fail();
    if (ncomp_ > 10) throw Fail();
    max_h_ = max_v_ = 1;
    for (const Comp& c : comps_) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) throw Fail();
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    for (Comp& c : comps_) {
      c.bw = int((int64_t(width_) * c.h + max_h_ * 8 - 1) / (max_h_ * 8));
      c.bh = int((int64_t(height_) * c.v + max_v_ * 8 - 1) / (max_v_ * 8));
      c.bw_pad = (c.bw + c.h - 1) / c.h * c.h;
      c.bh_pad = (c.bh + c.v - 1) / c.v * c.v;
    }
    multi_scan_ = ns_ < ncomp_ || progressive_;
  }

  // ------------------------------------------------------- bit reader

  // jpeg_fill_bit_buffer: whole bytes up to a marker, FF00 unstuffed.
  void fill() {
    while (bits_ <= 56 && unread_ == 0) {
      int c = src_.byte();
      if (c == 0xFF) {
        do {
          c = src_.byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_ = c;
          break;
        }
      }
      bbuf_ = (bbuf_ << 8) | uint64_t(c);
      bits_ += 8;
    }
  }

  // The next n (<= 16) bits, zero past the data, without consuming them.
  uint32_t peek(int n) {
    if (bits_ < n) fill();
    if (bits_ >= n) return uint32_t(bbuf_ >> (bits_ - n)) & ((1u << n) - 1);
    return uint32_t(bbuf_ << (n - bits_)) & ((1u << n) - 1);
  }

  void consume(int n) {
    if (n > bits_) {
      insufficient_ = true;  // a bit past the data was used
      bits_ = 0;
    } else {
      bits_ -= n;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    consume(n);
    return int(v);
  }

  int decode(const Derived& t) {
    const uint32_t w = peek(16);
    const uint16_t lk = t.look[w >> 8];
    if (lk) {
      consume(lk >> 8);
      return lk & 0xFF;
    }
    for (int l = 9; l <= 16; l++) {
      const int32_t code = int32_t(w >> (16 - l));
      if (code <= t.maxcode[l]) {
        consume(l);
        return t.val[(code + t.valoffset[l]) & 0xFF];
      }
    }
    consume(17);  // JWRN_HUFF_BAD_CODE: a zero symbol
    return 0;
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - ((1 << s) - 1) : r;
  }

  // ------------------------------------------------------------ scans

  void process_restart(int* last_dc, int* eobrun) {
    bits_ = 0;
    // read_restart_marker
    if (unread_ == 0) next_marker();
    if (unread_ == M_RST0 + next_restart_) {
      unread_ = 0;
    } else {
      resync_to_restart(next_restart_);
    }
    next_restart_ = (next_restart_ + 1) & 7;
    for (int i = 0; i < 4; i++) last_dc[i] = 0;
    *eobrun = 0;
    if (unread_ == 0) insufficient_ = false;
  }

  // jpeg_resync_to_restart (jdmarker.c).
  void resync_to_restart(int desired) {
    int marker = unread_;
    for (;;) {
      int action;
      if (marker < M_SOF0) {
        action = 2;
      } else if (marker < M_RST0 || marker > M_RST7) {
        action = 3;
      } else if (marker == M_RST0 + ((desired + 1) & 7) ||
                 marker == M_RST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == M_RST0 + ((desired - 1) & 7) ||
                 marker == M_RST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_ = 0;
        return;
      }
      if (action == 3) return;
      next_marker();
      marker = unread_;
    }
  }

  void latch_and_check() {
    // per_scan_setup
    int blocks = 0;
    if (ns_ > 1) {
      for (int i = 0; i < ns_; i++) {
        blocks += scomp_[i]->h * scomp_[i]->v;
        if (blocks > 10) throw Fail();  // JERR_BAD_MCU_SIZE
      }
    }
    // latch_quant_tables
    for (int i = 0; i < ns_; i++) {
      Comp* c = scomp_[i];
      if (c->latched) continue;
      if (c->tq < 0 || c->tq >= 4 || !qdef_[c->tq]) throw Fail();
      c->latched = true;
    }
  }

  void decode_scan() {
    latch_and_check();
    bbuf_ = 0;
    bits_ = 0;
    insufficient_ = false;
    // The MCU layout of the scan (per_scan_setup).
    struct Blk {
      int comp, dy, dx;
    };
    std::vector<Blk> mcu;
    int mcus_per_row, mcu_rows;
    if (ns_ == 1) {
      mcus_per_row = scomp_[0]->bw;
      mcu_rows = scomp_[0]->bh;
      mcu.push_back({0, 0, 0});
    } else {
      mcus_per_row = (width_ + max_h_ * 8 - 1) / (max_h_ * 8);
      mcu_rows = (height_ + max_v_ * 8 - 1) / (max_v_ * 8);
      for (int i = 0; i < ns_; i++)
        for (int y = 0; y < scomp_[i]->v; y++)
          for (int x = 0; x < scomp_[i]->h; x++) mcu.push_back({i, y, x});
    }
    const int nblk = int(mcu.size());
    std::vector<int16_t*> blocks(mcu.size());

    // The entropy decoder's start_pass: tables and scan checks.
    Derived dtbl[4], atbl[4];
    enum { SEQ, DC_FIRST, DC_REFINE, AC_FIRST, AC_REFINE } kind;
    if (!progressive_) {
      kind = SEQ;
      for (int i = 0; i < ns_; i++) {
        const int d = scomp_[i]->dc_tbl, a = scomp_[i]->ac_tbl;
        if (d >= 4 || a >= 4) throw Fail();
        derive(dc_[d], true, &dtbl[d]);
        derive(ac_[a], false, &atbl[a]);
      }
    } else {
      const bool dc_band = ss_ == 0;
      bool bad = false;
      if (dc_band) {
        if (se_ != 0) bad = true;
      } else {
        if (ss_ > se_ || se_ >= 64) bad = true;
        if (ns_ != 1) bad = true;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) throw Fail();
      if (dc_band) {
        kind = ah_ == 0 ? DC_FIRST : DC_REFINE;
        if (ah_ == 0) {
          for (int i = 0; i < ns_; i++) {
            const int d = scomp_[i]->dc_tbl;
            if (d >= 4) throw Fail();
            derive(dc_[d], true, &dtbl[d]);
          }
        }
      } else {
        kind = ah_ == 0 ? AC_FIRST : AC_REFINE;
        const int a = scomp_[0]->ac_tbl;
        if (a >= 4) throw Fail();
        derive(ac_[a], false, &atbl[a]);
      }
    }

    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restarts_to_go = restart_interval_;
    for (int my = 0; my < mcu_rows; my++) {
      for (int mx = 0; mx < mcus_per_row; mx++) {
        for (int b = 0; b < nblk; b++) {
          Comp* c = scomp_[mcu[b].comp];
          const int by = ns_ == 1 ? my : my * c->v + mcu[b].dy;
          const int bx = ns_ == 1 ? mx : mx * c->h + mcu[b].dx;
          blocks[b] = c->block(by, bx);
        }
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            process_restart(last_dc, &eobrun);
            restarts_to_go = restart_interval_;
          }
        }
        switch (kind) {
          case SEQ:
            if (!insufficient_) mcu_seq(blocks, mcu, dtbl, atbl, last_dc);
            break;
          case DC_FIRST:
            if (!insufficient_) mcu_dc_first(blocks, mcu, dtbl, last_dc);
            break;
          case DC_REFINE:
            mcu_dc_refine(blocks, nblk);
            break;
          case AC_FIRST:
            if (!insufficient_) mcu_ac_first(blocks[0], atbl, &eobrun);
            break;
          case AC_REFINE:
            if (!insufficient_) mcu_ac_refine(blocks[0], atbl, &eobrun);
            break;
        }
        restarts_to_go--;
      }
    }
  }

  void add_dc(int ci, int s, int* last_dc) {
    const int prev = last_dc[ci];
    if ((prev >= 0 && s > INT_MAX - prev) || (prev < 0 && s < INT_MIN - prev))
      throw Fail();  // JERR_BAD_DCT_COEF
    last_dc[ci] = prev + s;
  }

  template <typename Blk>
  void mcu_seq(const std::vector<int16_t*>& blocks,
               const std::vector<Blk>& mcu, const Derived* dtbl,
               const Derived* atbl, int* last_dc) {
    for (size_t b = 0; b < blocks.size(); b++) {
      const int ci = mcu[b].comp;
      const Comp* c = scomp_[ci];
      int16_t* blk = blocks[b];
      int s = decode(dtbl[c->dc_tbl]);
      if (s) s = extend(get_bits(s), s);
      add_dc(ci, s, last_dc);
      blk[0] = int16_t(last_dc[ci]);
      const Derived& at = atbl[c->ac_tbl];
      for (int k = 1; k < 64; k++) {
        s = decode(at);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          r = get_bits(s);
          blk[kNatural[k]] = int16_t(extend(r, s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  template <typename Blk>
  void mcu_dc_first(const std::vector<int16_t*>& blocks,
                    const std::vector<Blk>& mcu, const Derived* dtbl,
                    int* last_dc) {
    for (size_t b = 0; b < blocks.size(); b++) {
      const int ci = mcu[b].comp;
      int s = decode(dtbl[scomp_[ci]->dc_tbl]);
      if (s) s = extend(get_bits(s), s);
      add_dc(ci, s, last_dc);
      blocks[b][0] = int16_t(uint32_t(last_dc[ci]) << al_);
    }
  }

  void mcu_dc_refine(const std::vector<int16_t*>& blocks, int nblk) {
    const int p1 = 1 << al_;
    for (int b = 0; b < nblk; b++) {
      if (get_bits(1)) blocks[b][0] = int16_t(blocks[b][0] | p1);
    }
  }

  void mcu_ac_first(int16_t* blk, const Derived* atbl, int* eobrun) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    const Derived& t = atbl[scomp_[0]->ac_tbl];
    for (int k = ss_; k <= se_; k++) {
      int s = decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        r = get_bits(s);
        s = extend(r, s);
        blk[kNatural[k]] = int16_t(uint32_t(s) << al_);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          int run = 1 << r;
          if (r) run += get_bits(r);
          *eobrun = run - 1;
          break;
        }
      }
    }
  }

  void refine_bit(int16_t* coef, int p1, int m1) {
    if (get_bits(1)) {
      if ((*coef & p1) == 0) {
        if (*coef >= 0) *coef = int16_t(*coef + p1);
        else *coef = int16_t(*coef + m1);
      }
    }
  }

  void mcu_ac_refine(int16_t* blk, const Derived* atbl, int* eobrun) {
    const int p1 = 1 << al_;
    const int m1 = -(1 << al_);
    const Derived& t = atbl[scomp_[0]->ac_tbl];
    int k = ss_;
    int run = *eobrun;
    if (run == 0) {
      for (; k <= se_; k++) {
        int s = decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          run = 1 << r;
          if (r) run += get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine_bit(coef, p1, m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (run > 0) {
      for (; k <= se_; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine_bit(coef, p1, m1);
      }
      run--;
    }
    *eobrun = run;
  }
};

int read_one(const uint8_t* buf, int64_t len, int msub, int max_bh,
             int max_bw, int16_t* yout, int16_t* cout_, uint16_t* qout,
             int32_t* dout) {
  if (len <= 0) return -2;
  if (!(len > 3 && buf[0] == 0xFF && buf[1] == 0xD8)) return -3;
  const int m2 = msub * msub;
  const int cbh_max = max_bh / 2, cbw_max = max_bw / 2;
  try {
    Decoder dec(buf, len);
    dec.read_header();
    if (!dec.ycc420()) return -3;
    if (dec.arithmetic()) return -3;
    dec.read_coefficients();
    const int bh = dec.comp(0).bh, bw = dec.comp(0).bw;
    const int cbh = dec.comp(1).bh, cbw = dec.comp(1).bw;
    if (bh > max_bh || bw > max_bw || cbh > cbh_max || cbw > cbw_max)
      return -4;
    const uint16_t* q0 = dec.qtable(0);
    const uint16_t* q1 = dec.qtable(1);
    const uint16_t* q2 = dec.qtable(2);
    if (!q0 || !q1 || !q2 || memcmp(q1, q2, 64 * sizeof(uint16_t)) != 0)
      return -3;
    for (int u = 0; u < msub; u++) {
      for (int v = 0; v < msub; v++) {
        qout[u * msub + v] = q0[u * 8 + v];
        qout[m2 + u * msub + v] = q1[u * 8 + v];
      }
    }
    dout[0] = dec.height();
    dout[1] = dec.width();
    dout[2] = bh;
    dout[3] = bw;
    dout[4] = cbh;
    dout[5] = cbw;
    for (int ci = 0; ci < 3; ci++) {
      Comp& c = dec.comp(ci);
      const int gw = ci == 0 ? max_bw : cbw_max;
      int16_t* base = ci == 0 ? yout
                              : cout_ + size_t(ci - 1) * cbh_max * cbw_max * m2;
      for (int by = 0; by < c.bh; by++) {
        for (int bx = 0; bx < c.bw; bx++) {
          const int16_t* blk = c.block(by, bx);
          int16_t* dst = base + (size_t(by) * gw + bx) * m2;
          for (int u = 0; u < msub; u++)
            for (int v = 0; v < msub; v++) dst[u * msub + v] = blk[u * 8 + v];
        }
      }
    }
    return 0;
  } catch (const Fail&) {
    return -1;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

}  // namespace

extern "C" int jpegcoef_read_coeffs_batch(
    const uint8_t* const* bufs, const int64_t* lens, int n, int msub,
    int max_bh, int max_bw, int16_t* ycoef, int16_t* ccoef, uint16_t* qtab,
    int32_t* dims, int32_t* status, int n_threads) {
  if (n <= 0) return 0;
  if (msub < 1) msub = 1;
  if (msub > 8) msub = 8;
  const int m2 = msub * msub;
  const int cbh_max = max_bh / 2, cbw_max = max_bw / 2;
  const size_t ystride = size_t(max_bh) * max_bw * m2;
  const size_t cstride = size_t(2) * cbh_max * cbw_max * m2;
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int16_t* yout = ycoef + size_t(i) * ystride;
      int16_t* cout_ = ccoef + size_t(i) * cstride;
      uint16_t* qout = qtab + size_t(i) * 2 * m2;
      int32_t* dout = dims + size_t(i) * 6;
      memset(yout, 0, ystride * sizeof(int16_t));
      memset(cout_, 0, cstride * sizeof(int16_t));
      memset(qout, 0, 2 * m2 * sizeof(uint16_t));
      memset(dout, 0, 6 * sizeof(int32_t));
      const int st = read_one(bufs[i], lens[i], msub, max_bh, max_bw, yout,
                              cout_, qout, dout);
      status[i] = st;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  int ok = 0;
  for (int i = 0; i < n; i++) ok += (status[i] == 0);
  return ok;
}
