// A JPEG decoder with no library behind it, for the port's JPEG loader
// (dataloader.cc). It decodes what libjpeg-turbo 2.1.5 (the libjpeg 6.2
// API) decodes under the settings the loader asks for, out_color_space RGB
// or GRAYSCALE and scale 1/1, 1/2, 1/4 or 1/8, every other field at its
// default (ISLOW IDCT, fancy upsampling), and gives the same bytes:
//
//   - 8-bit files, Huffman-coded (baseline and extended sequential, SOF0
//     and SOF1; progressive, SOF2) or arithmetic-coded (sequential and
//     progressive, SOF9 and SOF10, with DAC conditioning), interleaved or
//     not, with restart intervals; libjpeg's standard Huffman tables stand
//     in for any that a file leaves out (motion-JPEG frames);
//   - 1 or 3 components with sampling factors 1-4; the colour space from
//     a JFIF marker, an Adobe marker's transform or the component IDs, as
//     libjpeg guesses it; YCbCr -> RGB with libjpeg's 16-bit fixed-point
//     factors, Y alone for gray output, RGB -> gray with its luma factors;
//   - the reduced IDCTs (4x4, 2x2, 1x1) of a scaled decode, each component
//     given the largest of them that spares it upsampling (libjpeg's rule),
//     and the fancy (triangle) upsamplers h2v1, h1v2 and h2v2 where the
//     smallest scaled block is larger than 1, else box replication;
//   - data that ends early: the Huffman blocks past the end keep zero
//     coefficients (libjpeg's fake EOI marker and zero bits; an arithmetic
//     decoder reads zero data), with a warning in libjpeg and none here;
//     a progressive file whose first AC coefficients lack
//     bits at its end has them estimated from the DC values around each
//     block, as libjpeg-turbo 2.1's block smoothing does.
//
// It refuses what libjpeg refuses at these settings: CMYK and YCCK, other
// precisions than 8 bits, lossless, hierarchical and differential files,
// 2 or 4 components, fractional sampling ratios, more than 10 blocks an
// MCU, broken markers and tables. It also refuses, where libjpeg would
// decode, an image whose coefficients take more than kMaxCoefBytes (1 GiB:
// about 179 million pixels at 4:4:4, 358 million at 4:2:0).
//
// Its IDCTs are libjpeg's C ones, in 64-bit integers as on x86-64. On x86
// libjpeg-turbo runs SIMD versions that saturate 16-bit lanes where the C
// code wraps: the two agree unless a block's coefficients overflow 16 bits
// in the transform, which only corrupt or cut data (zero bits read as
// codes) produces. There this decoder gives libjpeg-turbo's C result.
//
// The structure follows ITU-T T.81 and the order of operations libjpeg's
// output shows: every scan is decoded into one coefficient buffer, then
// each needed component is inverse-transformed into a plane, upsampled
// to the output size and colour-converted.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace jpeg_decode {

struct Error {
  const char* what;
};

[[noreturn]] inline void Fail(const char* what) { throw Error{what}; }

// Every scan is decoded into one buffer of all the coefficients, so a
// header whose buffer would exceed this is refused, not allocated.
constexpr size_t kMaxCoefBytes = size_t{1} << 30;

// Zigzag position -> row-major position; 16 more entries so that a
// corrupt run past the block's end lands on its last coefficient.
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The Huffman tables of T.81 Annex K.3, which libjpeg's sequential decoder
// installs in slots 0 (luminance) and 1 (chrominance) that a file leaves
// empty.
constexpr uint8_t kStdDcBits[2][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kStdAcBits[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// The probability estimation of T.81 Table D.2 (the QM coder), with the
// fixed estimate of 0.5 as its last state: Qe, the next state after an
// LPS and after an MPS, and whether an LPS switches the sense of the MPS.
constexpr uint16_t kQe[114] = {
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d,
    0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1,
    0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068,
    0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518,
    0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4,
    0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04,
    0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b,
    0x0d51, 0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
    0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
    0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
    0x5a10, 0x5522, 0x59eb, 0x5a1d};
constexpr uint8_t kNextLps[114] = {
    1,  14, 16, 18, 20, 23, 25, 28, 30, 33, 35, 9,  10, 12, 15, 36, 38, 39, 40,
    42, 43, 45, 46, 48, 49, 51, 52, 54, 56, 57, 59, 60, 62, 63, 32, 33, 37, 64,
    65, 67, 68, 69, 70, 72, 73, 74, 75, 77, 78, 79, 48, 50, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 59, 61, 61, 65, 80, 81, 82, 83, 84, 86, 87, 87, 72, 72, 74,
    74, 75, 77, 77, 80, 88, 89, 90, 91, 92, 93, 86, 88, 95, 96, 97, 99, 99, 93,
    95, 101, 102, 103, 104, 99, 105, 106, 107, 103, 105, 108, 109, 110, 111, 110, 112, 112, 113};
constexpr uint8_t kNextMps[114] = {
    1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 13, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 9,  37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, 62, 63, 32, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76,
    77, 78, 79, 48, 81, 82, 83, 84, 85, 86, 87, 71, 89, 90, 91, 92, 93, 94, 86,
    96, 97, 98, 99, 100, 93, 102, 103, 104, 99, 106, 107, 103, 109, 107, 111, 109, 111, 113};
constexpr uint8_t kSwitchMps[114] = {
    1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0,
    0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0};

// A table as a DHT segment defines it.
struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};  // bits[l]: the number of codes of length l
  uint8_t vals[256] = {};
};

// A table ready for decoding (T.81 Annex C and F.2.2.3): codes of up to 8
// bits through one lookup, longer ones bit by bit against maxcode.
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[256];  // (length << 8) | symbol; length 9: a longer code
  uint8_t vals[256];
};

inline int Extend(int x, int s) {
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

inline void BuildTable(const HuffSpec& spec, bool is_dc, HuffTable* t) {
  if (!spec.defined) Fail("a scan uses a Huffman table that is not defined");
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = spec.bits[l];
    if (p + n > 256) Fail("bad Huffman table");
    for (int i = 0; i < n; ++i) size[p++] = static_cast<uint8_t>(l);
  }
  size[p] = 0;
  const int num = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    // no code may be all ones
    if (code >= (1u << si)) Fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec.bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(code_of[p]);
      p += spec.bits[l];
      t->maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;  // ends the search at length 17
  for (int i = 0; i < 256; ++i) t->lookup[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < spec.bits[l]; ++i, ++p) {
      const int first = static_cast<int>(code_of[p]) << (8 - l);
      for (int k = 0; k < (1 << (8 - l)); ++k)
        t->lookup[first + k] = static_cast<uint16_t>((l << 8) | spec.vals[p]);
    }
  }
  std::memcpy(t->vals, spec.vals, sizeof(t->vals));
  if (is_dc) {
    for (int i = 0; i < num; ++i)
      if (spec.vals[i] > 15) Fail("bad DC Huffman table");
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;   // quantization table copied at its first scan
  int16_t qt[64] = {};    // libjpeg keeps the multipliers as shorts
  uint16_t qraw[64] = {}; // and the table as read, for block smoothing
  int wblocks = 0, hblocks = 0;  // blocks that hold image data
  int bw = 0, bh = 0;            // blocks allocated: whole MCUs
  std::vector<int16_t> coef;     // bw * bh blocks of 64, row-major order
  int coef_bits[64];             // progressive: the bit each coefficient is at
  int prev_bits[10];             // coef_bits[0..9] before the component's last scan
  int scaled = 8;                // IDCT size
  int dw = 0, dh = 0;            // samples after the IDCT
  bool needed = true;
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

enum ColorSpace { kGray, kYCbCr, kRGB };

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // Decodes the whole file into *out (rows of width * colors bytes).
  void Decode(int want_colors, int min_side, std::vector<uint8_t>* out,
              int* width, int* height) {
    want_colors_ = want_colors;
    ReadHeader();
    Setup(min_side);
    for (;;) {
      DecodeScan();
      const int m = ReadMarkers();
      if (m == 0xD9) break;
      if (!multi_scan_) Fail("a second scan in a single-scan file");
    }
    Output(out);
    *width = out_w_;
    *height = out_h_;
  }

 private:
  // ---- the byte source: the file, then the fake EOI libjpeg's stdio
  // source inserts, FF D9 over and over
  int Byte() {
    const size_t p = pos_++;
    if (p < size_) return data_[p];
    return ((p - size_) & 1) ? 0xD9 : 0xFF;
  }
  int Word() {
    const int hi = Byte();
    return (hi << 8) | Byte();
  }
  void Skip(long n) {
    if (n > 0) pos_ += static_cast<size_t>(n);
  }

  // ---- markers (libjpeg's jdmarker.c)
  void FirstMarker() {
    const int c = Byte(), c2 = Byte();
    if (c != 0xFF || c2 != 0xD8) Fail("not a JPEG file");
    unread_marker_ = c2;
  }

  void NextMarker() {
    for (;;) {
      int c = Byte();
      while (c != 0xFF) c = Byte();
      do c = Byte(); while (c == 0xFF);
      if (c != 0) {
        unread_marker_ = c;
        return;
      }
    }
  }

  // Reads markers up to and through the next SOS (returns 0xDA) or EOI
  // (returns 0xD9).
  int ReadMarkers() {
    for (;;) {
      if (unread_marker_ == 0) {
        if (!saw_soi_) FirstMarker();
        else NextMarker();
      }
      const int m = unread_marker_;
      switch (m) {
        case 0xD8:
          if (saw_soi_) Fail("a second SOI");
          saw_soi_ = true;
          restart_interval_ = 0;
          for (int i = 0; i < 16; ++i) {
            dc_l_[i] = 0;
            dc_u_[i] = 1;
            ac_k_[i] = 5;
          }
          break;
        case 0xC0:
        case 0xC1:
          GetSof(false, false);
          break;
        case 0xC2:
          GetSof(true, false);
          break;
        case 0xC9:
          GetSof(false, true);
          break;
        case 0xCA:
          GetSof(true, true);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          Fail("unsupported JPEG process");
        case 0xDA:
          GetSos();
          unread_marker_ = 0;
          return 0xDA;
        case 0xD9:
          unread_marker_ = 0;
          return 0xD9;
        case 0xCC:
          GetDac();
          break;
        case 0xC4:
          GetDht();
          break;
        case 0xDB:
          GetDqt();
          break;
        case 0xDD:
          if (Word() != 4) Fail("bad DRI length");
          restart_interval_ = Word();
          break;
        case 0xE0:
        case 0xEE:
          GetApp(m);
          break;
        case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6:
        case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC:
        case 0xED: case 0xEF: case 0xFE: case 0xDC:
          SkipVariable();
          break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
        case 0xD6: case 0xD7: case 0x01:
          break;
        default:
          Fail("unknown marker");
      }
      unread_marker_ = 0;
    }
  }

  void SkipVariable() {
    const long length = Word();
    Skip(length - 2);
  }

  void GetApp(int m) {
    long length = Word() - 2;
    const long n = length >= 14 ? 14 : (length > 0 ? length : 0);
    uint8_t d[14] = {};
    for (long i = 0; i < n; ++i) d[i] = static_cast<uint8_t>(Byte());
    if (m == 0xE0) {
      if (n >= 14 && !std::memcmp(d, "JFIF\0", 5)) saw_jfif_ = true;
    } else if (n >= 12 && !std::memcmp(d, "Adobe", 5)) {
      saw_adobe_ = true;
      adobe_transform_ = d[11];
    }
    Skip(length - n);
  }

  // the conditioning of arithmetic coding: L and U of DC tables, Kx of AC
  void GetDac() {
    long length = Word() - 2;
    while (length > 0) {
      const int index = Byte(), val = Byte();
      length -= 2;
      if (index >= 32) Fail("bad DAC index");
      if (index >= 16) {
        ac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_l_[index] = static_cast<uint8_t>(val & 15);
        dc_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dc_l_[index] > dc_u_[index]) Fail("bad DAC value");
      }
    }
    if (length != 0) Fail("bad DAC length");
  }

  void GetSof(bool progressive, bool arith) {
    if (saw_sof_) Fail("a second SOF");
    saw_sof_ = true;
    progressive_ = progressive;
    arith_ = arith;
    long length = Word();
    precision_ = Byte();
    height_ = Word();
    width_ = Word();
    const int n = Byte();
    length -= 8;
    if (height_ <= 0 || width_ <= 0 || n <= 0) Fail("empty image");
    if (length != n * 3) Fail("bad SOF length");
    comps_.resize(n);
    for (auto& c : comps_) {
      c.id = Byte();
      const int hv = Byte();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = Byte();
    }
  }

  void GetSos() {
    if (!saw_sof_) Fail("SOS before SOF");
    const long length = Word();
    const int n = Byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) Fail("bad SOS length");
    scan_.clear();
    for (int i = 0; i < n; ++i) {
      const int cc = Byte(), t = Byte();
      // libjpeg's search: among the first 4 components, from the i-th on
      int found = -1;
      for (int ci = i; ci < static_cast<int>(comps_.size()) && ci < 4; ++ci)
        if (comps_[ci].id == cc) {
          found = ci;
          break;
        }
      if (found < 0) Fail("bad component id in SOS");
      for (int s : scan_)
        if (s == found) Fail("a component twice in one scan");
      scan_.push_back(found);
      comps_[found].dc_tbl = (t >> 4) & 15;
      comps_[found].ac_tbl = t & 15;
    }
    ss_ = Byte();
    se_ = Byte();
    const int a = Byte();
    ah_ = (a >> 4) & 15;
    al_ = a & 15;
    next_restart_num_ = 0;
    ++scan_number_;
  }

  void GetDht() {
    long length = Word() - 2;
    while (length > 16) {
      const int index = Byte();
      HuffSpec spec;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        spec.bits[i] = static_cast<uint8_t>(Byte());
        count += spec.bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) Fail("bad Huffman table");
      for (int i = 0; i < count; ++i) spec.vals[i] = static_cast<uint8_t>(Byte());
      length -= count;
      spec.defined = true;
      const int slot = index & 0x0F;
      if ((index & ~0x10) > 3) Fail("bad DHT index");
      (index & 0x10 ? ac_specs_ : dc_specs_)[slot] = spec;
    }
    if (length != 0) Fail("bad DHT length");
  }

  void GetDqt() {
    long length = Word() - 2;
    while (length > 0) {
      const int pn = Byte();
      const int prec = pn >> 4, n = pn & 15;
      if (n >= 4) Fail("bad DQT index");
      uint16_t* q = qtables_[n];
      for (int i = 0; i < 64; ++i)
        q[kNatural[i]] = static_cast<uint16_t>(prec ? Word() : Byte());
      qdefined_[n] = true;
      length -= 65;
      if (prec) length -= 64;
    }
    if (length != 0) Fail("bad DQT length");
  }

  void ReadHeader() {
    if (ReadMarkers() != 0xDA) Fail("no image in the file");
    if (width_ > 65500 || height_ > 65500) Fail("image too big");
    if (precision_ != 8) Fail("only 8-bit samples are supported");
    if (comps_.size() > 10) Fail("too many components");
    for (auto& c : comps_) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) Fail("bad sampling factors");
      if (c.h > max_h_) max_h_ = c.h;
      if (c.v > max_v_) max_v_ = c.v;
    }
    multi_scan_ = progressive_ || scan_.size() < comps_.size();
    // libjpeg's default_decompress_parms; it converts no other count of
    // components (CMYK, YCCK, unknown) to RGB or gray
    if (comps_.size() == 1) {
      space_ = kGray;
    } else if (comps_.size() != 3) {
      Fail("no conversion from this colour space to RGB or gray");
    } else if (saw_jfif_) {
      space_ = kYCbCr;
    } else if (saw_adobe_) {
      space_ = adobe_transform_ == 0 ? kRGB : kYCbCr;
    } else if (comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B') {
      space_ = kRGB;
    } else {
      space_ = kYCbCr;
    }
  }

  // jpeg_calc_output_dimensions and the upsampler's choices
  void Setup(int min_side) {
    int denom = 1;
    if (min_side > 0) {
      const int shorter = width_ < height_ ? width_ : height_;
      while (denom < 8 && shorter / (denom * 2) >= min_side) denom *= 2;
    }
    min_scaled_ = 8 / denom;
    out_w_ = static_cast<int>((static_cast<long>(width_) * min_scaled_ + 7) / 8);
    out_h_ = static_cast<int>((static_cast<long>(height_) * min_scaled_ + 7) / 8);
    const int mcux = max_h_ * 8, mcuy = max_v_ * 8;
    mcus_per_row_ = (width_ + mcux - 1) / mcux;
    mcu_rows_ = (height_ + mcuy - 1) / mcuy;
    size_t coef_bytes = 0;
    for (const auto& c : comps_)
      coef_bytes += static_cast<size_t>(mcus_per_row_) * c.h * mcu_rows_ * c.v * 64 * sizeof(int16_t);
    if (coef_bytes > kMaxCoefBytes) Fail("the image's coefficients exceed kMaxCoefBytes");
    for (auto& c : comps_) {
      int s = min_scaled_;
      while (s < 8 && (max_h_ * min_scaled_) % (c.h * s * 2) == 0 &&
             (max_v_ * min_scaled_) % (c.v * s * 2) == 0)
        s *= 2;
      c.scaled = s;
      c.wblocks = static_cast<int>((static_cast<long>(width_) * c.h + mcux - 1) / mcux);
      c.hblocks = static_cast<int>((static_cast<long>(height_) * c.v + mcuy - 1) / mcuy);
      c.dw = static_cast<int>((static_cast<long>(width_) * c.h * s + mcux - 1) / mcux);
      c.dh = static_cast<int>((static_cast<long>(height_) * c.v * s + mcuy - 1) / mcuy);
      c.bw = mcus_per_row_ * c.h;
      c.bh = mcu_rows_ * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int& b : c.coef_bits) b = -1;
      for (int& b : c.prev_bits) b = -1;
    }
    if (want_colors_ == 1 && space_ == kYCbCr)
      for (size_t i = 1; i < comps_.size(); ++i) comps_[i].needed = false;
    for (const auto& c : comps_) {
      // libjpeg upsamples by whole factors only
      const int hin = c.h * c.scaled / min_scaled_, vin = c.v * c.scaled / min_scaled_;
      if (c.needed && (max_h_ % hin || max_v_ % vin)) Fail("fractional sampling is not supported");
    }
    // libjpeg's sequential Huffman decoder (not its progressive one) fills
    // the empty slots 0 and 1 with the standard tables
    for (int i = 0; i < 2 && !progressive_ && !arith_; ++i) {
      if (!dc_specs_[i].defined) {
        dc_specs_[i].defined = true;
        std::memcpy(dc_specs_[i].bits, kStdDcBits[i], 17);
        for (int k = 0; k < 12; ++k) dc_specs_[i].vals[k] = static_cast<uint8_t>(k);
      }
      if (!ac_specs_[i].defined) {
        ac_specs_[i].defined = true;
        std::memcpy(ac_specs_[i].bits, kStdAcBits[i], 17);
        std::memcpy(ac_specs_[i].vals, kStdAcVals[i], 162);
      }
    }
  }

  // ---- entropy-coded data (libjpeg's jdhuff.c bit reader)
  static constexpr int kMinGetBits = 57;

  void FillBits(int nbits) {
    if (unread_marker_ == 0) {
      // bytes that are neither 0xFF nor past the file, without the checks
      while (bits_left_ < kMinGetBits && pos_ < size_ && data_[pos_] != 0xFF) {
        get_buffer_ = (get_buffer_ << 8) | data_[pos_++];
        bits_left_ += 8;
      }
      while (bits_left_ < kMinGetBits) {
        int c = Byte();
        if (c == 0xFF) {
          do c = Byte(); while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker_ = c;
            break;
          }
        }
        get_buffer_ = (get_buffer_ << 8) | static_cast<uint64_t>(c);
        bits_left_ += 8;
      }
      if (unread_marker_ == 0) return;
    }
    if (nbits > bits_left_) {
      // past the end of the segment: zero bits, and no more MCUs decoded
      insufficient_ = true;
      get_buffer_ <<= kMinGetBits - bits_left_;
      bits_left_ = kMinGetBits;
    }
  }

  int GetBits(int n) {
    if (bits_left_ < n) FillBits(n);
    bits_left_ -= n;
    return static_cast<int>((get_buffer_ >> bits_left_) & ((1u << n) - 1));
  }

  int DecodeHuff(const HuffTable& t) {
    int nb = 1;
    if (bits_left_ < 8) FillBits(0);
    if (bits_left_ >= 8) {
      const int e = t.lookup[(get_buffer_ >> (bits_left_ - 8)) & 0xFF];
      nb = e >> 8;
      if (nb <= 8) {
        bits_left_ -= nb;
        return e & 0xFF;
      }
    }
    int code = GetBits(nb);
    int l = nb;
    while (code > t.maxcode[l]) {
      code = (code << 1) | GetBits(1);
      ++l;
    }
    if (l > 16) return 0;  // a bad code: libjpeg warns and takes 0
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  void ProcessRestart() {
    bits_left_ = 0;
    if (unread_marker_ == 0) NextMarker();
    if (unread_marker_ == 0xD0 + next_restart_num_) {
      unread_marker_ = 0;
    } else {
      Resync(next_restart_num_);
    }
    next_restart_num_ = (next_restart_num_ + 1) & 7;
    for (int& d : last_dc_) d = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (unread_marker_ == 0) insufficient_ = false;
  }

  // libjpeg's jpeg_resync_to_restart
  void Resync(int desired) {
    for (;;) {
      const int m = unread_marker_;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        return;
      }
      if (action == 3) return;
      NextMarker();
    }
  }

  void DecodeScan() {
    const int n = static_cast<int>(scan_.size());
    for (int ci : scan_) {
      Component& c = comps_[ci];
      if (!c.latched) {
        if (c.tq > 3 || !qdefined_[c.tq]) Fail("a component's quantization table is not defined");
        for (int k = 0; k < 64; ++k) c.qt[k] = static_cast<int16_t>(qtables_[c.tq][k]);
        std::memcpy(c.qraw, qtables_[c.tq], sizeof(c.qraw));
        c.latched = true;
      }
    }
    const bool dc_band = ss_ == 0;
    if (progressive_) {
      bool bad = false;
      if (dc_band) {
        if (se_ != 0) bad = true;
      } else {
        if (ss_ > se_ || se_ > 63 || n != 1) bad = true;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) Fail("bad progression parameters");
      for (int ci : scan_) {
        Component& c = comps_[ci];
        for (int k = ss_ < 1 ? ss_ : 1; k <= 9; ++k)
          c.prev_bits[k] = scan_number_ > 1 ? c.coef_bits[k] : 0;
        for (int k = ss_; k <= se_; ++k) c.coef_bits[k] = al_;
      }
    }
    for (int i = 0; i < n && arith_; ++i) {
      // arithmetic coding: the statistics of each table the scan uses
      const Component& c = comps_[scan_[i]];
      if (!progressive_ || (dc_band && ah_ == 0)) {
        std::memset(dc_stats_[c.dc_tbl], 0, sizeof(dc_stats_[0]));
        last_dc_[i] = 0;
        dc_context_[i] = 0;
      }
      if (!progressive_ || ss_) std::memset(ac_stats_[c.ac_tbl], 0, sizeof(ac_stats_[0]));
    }
    for (int i = 0; i < n && !arith_; ++i) {
      const Component& c = comps_[scan_[i]];
      if (!progressive_ || (dc_band && ah_ == 0)) {
        if (c.dc_tbl > 3) Fail("bad Huffman table index");
        BuildTable(dc_specs_[c.dc_tbl], true, &dc_[i]);
      }
      if (!progressive_ || !dc_band) {
        if (c.ac_tbl > 3) Fail("bad Huffman table index");
        BuildTable(ac_specs_[c.ac_tbl], false, &ac_[i]);
      }
    }
    get_buffer_ = 0;
    bits_left_ = 0;
    insufficient_ = false;
    for (int& d : last_dc_) d = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    arith_c_ = 0;
    arith_a_ = 0;
    arith_ct_ = -16;  // the first decision reads two bytes

    // the blocks of one MCU: (scan slot, block row, block column) offsets
    struct Blk {
      int slot, dy, dx;
    };
    std::vector<Blk> mcu;
    int rows, cols;
    if (n == 1) {
      rows = comps_[scan_[0]].hblocks;
      cols = comps_[scan_[0]].wblocks;
      mcu.push_back({0, 0, 0});
    } else {
      rows = mcu_rows_;
      cols = mcus_per_row_;
      for (int i = 0; i < n; ++i) {
        const Component& c = comps_[scan_[i]];
        for (int y = 0; y < c.v; ++y)
          for (int x = 0; x < c.h; ++x) mcu.push_back({i, y, x});
      }
      if (mcu.size() > 10) Fail("too many blocks in an MCU");
    }
    int16_t* blocks[10];
    for (int my = 0; my < rows; ++my) {
      for (int mx = 0; mx < cols; ++mx) {
        for (size_t b = 0; b < mcu.size(); ++b) {
          Component& c = comps_[scan_[mcu[b].slot]];
          const int sy = n == 1 ? my : my * c.v + mcu[b].dy;
          const int sx = n == 1 ? mx : mx * c.h + mcu[b].dx;
          blocks[b] = c.block(sy, sx);
        }
        // libjpeg's last_good_iMCU_row: the last iMCU row whose decode began
        // with data left (the block rows of a one-component scan in groups
        // of its v)
        if (!insufficient_) last_good_row_ = n == 1 ? my / comps_[scan_[0]].v : my;
        const int count = static_cast<int>(mcu.size());
        if (arith_) {
          if (restart_interval_) {
            if (restarts_to_go_ == 0) ArithRestart();
            --restarts_to_go_;
          }
          if (arith_ct_ != -1) DecodeArith(blocks, mcu.data(), count);  // -1: a bad code
          continue;
        }
        if (restart_interval_ && restarts_to_go_ == 0) ProcessRestart();
        if (!progressive_) {
          if (!insufficient_) DecodeSequential(blocks, mcu.data(), count);
        } else if (dc_band) {
          if (ah_ == 0) {
            if (!insufficient_) DecodeDcFirst(blocks, mcu.data(), count);
          } else {
            for (int b = 0; b < count; ++b)
              if (GetBits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | (1 << al_));
          }
        } else if (!insufficient_) {
          if (ah_ == 0) DecodeAcFirst(blocks[0]);
          else DecodeAcRefine(blocks[0]);
        }
        if (restart_interval_) --restarts_to_go_;
      }
    }
  }

  template <typename Blk>
  void DecodeSequential(int16_t** blocks, const Blk* mcu, int count) {
    for (int b = 0; b < count; ++b) {
      const int slot = mcu[b].slot;
      int16_t* blk = blocks[b];
      int s = DecodeHuff(dc_[slot]);
      if (s) s = Extend(GetBits(s), s);
      last_dc_[slot] = static_cast<int>(static_cast<unsigned>(last_dc_[slot]) + static_cast<unsigned>(s));
      blk[0] = static_cast<int16_t>(last_dc_[slot]);
      const HuffTable& ac = ac_[slot];
      for (int k = 1; k < 64; ++k) {
        s = DecodeHuff(ac);
        const int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(Extend(GetBits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  template <typename Blk>
  void DecodeDcFirst(int16_t** blocks, const Blk* mcu, int count) {
    for (int b = 0; b < count; ++b) {
      const int slot = mcu[b].slot;
      int s = DecodeHuff(dc_[slot]);
      if (s) s = Extend(GetBits(s), s);
      const long sum = static_cast<long>(last_dc_[slot]) + s;
      if (sum > INT32_MAX || sum < INT32_MIN) Fail("bad DC coefficient");
      last_dc_[slot] = static_cast<int>(sum);
      blocks[b][0] = static_cast<int16_t>(static_cast<unsigned long>(sum) << al_);
    }
  }

  void DecodeAcFirst(int16_t* blk) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const HuffTable& t = ac_[0];
    for (int k = ss_; k <= se_; ++k) {
      int s = DecodeHuff(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = Extend(GetBits(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1u << r;
        if (r) eobrun_ += static_cast<unsigned>(GetBits(r));
        --eobrun_;
        break;
      }
    }
  }

  void DecodeAcRefine(int16_t* blk) {
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    const HuffTable& t = ac_[0];
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int s = DecodeHuff(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = GetBits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += static_cast<unsigned>(GetBits(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (GetBits(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && GetBits(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun_;
    }
  }

  // ---- arithmetic-coded data (T.81 Annex D, F.1.4.4 and G.1.3.3, as
  // libjpeg's jdarith.c reads them)
  int ArithDecode(uint8_t* st) {
    while (arith_a_ < 0x8000) {
      if (--arith_ct_ < 0) {
        int data = 0;  // after a marker, zero data to the end
        if (!unread_marker_) {
          data = Byte();
          if (data == 0xFF) {
            do data = Byte(); while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker_ = data;
              data = 0;
            }
          }
        }
        arith_c_ = (arith_c_ << 8) | data;
        if ((arith_ct_ += 8) < 0 && ++arith_ct_ == 0) arith_a_ = 0x8000;
      }
      arith_a_ <<= 1;
    }
    int sv = *st;
    const int64_t qe = kQe[sv & 0x7F];
    const int nl = kNextLps[sv & 0x7F] | (kSwitchMps[sv & 0x7F] << 7), nm = kNextMps[sv & 0x7F];
    int64_t temp = arith_a_ - qe;
    arith_a_ = temp;
    temp <<= arith_ct_;
    if (arith_c_ >= temp) {
      arith_c_ -= temp;
      if (arith_a_ < qe) {
        arith_a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        arith_a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (arith_a_ < 0x8000) {
      if (arith_a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void ArithRestart() {
    if (unread_marker_ == 0) NextMarker();
    if (unread_marker_ == 0xD0 + next_restart_num_) {
      unread_marker_ = 0;
    } else {
      Resync(next_restart_num_);
    }
    next_restart_num_ = (next_restart_num_ + 1) & 7;
    for (size_t i = 0; i < scan_.size(); ++i) {
      const Component& c = comps_[scan_[i]];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        std::memset(dc_stats_[c.dc_tbl], 0, sizeof(dc_stats_[0]));
        last_dc_[i] = 0;
        dc_context_[i] = 0;
      }
      if (!progressive_ || ss_) std::memset(ac_stats_[c.ac_tbl], 0, sizeof(ac_stats_[0]));
    }
    arith_c_ = 0;
    arith_a_ = 0;
    arith_ct_ = -16;
    restarts_to_go_ = restart_interval_;
  }

  // A DC difference (Figures F.19 to F.24); false on a bad code
  bool ArithDc(int slot, int tbl, int* diff) {
    uint8_t* st = dc_stats_[tbl] + dc_context_[slot];
    if (ArithDecode(st) == 0) {
      dc_context_[slot] = 0;
      *diff = 0;
      return true;
    }
    const int sign = ArithDecode(st + 1);
    st += 2 + sign;
    int m = ArithDecode(st);
    if (m != 0) {
      st = dc_stats_[tbl] + 20;
      while (ArithDecode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << dc_l_[tbl]) >> 1)) {
      dc_context_[slot] = 0;
    } else if (m > ((1 << dc_u_[tbl]) >> 1)) {
      dc_context_[slot] = 12 + sign * 4;
    } else {
      dc_context_[slot] = 4 + sign * 4;
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ArithDecode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // An AC value after its nonzero decision: sign and magnitude; 0 on a
  // bad code
  int ArithAcValue(int tbl, int k, uint8_t* st) {
    const int sign = ArithDecode(&fixed_bin_);
    st += 2;
    int m = ArithDecode(st);
    if (m != 0 && ArithDecode(st)) {
      m <<= 1;
      st = ac_stats_[tbl] + (k <= ac_k_[tbl] ? 189 : 217);
      while (ArithDecode(st)) {
        if ((m <<= 1) == 0x8000) return 0;
        st += 1;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ArithDecode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  template <typename Blk>
  void DecodeArith(int16_t** blocks, const Blk* mcu, int count) {
    const bool dc_band = ss_ == 0;
    if (progressive_ && dc_band && ah_ != 0) {  // DC refinement: one bit a block
      for (int b = 0; b < count; ++b)
        if (ArithDecode(&fixed_bin_)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | (1 << al_));
      return;
    }
    if (progressive_ && !dc_band) {
      if (ah_ == 0) ArithAcFirst(blocks[0]);
      else ArithAcRefine(blocks[0]);
      return;
    }
    for (int b = 0; b < count; ++b) {
      const int slot = mcu[b].slot;
      const Component& c = comps_[scan_[slot]];
      int diff;
      if (!ArithDc(slot, c.dc_tbl, &diff)) {
        arith_ct_ = -1;
        return;
      }
      last_dc_[slot] = (last_dc_[slot] + diff) & 0xffff;
      if (progressive_) {
        blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(last_dc_[slot]) << al_);
        continue;
      }
      blocks[b][0] = static_cast<int16_t>(last_dc_[slot]);
      const int tbl = c.ac_tbl;
      for (int k = 1; k <= 63; ++k) {
        uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
        if (ArithDecode(st)) break;  // EOB
        while (ArithDecode(st + 1) == 0) {
          st += 3;
          if (++k > 63) {
            arith_ct_ = -1;
            return;
          }
        }
        const int v = ArithAcValue(tbl, k, st);
        if (v == 0) {
          arith_ct_ = -1;
          return;
        }
        blocks[b][kNatural[k]] = static_cast<int16_t>(v);
      }
    }
  }

  void ArithAcFirst(int16_t* blk) {
    const int tbl = comps_[scan_[0]].ac_tbl;
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (ArithDecode(st)) break;  // EOB
      while (ArithDecode(st + 1) == 0) {
        st += 3;
        if (++k > se_) {
          arith_ct_ = -1;
          return;
        }
      }
      const int v = ArithAcValue(tbl, k, st);
      if (v == 0) {
        arith_ct_ = -1;
        return;
      }
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al_);
    }
  }

  void ArithAcRefine(int16_t* blk) {
    const int tbl = comps_[scan_[0]].ac_tbl;
    const int p1 = 1 << al_, m1 = -1 * (1 << al_);
    int kex = se_;  // the end of the block in the previous stage
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && ArithDecode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ArithDecode(st + 2)) *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ArithDecode(st + 1)) {
          *coef = static_cast<int16_t>(ArithDecode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se_) {
          arith_ct_ = -1;
          return;
        }
      }
    }
  }

  // ---- output
  bool SmoothingOk() const;
  void SmoothBlock(const Component& c, int by, int bx, int16_t* ws) const;
  void Output(std::vector<uint8_t>* out);

  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  int unread_marker_ = 0;
  bool saw_soi_ = false, saw_sof_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  bool progressive_ = false, multi_scan_ = false;
  int precision_ = 0, width_ = 0, height_ = 0;
  std::vector<Component> comps_;
  int max_h_ = 1, max_v_ = 1;
  ColorSpace space_ = kGray;
  int want_colors_ = 3;
  int min_scaled_ = 8, out_w_ = 0, out_h_ = 0;
  int mcus_per_row_ = 0, mcu_rows_ = 0;
  HuffSpec dc_specs_[4], ac_specs_[4];
  uint16_t qtables_[4][64] = {};
  bool qdefined_[4] = {};
  int restart_interval_ = 0;
  // the current scan
  std::vector<int> scan_;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int scan_number_ = 0;
  HuffTable dc_[4], ac_[4];
  uint64_t get_buffer_ = 0;
  int bits_left_ = 0;
  bool insufficient_ = false;
  int last_dc_[4] = {};
  unsigned eobrun_ = 0;
  int restarts_to_go_ = 0;
  // arithmetic decoding: conditioning, statistics and coder registers
  bool arith_ = false;
  uint8_t dc_l_[16] = {}, dc_u_[16] = {}, ac_k_[16] = {};
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_ = 113;  // the fixed estimate of 0.5
  int dc_context_[4] = {};
  int64_t arith_c_ = 0, arith_a_ = 0;
  int arith_ct_ = 0;
  int last_good_row_ = 0;
  int next_restart_num_ = 0;
};

// ---- inverse DCTs (libjpeg's jidctint.c and jidctred.c: 13-bit constants,
// 2 extra bits after the first pass; the output's range limit wraps at
// 1024 as libjpeg's table does)

struct RangeLimit {
  uint8_t idct[1024];  // (x + 128) limited, x taken mod 1024 as signed
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      const int x = i < 512 ? i : i - 1024;
      idct[i] = static_cast<uint8_t>(x < -128 ? 0 : (x > 127 ? 255 : x + 128));
    }
  }
};

inline const RangeLimit& Limits() {
  static const RangeLimit r;
  return r;
}

inline int64_t Descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }
inline int64_t Shl(int64_t x, int n) {
  return static_cast<int64_t>(static_cast<uint64_t>(x) << n);
}

constexpr int kConstBits = 13, kPass1Bits = 2;

// libjpeg's jpeg_idct_islow in 64-bit integers, as its C code computes it
inline void Idct8x8(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = Limits().idct;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = static_cast<int>(Shl(ip[0] * qp[0], kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = Shl(z2 + z3, kConstBits);
    int64_t tmp1 = Shl(z2 - z3, kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(Descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(Descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(Descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(Descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(Descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(Descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(Descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(Descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t dc = rl[static_cast<int>(Descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * 4433;
    int64_t tmp2 = z1 + z3 * -15137;
    int64_t tmp3 = z1 + z2 * 6270;
    int64_t tmp0 = Shl(static_cast<int64_t>(wp[0]) + wp[4], kConstBits);
    int64_t tmp1 = Shl(static_cast<int64_t>(wp[0]) - wp[4], kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp0 *= 2446;
    tmp1 *= 16819;
    tmp2 *= 25172;
    tmp3 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits + kPass1Bits + 3;
    op[0] = rl[static_cast<int>(Descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = rl[static_cast<int>(Descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = rl[static_cast<int>(Descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = rl[static_cast<int>(Descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = rl[static_cast<int>(Descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = rl[static_cast<int>(Descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = rl[static_cast<int>(Descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = rl[static_cast<int>(Descale(tmp13 - tmp0, sh)) & 1023];
  }
}

inline void Idct4x4(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = Limits().idct;
  int ws[32];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // the second pass does not read column 4
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = static_cast<int>(Shl(ip[0] * qp[0], kPass1Bits));
      for (int r = 0; r < 4; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t tmp0 = Shl(ip[0] * qp[0], kConstBits + 1);
    int64_t tmp2 = static_cast<int64_t>(ip[16] * qp[16]) * 15137 +
                   static_cast<int64_t>(ip[48] * qp[48]) * -6270;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = ip[56] * qp[56], z2 = ip[40] * qp[40];
    const int64_t z3 = ip[24] * qp[24], z4 = ip[8] * qp[8];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    constexpr int sh = kConstBits - kPass1Bits + 1;
    wp[0] = static_cast<int>(Descale(tmp10 + tmp2, sh));
    wp[24] = static_cast<int>(Descale(tmp10 - tmp2, sh));
    wp[8] = static_cast<int>(Descale(tmp12 + tmp0, sh));
    wp[16] = static_cast<int>(Descale(tmp12 - tmp0, sh));
  }
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t dc = rl[static_cast<int>(Descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, dc, 4);
      continue;
    }
    int64_t tmp0 = Shl(wp[0], kConstBits + 1);
    int64_t tmp2 = static_cast<int64_t>(wp[2]) * 15137 + static_cast<int64_t>(wp[6]) * -6270;
    const int64_t tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    const int64_t z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    constexpr int sh = kConstBits + kPass1Bits + 3 + 1;
    op[0] = rl[static_cast<int>(Descale(tmp10 + tmp2, sh)) & 1023];
    op[3] = rl[static_cast<int>(Descale(tmp10 - tmp2, sh)) & 1023];
    op[1] = rl[static_cast<int>(Descale(tmp12 + tmp0, sh)) & 1023];
    op[2] = rl[static_cast<int>(Descale(tmp12 - tmp0, sh)) & 1023];
  }
}

inline void Idct2x2(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = Limits().idct;
  int ws[16];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;  // not read by the second pass
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[24] && !ip[40] && !ip[56]) {
      const int dc = static_cast<int>(Shl(ip[0] * qp[0], kPass1Bits));
      wp[0] = wp[8] = dc;
      continue;
    }
    const int64_t tmp10 = Shl(ip[0] * qp[0], kConstBits + 2);
    const int64_t tmp0 = static_cast<int64_t>(ip[56] * qp[56]) * -5906 +
                         static_cast<int64_t>(ip[40] * qp[40]) * 6967 +
                         static_cast<int64_t>(ip[24] * qp[24]) * -10426 +
                         static_cast<int64_t>(ip[8] * qp[8]) * 29692;
    constexpr int sh = kConstBits - kPass1Bits + 2;
    wp[0] = static_cast<int>(Descale(tmp10 + tmp0, sh));
    wp[8] = static_cast<int>(Descale(tmp10 - tmp0, sh));
  }
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[3] && !wp[5] && !wp[7]) {
      op[0] = op[1] = rl[static_cast<int>(Descale(wp[0], kPass1Bits + 3)) & 1023];
      continue;
    }
    const int64_t tmp10 = Shl(wp[0], kConstBits + 2);
    const int64_t tmp0 = static_cast<int64_t>(wp[7]) * -5906 + static_cast<int64_t>(wp[5]) * 6967 +
                         static_cast<int64_t>(wp[3]) * -10426 + static_cast<int64_t>(wp[1]) * 29692;
    constexpr int sh = kConstBits + kPass1Bits + 3 + 2;
    op[0] = rl[static_cast<int>(Descale(tmp10 + tmp0, sh)) & 1023];
    op[1] = rl[static_cast<int>(Descale(tmp10 - tmp0, sh)) & 1023];
  }
}

inline void Idct1x1(const int16_t* in, const int16_t* q, uint8_t* out, int) {
  const int dc = static_cast<int>(Descale(in[0] * q[0], 3));
  out[0] = Limits().idct[dc & 1023];
}

// ---- upsampling (libjpeg's jdsample.c) of a plane of dw x dh samples
// into out_w x out_h; fancy: libjpeg's triangle filters

inline void Upsample(const uint8_t* in, int stride, int dw, int dh, int he, int ve,
                     bool fancy, uint8_t* out, int out_w, int out_h) {
  const int last = dh - 1;
  if (he == 1 && ve == 1) {
    for (int y = 0; y < out_h; ++y)
      std::memcpy(out + static_cast<size_t>(y) * out_w, in + static_cast<size_t>(y) * stride, out_w);
    return;
  }
  if (he == 2 && fancy && dw > 2 && (ve == 1 || ve == 2)) {
    std::vector<int> sum(static_cast<size_t>(dw) + 2);
    for (int y = 0; y < out_h; ++y) {
      uint8_t* op = out + static_cast<size_t>(y) * out_w;
      const int r = y / ve;
      const uint8_t* near = in + static_cast<size_t>(r) * stride;
      int* cs = sum.data() + 1;
      if (ve == 1) {
        // h2v1: 3/4 nearer sample + 1/4 further, biases 1 and 2
        for (int x = 0; x < dw; ++x) cs[x] = near[x];
        cs[-1] = cs[0];
        cs[dw] = cs[dw - 1];
        for (int x = 0; x < out_w / 2; ++x) {
          op[2 * x] = static_cast<uint8_t>((3 * cs[x] + cs[x - 1] + 1) >> 2);
          op[2 * x + 1] = static_cast<uint8_t>((3 * cs[x] + cs[x + 1] + 2) >> 2);
        }
        if (out_w & 1) {
          const int x = out_w / 2;
          op[2 * x] = static_cast<uint8_t>((3 * cs[x] + cs[x - 1] + 1) >> 2);
        }
      } else {
        // h2v2: the same in both axes, biases 8 and 7 over column sums
        int nb = (y & 1) ? r + 1 : r - 1;
        nb = nb < 0 ? 0 : (nb > last ? last : nb);
        const uint8_t* far = in + static_cast<size_t>(nb) * stride;
        for (int x = 0; x < dw; ++x) cs[x] = 3 * near[x] + far[x];
        cs[-1] = cs[0];
        cs[dw] = cs[dw - 1];
        for (int x = 0; x < out_w / 2; ++x) {
          op[2 * x] = static_cast<uint8_t>((3 * cs[x] + cs[x - 1] + 8) >> 4);
          op[2 * x + 1] = static_cast<uint8_t>((3 * cs[x] + cs[x + 1] + 7) >> 4);
        }
        if (out_w & 1) {
          const int x = out_w / 2;
          op[2 * x] = static_cast<uint8_t>((3 * cs[x] + cs[x - 1] + 8) >> 4);
        }
      }
    }
    return;
  }
  if (he == 1 && ve == 2 && fancy) {
    // h1v2: 3/4 nearer row + 1/4 further row, bias 1 above and 2 below
    for (int y = 0; y < out_h; ++y) {
      uint8_t* op = out + static_cast<size_t>(y) * out_w;
      const int r = y / 2;
      int nb = (y & 1) ? r + 1 : r - 1;
      nb = nb < 0 ? 0 : (nb > last ? last : nb);
      const int bias = (y & 1) ? 2 : 1;
      const uint8_t* near = in + static_cast<size_t>(r) * stride;
      const uint8_t* far = in + static_cast<size_t>(nb) * stride;
      for (int x = 0; x < out_w; ++x)
        op[x] = static_cast<uint8_t>((3 * near[x] + far[x] + bias) >> 2);
    }
    return;
  }
  // box replication
  for (int y = 0; y < out_h; ++y) {
    uint8_t* op = out + static_cast<size_t>(y) * out_w;
    const uint8_t* ip = in + static_cast<size_t>(y / ve) * stride;
    for (int x = 0; x < out_w; ++x) op[x] = ip[x / he];
  }
}

// ---- colour conversion (libjpeg's jdcolor.c): its tables' entries are
// these 16-bit fixed-point products, rounded by half a unit, computed in
// place so that the loops run in SIMD lanes

constexpr int32_t kCrR = 91881, kCbB = 116130, kCrG = 46802, kCbG = 22554;  // 1.402 ...
constexpr int32_t kRY = 19595, kGY = 38470, kBY = 7471;  // 0.299, 0.587, 0.114
constexpr int32_t kHalf16 = 1 << 15;

inline uint8_t Clamp255(int32_t x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// ---- block smoothing (libjpeg-turbo's decompress_smooth_data): a
// progressive file whose first AC coefficients lack bits after its last
// scan (one cut short) has them estimated from the DC values of the 5x5
// blocks around each block, and where no AC bits came at all its DC too.

// the natural positions of the DC and the first nine AC coefficients
constexpr int kSmoothPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// libjpeg's smoothing_ok: every component has its DC and nonzero
// quantizers for those coefficients, and some of them still lack bits
inline bool Decoder::SmoothingOk() const {
  if (!progressive_) return false;
  bool useful = false;
  for (const auto& c : comps_) {
    if (!c.latched || c.coef_bits[0] < 0) return false;
    for (int k : kSmoothPos)
      if (c.qraw[k] == 0) return false;
    for (int k = 1; k < 10; ++k) useful = useful || c.coef_bits[k] != 0;
  }
  return useful;
}

inline int SmoothPredict(int64_t num, int64_t q, int al) {
  int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return num >= 0 ? pred : -pred;
}

inline void Decoder::SmoothBlock(const Component& c, int by, int bx, int16_t* ws) const {
  // the block rows above and below, as libjpeg picks them: within the
  // component's iMCU rows (v block rows each), clamped at the image's top
  // and bottom
  const int v = c.v;
  const int last = mcu_rows_ - 1;
  const int imcu = by / v, br = by % v;
  int block_rows = v;
  if (imcu == last) {
    block_rows = c.hblocks % v;
    if (block_rows == 0) block_rows = v;
  }
  int rows[5];
  rows[2] = by;
  rows[1] = (br > 0 || imcu > 0) ? by - 1 : by;
  rows[0] = (br > 1 || imcu > 1) ? by - 2 : rows[1];
  rows[3] = (br < block_rows - 1 || imcu < last) ? by + 1 : by;
  rows[4] = (br < block_rows - 2 || imcu + 1 < last) ? by + 2 : rows[3];
  // the columns, as libjpeg's sliding registers give them: clamped at the
  // edges, except that in a component two blocks wide the register two to
  // the right keeps column 0 (it is loaded only from the third column)
  int cols[5];
  const int lastcol = c.wblocks - 1;
  for (int k = 0; k < 5; ++k) {
    const int x = bx + k - 2;
    cols[k] = x < 0 ? 0 : (x > lastcol ? lastcol : x);
  }
  if (lastcol == 1) {
    if (bx == 0) cols[4] = 0;
    else cols[3] = cols[4] = 0;
  }
  int dc[26];  // dc[1..25]: libjpeg's DC01..DC25, row by row
  for (int r = 0; r < 5; ++r) {
    const int16_t* row = c.coef.data() + static_cast<size_t>(rows[r]) * c.bw * 64;
    for (int k = 0; k < 5; ++k) dc[1 + r * 5 + k] = row[static_cast<size_t>(cols[k]) * 64];
  }
  // past the last row the data reached, the bits before the last scan
  int prev[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  if (scan_number_ > 1) std::memcpy(prev + 1, c.prev_bits + 1, 9 * sizeof(int));
  const int* bits = imcu > last_good_row_ ? prev : c.coef_bits;
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                         bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                         bits[9] == -1;
  const int64_t q00 = c.qraw[0];
  auto predict = [&](int zz, int64_t sum) {
    const int pos = kSmoothPos[zz];
    if (bits[zz] != 0 && ws[pos] == 0)
      ws[pos] = static_cast<int16_t>(SmoothPredict(q00 * sum, c.qraw[pos], bits[zz]));
  };
  const int* d = dc;
  if (change_dc) {
    predict(1, -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] + 3 * d[10] -
                   3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] - 3 * d[16] + 13 * d[17] -
                   13 * d[19] + 3 * d[20] - d[21] - d[22] + d[24] + d[25]);
    predict(2, -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] + 38 * d[8] +
                   13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] - 13 * d[19] + d[20] +
                   d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] + d[25]);
    predict(3, d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] - 5 * d[14] +
                   2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]);
    predict(4, -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] - d[25]);
    predict(5, 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] + 7 * d[14] +
                   d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]);
    predict(6, d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]);
    predict(7, d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]);
    predict(8, d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]);
    predict(9, d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]);
    const int64_t num =
        q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
               42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
               42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
               6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]);
    ws[0] = static_cast<int16_t>(SmoothPredict(num, q00, 0));
  } else {
    predict(1, -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]);
    predict(2, -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]);
    predict(3, -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]);
    predict(4, d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] - d[24] + d[4] -
                   d[6] + 10 * d[7] - 10 * d[9]);
    predict(5, -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]);
  }
}

inline void Decoder::Output(std::vector<uint8_t>* out) {
  const bool smooth = SmoothingOk();
  const bool fancy = min_scaled_ > 1;
  const size_t npix = static_cast<size_t>(out_w_) * out_h_;
  std::vector<std::vector<uint8_t>> full(comps_.size());
  std::vector<uint8_t> plane;
  for (size_t ci = 0; ci < comps_.size(); ++ci) {
    Component& c = comps_[ci];
    if (!c.needed) continue;
    const int s = c.scaled;
    const int stride = c.wblocks * s;
    plane.assign(static_cast<size_t>(stride) * c.hblocks * s, 0);
    void (*idct)(const int16_t*, const int16_t*, uint8_t*, int) =
        s == 8 ? Idct8x8 : s == 4 ? Idct4x4 : s == 2 ? Idct2x2 : Idct1x1;
    int16_t ws[64];
    for (int by = 0; by < c.hblocks; ++by)
      for (int bx = 0; bx < c.wblocks; ++bx) {
        const int16_t* blk = c.block(by, bx);
        if (smooth) {
          std::memcpy(ws, blk, sizeof(ws));
          SmoothBlock(c, by, bx, ws);
          blk = ws;
        }
        idct(blk, c.qt, plane.data() + static_cast<size_t>(by) * s * stride + bx * s, stride);
      }
    c.coef = std::vector<int16_t>();
    const int he = max_h_ * min_scaled_ / (c.h * s);
    const int ve = max_v_ * min_scaled_ / (c.v * s);
    full[ci].resize(npix);
    Upsample(plane.data(), stride, c.dw, c.dh, he, ve, fancy, full[ci].data(), out_w_, out_h_);
  }
  out->resize(npix * want_colors_);
  uint8_t* o = out->data();
  if (space_ == kGray || (space_ == kYCbCr && want_colors_ == 1)) {
    const uint8_t* y = full[0].data();
    if (want_colors_ == 1) {
      std::memcpy(o, y, npix);
    } else {
      for (size_t i = 0; i < npix; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = y[i];
    }
  } else if (space_ == kYCbCr) {
    const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
    for (size_t i = 0; i < npix; ++i) {
      const int32_t yy = y[i], b = cb[i] - 128, r = cr[i] - 128;
      o[3 * i] = Clamp255(yy + ((kCrR * r + kHalf16) >> 16));
      o[3 * i + 1] = Clamp255(yy + ((-kCbG * b + kHalf16 - kCrG * r) >> 16));
      o[3 * i + 2] = Clamp255(yy + ((kCbB * b + kHalf16) >> 16));
    }
  } else {  // RGB
    const uint8_t *r = full[0].data(), *g = full[1].data(), *b = full[2].data();
    if (want_colors_ == 3) {
      for (size_t i = 0; i < npix; ++i) {
        o[3 * i] = r[i];
        o[3 * i + 1] = g[i];
        o[3 * i + 2] = b[i];
      }
    } else {
      for (size_t i = 0; i < npix; ++i)
        o[i] = static_cast<uint8_t>((kRY * r[i] + kGY * g[i] + kBY * b[i] + kHalf16) >> 16);
    }
  }
}

// Decodes a whole JPEG file held in memory: false where libjpeg refuses it
// (or the memory for it cannot be had).
inline bool Decode(const uint8_t* data, size_t size, int want_colors, int min_side,
                   std::vector<uint8_t>* pixels, int* width, int* height) {
  try {
    Decoder d(data, size);
    d.Decode(want_colors, min_side, pixels, width, height);
    return true;
  } catch (const Error&) {
    return false;
  } catch (const std::bad_alloc&) {
    return false;
  }
}

}  // namespace jpeg_decode
