// szip decoding: CCSDS 121.0-B lossless Rice coding as libaec's
// SZ_BufftoBuffDecompress decodes it, the format of HDF5's szip filter
// (filter id 4). convnet_tpu_torch/hdf5.py strips the filter's 4-byte size
// header and decodes each chunk through szip_decode; data/native.py builds
// this file with g++ at first use and binds it with ctypes.
//
// The stream is a sequence of blocks of `pixels per block` samples; every
// `rsi` blocks (a reference sample interval, one scanline rounded up to
// whole blocks) start over. Each block opens with an ID: zero is a
// low-entropy block (a zero block run or the second extension), the
// largest ID a block stored as it is, and any other ID k + 1 a block of
// fundamental sequences split k bits low. With the NN option the samples
// are residuals of a unit-delay predictor behind a reference sample at the
// start of each interval, mapped back here. 32- and 64-bit pixels are coded
// as bytes, one byte plane after another (libaec's interleaving).
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMsbOption = 16;  // SZ_MSB_OPTION_MASK: samples big-endian
constexpr int kNnOption = 32;   // SZ_NN_OPTION_MASK: nearest-neighbour preprocessing
constexpr int kSeTableSize = 90;

// Bits, most significant first.
class BitReader {
 public:
  BitReader(const uint8_t* p, int64_t n) : p_(p), end_(p + n) {}

  // The next k bits (k <= 32) into *v; false at the end of the input.
  bool Get(int k, uint32_t* v) {
    if (k == 0) {
      *v = 0;
      return true;
    }
    if (!Fill(k)) return false;
    bits_ -= k;
    *v = static_cast<uint32_t>((acc_ >> bits_) & ((uint64_t{1} << k) - 1));
    return true;
  }

  // A fundamental sequence: the zeros before the next one.
  bool Fs(uint32_t* v) {
    uint32_t zeros = 0;
    for (;;) {
      if (bits_ == 0 && !Fill(1)) return false;
      const uint64_t window = acc_ & ((uint64_t{1} << bits_) - 1);
      if (window) {
        const int top = 63 - __builtin_clzll(window);  // the highest one
        zeros += static_cast<uint32_t>(bits_ - 1 - top);
        bits_ = top;
        *v = zeros;
        return true;
      }
      zeros += static_cast<uint32_t>(bits_);
      bits_ = 0;
    }
  }

 private:
  // At least k bits held (k <= 32 keeps them under 40 of the 64).
  bool Fill(int k) {
    while (bits_ < k) {
      if (p_ == end_) return false;
      acc_ = (acc_ << 8) | *p_++;
      bits_ += 8;
    }
    return true;
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

// One reference sample interval's samples, with the NN option mapped back
// from residuals (libaec's flush_kind for unsigned samples).
void Postprocess(std::vector<uint32_t>* s, bool nn, uint32_t xmax) {
  if (!nn || s->empty()) return;
  const uint32_t med = xmax / 2 + 1;
  uint32_t data = (*s)[0];  // the reference sample
  for (size_t i = 1; i < s->size(); i++) {
    const uint32_t d = (*s)[i];
    const uint32_t half_d = (d >> 1) + (d & 1);
    const uint32_t m = (data & med) ? xmax : 0;
    if (half_d <= (m ^ data)) {
      data += (d >> 1) ^ (~((d & 1) - 1));  // + d/2 for even d, - (d+1)/2 for odd
    } else {
      data = m ^ d;
    }
    (*s)[i] = data;
  }
}

}  // namespace

extern "C" {

// Decodes in[0, in_len) into out[0, out_len) with HDF5's szip parameters.
// Returns the bytes written (out_len), -1 if the input ends early, -2 if it
// is not valid szip data, -3 if the parameters are not ones libaec takes.
int64_t szip_decode(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len,
                    int options_mask, int pixels_per_block, int bits_per_pixel,
                    int pixels_per_scanline) {
  const bool interleaved = bits_per_pixel == 32 || bits_per_pixel == 64;
  const int n = interleaved ? 8 : bits_per_pixel;
  const int block = pixels_per_block;
  if (n < 1 || n > 32 || block < 2 || (block & 1) || pixels_per_scanline < 1 || out_len < 0) {
    return -3;
  }
  const int bytes = n > 16 ? 4 : n > 8 ? 2 : 1;
  const int64_t rsi = (pixels_per_scanline + block - 1) / block;  // blocks an interval
  const bool nn = options_mask & kNnOption;
  const bool msb = options_mask & kMsbOption;
  const int id_len = n > 16 ? 5 : n > 8 ? 4 : 3;
  const uint32_t id_max = (1u << id_len) - 1;  // a block stored as it is
  const uint32_t xmax = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1;
  // Scanlines are padded to whole blocks when a block does not divide them.
  const bool padded = pixels_per_scanline % block != 0;
  const int64_t line = rsi * block;
  int64_t total = out_len / bytes;  // samples to decode
  if (padded) {
    total = (out_len / bytes + pixels_per_scanline - 1) / pixels_per_scanline * line;
  }

  // The SE option's table: m -> (d0 + d1, the first m of that sum).
  int se[2 * (kSeTableSize + 1)];
  for (int i = 0, k = 0; i < 13; i++) {
    const int first = k;
    for (int j = 0; j <= i; j++, k++) {
      se[2 * k] = i;
      se[2 * k + 1] = first;
    }
  }

  BitReader bits(in, in_len);
  std::vector<uint8_t> decoded(static_cast<size_t>(total) * bytes);
  std::vector<uint32_t> interval;
  interval.reserve(static_cast<size_t>(line));
  std::vector<uint32_t> fs(block);
  int64_t produced = 0;
  while (produced < total) {
    interval.clear();
    const int64_t want = total - produced < line ? total - produced : line;
    for (int64_t b = 0; static_cast<int64_t>(interval.size()) < want;) {
      const bool ref = nn && b == 0;  // the interval's reference sample
      uint32_t id, v;
      if (!bits.Get(id_len, &id)) return -1;
      if (id == 0) {  // low entropy
        uint32_t second;
        if (!bits.Get(1, &second)) return -1;
        if (ref) {
          if (!bits.Get(n, &v)) return -1;
          interval.push_back(v);
        }
        if (second) {  // second extension: pairs coded together
          for (int i = ref ? 1 : 0; i < block;) {
            uint32_t m;
            if (!bits.Fs(&m)) return -1;
            if (m > kSeTableSize) return -2;
            const uint32_t d1 = m - static_cast<uint32_t>(se[2 * m + 1]);
            if ((i & 1) == 0) {
              interval.push_back(static_cast<uint32_t>(se[2 * m]) - d1);
              i++;
            }
            interval.push_back(d1);
            i++;
          }
          b++;
        } else {  // a run of zero blocks; 5 is the rest of the segment
          uint32_t runs;
          if (!bits.Fs(&runs)) return -1;
          int64_t count = static_cast<int64_t>(runs) + 1;
          if (count == 5) {
            const int64_t left = rsi - b, segment = 64 - b % 64;
            count = left < segment ? left : segment;
          } else if (count > 5) {
            count--;
          }
          if (count > rsi - b) return -2;  // a run past the interval's end
          interval.insert(interval.end(), count * block - (ref ? 1 : 0), 0u);
          b += count;
        }
      } else if (id == id_max) {  // stored as it is, the reference sample first
        for (int i = 0; i < block; i++) {
          if (!bits.Get(n, &v)) return -1;
          interval.push_back(v);
        }
        b++;
      } else {  // fundamental sequences, then k low bits each
        const int k = static_cast<int>(id) - 1;
        if (ref) {
          if (!bits.Get(n, &v)) return -1;
          interval.push_back(v);
        }
        const int coded = block - (ref ? 1 : 0);
        for (int i = 0; i < coded; i++) {
          if (!bits.Fs(&fs[i])) return -1;
        }
        for (int i = 0; i < coded; i++) {
          if (!bits.Get(k, &v)) return -1;
          interval.push_back((fs[i] << k) | v);
        }
        b++;
      }
    }
    Postprocess(&interval, nn, xmax);
    for (int64_t i = 0; i < want; i++) {
      uint8_t* at = decoded.data() + (produced + i) * bytes;
      const uint32_t x = interval[i];
      for (int j = 0; j < bytes; j++) {
        const int shift = 8 * (msb ? bytes - 1 - j : j);
        at[j] = static_cast<uint8_t>(x >> shift);
      }
    }
    produced += want;
  }

  // Scanlines back to their width, then byte planes back to pixels.
  std::vector<uint8_t> lines;
  const uint8_t* src = decoded.data();
  if (padded) {
    const int64_t keep = static_cast<int64_t>(pixels_per_scanline) * bytes;
    lines.resize(static_cast<size_t>(out_len));
    for (int64_t o = 0, i = 0; o < out_len; o += keep, i += line * bytes) {
      const int64_t size = out_len - o < keep ? out_len - o : keep;
      std::memcpy(lines.data() + o, decoded.data() + i, static_cast<size_t>(size));
    }
    src = lines.data();
  }
  if (interleaved) {
    const int64_t width = bits_per_pixel / 8, count = out_len / width;
    for (int64_t i = 0; i < count; i++) {
      for (int64_t j = 0; j < width; j++) out[i * width + j] = src[j * count + i];
    }
  } else {
    std::memcpy(out, src, static_cast<size_t>(out_len));
  }
  return out_len;
}

}  // extern "C"
