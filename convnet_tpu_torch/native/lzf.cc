// LZF decompression: liblzf's lzf_decompress, the format of h5py's lzf
// filter (HDF5 filter id 32000). convnet_tpu_torch/hdf5.py decodes each
// lzf chunk through this function; data/native.py builds it with g++ at
// first use and binds it with ctypes.
#include <cstdint>
#include <cstring>

extern "C" {

// Decodes in[0, in_len) into out[0, out_len). Returns the number of bytes
// written, -1 if out is too small (liblzf's E2BIG) or -2 if the input is
// not valid LZF (EINVAL).
int64_t lzf_decode(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  const uint8_t* ip = in;
  const uint8_t* const in_end = in + in_len;
  uint8_t* op = out;
  uint8_t* const out_end = out + out_len;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < (1u << 5)) {  // a literal run of ctrl + 1 bytes
      const int64_t run = ctrl + 1;
      if (run > out_end - op) return -1;
      if (run > in_end - ip) return -2;
      std::memcpy(op, ip, run);
      op += run;
      ip += run;
    } else {  // a back reference: len + 2 bytes from back bytes behind
      int64_t len = ctrl >> 5;
      int64_t back = static_cast<int64_t>((ctrl & 0x1f) << 8) + 1;
      if (ip >= in_end) return -2;
      if (len == 7) {
        len += *ip++;
        if (ip >= in_end) return -2;
      }
      back += *ip++;
      if (len + 2 > out_end - op) return -1;
      if (back > op - out) return -2;
      const uint8_t* ref = op - back;
      len += 2;
      // byte by byte: a reference may overlap the bytes it writes, which
      // repeats them, as LZF means it to
      for (int64_t i = 0; i < len; i++) *op++ = *ref++;
    }
  }
  return op - out;
}

}  // extern "C"
