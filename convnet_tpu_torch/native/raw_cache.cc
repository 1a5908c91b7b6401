// Raw-cache gather: rows of a memory-mapped, fixed-stride row store copied
// out by a pool of threads, off the Python interpreter's lock.
//
// The port's own copy of the raw-cache half of native/dataloader.cc (the
// JAX package's loader), without its libjpeg decoder, so that it builds
// with g++ alone (convnet_tpu_torch/data/native.py builds it at first use).
// Format (convnet_tpu_torch.data.native.write_raw_cache):
//   16-byte header: magic "CNTC" (4) | uint32 version | uint64 row_bytes
//   then nrows * row_bytes of payload (dtype and row shape live in a JSON
//   sidecar that the Python side reads).
//
// C ABI:
//   void*   cache_open(const char* path, int threads);  // nullptr: bad file
//   int64_t cache_num_rows(void* h);
//   int64_t cache_row_bytes(void* h);
//   int     cache_gather(void* h, const int64_t* indices, int count,
//                        uint8_t* out);  // out: count * row_bytes; 0 or -1
//   void    cache_close(void* h);

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct RawCache {
  int fd = -1;
  const uint8_t* base = nullptr;  // payload start (past the header)
  size_t map_len = 0;
  uint64_t row_bytes = 0;
  int64_t nrows = 0;
  int threads = 4;
};

}  // namespace

extern "C" {

void* cache_open(const char* path, int threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (m == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  const uint8_t* p = static_cast<const uint8_t*>(m);
  if (std::memcmp(p, "CNTC", 4) != 0) {
    munmap(m, st.st_size);
    close(fd);
    return nullptr;
  }
  uint64_t row_bytes;
  std::memcpy(&row_bytes, p + 8, 8);
  if (row_bytes == 0) {
    munmap(m, st.st_size);
    close(fd);
    return nullptr;
  }
  auto* c = new RawCache;
  c->fd = fd;
  c->base = p + 16;
  c->map_len = st.st_size;
  c->row_bytes = row_bytes;
  c->nrows = (st.st_size - 16) / row_bytes;
  c->threads = threads < 1 ? 1 : threads;
  return c;
}

int64_t cache_num_rows(void* h) { return h ? static_cast<RawCache*>(h)->nrows : -1; }

int64_t cache_row_bytes(void* h) {
  return h ? static_cast<int64_t>(static_cast<RawCache*>(h)->row_bytes) : -1;
}

// Gather count rows into out (count * row_bytes). Returns 0, or -1 on a
// bad handle or an index out of range (then nothing is copied).
int cache_gather(void* h, const int64_t* indices, int count, uint8_t* out) {
  if (!h || !indices || !out || count < 0) return -1;
  auto* c = static_cast<RawCache*>(h);
  for (int k = 0; k < count; ++k)
    if (indices[k] < 0 || indices[k] >= c->nrows) return -1;
  std::atomic<int> next(0);
  auto work = [&] {
    for (;;) {
      const int k = next.fetch_add(1);
      if (k >= count) break;
      std::memcpy(out + static_cast<size_t>(k) * c->row_bytes,
                  c->base + static_cast<size_t>(indices[k]) * c->row_bytes, c->row_bytes);
    }
  };
  const int nt = std::min<int>(c->threads, count > 0 ? count : 1);
  std::vector<std::thread> ts;
  for (int i = 1; i < nt; ++i) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
  return 0;
}

void cache_close(void* h) {
  if (!h) return;
  auto* c = static_cast<RawCache*>(h);
  munmap(const_cast<uint8_t*>(c->base) - 16, c->map_len);
  close(c->fd);
  delete c;
}

}  // extern "C"
