// Batch .npy loader and image normalisation for the data plane (the
// port's copy of qaig_tpu/native/npy_loader.cpp).
//
// Loads a whole batch of raw float32 .npy latents into one preallocated
// (N, *item_shape) buffer over a thread pool, and fuses the uint8 -> [-1, 1]
// normalisation with the HWC -> CHW transpose for images.
//
// C ABI only (bound with ctypes); the C++ standard library and pthreads.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Minimal NPY parser: v1.0/v2.0, little-endian f4, C-contiguous.
// Returns the byte offset of the data section, or -1 on error; fills
// n_floats with the product of the shape.
long parse_npy_header(FILE* f, long* n_floats) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
  int major = magic[6];
  unsigned int header_len = 0;
  long data_off = 0;
  if (major == 1) {
    unsigned char hl[2];
    if (fread(hl, 1, 2, f) != 2) return -1;
    header_len = hl[0] | (hl[1] << 8);
    data_off = 10 + header_len;
  } else {
    unsigned char hl[4];
    if (fread(hl, 1, 4, f) != 4) return -1;
    header_len = hl[0] | (hl[1] << 8) | (hl[2] << 16) |
                 ((unsigned int)hl[3] << 24);
    data_off = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return -1;
  if (header.find("'<f4'") == std::string::npos &&
      header.find("\"<f4\"") == std::string::npos)
    return -1;
  if (header.find("'fortran_order': True") != std::string::npos) return -1;
  size_t p = header.find("'shape':");
  if (p == std::string::npos) return -1;
  p = header.find('(', p);
  size_t q = header.find(')', p);
  if (p == std::string::npos || q == std::string::npos) return -1;
  long total = 1;
  long cur = -1;
  for (size_t i = p + 1; i <= q; i++) {
    char c = header[i];
    if (c >= '0' && c <= '9') {
      if (cur < 0) cur = 0;
      cur = cur * 10 + (c - '0');
    } else if (cur >= 0) {
      total *= cur;
      cur = -1;
    }
  }
  *n_floats = total;
  return data_off;
}

// One file into its slot of the slab; 0 on success.
int load_one(const char* path, float* out, long item_floats) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  long n_floats = 0;
  long off = parse_npy_header(f, &n_floats);
  if (off < 0 || n_floats != item_floats) {
    fclose(f);
    return 2;
  }
  if (fseek(f, off, SEEK_SET) != 0) {
    fclose(f);
    return 3;
  }
  size_t got = fread(out, sizeof(float), (size_t)n_floats, f);
  fclose(f);
  return got == (size_t)n_floats ? 0 : 4;
}

// Keep the smallest failing index: every lower index was taken earlier
// and runs to its end, so the smallest is the first bad file.
void note_failure(std::atomic<int>& failed, int i) {
  int seen = failed.load();
  while ((seen < 0 || i < seen) &&
         !failed.compare_exchange_weak(seen, i)) {
  }
}

}  // namespace

extern "C" {

// Load n .npy files (each exactly item_floats f4 values) into out
// (n * item_floats contiguous).  Returns 0 on success, else 100 + the index
// of the first failing file.
int qaig_load_npy_batch(const char** paths, int n, float* out,
                        long item_floats, int num_threads) {
  if (num_threads > n) num_threads = n;
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(-1);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() >= 0) break;
      if (load_one(paths[i], out + (long)i * item_floats, item_floats) != 0)
        note_failure(failed, i);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  int fi = failed.load();
  return fi >= 0 ? 100 + fi : 0;
}

// Fused uint8 BGR HWC -> float32 CHW [-1, 1] for a batch of images.
// in: (n, h, w, c) uint8; out: (n, c, h, w) float32.
void qaig_normalize_images(const unsigned char* in, float* out, int n,
                           int h, int w, int c) {
  const float scale = 1.0f / 127.5f;
  long hw = (long)h * w;
  for (int b = 0; b < n; b++) {
    const unsigned char* src = in + (long)b * hw * c;
    float* dst = out + (long)b * hw * c;
    for (long px = 0; px < hw; px++) {
      for (int ch = 0; ch < c; ch++) {
        dst[ch * hw + px] = (float)src[px * c + ch] * scale - 1.0f;
      }
    }
  }
}

}  // extern "C"
