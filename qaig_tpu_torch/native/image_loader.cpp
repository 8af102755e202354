// Batch PNG decoder for the data plane: row filters, sample expansion and
// normalisation of N images into one (N, 3, H, W) float32 slab.
//
// The pixels are cv2.imread's (and utils/png.py::read_bgr's): BGR order,
// gray repeated over three channels, alpha dropped, 16-bit samples cut to
// their high byte, palette indices expanded, 1/2/4-bit gray scaled to
// 0-255; each written as (x - 127.5f) / 127.5f, CHW, as
// qaig_tpu/native/image_loader.cpp writes its slab.
//
// The C++ side takes what Python hands over: each image's inflated
// scanlines (a filter byte before each row; Python checks the chunks'
// CRCs and the header, and inflates with zlib), its header and its
// palette.  It undoes the five row filters, expands the samples and
// normalises, over a thread pool.  No libpng: the C++ standard library
// and pthreads only.
//
// C ABI only (bound with ctypes, which releases the GIL for the call).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

// Per-image status codes, written to errors[i] (0: decoded).
enum Status {
  kOk = 0,
  kTruncated = 1,      // fewer inflated bytes than the rows need
  kBadFilter = 2,      // a filter byte outside 0-4
  kBadPalette = 3,     // a palette index past the PLTE entries
  kBadSize = 4,        // not the batch's (height, width)
  kBadFormat = 5,      // a color type / bit depth pair PNG does not allow
};

int channels_of(int color) {
  switch (color) {
    case 0: return 1;   // gray
    case 2: return 3;   // RGB
    case 3: return 1;   // palette
    case 4: return 2;   // gray + alpha
    case 6: return 4;   // RGBA
    default: return 0;
  }
}

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Undo one row's filter in place: cur holds the filtered bytes, prev the
// row above (zeros for the first row), bpp the bytes a pixel (at least 1).
bool unfilter_row(int kind, uint8_t* cur, const uint8_t* prev, int stride,
                  int bpp) {
  switch (kind) {
    case 0:
      return true;
    case 1:   // Sub
      for (int i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
      return true;
    case 2:   // Up
      for (int i = 0; i < stride; ++i) cur[i] += prev[i];
      return true;
    case 3:   // Average
      for (int i = 0; i < bpp && i < stride; ++i) cur[i] += prev[i] >> 1;
      for (int i = bpp; i < stride; ++i)
        cur[i] += static_cast<uint8_t>((cur[i - bpp] + prev[i]) >> 1);
      return true;
    case 4:   // Paeth
      for (int i = 0; i < bpp && i < stride; ++i) cur[i] += prev[i];
      for (int i = bpp; i < stride; ++i)
        cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
      return true;
    default:
      return false;
  }
}

// Sample `s` (of `channels` per pixel) of pixel `x` in an unfiltered row:
// the high byte of a 16-bit sample, or a 1/2/4/8-bit sample.
inline int sample(const uint8_t* row, int x, int s, int channels,
                  int depth) {
  if (depth == 8) return row[x * channels + s];
  if (depth == 16) return row[(x * channels + s) * 2];
  int bit = x * depth;   // depth < 8 only with one channel
  return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
}

inline float normalise(int v) {
  return (static_cast<float>(v) - 127.5f) / 127.5f;
}

// Decode one image into its (3, h, w) slot of the slab.
int decode_one(const uint8_t* data, int64_t size, const int32_t* header,
               const uint8_t* palette, int palette_entries, float* out,
               int h, int w) {
  const int width = header[0], height = header[1], depth = header[2],
            color = header[3];
  if (width != w || height != h) return kBadSize;
  const int channels = channels_of(color);
  if (channels == 0 || !valid_depth(color, depth)) return kBadFormat;
  const int bits = depth * channels;
  const int stride = static_cast<int>((static_cast<int64_t>(w) * bits + 7) /
                                      8);
  const int bpp = bits >= 8 ? bits / 8 : 1;
  if (size < static_cast<int64_t>(h) * (stride + 1)) return kTruncated;
  // 1/2/4-bit gray is scaled to 0-255; palette indices are not
  const int gray_scale = (color == 0 && depth < 8) ? 255 / ((1 << depth) - 1)
                                                   : 1;
  std::vector<uint8_t> rows(2 * static_cast<size_t>(stride), 0);
  uint8_t* prev = rows.data();
  uint8_t* cur = rows.data() + stride;
  const size_t plane = static_cast<size_t>(h) * w;
  float* blue = out;
  float* green = out + plane;
  float* red = out + 2 * plane;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = data + static_cast<int64_t>(y) * (stride + 1);
    for (int i = 0; i < stride; ++i) cur[i] = src[1 + i];
    if (!unfilter_row(src[0], cur, prev, stride, bpp)) return kBadFilter;
    const size_t base = static_cast<size_t>(y) * w;
    for (int x = 0; x < w; ++x) {
      int r, g, b;
      if (color == 3) {
        const int index = sample(cur, x, 0, 1, depth);
        if (index >= palette_entries) return kBadPalette;
        r = palette[3 * index];
        g = palette[3 * index + 1];
        b = palette[3 * index + 2];
      } else if (channels <= 2) {   // gray, gray + alpha
        r = g = b = sample(cur, x, 0, channels, depth) * gray_scale;
      } else {                      // RGB, RGBA
        r = sample(cur, x, 0, channels, depth);
        g = sample(cur, x, 1, channels, depth);
        b = sample(cur, x, 2, channels, depth);
      }
      blue[base + x] = normalise(b);
      green[base + x] = normalise(g);
      red[base + x] = normalise(r);
    }
    uint8_t* t = prev;
    prev = cur;
    cur = t;
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode n PNG images of exactly (h, w) into out (n, 3, h, w) float32 BGR
// in [-1, 1].  data[i]: image i's inflated scanlines (sizes[i] bytes);
// headers[4 * i ..]: its width, height, bit depth and color type;
// palettes[i]: its PLTE entries (palette_entries[i] RGB triples; null
// when it has none).  Writes each image's status to errors[i] and returns
// 0 when every image decoded, else 100 + the index of the first that did
// not.
int qaig_decode_png_batch(int n, const uint8_t* const* data,
                          const int64_t* sizes, const int32_t* headers,
                          const uint8_t* const* palettes,
                          const int32_t* palette_entries, float* out, int h,
                          int w, int num_threads, int32_t* errors) {
  const size_t item = static_cast<size_t>(3) * h * w;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      errors[i] = decode_one(data[i], sizes[i], headers + 4 * i,
                             palettes[i], palette_entries[i],
                             out + item * i, h, w);
    }
  };
  int t = num_threads < 1 ? 1 : (num_threads > n ? n : num_threads);
  if (t <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < t; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  for (int i = 0; i < n; ++i)
    if (errors[i] != kOk) return 100 + i;
  return 0;
}

}  // extern "C"
