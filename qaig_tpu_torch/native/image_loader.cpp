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
// scanlines (a filter byte before each row, pass after pass when the file
// is interlaced; Python checks the chunks' CRCs and the header, and
// inflates with zlib), its header and its palette.  It undoes the five
// row filters, expands the samples and normalises, over a thread pool.
// An interlaced (Adam7) image is walked pass by pass: each non-empty pass
// is a small image of its own scanlines (its own stride, a filter byte a
// row, the row above zero at its first row), and each of its pixels is
// written to its place in the full image, as libpng's png_read_image
// de-interlaces.  No libpng: the C++ standard library and pthreads only.
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

// One pass of an image (the whole image when it is not interlaced): its
// first row and column, its steps, and its size in pixels.
struct Pass {
  int y0, x0, dy, dx, cols, rows;
};

// The non-empty passes of a (w, h) image: the whole image, or Adam7's.
std::vector<Pass> passes_of(int w, int h, bool interlaced) {
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {0, 4, 8, 8}, {4, 0, 8, 4},
                                   {0, 2, 4, 4}, {2, 0, 4, 2}, {0, 1, 2, 2},
                                   {1, 0, 2, 1}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int(*table)[4] = interlaced ? kAdam7 : kWhole;
  const int count = interlaced ? 7 : 1;
  std::vector<Pass> out;
  for (int p = 0; p < count; ++p) {
    const int y0 = table[p][0], x0 = table[p][1], dy = table[p][2],
              dx = table[p][3];
    const int cols = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int rows = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (cols > 0 && rows > 0) out.push_back({y0, x0, dy, dx, cols, rows});
  }
  return out;
}

inline int64_t stride_of(int cols, int bits) {
  return (static_cast<int64_t>(cols) * bits + 7) / 8;
}

// Decode one image into its (3, h, w) slot of the slab.
int decode_one(const uint8_t* data, int64_t size, const int32_t* header,
               const uint8_t* palette, int palette_entries, float* out,
               int h, int w) {
  const int width = header[0], height = header[1], depth = header[2],
            color = header[3], interlace = header[4];
  if (width != w || height != h) return kBadSize;
  const int channels = channels_of(color);
  if (channels == 0 || !valid_depth(color, depth) || interlace < 0 ||
      interlace > 1)
    return kBadFormat;
  const int bits = depth * channels;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  const std::vector<Pass> passes = passes_of(w, h, interlace == 1);
  int64_t need = 0;
  for (const Pass& p : passes) need += p.rows * (stride_of(p.cols, bits) + 1);
  if (size < need) return kTruncated;
  // 1/2/4-bit gray is scaled to 0-255; palette indices are not
  const int gray_scale = (color == 0 && depth < 8) ? 255 / ((1 << depth) - 1)
                                                   : 1;
  const size_t plane = static_cast<size_t>(h) * w;
  float* blue = out;
  float* green = out + plane;
  float* red = out + 2 * plane;
  const uint8_t* src = data;
  std::vector<uint8_t> rows;
  for (const Pass& p : passes) {
    const int stride = static_cast<int>(stride_of(p.cols, bits));
    rows.assign(2 * static_cast<size_t>(stride), 0);
    uint8_t* prev = rows.data();
    uint8_t* cur = rows.data() + stride;
    for (int y = 0; y < p.rows; ++y, src += stride + 1) {
      for (int i = 0; i < stride; ++i) cur[i] = src[1 + i];
      if (!unfilter_row(src[0], cur, prev, stride, bpp)) return kBadFilter;
      const size_t base = static_cast<size_t>(p.y0 + y * p.dy) * w;
      for (int x = 0; x < p.cols; ++x) {
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
        const size_t at = base + p.x0 + static_cast<size_t>(x) * p.dx;
        blue[at] = normalise(b);
        green[at] = normalise(g);
        red[at] = normalise(r);
      }
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode n PNG images of exactly (h, w) into out (n, 3, h, w) float32 BGR
// in [-1, 1].  data[i]: image i's inflated scanlines (sizes[i] bytes);
// headers[5 * i ..]: its width, height, bit depth, color type and
// interlace method (0 none, 1 Adam7);
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
      errors[i] = decode_one(data[i], sizes[i], headers + 5 * i,
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
