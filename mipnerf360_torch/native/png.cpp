// PNG row unfiltering for the port's own PNG reader (utils/png.py), for
// machines without PIL. The NumPy loop in native/__init__.py is its
// reference and gives the same bytes.
//
// Each of the h rows of `src` is one filter-type byte followed by `stride`
// filtered bytes; `dst` receives the h * stride reconstructed bytes. `bpp`
// is the bytes per complete pixel (1 to 4 for 8-bit samples). The five
// filter types are those of the PNG specification (section 9.2): None, Sub,
// Up, Average and Paeth, with a = the byte bpp to the left, b = the byte
// above and c = the byte above and to the left (0 outside the image).
// Returns 0, or 1 + the index of the first row with an unknown filter type.
//
// Built with batcher.cpp into one library by native/__init__.py.

#include <cstdint>
#include <cstdlib>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

int64_t mnr_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t h,
                         int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t type = src[y * (stride + 1)];
    const uint8_t* in = src + y * (stride + 1) + 1;
    uint8_t* out = dst + y * stride;
    const uint8_t* up = y > 0 ? dst + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? out[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return y + 1;
      }
      out[x] = static_cast<uint8_t>(in[x] + pred);
    }
  }
  return 0;
}

}  // extern "C"
