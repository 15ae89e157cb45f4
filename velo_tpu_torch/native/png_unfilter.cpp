// PNG scanline unfiltering for 8-bit, one-channel images.
//
// Undoes the five filter types of the PNG specification (None, Sub, Up,
// Average, Paeth) on the inflated image data of an 8-bit grayscale,
// non-interlaced PNG: ``raw`` is height rows of (1 + width) bytes, the
// filter type first.  Sub, Average and Paeth depend on the reconstructed
// pixel to the left, so each row is one sequential pass.
//
// Built into the same library as veloio.cpp and called through ctypes,
// which releases the GIL for the whole call: a frame decodes in a reader
// thread while the interpreter runs the frame loop.
//
// C ABI only (consumed via ctypes).

#include <cstdint>
#include <cstdlib>

extern "C" {

// Returns 0, or 1 + the index of the first row whose filter type is not
// one of 0-4 (rows from there on are left unwritten).
int velo_png_unfilter(const uint8_t* raw, int height, int width,
                      uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + static_cast<long>(y) * (width + 1);
    const uint8_t ftype = line[0];
    const uint8_t* src = line + 1;
    uint8_t* row = out + static_cast<long>(y) * width;
    const uint8_t* up = y ? row - width : nullptr;
    switch (ftype) {
      case 0:  // None
        for (int x = 0; x < width; ++x) row[x] = src[x];
        break;
      case 1: {  // Sub
        int left = 0;
        for (int x = 0; x < width; ++x) {
          left = (src[x] + left) & 255;
          row[x] = static_cast<uint8_t>(left);
        }
        break;
      }
      case 2:  // Up
        for (int x = 0; x < width; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (up ? up[x] : 0));
        break;
      case 3: {  // Average
        int left = 0;
        for (int x = 0; x < width; ++x) {
          const int b = up ? up[x] : 0;
          left = (src[x] + ((left + b) >> 1)) & 255;
          row[x] = static_cast<uint8_t>(left);
        }
        break;
      }
      case 4: {  // Paeth
        int left = 0, upleft = 0;
        for (int x = 0; x < width; ++x) {
          const int b = up ? up[x] : 0;
          const int p = left + b - upleft;
          const int pa = std::abs(p - left), pb = std::abs(p - b),
                    pc = std::abs(p - upleft);
          const int pred = (pa <= pb && pa <= pc) ? left
                           : (pb <= pc)           ? b
                                                  : upleft;
          left = (src[x] + pred) & 255;
          row[x] = static_cast<uint8_t>(left);
          upleft = b;
        }
        break;
      }
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
