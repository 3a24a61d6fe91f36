/* PNG scanline unfiltering (ISO/IEC 15948, section 9), for native/png.py.

   Average and Paeth rows are sequential along the row (each byte needs the
   reconstructed byte one pixel to its left), so numpy cannot vectorize them;
   in Python a 512x1024 u16 depth map of such rows takes seconds. This file
   has no dependencies beyond the C library.

   Build (done at first use by native/png.py, into the git-ignored build/):
       cc -O2 -shared -fPIC png_unfilter.c -o libsalve_png.so

   `filtered` holds `height` rows of 1 filter byte + `stride` bytes; `out`
   receives height * stride bytes. `bpp` is the bytes of one pixel (at least
   1). Returns 0, or 1 + the index of the first row whose filter type is not
   0-4. */

#include <stdlib.h>

int salve_png_unfilter(const unsigned char *filtered, long height, long stride, int bpp,
                       unsigned char *out) {
  for (long y = 0; y < height; ++y) {
    const unsigned char *src = filtered + y * (stride + 1);
    int type = src[0];
    ++src;
    unsigned char *cur = out + y * stride;
    const unsigned char *prior = y > 0 ? out + (y - 1) * stride : NULL;
    for (long x = 0; x < stride; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = prior ? prior[x] : 0;
      int c = (prior && x >= bpp) ? prior[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return (int)(y + 1);
      }
      cur[x] = (unsigned char)(src[x] + pred);
    }
  }
  return 0;
}
