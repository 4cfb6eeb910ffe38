/* Write a lossless (SOF3) or, with -dct, a sequential DCT JPEG file of raw
 * samples with GDCM's IJG library (libgdcmjpeg8 for 8-bit samples,
 * libgdcmjpeg12 for 12-bit ones, chosen at build time by the include
 * path). Test tooling: it writes files that tests/test_torch_jpeg.py
 * decodes. The input holds the width, height and component count as
 * three 32-bit little-endian integers, then the samples interleaved by
 * pixel (one byte each at 8 bits, two little-endian bytes at 12).
 *
 *   gcc -O2 -I/usr/include/gdcm-3.0/gdcmjpeg/8 jpeg_lossless.c -o jpeg_lossless8 -lgdcmjpeg8
 *   jpeg_lossless8 IN OUT [-predictor 1..7] [-pt N] [-restart-rows N] [-dct]
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "jpeglib.h"

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [-predictor P] [-pt N] [-restart-rows N] [-dct]\n",
            argv[0]);
    return 2;
  }
  int predictor = 1, pt = 0, rows = 0, dct = 0;
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "-predictor") && i + 1 < argc) predictor = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-pt") && i + 1 < argc) pt = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-restart-rows") && i + 1 < argc) rows = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-dct")) dct = 1;
    else {
      fprintf(stderr, "unknown argument %s\n", argv[i]);
      return 2;
    }
  }
  FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
  if (!in || !out) return 1;
  int hdr[3];
  if (fread(hdr, 4, 3, in) != 3) return 1;
  int w = hdr[0], h = hdr[1], nc = hdr[2];
  size_t row = (size_t)w * nc;
  JSAMPLE *img = malloc(row * h * sizeof(JSAMPLE));
  for (size_t i = 0; i < row * h; ++i) {
    unsigned char b[2] = {0, 0};
    if (fread(b, 1, BITS_IN_JSAMPLE > 8 ? 2 : 1, in) < 1) return 1;
    img[i] = (JSAMPLE)(b[0] | (b[1] << 8));
  }
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr jerr;
  c.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&c);
  if (!dct) jpeg_simple_lossless(&c, predictor, pt);
  c.restart_in_rows = rows;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW r = img + row * c.next_scanline;
    jpeg_write_scanlines(&c, &r, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  free(img);
  fclose(in);
  return fclose(out) != 0;
}
