/* Transcode a JPEG file without decoding it (jpeg_read_coefficients, then
 * jpeg_write_coefficients, as jpegtran does), to arithmetic or Huffman
 * coding, sequential or progressive (jpeg_simple_progression), with a
 * restart interval and DAC conditioning values of its own. Test tooling:
 * it writes files that tests/test_torch_jpeg.py decodes.
 *
 *   gcc -O2 jpeg_arith.c -o jpeg_arith -l:libjpeg.a
 *   jpeg_arith IN OUT [-huffman] [-progressive] [-restart N] [-dac L U K]
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [-huffman] [-progressive] [-restart N] [-dac L U K]\n",
            argv[0]);
    return 2;
  }
  int arith = 1, progressive = 0, restart = 0, dac = 0, L = 0, U = 1, K = 5;
  for (int i = 3; i < argc; ++i) {
    if (!strcmp(argv[i], "-huffman")) arith = 0;
    else if (!strcmp(argv[i], "-progressive")) progressive = 1;
    else if (!strcmp(argv[i], "-restart") && i + 1 < argc) restart = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-dac") && i + 3 < argc) {
      dac = 1;
      L = atoi(argv[++i]);
      U = atoi(argv[++i]);
      K = atoi(argv[++i]);
    } else {
      fprintf(stderr, "unknown argument %s\n", argv[i]);
      return 2;
    }
  }
  FILE *in = fopen(argv[1], "rb"), *out = fopen(argv[2], "wb");
  if (!in || !out) return 1;
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jsrc, jdst;
  src.err = jpeg_std_error(&jsrc);
  jpeg_create_decompress(&src);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  dst.err = jpeg_std_error(&jdst);
  jpeg_create_compress(&dst);
  jpeg_stdio_dest(&dst, out);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = arith;
  dst.optimize_coding = FALSE;
  if (progressive) jpeg_simple_progression(&dst);
  dst.restart_interval = restart;
  if (dac)
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      dst.arith_dc_L[t] = L;
      dst.arith_dc_U[t] = U;
      dst.arith_ac_K[t] = K;
    }
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  return fclose(out) != 0;
}
