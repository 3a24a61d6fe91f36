/* JPEG decode through the system's libjpeg, set up as Pillow sets it up.

   `imageio.v2.imread` reads a JPEG through Pillow, which decodes it with its
   own libjpeg-turbo at libjpeg's defaults: the accurate integer IDCT
   (JDCT_ISLOW), fancy (triangle-filter) chroma upsampling, libjpeg's
   YCbCr -> RGB conversion, and no EXIF orientation. This shim asks the same
   of the system's libjpeg, so its arrays equal imageio's byte for byte.
   A grayscale file comes back with one channel; CMYK and YCCK files are
   refused (imageio would return four channels).

   Build (done at first use by native/jpeg.py, into the git-ignored build/):
       cc -O2 -shared -fPIC jpeg_decode.c -ljpeg -o libsalve_jpeg.so

   Two calls: salve_jpeg_info reads the header (height, width, channels),
   then salve_jpeg_decode writes height * width * channels bytes into a
   buffer the caller allocated. Each returns 0, or -1 with libjpeg's message
   in `msg` (JMSG_LENGTH_MAX bytes). */

#include <setjmp.h>
#include <stdio.h>
#include <string.h>

#include <jpeglib.h>

struct salve_err {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
  char *msg;
};

static void salve_error_exit(j_common_ptr cinfo) {
  struct salve_err *err = (struct salve_err *)cinfo->err;
  (*cinfo->err->format_message)(cinfo, err->msg);
  longjmp(err->jump, 1);
}

/* Warnings (a corrupt but readable stream) are not printed; Pillow keeps
   going on them too. */
static void salve_emit_message(j_common_ptr cinfo, int level) {
  (void)cinfo;
  (void)level;
}

static int salve_open(struct jpeg_decompress_struct *cinfo, struct salve_err *err,
                      const unsigned char *data, unsigned long size) {
  jpeg_mem_src(cinfo, (unsigned char *)data, size);
  jpeg_read_header(cinfo, TRUE);
  if (cinfo->jpeg_color_space == JCS_CMYK || cinfo->jpeg_color_space == JCS_YCCK) {
    strcpy(err->msg, "CMYK and YCCK JPEGs are not read");
    return -1;
  }
  cinfo->out_color_space = cinfo->num_components == 1 ? JCS_GRAYSCALE : JCS_RGB;
  cinfo->dct_method = JDCT_ISLOW;
  cinfo->do_fancy_upsampling = TRUE;
  return 0;
}

int salve_jpeg_info(const unsigned char *data, unsigned long size, int *height, int *width,
                    int *channels, char *msg) {
  struct jpeg_decompress_struct cinfo;
  struct salve_err err;
  int rc = -1;
  msg[0] = '\0';
  err.msg = msg;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = salve_error_exit;
  err.pub.emit_message = salve_emit_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  if (salve_open(&cinfo, &err, data, size) == 0) {
    jpeg_calc_output_dimensions(&cinfo);
    *height = (int)cinfo.output_height;
    *width = (int)cinfo.output_width;
    *channels = cinfo.output_components;
    rc = 0;
  }
  jpeg_destroy_decompress(&cinfo);
  return rc;
}

int salve_jpeg_decode(const unsigned char *data, unsigned long size, unsigned char *out,
                      unsigned long out_size, char *msg) {
  struct jpeg_decompress_struct cinfo;
  struct salve_err err;
  msg[0] = '\0';
  err.msg = msg;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = salve_error_exit;
  err.pub.emit_message = salve_emit_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  if (salve_open(&cinfo, &err, data, size) != 0) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_start_decompress(&cinfo);
  unsigned long row_bytes = (unsigned long)cinfo.output_width * cinfo.output_components;
  if (row_bytes * cinfo.output_height != out_size) {
    strcpy(msg, "output buffer size does not match the image");
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (unsigned long)cinfo.output_scanline * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
