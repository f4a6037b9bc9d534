/* The part of libjpeg's interface that native/src/mmpdf.cpp uses, served by
 * the port's own decoder (jpegdec.cpp), so that DCTDecode images decode on a
 * machine without libjpeg. mmpdf.cpp includes this file in place of the
 * system's <jpeglib.h> (the build puts this directory first on the include
 * path) and is linked with jpegdec.cpp instead of -ljpeg.
 *
 * The decoder reproduces libjpeg-turbo's default output for RGB: the
 * accurate integer IDCT (jidctint.c), fancy upsampling (jdsample.c) and its
 * YCbCr -> RGB tables (jdcolor.c), for baseline, extended and progressive
 * Huffman-coded 8-bit JPEGs with 1 or 3 components. Anything else fails
 * through the caller's error_exit, as a corrupt stream does with libjpeg:
 * arithmetic coding, 12-bit samples, 4 components, and progressive files
 * whose missing coefficients libjpeg would smooth. mmpdf then skips the
 * image, and mmpdf_jpeg_failures() counts it. */
#ifndef MMPDF_JPEG_JPEGLIB_H
#define MMPDF_JPEG_JPEGLIB_H

#include <stddef.h>

typedef int boolean;
#ifndef TRUE
#define TRUE 1
#endif
#ifndef FALSE
#define FALSE 0
#endif

typedef unsigned char JSAMPLE;
typedef JSAMPLE* JSAMPROW;
typedef JSAMPROW* JSAMPARRAY;
typedef unsigned int JDIMENSION;

typedef enum { JCS_UNKNOWN, JCS_GRAYSCALE, JCS_RGB } J_COLOR_SPACE;

struct jpeg_common_struct;
typedef struct jpeg_common_struct* j_common_ptr;

struct jpeg_error_mgr {
  void (*error_exit)(j_common_ptr cinfo);
};

/* Both structs start with the error manager, as libjpeg's do, so a
 * decompress struct is read through a j_common_ptr. */
struct jpeg_common_struct {
  struct jpeg_error_mgr* err;
};

struct jpeg_decompress_struct {
  struct jpeg_error_mgr* err;
  J_COLOR_SPACE out_color_space;
  JDIMENSION output_width;
  JDIMENSION output_height;
  JDIMENSION output_scanline;
  void* decoder; /* the decoder's state, owned by jpegdec.cpp */
};
typedef struct jpeg_decompress_struct* j_decompress_ptr;

struct jpeg_error_mgr* jpeg_std_error(struct jpeg_error_mgr* err);
void jpeg_create_decompress(j_decompress_ptr cinfo);
void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* buf, size_t size);
int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image);
boolean jpeg_start_decompress(j_decompress_ptr cinfo);
JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY rows, JDIMENSION n);
boolean jpeg_finish_decompress(j_decompress_ptr cinfo);
void jpeg_destroy_decompress(j_decompress_ptr cinfo);

/* How many JPEG decodes failed on the calling thread since it started. */
int mmpdf_jpeg_failures(void);

#endif
