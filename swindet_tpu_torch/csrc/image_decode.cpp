// JPEG decode for the port's data loader: a host-side C++ library with a
// plain C interface, bound with ctypes (swindet_tpu_torch/datasets/image_io.py).
// The port of image_decode's JPEG half (swindet_tpu/native/image_ops.cpp:36,
// :182): libjpeg decodes to RGB, and the rows are stored BGR, cv2.imread's
// layout. PNG is decoded in numpy and zlib (image_io.py), with no library.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC image_decode.cpp -ljpeg
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Open `path` and read its header with RGB output; returns 0 on success.
// On failure the struct is destroyed and the file closed.
int open_jpeg(const char* path, jpeg_decompress_struct* cinfo, JpegErr* jerr,
              FILE** f) {
  *f = std::fopen(path, "rb");
  if (!*f) return 1;
  cinfo->err = jpeg_std_error(&jerr->mgr);
  jerr->mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr->jb)) {
    jpeg_destroy_decompress(cinfo);
    std::fclose(*f);
    return 2;
  }
  jpeg_create_decompress(cinfo);
  jpeg_stdio_src(cinfo, *f);
  jpeg_read_header(cinfo, TRUE);
  cinfo->out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Height and width of the JPEG at `path`. Returns 0, 1 (cannot open) or
// 2 (not a JPEG libjpeg can read).
int swindet_jpeg_size(const char* path, int64_t* h, int64_t* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  FILE* f = nullptr;
  const int rc = open_jpeg(path, &cinfo, &jerr, &f);
  if (rc) return rc;
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// Decode the JPEG at `path` into `out`, (h, w, 3) BGR uint8, which must
// hold h * w * 3 bytes for the size swindet_jpeg_size gave. Returns 0, 1
// (cannot open), 2 (decode error) or 3 (size differs from h, w).
int swindet_jpeg_decode(const char* path, uint8_t* out, int64_t h,
                        int64_t w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  FILE* f = nullptr;
  const int rc = open_jpeg(path, &cinfo, &jerr, &f);
  if (rc) return rc;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  if (static_cast<int64_t>(cinfo.output_height) != h ||
      static_cast<int64_t>(cinfo.output_width) != w) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 3;
  }
  jpeg_start_decompress(&cinfo);
  const int c = cinfo.output_components;  // 3 with JCS_RGB
  std::vector<uint8_t> row(w * c);
  uint8_t* rp = row.data();
  for (int64_t y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = out + y * w * 3;
    for (int64_t x = 0; x < w; ++x) {  // RGB to BGR
      dst[x * 3 + 0] = row[x * c + 2 % c];
      dst[x * 3 + 1] = row[x * c + 1 % c];
      dst[x * 3 + 2] = row[x * c + 0];
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

}  // extern "C"
