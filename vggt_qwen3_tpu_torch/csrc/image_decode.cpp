// image_decode — thread-pooled JPEG/PNG → RGB8 decoder with a C ABI (loaded
// with ctypes by vggt_qwen3_tpu_torch/data/image_decode.py).
//
// A training micro step reads B·V views (6 · 8 = 48 at the stage-1 recipe).
// This decoder fans a batch of files across a std::thread pool (no GIL),
// with libjpeg for JFIF and libpng for PNG (the format sniffed from the magic
// bytes), and writes straight into caller-owned (numpy) buffers. Every PNG
// variant is normalised to 8-bit RGB as PIL's convert("RGB") does
// (palette, gray, 16-bit, alpha); JPEG output is libjpeg's RGB.
//
// Built with the host C++ compiler at first use (data/native.py), linked
// with -ljpeg -lpng; where those headers are missing the build fails and
// the Python side decodes with PIL.
// API (thread-safe, no global state):
//   int img_probe(const char* path, int* w, int* h);
//       → 0 ok, <0 error. Reads only the header.
//   int img_decode_rgb(const char* path, unsigned char* out, long cap);
//       → 0 ok; `out` must hold w*h*3 bytes (from img_probe).
//   int img_decode_batch_rgb(const char** paths, int n,
//                            unsigned char** outs, const long* caps,
//                            int* rcs, int nthreads);
//       → decodes n files concurrently; per-file status in rcs.
// Error codes: -1 open/read, -2 unsupported format, -3 decode failure,
//              -4 buffer too small.

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrDecode = -3;
constexpr int kErrBuffer = -4;

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int sniff(FILE* f) {  // 0 = jpeg, 1 = png, <0 = error
  unsigned char magic[8] = {0};
  if (fread(magic, 1, 8, f) != 8) return kErrOpen;
  rewind(f);
  if (magic[0] == 0xFF && magic[1] == 0xD8) return 0;
  if (!png_sig_cmp(magic, 0, 8)) return 1;
  return kErrFormat;
}

int jpeg_dims(FILE* f, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode(FILE* f, unsigned char* out, long cap, int* ow, int* oh) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/CMYK promote to RGB
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  if (ow) *ow = w;
  if (oh) *oh = h;
  if (static_cast<long>(w) * h * 3 > cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return kErrBuffer;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int png_dims(FILE* f, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int png_decode(FILE* f, unsigned char* out, long cap, int* ow, int* oh) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  const int w = static_cast<int>(png_get_image_width(png, info));
  const int h = static_cast<int>(png_get_image_height(png, info));
  if (ow) *ow = w;
  if (oh) *oh = h;
  if (static_cast<long>(w) * h * 3 > cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrBuffer;
  }
  // normalize every variant to 8-bit RGB (match PIL convert("RGB"):
  // palette→rgb, gray→rgb, 16-bit→8-bit, alpha stripped)
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = out + static_cast<long>(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

}  // namespace

extern "C" {

int img_probe(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  int kind = sniff(f);
  int rc = kind < 0 ? kind : (kind == 0 ? jpeg_dims(f, w, h) : png_dims(f, w, h));
  fclose(f);
  return rc;
}

int img_decode_rgb(const char* path, unsigned char* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  int kind = sniff(f);
  int rc = kind < 0 ? kind
                    : (kind == 0 ? jpeg_decode(f, out, cap, nullptr, nullptr)
                                 : png_decode(f, out, cap, nullptr, nullptr));
  fclose(f);
  return rc;
}

int img_decode_batch_rgb(const char** paths, int n, unsigned char** outs,
                         const long* caps, int* rcs, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next{0};
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1))
      rcs[i] = img_decode_rgb(paths[i], outs[i], caps[i]);
  };
  std::vector<std::thread> pool;
  const int t = std::min(nthreads, n);
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  int bad = 0;
  for (int i = 0; i < n; ++i)
    if (rcs[i] != 0) ++bad;
  return bad;
}

}  // extern "C"
