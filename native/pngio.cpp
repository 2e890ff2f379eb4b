// Native PNG decoder for the data-ingestion hot path.
//
// The reference's loader layer is native C++ (OpenCV imgcodecs decoding n
// high-resolution frames, Utilities.cpp:349-395). This is its optional
// equivalent here: a minimal libpng wrapper exposed through a C ABI and driven
// from Python via ctypes (srmeetsps_cuda_tpu/io/native_loader.py). Decodes
// 8-bit RGB/RGBA/gray and 16-bit gray PNGs into caller-allocated buffers
// (16-bit values are returned host-endian).
//
// Build: make -C native   (-> libpngio.so)

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct PngInfo {
  int width = 0;
  int height = 0;
  int channels = 0;
  int bit_depth = 0;
};

// Opens the file and reads header + normalized format info. On success the
// caller owns the returned structs and must destroy them.
int open_png(const char* path, FILE** fp_out, png_structp* png_out,
             png_infop* info_out, PngInfo* meta) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  unsigned char sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return 2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 4;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int color_type = png_get_color_type(png, info);
  int bit_depth = png_get_bit_depth(png, info);

  // Normalize: palette -> RGB, expand sub-8-bit gray, keep 16-bit as-is.
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // little-endian host order
  png_read_update_info(png, info);

  meta->width = static_cast<int>(png_get_image_width(png, info));
  meta->height = static_cast<int>(png_get_image_height(png, info));
  meta->channels = static_cast<int>(png_get_channels(png, info));
  meta->bit_depth = static_cast<int>(png_get_bit_depth(png, info));
  *fp_out = fp;
  *png_out = png;
  *info_out = info;
  return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success and fills width/height/channels/bit_depth.
int pngio_read_info(const char* path, int* width, int* height, int* channels,
                    int* bit_depth) {
  FILE* fp = nullptr;
  png_structp png = nullptr;
  png_infop info = nullptr;
  PngInfo meta;
  int rc = open_png(path, &fp, &png, &info, &meta);
  if (rc) return rc;
  *width = meta.width;
  *height = meta.height;
  *channels = meta.channels;
  *bit_depth = meta.bit_depth;
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decodes the whole image row-major into `out` (caller-allocated:
// height*width*channels elements of uint8 or uint16 per bit_depth).
int pngio_decode(const char* path, void* out) {
  FILE* fp = nullptr;
  png_structp png = nullptr;
  png_infop info = nullptr;
  PngInfo meta;
  int rc = open_png(path, &fp, &png, &info, &meta);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 5;
  }
  const size_t bytes_per_px =
      static_cast<size_t>(meta.channels) * (meta.bit_depth == 16 ? 2 : 1);
  const size_t stride = bytes_per_px * static_cast<size_t>(meta.width);
  std::vector<png_bytep> rows(meta.height);
  auto* base = static_cast<unsigned char*>(out);
  for (int i = 0; i < meta.height; ++i) rows[i] = base + i * stride;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

}  // extern "C"
