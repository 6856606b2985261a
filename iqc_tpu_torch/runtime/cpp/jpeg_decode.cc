// Native JPEG decoder for the serving hot path.
//
// libjpeg(-turbo) with DCT-domain scaling: scale_denom 2/4/8 decodes
// directly at reduced resolution, skipping most of the IDCT work, when the
// pipeline resizes to the model input anyway.
//
// C ABI (ctypes-friendly, see runtime/native.py):
//   iqc_jpeg_info(data, len, &w, &h)                 -> 0 ok
//   iqc_jpeg_decode(data, len, scale_denom, out, cap, &w, &h, &c) -> 0 ok
// out receives tightly packed RGB8; caller sizes cap from iqc_jpeg_info
// (ceil(w/scale)*ceil(h/scale)*3 is an upper bound).
//
// Built as a shared object of its own (linked with -ljpeg), so a machine
// without libjpeg loses only JPEG decoding.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

}  // namespace

extern "C" {

int iqc_jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  // const_cast: classic IJG libjpeg (pre-9b) declares the source buffer
  // non-const; libjpeg never writes it, so the cast is safe on both ABIs.
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// scale_denom in {1,2,4,8}: decode at image_size/scale_denom (DCT-domain).
int iqc_jpeg_decode(const uint8_t* data, size_t len, int scale_denom,
                    uint8_t* out, size_t out_cap, int* w, int* h, int* c) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom =
      (scale_denom == 2 || scale_denom == 4 || scale_denom == 8) ? scale_denom
                                                                 : 1;
  // favor speed: the pipeline bilinearly resizes to the model input anyway
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);

  const size_t row = static_cast<size_t>(cinfo.output_width) *
                     cinfo.output_components;
  const size_t need = row * cinfo.output_height;
  if (cinfo.output_components != 3 || need > out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rows[1] = {out + static_cast<size_t>(cinfo.output_scanline) * row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  *c = cinfo.output_components;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
