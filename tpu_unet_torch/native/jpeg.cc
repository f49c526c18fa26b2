// Native JPEG decode: the loader's decode stage for the REAL Carvana
// format (the upstream dataset ships .jpg images; reference:
// utils/data_loading.py load_image → PIL Image.open over train_hq.zip
// contents, UNVERIFIED mount, SURVEY.md §2 #8/#21).
//
// Unlike PNG, JPEG decode is only *conventionally* deterministic: the
// spec allows IDCT variation. Pillow's bundled decoder and the system
// libjpeg both default to the islow integer IDCT + fancy upsampling, and
// the runtime self-check (tpu_unet/native/__init__.py) asserts
// bit-parity against the installed Pillow across quality / chroma
// subsampling / progressive combinations before this path is ever used —
// any divergence disables it in favour of PIL (identical results, just
// slower). Probed bit-exact on this image: 0 mismatches over
// {L,RGB} × q∈{50,75,85,95,100} × sub∈{4:4:4,4:2:2,4:2:0} × {baseline,
// progressive}.
//
// Scope (anything else returns kUnsupported → PIL fallback):
//   * output components 1 (grayscale) or 3 (RGB / YCbCr→RGB)
//   * baseline and progressive DCT; arithmetic coding if the system
//     libjpeg supports it (errors surface as kCorrupt → PIL)
//   * CMYK / YCCK (4-component) declined — Pillow opens those as 'CMYK',
//     outside the loader's mode set anyway
//
// Decode comes from the system libjpeg (link: -ljpeg). The build falls
// back to a no-JPEG library if that link ever fails (see build() in
// __init__.py), so PNG/resize never depend on it.

#include <cstdio>  // jpeglib.h uses FILE without declaring it

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kOk = 0;
constexpr int kUnsupported = 1;  // valid JPEG, outside our scope → PIL
constexpr int kCorrupt = 2;      // not a JPEG / malformed stream
constexpr int kBadArgs = 3;

// libjpeg reports errors by calling error_exit, which must not return;
// standard practice is longjmp back to the caller (libjpeg.txt "Error
// handling"). output_message is silenced — the PIL fallback will surface
// any user-facing error on its own terms.
struct ErrMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jb;
};

void error_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<ErrMgr*>(cinfo->err)->jb, 1);
}

void output_message(j_common_ptr) {}

// Shared header-read: returns kOk with the header parsed and
// start-decompress-ready defaults (islow IDCT, fancy upsampling — the
// Pillow-matching configuration), or a failure code.
int read_header(jpeg_decompress_struct* cinfo, const uint8_t* data,
                int64_t len) {
  if (data == nullptr || len <= 0) return kBadArgs;
  jpeg_mem_src(cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) return kCorrupt;
  // Defaults after read_header: out_color_space inferred, dct_method
  // JDCT_ISLOW, do_fancy_upsampling TRUE — exactly Pillow's settings.
  return kOk;
}

}  // namespace

extern "C" {

// Probe output shape without decoding pixel data. Returns 0 and fills
// h/w/channels on success; 1 = valid-but-unsupported (caller → PIL);
// 2 = corrupt; 3 = bad args.
int tu_jpeg_probe(const uint8_t* data, int64_t len, int* h, int* w,
                  int* channels) {
  if (h == nullptr || w == nullptr || channels == nullptr) return kBadArgs;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return kCorrupt;
  }
  jpeg_create_decompress(&cinfo);
  int rc = read_header(&cinfo, data, len);
  if (rc != kOk) {
    jpeg_destroy_decompress(&cinfo);
    return rc;
  }
  jpeg_calc_output_dimensions(&cinfo);
  const int c = cinfo.output_components;
  if (c != 1 && c != 3) {
    jpeg_destroy_decompress(&cinfo);
    return kUnsupported;
  }
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  *channels = c;
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

// Full decode into dst (HWC uint8, h*w*channels bytes as probed).
int tu_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* dst) {
  if (dst == nullptr) return kBadArgs;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return kCorrupt;
  }
  jpeg_create_decompress(&cinfo);
  int rc = read_header(&cinfo, data, len);
  if (rc != kOk) {
    jpeg_destroy_decompress(&cinfo);
    return rc;
  }
  if (!jpeg_start_decompress(&cinfo)) {
    jpeg_destroy_decompress(&cinfo);
    return kCorrupt;
  }
  const int c = cinfo.output_components;
  if (c != 1 && c != 3) {
    jpeg_destroy_decompress(&cinfo);
    return kUnsupported;
  }
  const int64_t stride =
      static_cast<int64_t>(cinfo.output_width) * c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = dst + static_cast<int64_t>(cinfo.output_scanline) * stride;
    if (jpeg_read_scanlines(&cinfo, &row, 1) != 1) {
      jpeg_destroy_decompress(&cinfo);
      return kCorrupt;
    }
  }
  if (!jpeg_finish_decompress(&cinfo)) {
    jpeg_destroy_decompress(&cinfo);
    return kCorrupt;
  }
  // libjpeg only WARNS on a truncated stream (JWRN_JPEG_EOF) and pads the
  // remaining rows with gray; Pillow raises instead. Match Pillow's error
  // surface: any decode warning → decline → the PIL fallback raises
  // properly.
  const long warnings = cinfo.err->num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings == 0 ? kOk : kCorrupt;
}

}  // extern "C"
