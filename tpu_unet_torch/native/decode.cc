// Native PNG decode: the loader's decode stage without Pillow.
//
// Together with preproc.cc (resize/normalize) this makes the host data
// path decode→resize→normalize fully native and GIL-free (the reference
// runs the same stages inside Pillow's C internals; reference:
// utils/data_loading.py load_image → PIL Image.open, UNVERIFIED mount,
// SURVEY.md §2 #8). PNG is lossless, so bit-parity with Pillow's decoder
// is a correctness property of the implementation, not an approximation —
// and it is still verified at runtime by the self-check in
// tpu_unet/native/__init__.py before the path is enabled.
//
// Scope (anything else returns kUnsupported and the caller falls back to
// PIL — identical results, just slower):
//   * bit depth 8, non-interlaced
//   * color types: 0 gray (c=1), 2 RGB (c=3), 3 palette (emits the index
//     band, c=1 — exactly what numpy.asarray gives for a PIL 'P' image),
//     4 gray+alpha (c=2), 6 RGBA (c=4)
//   * all five scanline filters (None/Sub/Up/Average/Paeth)
//   * multiple IDAT chunks; ancillary chunks skipped
//
// Inflate comes from the system zlib (link: -lz). No other dependencies.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kUnsupported = 1;  // valid PNG, outside our scope → PIL
constexpr int kCorrupt = 2;      // not a PNG / malformed stream
constexpr int kBadArgs = 3;

inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

struct PngInfo {
  uint32_t w = 0, h = 0;
  int bit_depth = 0;
  int color_type = 0;
  int channels = 0;  // emitted channels (palette → 1, the index band)
  int interlace = 0;
};

const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

// Chunk CRC over type+data, as the spec defines. Pillow rejects critical
// chunks with bad CRCs (SyntaxError), so the native path must match that
// error surface — a mismatch here returns kCorrupt and the caller falls
// back to PIL, which raises properly.
bool chunk_crc_ok(const uint8_t* type, uint32_t data_len) {
  const uint32_t want = be32(type + 4 + data_len);
  const uint32_t got =
      crc32(crc32(0L, Z_NULL, 0), type, 4 + data_len) & 0xFFFFFFFFu;
  return want == got;
}

// Parse the header far enough to know shape/type. Returns kOk/kUnsupported/
// kCorrupt.
int parse_ihdr(const uint8_t* data, int64_t len, PngInfo* info) {
  if (len < 8 + 25 || std::memcmp(data, kSig, 8) != 0) return kCorrupt;
  const uint8_t* p = data + 8;
  if (be32(p) != 13 || std::memcmp(p + 4, "IHDR", 4) != 0) return kCorrupt;
  if (!chunk_crc_ok(p + 4, 13)) return kCorrupt;
  const uint8_t* ih = p + 8;
  info->w = be32(ih);
  info->h = be32(ih + 4);
  info->bit_depth = ih[8];
  info->color_type = ih[9];
  info->interlace = ih[12];
  if (info->w == 0 || info->h == 0) return kCorrupt;
  if (ih[10] != 0 || ih[11] != 0) return kCorrupt;  // compression/filter
  if (info->bit_depth != 8 || info->interlace != 0) return kUnsupported;
  switch (info->color_type) {
    case 0: info->channels = 1; break;  // gray
    case 2: info->channels = 3; break;  // RGB
    case 3: info->channels = 1; break;  // palette index band
    case 4: info->channels = 2; break;  // gray+alpha
    case 6: info->channels = 4; break;  // RGBA
    default: return kUnsupported;
  }
  // Keep h*w*c comfortably inside int64/size_t arithmetic.
  if (static_cast<uint64_t>(info->w) > (1u << 24) ||
      static_cast<uint64_t>(info->h) > (1u << 24)) {
    return kUnsupported;
  }
  return kOk;
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Inflate every IDAT chunk into `raw` (expected exact size already
// reserved by the caller).
int inflate_idat(const uint8_t* data, int64_t len, std::vector<uint8_t>& raw) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kCorrupt;
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());

  int rc = kCorrupt;
  bool done = false;
  bool bad = false;
  const uint8_t* p = data + 8 + 25;  // past signature + IHDR
  while (p + 12 <= data + len) {
    const uint32_t clen = be32(p);
    const uint8_t* ctype = p + 4;
    const uint8_t* cdata = p + 8;
    if (cdata + clen + 4 > data + len) {
      bad = true;  // truncated chunk
      break;
    }
    if (std::memcmp(ctype, "IDAT", 4) == 0) {
      if (!chunk_crc_ok(ctype, clen)) {
        bad = true;  // Pillow raises on critical-chunk CRC mismatch
        break;
      }
      zs.next_in = const_cast<uint8_t*>(cdata);
      zs.avail_in = clen;
      const int zrc = inflate(&zs, Z_NO_FLUSH);
      if (zrc == Z_STREAM_END) {
        done = true;
      } else if (zrc != Z_OK && zrc != Z_BUF_ERROR) {
        bad = true;
        break;
      }
    } else if (std::memcmp(ctype, "IEND", 4) == 0) {
      break;
    }
    p = cdata + clen + 4;  // skip data + CRC
  }
  if (!bad && done && zs.avail_out == 0) rc = kOk;
  inflateEnd(&zs);
  return rc;
}

int decode_png(const uint8_t* data, int64_t len, uint8_t* dst) {
  PngInfo info;
  int rc = parse_ihdr(data, len, &info);
  if (rc != kOk) return rc;

  const size_t stride = static_cast<size_t>(info.w) * info.channels;
  std::vector<uint8_t> raw;
  raw.resize(static_cast<size_t>(info.h) * (stride + 1));
  rc = inflate_idat(data, len, raw);
  if (rc != kOk) return rc;

  // Unfilter scanline by scanline, writing the recon bytes straight into
  // dst (dst row y doubles as the "previous scanline" for row y+1).
  const int bpp = info.channels;  // bytes per pixel at depth 8
  for (uint32_t y = 0; y < info.h; y++) {
    const uint8_t* line = &raw[static_cast<size_t>(y) * (stride + 1)];
    const int filter = line[0];
    const uint8_t* s = line + 1;
    uint8_t* d = dst + static_cast<size_t>(y) * stride;
    const uint8_t* up = y == 0 ? nullptr : d - stride;
    switch (filter) {
      case 0:
        std::memcpy(d, s, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; i++) {
          d[i] = static_cast<uint8_t>(
              s[i] + (i >= static_cast<size_t>(bpp) ? d[i - bpp] : 0));
        }
        break;
      case 2:  // Up
        if (up == nullptr) {
          std::memcpy(d, s, stride);
        } else {
          for (size_t i = 0; i < stride; i++) {
            d[i] = static_cast<uint8_t>(s[i] + up[i]);
          }
        }
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; i++) {
          const int a = i >= static_cast<size_t>(bpp) ? d[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          d[i] = static_cast<uint8_t>(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; i++) {
          const int a = i >= static_cast<size_t>(bpp) ? d[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= static_cast<size_t>(bpp)) ? up[i - bpp] : 0;
          d[i] = static_cast<uint8_t>(s[i] + paeth(a, b, c));
        }
        break;
      default:
        return kCorrupt;
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// Probe shape/type without decoding. Returns 0 and fills h/w/channels/
// is_palette on success; 1 = valid-but-unsupported (caller → PIL);
// 2 = corrupt/not-PNG; 3 = bad arguments.
int tu_png_probe(const uint8_t* data, int64_t len, int* h, int* w,
                 int* channels, int* is_palette) {
  if (data == nullptr || h == nullptr || w == nullptr || channels == nullptr ||
      is_palette == nullptr) {
    return kBadArgs;
  }
  PngInfo info;
  const int rc = parse_ihdr(data, len, &info);
  if (rc != kOk) return rc;
  *h = static_cast<int>(info.h);
  *w = static_cast<int>(info.w);
  *channels = info.channels;
  *is_palette = info.color_type == 3 ? 1 : 0;
  return kOk;
}

// Decode into dst (h*w*channels bytes, as probed). Palette images emit the
// raw index band — matching numpy.asarray of a PIL 'P' image.
int tu_png_decode(const uint8_t* data, int64_t len, uint8_t* dst) {
  if (data == nullptr || dst == nullptr) return kBadArgs;
  return decode_png(data, len, dst);
}

}  // extern "C"
