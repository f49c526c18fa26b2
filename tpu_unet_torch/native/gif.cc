// Native GIF decode: the loader's decode stage for the REAL Carvana mask
// format (the upstream dataset ships <id>_mask.gif palette masks;
// reference: utils/data_loading.py load_image → PIL Image.open over
// train_masks.zip contents, UNVERIFIED mount, SURVEY.md §2 #8/#10).
//
// Emits the raw palette INDEX band of the first frame — exactly what
// numpy.asarray gives for a PIL 'P' image, which is what the loader's
// unique-mask scan and preprocess consume (mask VALUES, not colors).
// GIF's LZW is lossless, so bit-parity with Pillow is a correctness
// property, verified at runtime by the self-check in
// tpu_unet/native/__init__.py before the path is enabled.
//
// Scope (anything else returns kUnsupported → PIL fallback):
//   * first image frame only, positioned at (0,0) with the logical
//     screen's exact size (animated GIFs' later frames are never read;
//     Carvana masks are single-frame)
//   * interlaced and non-interlaced; 87a and 89a; local or global color
//     table (skipped — indices are the payload); extensions skipped
//
// Pure C++ LZW (GIF flavour: LSB-first variable-width codes, CLEAR/EOI,
// 12-bit dictionary cap). No external dependencies.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kUnsupported = 1;  // valid GIF, outside our scope → PIL
constexpr int kCorrupt = 2;      // not a GIF / malformed stream
constexpr int kBadArgs = 3;

inline uint16_t le16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

struct GifFrame {
  int screen_w = 0, screen_h = 0;
  int left = 0, top = 0, w = 0, h = 0;
  bool interlaced = false;
  int min_code_size = 0;
  std::vector<uint8_t> lzw;  // concatenated data sub-blocks
};

// Parse up to and including the first image descriptor. Returns kOk with
// `f` filled (lzw only when want_data), or a failure code.
int parse(const uint8_t* data, int64_t len, GifFrame* f, bool want_data) {
  if (data == nullptr || len < 13) return kCorrupt;
  if (std::memcmp(data, "GIF87a", 6) != 0 &&
      std::memcmp(data, "GIF89a", 6) != 0)
    return kCorrupt;
  int64_t pos = 6;
  f->screen_w = le16(data + pos);
  f->screen_h = le16(data + pos + 2);
  const uint8_t packed = data[pos + 4];
  pos += 7;
  if (packed & 0x80) {  // global color table: 3 * 2^(N+1) bytes, skipped
    pos += 3LL * (1 << ((packed & 0x07) + 1));
  }
  while (pos < len) {
    const uint8_t block = data[pos++];
    if (block == 0x3B) return kCorrupt;  // trailer before any image
    if (block == 0x21) {                 // extension: label + sub-blocks
      if (pos >= len) return kCorrupt;
      ++pos;  // label
      while (pos < len && data[pos] != 0) pos += 1 + data[pos];
      if (pos >= len) return kCorrupt;
      ++pos;  // block terminator
      continue;
    }
    if (block != 0x2C) return kCorrupt;  // unknown block type
    if (pos + 9 > len) return kCorrupt;
    f->left = le16(data + pos);
    f->top = le16(data + pos + 2);
    f->w = le16(data + pos + 4);
    f->h = le16(data + pos + 6);
    const uint8_t ipacked = data[pos + 8];
    pos += 9;
    f->interlaced = (ipacked & 0x40) != 0;
    if (ipacked & 0x80) {  // local color table, skipped
      pos += 3LL * (1 << ((ipacked & 0x07) + 1));
    }
    if (pos >= len) return kCorrupt;
    f->min_code_size = data[pos++];
    if (f->min_code_size < 1 || f->min_code_size > 11) return kCorrupt;
    if (f->left != 0 || f->top != 0 || f->w != f->screen_w ||
        f->h != f->screen_h || f->w <= 0 || f->h <= 0)
      return kUnsupported;  // sub-canvas frame: PIL composites, we don't
    if (!want_data) return kOk;
    while (pos < len && data[pos] != 0) {
      const uint8_t n = data[pos++];
      if (pos + n > len) return kCorrupt;
      f->lzw.insert(f->lzw.end(), data + pos, data + pos + n);
      pos += n;
    }
    if (pos >= len) return kCorrupt;
    return kOk;
  }
  return kCorrupt;
}

// GIF-flavour LZW into exactly n_pixels index bytes (surplus codes from
// sloppy encoders are ignored, shortfall is kCorrupt — PIL pads instead,
// but a short Carvana-class mask stream is damage, not a convention).
int lzw_decode(const std::vector<uint8_t>& src, int min_code_size,
               uint8_t* out, int64_t n_pixels) {
  const int clear = 1 << min_code_size;
  const int eoi = clear + 1;
  // Dictionary entry: prefix chain + suffix byte + first byte + expanded
  // length, packed into 8 bytes so a chain step touches ONE cache line.
  // Tracking lengths lets every string be written tail-first straight
  // into the output buffer — one write per pixel, no stack-then-copy pass
  // (both measured on 1918×1280 Carvana-scale masks).
  struct Entry {
    int32_t prefix;
    uint8_t suffix;
    uint8_t first;
    uint16_t len;
  };
  static_assert(sizeof(Entry) == 8, "keep chain steps one-cache-line");
  static thread_local std::vector<Entry> dict;
  dict.assign(4096, Entry{-1, 0, 0, 1});
  for (int i = 0; i < clear; ++i) {
    dict[i].suffix = static_cast<uint8_t>(i);
    dict[i].first = static_cast<uint8_t>(i);
  }
  int code_size = min_code_size + 1;
  int next = eoi + 1;
  int prev = -1;
  uint32_t bits = 0;
  int nbits = 0;
  size_t spos = 0;
  int64_t emitted = 0;
  while (emitted < n_pixels) {
    while (nbits < code_size) {
      if (spos >= src.size()) return kCorrupt;  // ran dry mid-image
      bits |= static_cast<uint32_t>(src[spos++]) << nbits;
      nbits += 8;
    }
    const int code = static_cast<int>(bits & ((1u << code_size) - 1));
    bits >>= code_size;
    nbits -= code_size;
    if (code == clear) {
      code_size = min_code_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) return kCorrupt;  // EOI before the image was full
    if (code > next || (code == next && prev < 0)) return kCorrupt;
    int cur;
    int64_t total;
    int64_t pos;  // one past the last byte the chain walk writes
    uint8_t first_byte;
    if (code == next) {
      // KwKwK case: string(prev) + first(prev)
      total = static_cast<int64_t>(dict[prev].len) + 1;
      if (emitted + total > n_pixels) return kCorrupt;
      out[emitted + total - 1] = dict[prev].first;
      cur = prev;
      pos = emitted + total - 1;
      first_byte = dict[prev].first;
    } else {
      total = dict[code].len;
      if (emitted + total > n_pixels) return kCorrupt;
      cur = code;
      pos = emitted + total;
      first_byte = dict[code].first;
    }
    // Walk the prefix chain tail→head, writing in place (literals have
    // prefix -1, terminating the walk).
    while (cur >= 0) {
      out[--pos] = dict[cur].suffix;
      cur = dict[cur].prefix;
    }
    emitted += total;
    if (prev >= 0 && next < 4096) {
      dict[next] = Entry{prev, first_byte, dict[prev].first,
                         static_cast<uint16_t>(dict[prev].len + 1)};
      ++next;
      if (next == (1 << code_size) && code_size < 12) ++code_size;
    }
    prev = code;
  }
  return kOk;
}

// GIF interlace pass structure: rows 0,8,16.. then 4,12.. then 2,6.. then
// odd rows (GIF89a spec appendix E).
void deinterlace(const uint8_t* seq, uint8_t* dst, int h, int w) {
  static const int start[4] = {0, 4, 2, 1};
  static const int step[4] = {8, 8, 4, 2};
  int64_t src_row = 0;
  for (int pass = 0; pass < 4; ++pass) {
    for (int y = start[pass]; y < h; y += step[pass]) {
      std::memcpy(dst + static_cast<int64_t>(y) * w, seq + src_row * w, w);
      ++src_row;
    }
  }
}

}  // namespace

extern "C" {

// Probe shape without decoding. Returns 0 and fills h/w on success;
// 1 = valid-but-unsupported (caller → PIL); 2 = corrupt; 3 = bad args.
int tu_gif_probe(const uint8_t* data, int64_t len, int* h, int* w) {
  if (h == nullptr || w == nullptr) return kBadArgs;
  GifFrame f;
  const int rc = parse(data, len, &f, /*want_data=*/false);
  if (rc != kOk) return rc;
  *h = f.h;
  *w = f.w;
  return kOk;
}

// Full decode of the first frame's index band into dst (h*w bytes).
int tu_gif_decode(const uint8_t* data, int64_t len, uint8_t* dst) {
  if (dst == nullptr) return kBadArgs;
  GifFrame f;
  const int rc = parse(data, len, &f, /*want_data=*/true);
  if (rc != kOk) return rc;
  const int64_t n = static_cast<int64_t>(f.w) * f.h;
  if (!f.interlaced) return lzw_decode(f.lzw, f.min_code_size, dst, n);
  std::vector<uint8_t> seq(static_cast<size_t>(n));
  const int drc = lzw_decode(f.lzw, f.min_code_size, seq.data(), n);
  if (drc != kOk) return drc;
  deinterlace(seq.data(), dst, f.h, f.w);
  return kOk;
}

}  // extern "C"
