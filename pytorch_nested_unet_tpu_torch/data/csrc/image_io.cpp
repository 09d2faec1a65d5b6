// Image codec and resize library of the PyTorch port's data path: threaded
// PNG/JPEG decode + resize into one caller-provided buffer, header probes, and
// PNG/JPEG encoders (the cv2.imread / cv2.resize / cv2.imwrite calls of the
// JAX package's data path, without cv2). Plain C interface, loaded with ctypes
// by data/image_io.py, which builds it with g++ at first use.
//
// Decode and resize keep the behaviour of the JAX package's native loader
// (native/fastloader.cpp):
//   - images decode to 3-channel BGR uint8, gray is replicated, alpha is
//     composited onto black; masks decode to 1-channel gray (RGB inputs
//     through libpng's simplified-API luma: sRGB-linearised Rec.709 weights);
//   - resize: bilinear with half-pixel centres and lround (cv2 INTER_LINEAR
//     within 1 LSB) for images, nearest with floor indexing (cv2
//     INTER_NEAREST) for masks.
// The PNG codec is written against zlib alone, so it builds on hosts without
// libpng: 8-bit (and 1/2/4-bit gray and palette) images of every colour type,
// interlaced or not, decode bit for bit as libpng's simplified API decodes
// them (gAMA and sRGB read, as libpng does; partial alpha composited onto
// black as libpng does it, within 1 LSB for gray output); 16-bit samples keep
// their high byte, where libpng would take them as linear light.
// JPEG goes through libjpeg(-turbo) and is compiled in only with -DNU_JPEG
// (data/image_io.py passes it when the compiler finds <jpeglib.h>).
//
// Build (data/image_io.py does this): g++ -O3 -shared -fPIC -std=c++17
//   -ffp-contract=off image_io.cpp -lz -pthread [-DNU_JPEG -ljpeg]
// -ffp-contract=off keeps the bilinear weights unfused, so the resize equals
// its plain numpy version (data/image_io.py) exactly.

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#ifdef NU_JPEG
extern "C" {
#include <jpeglib.h>
}
#endif

namespace {

// status codes, shared with data/image_io.py
enum : int { kOk = 0, kUnreadable = 1, kUnknownFormat = 2, kCorrupt = 3, kNoJpeg = 4 };

struct Image {
  std::vector<unsigned char> data;  // interleaved, row-major
  int h = 0, w = 0, c = 0;          // c: 1 (gray) or 3 (BGR)
};

bool read_file(const char* path, std::vector<unsigned char>* bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char buf[1 << 16];
  size_t got;
  while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) bytes->insert(bytes->end(), buf, buf + got);
  std::fclose(f);
  return true;
}

int sniff(const char* path) {  // 'P' PNG, 'J' JPEG, 0 unknown, -1 unreadable
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  unsigned char magic[4] = {0, 0, 0, 0};
  size_t got = std::fread(magic, 1, 4, f);
  std::fclose(f);
  if (got < 4) return 0;
  if (magic[0] == 0x89 && magic[1] == 'P') return 'P';
  if (magic[0] == 0xFF && magic[1] == 0xD8) return 'J';
  return 0;
}

// ---------- PNG (zlib only) ----------

const unsigned char kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

unsigned be32(const unsigned char* p) {
  return (unsigned(p[0]) << 24) | (unsigned(p[1]) << 16) | (unsigned(p[2]) << 8) | p[3];
}

struct PngHeader {
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
  int gamma = 0;  // gAMA * 1e5; 0 when the file has none
  std::vector<unsigned char> plte, trns;
};

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

bool valid_depth(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

// Walks the chunks; fills the header and, when idat is given, the IDAT bytes.
// Critical chunks must pass their CRC; ancillary ones other than gAMA, sRGB
// and tRNS are skipped.
int png_parse(const std::vector<unsigned char>& b, PngHeader* hd, std::vector<unsigned char>* idat) {
  if (b.size() < 8 || std::memcmp(b.data(), kPngSig, 8) != 0) return kUnknownFormat;
  size_t pos = 8;
  bool have_ihdr = false, have_iend = false;
  while (pos + 12 <= b.size()) {
    const unsigned len = be32(&b[pos]);
    if (len > b.size() - pos - 12) return kCorrupt;
    const unsigned char* type = &b[pos + 4];
    const unsigned char* data = &b[pos + 8];
    const bool critical = !(type[0] & 0x20);
    if (critical) {
      const unsigned crc = be32(data + len);
      if (crc32(crc32(0L, Z_NULL, 0), type, len + 4) != crc) return kCorrupt;
    }
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return kCorrupt;
      hd->w = int(be32(data));
      hd->h = int(be32(data + 4));
      hd->depth = data[8];
      hd->ctype = data[9];
      hd->interlace = data[12];
      if (hd->w <= 0 || hd->h <= 0 || hd->w > (1 << 24) || hd->h > (1 << 24) ||
          !valid_depth(hd->ctype, hd->depth) || data[10] != 0 || data[11] != 0 || hd->interlace > 1)
        return kCorrupt;
      have_ihdr = true;
      if (!idat) return kOk;  // a probe needs the header only
    } else if (!have_ihdr) {
      return kCorrupt;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len == 0 || len > 768) return kCorrupt;
      hd->plte.assign(data, data + len);
    } else if (!std::memcmp(type, "tRNS", 4)) {
      hd->trns.assign(data, data + len);
    } else if (!std::memcmp(type, "gAMA", 4)) {
      if (len == 4 && hd->gamma == 0) hd->gamma = int(be32(data));
    } else if (!std::memcmp(type, "sRGB", 4)) {
      hd->gamma = 45455;  // libpng: an sRGB chunk sets the file gamma to 1/2.2
    } else if (!std::memcmp(type, "IDAT", 4)) {
      if (idat) idat->insert(idat->end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      have_iend = true;
      break;
    } else if (critical) {
      return kCorrupt;  // an unknown critical chunk
    }
    pos += 12 + size_t(len);
  }
  if (!have_ihdr || (idat && !have_iend)) return kCorrupt;
  if (hd->ctype == 3 && hd->plte.empty()) return kCorrupt;
  return kOk;
}

bool inflate_all(const std::vector<unsigned char>& in, std::vector<unsigned char>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<unsigned char*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  const int rc = inflate(&zs, Z_FINISH);
  const bool ok = (rc == Z_STREAM_END || rc == Z_BUF_ERROR) && zs.avail_out == 0;
  inflateEnd(&zs);
  return ok;
}

int paeth(int a, int b, int c) {
  const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undoes the row filters of one (sub)image in place; rows are 1 + rowbytes long.
bool unfilter(unsigned char* p, int rows, size_t rowbytes, int bpp) {
  for (int y = 0; y < rows; ++y) {
    unsigned char* row = p + size_t(y) * (rowbytes + 1);
    const unsigned char* prev = y ? row - (rowbytes + 1) + 1 : nullptr;
    const int ft = row[0];
    unsigned char* r = row + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= size_t(bpp) ? r[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
      switch (ft) {
        case 0: break;
        case 1: r[i] = static_cast<unsigned char>(r[i] + a); break;
        case 2: r[i] = static_cast<unsigned char>(r[i] + b); break;
        case 3: r[i] = static_cast<unsigned char>(r[i] + ((a + b) >> 1)); break;
        case 4: r[i] = static_cast<unsigned char>(r[i] + paeth(a, b, c)); break;
        default: return false;
      }
    }
  }
  return true;
}

int sample(const unsigned char* row, int depth, size_t i) {  // i-th sample of a row
  switch (depth) {
    case 8: return row[i];
    case 16: return (row[2 * i] << 8) | row[2 * i + 1];
    default: {
      const size_t bit = i * depth;
      return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
    }
  }
}

// libpng's gamma arithmetic (png.c, floating-point build): fixed point at 1e5.
int reciprocal(int a) { return int(std::floor(1e10 / a + .5)); }
int reciprocal2(int a, int b) { return int(std::floor(1e15 / a / b + .5)); }
bool gamma_significant(int g) { return g < 100000 - 5000 || g > 100000 + 5000; }
void gamma_table(int g, unsigned char* t) {
  for (int i = 0; i < 256; ++i) {
    if (gamma_significant(g) && i > 0 && i < 255)
      t[i] = static_cast<unsigned char>(std::floor(255 * std::pow(i / 255., g * .00001) + .5));
    else
      t[i] = static_cast<unsigned char>(i);
  }
}

double srgb_to_linear(double v) { return v <= 0.04045 ? v / 12.92 : std::pow((v + 0.055) / 1.055, 2.4); }
double linear_to_srgb(double v) { return v <= 0.0031308 ? v * 12.92 : 1.055 * std::pow(v, 1 / 2.4) - 0.055; }

// libpng's PNG_sRGB_FROM_LINEAR on an 8-bit linear value: the sRGB encoding,
// rounded, except at the two inputs where libpng's piecewise-linear tables
// round the other way.
int srgb_from_linear8(int v) {
  if (v == 110) return 176;
  if (v == 129) return 188;
  return static_cast<int>(std::lround(255 * linear_to_srgb(v / 255.)));
}

int decode_png(const char* path, int want_channels, Image* out) {
  std::vector<unsigned char> bytes, idat;
  if (!read_file(path, &bytes)) return kUnreadable;
  PngHeader hd;
  int rc = png_parse(bytes, &hd, &idat);
  if (rc != kOk) return rc;
  const int nch = png_channels(hd.ctype);
  const int bits = nch * hd.depth;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  const int w = hd.w, h = hd.h;

  // the 7 Adam7 passes, or one pass over the whole image
  struct Pass { int x0, y0, dx, dy; };
  const Pass adam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                         {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  const Pass whole = {0, 0, 1, 1};
  const int npass = hd.interlace ? 7 : 1;
  const Pass* passes = hd.interlace ? adam7 : &whole;
  size_t total = 0;
  for (int p = 0; p < npass; ++p) {
    const int pw = (w - passes[p].x0 + passes[p].dx - 1) / passes[p].dx;
    const int ph = (h - passes[p].y0 + passes[p].dy - 1) / passes[p].dy;
    if (pw > 0 && ph > 0) total += size_t(ph) * (1 + (size_t(pw) * bits + 7) / 8);
  }
  std::vector<unsigned char> raw(total);
  if (!inflate_all(idat, &raw)) return kCorrupt;

  // samples -> 8-bit (value, alpha) per pixel, before any colour conversion
  std::vector<unsigned char> rgba(size_t(w) * h * 4);
  const bool color = hd.ctype == 2 || hd.ctype == 3 || hd.ctype == 6;
  const int maxv = (1 << hd.depth) - 1;
  int trns_key[3] = {-1, -1, -1};
  if (hd.ctype == 0 && hd.trns.size() >= 2) trns_key[0] = (hd.trns[0] << 8) | hd.trns[1];
  if (hd.ctype == 2 && hd.trns.size() >= 6)
    for (int k = 0; k < 3; ++k) trns_key[k] = (hd.trns[2 * k] << 8) | hd.trns[2 * k + 1];
  auto to8 = [&](int v) {  // expand 1/2/4-bit gray, keep 8-bit, high byte of 16-bit
    if (hd.depth == 16) return v >> 8;
    return hd.depth == 8 ? v : v * 255 / maxv;
  };
  size_t off = 0;
  for (int p = 0; p < npass; ++p) {
    const Pass& ps = passes[p];
    const int pw = (w - ps.x0 + ps.dx - 1) / ps.dx;
    const int ph = (h - ps.y0 + ps.dy - 1) / ps.dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t rowbytes = (size_t(pw) * bits + 7) / 8;
    if (!unfilter(raw.data() + off, ph, rowbytes, bpp)) return kCorrupt;
    for (int y = 0; y < ph; ++y) {
      const unsigned char* row = raw.data() + off + size_t(y) * (rowbytes + 1) + 1;
      for (int x = 0; x < pw; ++x) {
        unsigned char* q = &rgba[(size_t(ps.y0 + y * ps.dy) * w + ps.x0 + x * ps.dx) * 4];
        const size_t s = size_t(x) * nch;
        int r, g, b, a = 255;
        switch (hd.ctype) {
          case 0: {
            const int v = sample(row, hd.depth, s);
            r = g = b = to8(v);
            if (v == trns_key[0]) a = 0;
            break;
          }
          case 3: {
            const int idx = sample(row, hd.depth, s);
            if (size_t(idx) * 3 + 2 >= hd.plte.size()) return kCorrupt;
            r = hd.plte[idx * 3];
            g = hd.plte[idx * 3 + 1];
            b = hd.plte[idx * 3 + 2];
            if (size_t(idx) < hd.trns.size()) a = hd.trns[idx];
            break;
          }
          case 2: {
            const int vr = sample(row, hd.depth, s), vg = sample(row, hd.depth, s + 1),
                      vb = sample(row, hd.depth, s + 2);
            r = to8(vr), g = to8(vg), b = to8(vb);
            if (vr == trns_key[0] && vg == trns_key[1] && vb == trns_key[2]) a = 0;
            break;
          }
          case 4:
            r = g = b = to8(sample(row, hd.depth, s));
            a = to8(sample(row, hd.depth, s + 1));
            break;
          default:  // 6
            r = to8(sample(row, hd.depth, s));
            g = to8(sample(row, hd.depth, s + 1));
            b = to8(sample(row, hd.depth, s + 2));
            a = to8(sample(row, hd.depth, s + 3));
        }
        q[0] = static_cast<unsigned char>(r);
        q[1] = static_cast<unsigned char>(g);
        q[2] = static_cast<unsigned char>(b);
        q[3] = static_cast<unsigned char>(a);
      }
    }
    off += size_t(ph) * (rowbytes + 1);
  }

  // colour conversion as libpng's simplified API does it for 8-bit sRGB output
  const int screen = 220000;  // PNG_GAMMA_sRGB
  const int file = hd.gamma > 0 ? hd.gamma : reciprocal(screen);
  unsigned char gt[256], to1[256], from1[256];
  gamma_table(reciprocal2(file, screen), gt);
  gamma_table(reciprocal(file), to1);
  gamma_table(reciprocal(screen), from1);
  const unsigned rc_ = 6968, gc_ = 23434, bc_ = 32768 - 6968 - 23434;  // Rec.709, 1/32768
  out->h = h;
  out->w = w;
  out->c = want_channels;
  out->data.assign(size_t(h) * w * want_channels, 0);
  for (size_t i = 0; i < size_t(h) * w; ++i) {
    const unsigned char* q = &rgba[i * 4];
    int v[3];
    int n;
    if (want_channels == 3) {
      v[0] = gt[q[2]];
      v[1] = gt[q[1]];
      v[2] = gt[q[0]];
      n = 3;
    } else {
      n = 1;
      if (color && (q[0] != q[1] || q[0] != q[2]))
        v[0] = from1[(rc_ * to1[q[0]] + gc_ * to1[q[1]] + bc_ * to1[q[2]] + 16384) >> 15];
      else
        v[0] = gt[q[0]];
    }
    const int a = q[3];
    unsigned char* d = &out->data[i * want_channels];
    for (int k = 0; k < n; ++k) {
      if (a == 255) {
        d[k] = static_cast<unsigned char>(v[k]);
      } else if (a > 0 && n == 3) {
        // over black: libpng's 8-bit png_composite of the linearised value,
        // then its linear -> sRGB table
        const unsigned t = unsigned(to1[want_channels == 3 ? q[2 - k] : v[k]]) * a + 128;
        d[k] = static_cast<unsigned char>(srgb_from_linear8(((t + (t >> 8)) >> 8) & 0xff));
      } else if (a > 0) {  // gray over black in linear light (within 1 LSB of libpng)
        const double lin = srgb_to_linear(v[k] / 255.) * (a / 255.);
        d[k] = static_cast<unsigned char>(std::lround(255 * linear_to_srgb(lin)));
      }
    }
  }
  return kOk;
}

int probe_png(const char* path, int* h, int* w, int* c) {
  std::vector<unsigned char> head(33);
  FILE* f = std::fopen(path, "rb");
  if (!f) return kUnreadable;
  head.resize(std::fread(head.data(), 1, head.size(), f));
  std::fclose(f);
  PngHeader hd;
  const int rc = png_parse(head, &hd, nullptr);
  if (rc != kOk) return rc;
  *h = hd.h;
  *w = hd.w;
  *c = hd.ctype == 3 ? 3 : png_channels(hd.ctype);
  return kOk;
}

void put_chunk(std::vector<unsigned char>* b, const char* type, const unsigned char* data, size_t len) {
  const unsigned char l[4] = {static_cast<unsigned char>(len >> 24), static_cast<unsigned char>(len >> 16),
                              static_cast<unsigned char>(len >> 8), static_cast<unsigned char>(len)};
  b->insert(b->end(), l, l + 4);
  const size_t start = b->size();
  b->insert(b->end(), type, type + 4);
  if (len) b->insert(b->end(), data, data + len);
  const unsigned crc = crc32(crc32(0L, Z_NULL, 0), b->data() + start, static_cast<uInt>(len + 4));
  const unsigned char cb[4] = {static_cast<unsigned char>(crc >> 24), static_cast<unsigned char>(crc >> 16),
                               static_cast<unsigned char>(crc >> 8), static_cast<unsigned char>(crc)};
  b->insert(b->end(), cb, cb + 4);
}

// 8-bit gray (c = 1) or BGR (c = 3) -> PNG, each row Up-filtered, zlib level 6.
int write_png(const char* path, const unsigned char* px, int h, int w, int c) {
  if (h <= 0 || w <= 0 || (c != 1 && c != 3)) return kCorrupt;
  const size_t rowbytes = size_t(w) * c;
  std::vector<unsigned char> raw(size_t(h) * (rowbytes + 1));
  for (int y = 0; y < h; ++y) {
    unsigned char* r = &raw[size_t(y) * (rowbytes + 1)];
    const unsigned char* src = px + size_t(y) * rowbytes;
    const unsigned char* up = y ? src - rowbytes : nullptr;
    r[0] = 2;  // Up
    for (int x = 0; x < w; ++x)
      for (int k = 0; k < c; ++k) {
        const size_t i = size_t(x) * c + k;
        const size_t j = size_t(x) * c + (c == 3 ? 2 - k : 0);  // BGR -> RGB
        r[1 + i] = static_cast<unsigned char>(src[j] - (up ? up[j] : 0));
      }
  }
  uLongf zlen = compressBound(static_cast<uLong>(raw.size()));
  std::vector<unsigned char> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), static_cast<uLong>(raw.size()), 6) != Z_OK) return kCorrupt;
  std::vector<unsigned char> b(kPngSig, kPngSig + 8);
  unsigned char ihdr[13] = {static_cast<unsigned char>(w >> 24), static_cast<unsigned char>(w >> 16),
                            static_cast<unsigned char>(w >> 8), static_cast<unsigned char>(w),
                            static_cast<unsigned char>(h >> 24), static_cast<unsigned char>(h >> 16),
                            static_cast<unsigned char>(h >> 8), static_cast<unsigned char>(h),
                            8, static_cast<unsigned char>(c == 3 ? 2 : 0), 0, 0, 0};
  put_chunk(&b, "IHDR", ihdr, 13);
  put_chunk(&b, "IDAT", z.data(), zlen);
  put_chunk(&b, "IEND", nullptr, 0);
  FILE* f = std::fopen(path, "wb");
  if (!f) return kUnreadable;
  const bool ok = std::fwrite(b.data(), 1, b.size(), f) == b.size();
  return (std::fclose(f) == 0 && ok) ? kOk : kUnreadable;
}

// ---------- JPEG ----------

#ifdef NU_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

int decode_jpeg(const char* path, int want_channels, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kUnreadable;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kCorrupt;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (want_channels == 1) ? JCS_GRAYSCALE : JCS_EXT_BGR;
  jpeg_start_decompress(&cinfo);
  out->h = static_cast<int>(cinfo.output_height);
  out->w = static_cast<int>(cinfo.output_width);
  out->c = want_channels;
  out->data.resize(static_cast<size_t>(out->h) * out->w * out->c);
  const size_t stride = static_cast<size_t>(out->w) * out->c;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->data.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return kOk;
}

int probe_jpeg(const char* path, int* h, int* w, int* c) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kUnreadable;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return kCorrupt;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return kOk;
}

// 8-bit gray (c = 1) or BGR (c = 3) -> baseline JPEG at `quality`, 4:2:0.
int write_jpeg(const char* path, const unsigned char* px, int h, int w, int c, int quality) {
  if (h <= 0 || w <= 0 || (c != 1 && c != 3)) return kCorrupt;
  FILE* f = std::fopen(path, "wb");
  if (!f) return kUnreadable;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return kCorrupt;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = c;
  cinfo.in_color_space = c == 3 ? JCS_EXT_BGR : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = size_t(w) * c;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<unsigned char*>(px + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return std::fclose(f) == 0 ? kOk : kUnreadable;
}
#endif

int decode(const char* path, int want_channels, Image* out) {
  switch (sniff(path)) {
    case -1: return kUnreadable;
    case 'P': return decode_png(path, want_channels, out);
#ifdef NU_JPEG
    case 'J': return decode_jpeg(path, want_channels, out);
#else
    case 'J': return kNoJpeg;
#endif
  }
  return kUnknownFormat;
}

// ---------- resize ----------

// Bilinear, half-pixel centers (cv2 INTER_LINEAR / torch align_corners=False).
void resize_bilinear_u8(const Image& src, unsigned char* dst, int oh, int ow) {
  const int c = src.c;
  const double sy = static_cast<double>(src.h) / oh;
  const double sx = static_cast<double>(src.w) / ow;
  for (int y = 0; y < oh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > src.h - 1) y0 = src.h - 1;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    const double wy = fy - y0;
    for (int x = 0; x < ow; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > src.w - 1) x0 = src.w - 1;
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      const double wx = fx - x0;
      const unsigned char* p00 = &src.data[(static_cast<size_t>(y0) * src.w + x0) * c];
      const unsigned char* p01 = &src.data[(static_cast<size_t>(y0) * src.w + x1) * c];
      const unsigned char* p10 = &src.data[(static_cast<size_t>(y1) * src.w + x0) * c];
      const unsigned char* p11 = &src.data[(static_cast<size_t>(y1) * src.w + x1) * c];
      unsigned char* q = dst + (static_cast<size_t>(y) * ow + x) * c;
      for (int k = 0; k < c; ++k) {
        const double v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                         wy * ((1 - wx) * p10[k] + wx * p11[k]);
        int r = static_cast<int>(std::lround(v));
        q[k] = static_cast<unsigned char>(r < 0 ? 0 : (r > 255 ? 255 : r));
      }
    }
  }
}

// Nearest, floor indexing (cv2 INTER_NEAREST / torch 'nearest').
void resize_nearest_u8(const Image& src, unsigned char* dst, int oh, int ow) {
  const int c = src.c;
  for (int y = 0; y < oh; ++y) {
    int yy = static_cast<int>(static_cast<double>(y) * src.h / oh);
    if (yy > src.h - 1) yy = src.h - 1;
    for (int x = 0; x < ow; ++x) {
      int xx = static_cast<int>(static_cast<double>(x) * src.w / ow);
      if (xx > src.w - 1) xx = src.w - 1;
      std::memcpy(dst + (static_cast<size_t>(y) * ow + x) * c,
                  &src.data[(static_cast<size_t>(yy) * src.w + xx) * c], c);
    }
  }
}

}  // namespace

extern "C" {

int nu_version() { return 1; }

// bit 0: PNG codec; bit 1: JPEG codec (built with -DNU_JPEG)
int nu_features() {
#ifdef NU_JPEG
  return 3;
#else
  return 1;
#endif
}

// Size and channel count stored in a file's header (a palette counts as 3).
// Returns a status code (0: ok).
int nu_probe(const char* path, int* h, int* w, int* c) {
  switch (sniff(path)) {
    case -1: return kUnreadable;
    case 'P': return probe_png(path, h, w, c);
#ifdef NU_JPEG
    case 'J': return probe_jpeg(path, h, w, c);
#else
    case 'J': return kNoJpeg;
#endif
  }
  return kUnknownFormat;
}

// Decode n images into out (n, out_h, out_w, channels) uint8, resizing when
// the source size differs; nearest != 0 selects nearest interpolation. Every
// path is tried: status[i] gets its code (0: ok) and sizes[2i], sizes[2i+1]
// its source height and width (0 when it failed). Returns 0 when all
// succeeded, else the 1-based index of the first failing path.
int nu_load_batch(const char** paths, int n, unsigned char* out, int out_h, int out_w,
                  int channels, int nearest, int num_threads, int* status, int* sizes) {
  std::atomic<int> next(0);
  const size_t img_bytes = static_cast<size_t>(out_h) * out_w * channels;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      Image im;
      unsigned char* dst = out + static_cast<size_t>(i) * img_bytes;
      status[i] = decode(paths[i], channels, &im);
      sizes[2 * i] = status[i] == kOk ? im.h : 0;
      sizes[2 * i + 1] = status[i] == kOk ? im.w : 0;
      if (status[i] != kOk) {
        std::memset(dst, 0, img_bytes);
      } else if (im.h == out_h && im.w == out_w) {
        std::memcpy(dst, im.data.data(), img_bytes);
      } else if (nearest) {
        resize_nearest_u8(im, dst, out_h, out_w);
      } else {
        resize_bilinear_u8(im, dst, out_h, out_w);
      }
    }
  };

  int nthreads = num_threads > 0 ? num_threads
                                 : static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i)
    if (status[i] != kOk) return i + 1;
  return 0;
}

// The two resizes on a uint8 (h, w, c) array, for the tests against their
// plain numpy versions.
void nu_resize(const unsigned char* src, int h, int w, int c, unsigned char* dst, int oh,
               int ow, int nearest) {
  Image im;
  im.data.assign(src, src + size_t(h) * w * c);
  im.h = h;
  im.w = w;
  im.c = c;
  if (nearest)
    resize_nearest_u8(im, dst, oh, ow);
  else
    resize_bilinear_u8(im, dst, oh, ow);
}

// Union per-instance masks (threshold >127) into one binary mask * 255 --
// the DSB2018 offline preprocessing inner loop. masks: (n, h, w) uint8;
// out: (h, w) uint8.
void nu_union_masks(const unsigned char* masks, int n, long long hw, unsigned char* out) {
  std::memset(out, 0, hw);
  for (int i = 0; i < n; ++i) {
    const unsigned char* m = masks + static_cast<size_t>(i) * hw;
    for (long long j = 0; j < hw; ++j) {
      if (m[j] > 127) out[j] = 255;
    }
  }
}

// Write an 8-bit gray (c = 1) or BGR (c = 3) image; format 'P' (PNG) or 'J'
// (JPEG at `quality`). Returns a status code.
int nu_write(const char* path, const unsigned char* px, int h, int w, int c, int format,
             int quality) {
  if (format == 'P') return write_png(path, px, h, w, c);
#ifdef NU_JPEG
  if (format == 'J') return write_jpeg(path, px, h, w, c, quality);
  return kUnknownFormat;
#else
  (void)quality;
  return format == 'J' ? kNoJpeg : kUnknownFormat;
#endif
}

}  // extern "C"
