// slamio — native host runtime of the PyTorch port
// (stereo_visual_slam_tpu_torch/utils/native.py binds it with ctypes).
//
// The port's copy of native/src/slamio.cpp. It differs in one part: PNG
// decode is the port's own (zlib's inflate, the five row filters, Adam7 and
// the sample conversions), so the library needs zlib only and builds where
// libpng is not installed. It turns every PNG that libpng reads into the
// bytes that the original's libpng call sequence gives (see
// decode_png_gray), and refuses what libpng refuses with a reason that
// sio_last_error() returns. Everything else is the original's:
//
//   * grayscale image decode (PNG, binary PGM) — replaces
//     cv::imread(..., IMREAD_GRAYSCALE) of visual_odometry.cpp:50-51;
//   * a multithreaded prefetching stereo-frame loader with a bounded ring
//     buffer, which overlaps decode with device compute;
//   * a KITTI-format trajectory writer emitting the exact row layout of
//     Map::write_pose (map.cpp:188-195): "frame_id r00 r01 r02 x ... z" of
//     T_w_c = T_c_w^-1.
//
// C ABI throughout, consumed from Python via ctypes. All functions return
// 0 / non-negative on success, negative on error.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define SIO_API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// Image decode
// ---------------------------------------------------------------------------

struct GrayImage {
  int h = 0;
  int w = 0;
  std::vector<uint8_t> pix;
};

// Why the last decode on this thread failed (sio_last_error).
thread_local std::string g_error;

bool fail(const std::string& why) {
  g_error = why;
  return false;
}

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
// libpng's default limit on either side (PNG_USER_WIDTH_MAX), and a bound
// on the inflated data that keeps it within zlib's 32-bit counts
const uint32_t kPngMaxSide = 1000000;
const size_t kPngMaxBytes = size_t(1) << 30;

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

std::string chunk_name(const uint8_t* type) {
  return std::string(reinterpret_cast<const char*>(type), 4);
}

const char* png_color_name(int color) {
  switch (color) {
    case 0: return "gray";
    case 2: return "RGB";
    case 3: return "palette";
    case 4: return "gray+alpha";
    case 6: return "RGBA";
  }
  return "invalid";
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;

  int channels() const {
    static const int n[7] = {1, 0, 3, 1, 2, 0, 4};
    return n[color];
  }
};

// An IHDR chunk's `len` bytes at `data`: a header libpng accepts (every
// colour type at each of its bit depths, interlace none or Adam7), or
// false with the reason it is refused.
bool parse_ihdr(uint32_t len, const uint8_t* data, PngHeader* hdr) {
  if (len != 13) return fail("bad PNG header");
  hdr->w = be32(data);
  hdr->h = be32(data + 4);
  hdr->depth = data[8];
  hdr->color = data[9];
  hdr->interlace = data[12];
  const int depth = hdr->depth, color = hdr->color;
  if (hdr->w == 0 || hdr->h == 0 || hdr->w > kPngMaxSide || hdr->h > kPngMaxSide)
    return fail("bad PNG size " + std::to_string(hdr->w) + "x" + std::to_string(hdr->h));
  if (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16)
    return fail("bad PNG bit depth " + std::to_string(depth));
  if (color > 6 || color == 1 || color == 5)
    return fail("bad PNG colour type " + std::to_string(color));
  if ((color == 3 && depth == 16) || (color != 0 && color != 3 && depth < 8))
    return fail("bad PNG bit depth " + std::to_string(depth) + " for colour type " +
                std::to_string(color) + " (" + png_color_name(color) + ")");
  if (data[10] != 0) return fail("bad PNG compression method " + std::to_string(data[10]));
  if (data[11] != 0) return fail("bad PNG filter method " + std::to_string(data[11]));
  if (hdr->interlace > 1) return fail("bad PNG interlace method " + std::to_string(hdr->interlace));
  return true;
}

// ---- libpng's colour handling, in its fixed point (x 100000) -------------
//
// The original reads with png_set_rgb_to_gray_fixed(png, 1, -1, -1) and no
// png_set_gamma. libpng then weights R, G and B with coefficients that sum
// to 32768: 6968 / 23434 / 2366, or those derived from the Y of the file's
// end points (a cHRM chunk, or sRGB's). With no file gamma the weighting is
// plain; with a file gamma G (gAMA or sRGB) whose G or 1/G lies more than
// 0.05 from 1, libpng linearises each channel by tables, weights, and
// re-encodes with G. The tables below are those values, computed the way
// libpng 1.6 computes them (double arithmetic, rounded with floor(x + .5)),
// so that the bytes agree.

const int32_t kFp1 = 100000;
const int32_t kSrgbGamma = 45455;
// sRGB's end points: (x, y) of white, red, green, blue, and their Y
const int32_t kSrgbXy[8] = {31270, 32900, 64000, 33000, 30000, 60000, 15000, 6000};
const int32_t kSrgbY[3] = {21264, 71517, 7219};
// the 16-bit tables keep at least the top 11 bits when the output is 8-bit
const int kMaxGammaShift16To8 = 5;

bool fp_from_double(double r, int32_t* out) {
  if (!(r <= 2147483647. && r >= -2147483648.)) return false;
  *out = static_cast<int32_t>(r);
  return true;
}

// a * times / divisor, rounded; false on a zero divisor or overflow
bool fp_muldiv(int32_t* res, int32_t a, int32_t times, int32_t divisor) {
  if (divisor == 0) return false;
  if (a == 0 || times == 0) {
    *res = 0;
    return true;
  }
  double r = a;
  r *= times;
  r /= divisor;
  return fp_from_double(std::floor(r + .5), res);
}

int32_t fp_reciprocal(int32_t a) {
  int32_t r = 0;
  return fp_from_double(std::floor(1E10 / a + .5), &r) ? r : 0;
}

int32_t fp_reciprocal2(int32_t a, int32_t b) {  // 1 / (a * b)
  int32_t r = 0;
  if (a == 0 || b == 0) return 0;
  double d = 1E15 / a;
  d /= b;
  return fp_from_double(std::floor(d + .5), &r) ? r : 0;
}

int32_t fp_product2(int32_t a, int32_t b) {
  int32_t r = 0;
  double d = a * 1E-5;
  d *= b;
  return fp_from_double(std::floor(d + .5), &r) ? r : 0;
}

bool gamma_significant(int32_t g) { return g < kFp1 - 5000 || g > kFp1 + 5000; }

bool xy_match(const int32_t* a, const int32_t* b, int32_t delta) {
  for (int i = 0; i < 8; ++i)
    if (a[i] < b[i] - delta || a[i] > b[i] + delta) return false;
  return true;
}

// The Y of the end points of chromaticities xy (white, red, green, blue),
// with white's Y taken as 1; false where libpng finds them invalid: out of
// range, or not recovered within 5 by the way back.
bool end_points_y(const int32_t* xy, int32_t* Y) {
  const int32_t wx = xy[0], wy = xy[1], rx = xy[2], ry = xy[3];
  const int32_t gx = xy[4], gy = xy[5], bx = xy[6], by = xy[7];
  for (int i = 2; i < 8; i += 2)
    if (xy[i] < 0 || xy[i] > kFp1 || xy[i + 1] < 0 || xy[i + 1] > kFp1 - xy[i]) return false;
  if (wx < 0 || wx > kFp1 || wy < 5 || wy > kFp1 - wx) return false;
  // the scales of red and green (as reciprocals) from the white point, and
  // blue's as what is left of white's
  int32_t left, right, denominator, red_inverse, green_inverse;
  if (!fp_muldiv(&left, gx - bx, ry - by, 7) || !fp_muldiv(&right, gy - by, rx - bx, 7))
    return false;
  denominator = left - right;
  if (!fp_muldiv(&left, gx - bx, wy - by, 7) || !fp_muldiv(&right, gy - by, wx - bx, 7))
    return false;
  if (!fp_muldiv(&red_inverse, wy, denominator, left - right) || red_inverse <= wy) return false;
  if (!fp_muldiv(&left, ry - by, wx - bx, 7) || !fp_muldiv(&right, rx - bx, wy - by, 7))
    return false;
  if (!fp_muldiv(&green_inverse, wy, denominator, left - right) || green_inverse <= wy)
    return false;
  const int32_t blue_scale =
      fp_reciprocal(wy) - fp_reciprocal(red_inverse) - fp_reciprocal(green_inverse);
  if (blue_scale <= 0) return false;
  // X, Y, Z of red, green and blue
  int32_t XYZ[9];
  if (!fp_muldiv(&XYZ[0], rx, kFp1, red_inverse) || !fp_muldiv(&XYZ[1], ry, kFp1, red_inverse) ||
      !fp_muldiv(&XYZ[2], kFp1 - rx - ry, kFp1, red_inverse) ||
      !fp_muldiv(&XYZ[3], gx, kFp1, green_inverse) ||
      !fp_muldiv(&XYZ[4], gy, kFp1, green_inverse) ||
      !fp_muldiv(&XYZ[5], kFp1 - gx - gy, kFp1, green_inverse) ||
      !fp_muldiv(&XYZ[6], bx, blue_scale, kFp1) || !fp_muldiv(&XYZ[7], by, blue_scale, kFp1) ||
      !fp_muldiv(&XYZ[8], kFp1 - bx - by, blue_scale, kFp1))
    return false;
  // the way back to chromaticities
  int32_t back[8], sum_x = 0, sum_y = 0, sum = 0;
  for (int c = 0; c < 3; ++c) {
    const int32_t X = XYZ[3 * c], Yc = XYZ[3 * c + 1], d = X + Yc + XYZ[3 * c + 2];
    if (!fp_muldiv(&back[2 + 2 * c], X, kFp1, d) || !fp_muldiv(&back[3 + 2 * c], Yc, kFp1, d))
      return false;
    sum_x += X;
    sum_y += Yc;
    sum += d;
  }
  if (!fp_muldiv(&back[0], sum_x, kFp1, sum) || !fp_muldiv(&back[1], sum_y, kFp1, sum))
    return false;
  if (!xy_match(xy, back, 5)) return false;
  Y[0] = XYZ[1];
  Y[1] = XYZ[4];
  Y[2] = XYZ[7];
  return true;
}

// What the colour chunks (gAMA, cHRM, sRGB, and sBIT, which narrows the
// 16-bit gamma tables) before PLTE and IDAT leave, as libpng keeps it: a
// chunk that contradicts an earlier one, or is invalid, makes the colour
// space invalid and later ones are ignored; an invalid sBIT is ignored.
struct PngColour {
  int32_t gamma = 0;  // 0: none
  bool from_gama = false, from_srgb = false, from_chrm = false, have_intent = false;
  bool invalid = false, have_end_points = false;
  int32_t xy[8] = {0};
  int32_t Y[3] = {0};
  int sig_bits = 0;  // sBIT's most significant bits of R, G, B (gray); 0: none

  void sbit(const uint8_t* data, uint32_t len, const PngHeader& hdr) {
    const int max = hdr.color == 3 ? 8 : hdr.depth;
    if (sig_bits != 0 || len != static_cast<uint32_t>(hdr.color == 3 ? 3 : hdr.channels()))
      return;
    for (uint32_t i = 0; i < len; ++i)
      if (data[i] == 0 || data[i] > max) return;
    sig_bits = data[0];
    if (hdr.color & 2) sig_bits = std::max(sig_bits, std::max<int>(data[1], data[2]));
  }

  void set_end_points(const int32_t* new_xy, const int32_t* new_Y) {
    std::memcpy(xy, new_xy, sizeof(xy));
    std::memcpy(Y, new_Y, sizeof(Y));
    have_end_points = true;
  }

  void gama(uint32_t v) {
    const int32_t g = v > 0x7fffffffu ? -1 : static_cast<int32_t>(v);
    if (g < 16 || g > 625000000 || from_gama) {
      invalid = true;
      return;
    }
    if (invalid) return;
    int32_t ratio = 0;
    if (gamma != 0 && from_srgb &&
        (!fp_muldiv(&ratio, gamma, kFp1, g) || gamma_significant(ratio)))
      return;  // sRGB's gamma stays
    gamma = g;
    from_gama = true;
  }

  void srgb(int intent) {
    if (invalid) return;
    if (have_intent || intent < 0 || intent > 3) {
      invalid = true;
      return;
    }
    have_intent = from_srgb = true;
    set_end_points(kSrgbXy, kSrgbY);
    gamma = kSrgbGamma;
  }

  void chrm(const uint8_t* data) {
    int32_t v[8];
    for (int i = 0; i < 8; ++i) {
      const uint32_t u = be32(data + 4 * i);
      if (u > 0x7fffffffu) return;  // invalid values: the chunk is ignored
      v[i] = static_cast<int32_t>(u);
    }
    if (invalid) return;
    if (from_chrm) {
      invalid = true;
      return;
    }
    from_chrm = true;
    int32_t new_Y[3];
    if (!end_points_y(v, new_Y) || (have_end_points && !xy_match(v, xy, 100))) {
      invalid = true;
      return;
    }
    set_end_points(v, new_Y);
  }
};

double gamma_exponent(int32_t g) { return g * .00001; }

// libpng's 8-bit table for gamma g: 255 * (i / 255)^g, rounded
std::vector<uint8_t> gamma_table_8(int32_t g) {
  std::vector<uint8_t> t(256);
  for (int i = 0; i < 256; ++i) {
    t[i] = static_cast<uint8_t>(i);
    if (gamma_significant(g) && i > 0 && i < 255)
      t[i] = static_cast<uint8_t>(std::floor(255 * std::pow(i / 255., gamma_exponent(g)) + .5));
  }
  return t;
}

// libpng's 16-bit table for gamma g, indexed by a sample's top 16 - shift bits
std::vector<uint16_t> gamma_table_16(int32_t g, int shift) {
  const uint32_t max = (1u << (16 - shift)) - 1;
  const double fmax = 1.0 / max;
  std::vector<uint16_t> t(max + 1);
  for (uint32_t ig = 0; ig <= max; ++ig) {
    t[ig] = gamma_significant(g)
                ? static_cast<uint16_t>(
                      std::floor(65535. * std::pow(ig * fmax, gamma_exponent(g)) + .5))
                : static_cast<uint16_t>((ig * 65535u + (1u << (15 - shift))) / max);
  }
  return t;
}

uint32_t gamma_correct_16(uint32_t v, int32_t g) {
  if (v == 0 || v >= 65535) return v;
  return static_cast<uint32_t>(
      std::floor(65535 * std::pow(static_cast<int32_t>(v) / 65535., gamma_exponent(g)) + .5));
}

// libpng's 16-to-8 table for gamma g (the reciprocal of the correction): the
// nearest of the 256 8-bit levels (x 257), by the top 16 - shift bits
std::vector<uint16_t> gamma_table_16_to_8(int32_t g, int shift) {
  const uint32_t max = (1u << (16 - shift)) - 1;
  std::vector<uint16_t> t(max + 1, 65535);
  uint32_t last = 0;
  for (uint32_t i = 0; i < 255; ++i) {
    // the input at the boundary between levels i and i + 1, on max
    const uint32_t out = i * 257;
    const uint32_t bound = (gamma_correct_16(out + 128, g) * max + 32768) / 65535 + 1;
    for (; last < bound && last <= max; ++last) t[last] = static_cast<uint16_t>(out);
  }
  return t;
}

// Rows of a PNG's samples -> 8-bit gray: libpng's expansion of palettes and
// of 1/2/4-bit gray, its strip_alpha, rgb_to_gray and strip_16, in that
// order. tRNS takes no part: its alpha is stripped as the colour types'
// own alpha is.
struct GrayConverter {
  int color = 0, depth = 8;
  uint32_t rc = 6968, gc = 23434, bc = 2366;
  bool tables = false;               // libpng's gamma-table path
  int shift = kMaxGammaShift16To8;   // the 16-bit tables' index: v >> shift
  uint8_t palette_gray[256] = {0};   // each palette index's gray
  std::vector<uint8_t> to_linear_8, from_linear_8, equal_8;
  std::vector<uint16_t> to_linear_16, from_linear_16, equal_16;

  uint8_t rgb8(uint32_t r, uint32_t g, uint32_t b) const {
    if (r == g && r == b) return tables ? equal_8[r] : static_cast<uint8_t>(r);
    if (!tables) return static_cast<uint8_t>((rc * r + gc * g + bc * b) >> 15);
    return from_linear_8[(rc * to_linear_8[r] + gc * to_linear_8[g] + bc * to_linear_8[b] +
                          16384) >> 15];
  }

  uint8_t rgb16(const uint8_t* p) const {
    const uint32_t r = (p[0] << 8) | p[1], g = (p[2] << 8) | p[3], b = (p[4] << 8) | p[5];
    if (!tables) return static_cast<uint8_t>(((rc * r + gc * g + bc * b + 16384) >> 15) >> 8);
    if (r == g && r == b) return static_cast<uint8_t>(equal_16[r >> shift] >> 8);
    const uint32_t gray = (rc * to_linear_16[r >> shift] + gc * to_linear_16[g >> shift] +
                           bc * to_linear_16[b >> shift] + 16384) >> 15;
    return static_cast<uint8_t>(from_linear_16[gray >> shift] >> 8);
  }

  // the coefficients and tables of a header and its colour chunks; the
  // palette's grays come with set_palette
  bool init(const PngHeader& hdr, const PngColour& colour) {
    color = hdr.color;
    depth = hdr.depth;
    if (color != 2 && color != 3 && color != 6) return true;
    if (colour.have_end_points) {
      int32_t r = colour.Y[0], g = colour.Y[1], b = colour.Y[2];
      const int32_t total = r + g + b;
      if (!(total > 0 && r >= 0 && fp_muldiv(&r, r, 32768, total) && r >= 0 && r <= 32768 &&
            g >= 0 && fp_muldiv(&g, g, 32768, total) && g >= 0 && g <= 32768 && b >= 0 &&
            fp_muldiv(&b, b, 32768, total) && b >= 0 && b <= 32768 && r + g + b <= 32769))
        return fail("bad PNG chromaticities");
      // a sum off 32768 by one moves the largest coefficient
      const int add = r + g + b > 32768 ? -1 : r + g + b < 32768 ? 1 : 0;
      if (g >= r && g >= b) {
        g += add;
      } else if (r >= g && r >= b) {
        r += add;
      } else {
        b += add;
      }
      rc = static_cast<uint32_t>(r);
      gc = static_cast<uint32_t>(g);
    }
    bc = 32768 - rc - gc;
    // no file gamma: file and screen are both taken as linear
    const int32_t file = colour.gamma != 0 ? colour.gamma : kFp1;
    const int32_t screen = colour.gamma != 0 ? fp_reciprocal(colour.gamma) : kFp1;
    tables = gamma_significant(file) || gamma_significant(screen);
    if (!tables) return true;
    if (depth <= 8) {
      equal_8 = gamma_table_8(fp_reciprocal2(file, screen));
      to_linear_8 = gamma_table_8(fp_reciprocal(file));
      from_linear_8 = gamma_table_8(fp_reciprocal(screen));
    } else {
      // the bits below the significant ones, at least those that 8 bits drop
      shift = colour.sig_bits > 0 && colour.sig_bits < 16 ? 16 - colour.sig_bits : 0;
      shift = std::min(std::max(shift, kMaxGammaShift16To8), 8);
      equal_16 = gamma_table_16_to_8(fp_product2(file, screen), shift);
      to_linear_16 = gamma_table_16(fp_reciprocal(file), shift);
      from_linear_16 = gamma_table_16(fp_reciprocal(screen), shift);
    }
    return true;
  }

  // PLTE's `n` entries; an index past them reads as black
  void set_palette(const uint8_t* rgb, int n) {
    for (int i = 0; i < 256; ++i)
      palette_gray[i] = i < n ? rgb8(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]) : rgb8(0, 0, 0);
  }

  // one unfiltered row of `n` pixels at `src` -> `n` gray bytes at `dst`
  void row(const uint8_t* src, uint32_t n, uint8_t* dst) const {
    if (depth < 8) {  // gray or palette, packed from the high bits
      const int per = 8 / depth, mask = (1 << depth) - 1;
      const int scale = color == 0 ? 255 / mask : 0;
      for (uint32_t x = 0; x < n; ++x) {
        const int v = (src[x / per] >> (8 - depth * (1 + x % per))) & mask;
        dst[x] = static_cast<uint8_t>(color == 0 ? v * scale : palette_gray[v]);
      }
      return;
    }
    const int step = (depth / 8) * (color == 0 ? 1 : color == 4 ? 2 : color == 2 ? 3 : 4);
    switch (color) {
      case 0:
      case 4:  // gray (+ alpha): the first byte of each pixel
        if (step == 1) {
          std::memcpy(dst, src, n);
        } else {
          for (uint32_t x = 0; x < n; ++x) dst[x] = src[x * step];
        }
        break;
      case 3:
        for (uint32_t x = 0; x < n; ++x) dst[x] = palette_gray[src[x]];
        break;
      default:  // RGB (+ alpha)
        if (depth == 8) {
          for (uint32_t x = 0; x < n; ++x, src += step) dst[x] = rgb8(src[0], src[1], src[2]);
        } else {
          for (uint32_t x = 0; x < n; ++x, src += step) dst[x] = rgb16(src);
        }
    }
  }
};

// Adam7's passes: first column and row, then the steps between them
struct PngPass {
  uint32_t x0, y0, dx, dy;
};
const PngPass kWholeImage[1] = {{0, 0, 1, 1}};
const PngPass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                           {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

uint32_t pass_extent(uint32_t n, uint32_t start, uint32_t step) {
  return n > start ? (n - start + step - 1) / step : 0;
}

// Undo the row filters of `h` rows of `stride` bytes, each behind its filter
// byte, in place; `bpp`: the bytes of one pixel, at least 1.
bool unfilter(uint8_t* raw, uint32_t h, size_t stride, size_t bpp) {
  const std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* cur = raw + y * (stride + 1) + 1;
    switch (cur[-1]) {
      case 0:  // None
        break;
      case 1:  // Sub
        for (size_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) cur[i] += prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < bpp; ++i) cur[i] += prev[i] >> 1;
        for (size_t i = bpp; i < stride; ++i) cur[i] += (cur[i - bpp] + prev[i]) >> 1;
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < bpp; ++i) cur[i] += prev[i];
        for (size_t i = bpp; i < stride; ++i)
          cur[i] += paeth(cur[i - bpp], prev[i], prev[i - bpp]);
        break;
      default:
        return fail("bad PNG row filter " + std::to_string(cur[-1]));
    }
    prev = cur;
  }
  return true;
}

// The file's size in bytes, leaving it at its start.
bool file_size(FILE* fp, size_t* size) {
  if (std::fseek(fp, 0, SEEK_END) != 0) return fail("cannot read the file");
  const long n = std::ftell(fp);
  if (n < 0 || std::fseek(fp, 0, SEEK_SET) != 0) return fail("cannot read the file");
  *size = static_cast<size_t>(n);
  return true;
}

// Any PNG -> 8-bit gray, byte for byte as native/src/slamio.cpp's libpng
// calls make it: png_set_strip_16, png_set_palette_to_rgb,
// png_set_expand_gray_1_2_4_to_8, png_set_tRNS_to_alpha, png_set_strip_alpha
// and png_set_rgb_to_gray_fixed(png, 1, -1, -1). Critical chunks' CRCs are
// checked; an ancillary chunk with a bad CRC is dropped, as libpng does by
// default. Of the ancillary chunks, gAMA, cHRM and sRGB take part (see
// GrayConverter), and sBIT where they make 16-bit tables; tRNS's alpha is
// stripped, and the rest are skipped. (The original calls
// png_set_strip_alpha for the colour types with alpha only, so a tRNS image
// there comes back as gray+alpha rows written into gray rows, past the end
// of its buffer; the port gives the gray.)
bool decode_png_gray(FILE* fp, GrayImage* out) {
  size_t size = 0;
  if (!file_size(fp, &size)) return false;
  std::vector<uint8_t> file(size);
  if (std::fread(file.data(), 1, file.size(), fp) != file.size()) return fail("short read");
  if (file.size() < 8 || std::memcmp(file.data(), kPngSignature, 8) != 0)
    return fail("not a PNG file");

  PngHeader hdr;
  PngColour colour;
  const uint8_t* palette = nullptr;
  int palette_size = 0;
  bool have_header = false, have_plte = false, have_end = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (!have_end) {
    if (file.size() - pos < 12) return fail("truncated PNG");
    uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return fail("truncated PNG chunk");
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = type + 4;
    pos += size_t(len) + 12;
    const bool critical = !(type[0] & 0x20);
    const bool crc_ok = crc32(0L, type, len + 4) == be32(data + len);
    if (critical && !crc_ok) return fail("CRC error in PNG chunk " + chunk_name(type));
    const bool before_data = idat.empty() && !have_plte;
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_header) return fail("bad PNG header");
      if (!parse_ihdr(len, data, &hdr)) return false;
      have_header = true;
    } else if (!have_header) {
      return fail("PNG without a header");
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (hdr.color == 3 && palette == nullptr)
        return fail("PNG palette image without a PLTE chunk before its data");
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      have_end = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (have_plte) return fail("PNG with two PLTE chunks");
      if (!idat.empty()) continue;  // out of place
      have_plte = true;
      if (!(hdr.color & 2)) continue;  // a gray image's
      if (len % 3 != 0 || len > 768) {
        if (hdr.color == 3) return fail("bad PNG palette of " + std::to_string(len) + " bytes");
        continue;
      }
      if (len == 0) return fail("bad PNG palette of 0 bytes");
      palette = data;
      palette_size = static_cast<int>(len / 3);
      if (hdr.color == 3 && palette_size > (1 << hdr.depth)) palette_size = 1 << hdr.depth;
    } else if (critical) {
      return fail("unknown critical PNG chunk " + chunk_name(type));
    } else if (!crc_ok || !before_data) {
      // dropped: a bad CRC, or a colour chunk after PLTE or IDAT
    } else if (std::memcmp(type, "gAMA", 4) == 0) {
      if (len == 4) colour.gama(be32(data));
    } else if (std::memcmp(type, "sRGB", 4) == 0) {
      if (len == 1) colour.srgb(data[0]);
    } else if (std::memcmp(type, "sBIT", 4) == 0) {
      colour.sbit(data, len, hdr);
    } else if (std::memcmp(type, "cHRM", 4) == 0) {
      if (len == 32) colour.chrm(data);
    }
  }
  if (idat.empty()) return fail("PNG without image data");
  GrayConverter conv;
  if (!conv.init(hdr, colour)) return false;
  if (hdr.color == 3) conv.set_palette(palette, palette_size);

  // per pass: one filter byte, then the row's samples (big-endian at 16 bits)
  const uint32_t w = hdr.w, h = hdr.h;
  const size_t bits = size_t(hdr.channels()) * hdr.depth;
  const size_t bpp = bits < 8 ? 1 : bits / 8;
  const PngPass* passes = hdr.interlace ? kAdam7 : kWholeImage;
  const int n_passes = hdr.interlace ? 7 : 1;
  size_t total = 0;
  for (int p = 0; p < n_passes; ++p) {
    const uint32_t pw = pass_extent(w, passes[p].x0, passes[p].dx);
    const uint32_t ph = pass_extent(h, passes[p].y0, passes[p].dy);
    if (pw && ph) total += ph * ((pw * bits + 7) / 8 + 1);
    if (total > kPngMaxBytes) return fail("PNG image too large");
  }
  std::vector<uint8_t> raw(total);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return fail("zlib inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  // data past the last row is ignored, as libpng warns and goes on
  inflate(&zs, Z_FINISH);
  const bool complete = zs.avail_out == 0;
  inflateEnd(&zs);
  if (!complete) return fail("corrupt or short PNG image data");

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->pix.resize(static_cast<size_t>(h) * w);
  std::vector<uint8_t> line(hdr.interlace ? w : 0);
  uint8_t* rows = raw.data();
  for (int p = 0; p < n_passes; ++p) {
    const PngPass& ps = passes[p];
    const uint32_t pw = pass_extent(w, ps.x0, ps.dx), ph = pass_extent(h, ps.y0, ps.dy);
    if (!pw || !ph) continue;  // a pass with no pixels has no bytes
    const size_t stride = (pw * bits + 7) / 8;
    if (!unfilter(rows, ph, stride, bpp)) return false;
    for (uint32_t r = 0; r < ph; ++r) {
      const uint8_t* src = rows + r * (stride + 1) + 1;
      uint8_t* dst = &out->pix[size_t(ps.y0 + r * ps.dy) * w];
      if (!hdr.interlace) {
        conv.row(src, pw, dst);
        continue;
      }
      conv.row(src, pw, line.data());
      for (uint32_t i = 0; i < pw; ++i) dst[ps.x0 + i * ps.dx] = line[i];
    }
    rows += ph * (stride + 1);
  }
  return true;
}

// A PNG's size from its signature and first chunk alone, which must be the
// header: that chunk gets decode_png_gray's checks, in its order and with
// its reasons. The image data is not read.
bool probe_png_gray(FILE* fp, int* h, int* w) {
  size_t size = 0;
  if (!file_size(fp, &size)) return false;
  uint8_t head[16];  // the signature, then the first chunk's length and type
  if (size < 8 || std::fread(head, 1, 8, fp) != 8 || std::memcmp(head, kPngSignature, 8) != 0)
    return fail("not a PNG file");
  if (size - 8 < 12) return fail("truncated PNG");
  if (std::fread(head + 8, 1, 8, fp) != 8) return fail("short read");
  const uint32_t len = be32(head + 8);
  if (len > size - 8 - 12) return fail("truncated PNG chunk");
  std::vector<uint8_t> chunk(size_t(len) + 8);  // type, data, CRC
  std::memcpy(chunk.data(), head + 12, 4);
  if (std::fread(chunk.data() + 4, 1, size_t(len) + 4, fp) != size_t(len) + 4)
    return fail("short read");
  const uint8_t* type = chunk.data();
  const uint8_t* data = type + 4;
  if (!(type[0] & 0x20) && crc32(0L, type, len + 4) != be32(data + len))
    return fail("CRC error in PNG chunk " + chunk_name(type));
  if (std::memcmp(type, "IHDR", 4) != 0) return fail("PNG without a header");
  PngHeader hdr;
  if (!parse_ihdr(len, data, &hdr)) return false;
  *h = static_cast<int>(hdr.h);
  *w = static_cast<int>(hdr.w);
  return true;
}

// A binary PGM's header: its size, or the reason it is refused.
bool read_pgm_header(FILE* fp, long* w, long* h) {
  auto skip_ws = [&]() {
    int c;
    while ((c = fgetc(fp)) != EOF) {
      if (c == '#') {
        while ((c = fgetc(fp)) != EOF && c != '\n') {
        }
      } else if (!std::isspace(c)) {
        ungetc(c, fp);
        return;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    int c, any = 0;
    while ((c = fgetc(fp)) != EOF && std::isdigit(c)) {
      v = v * 10 + (c - '0');
      any = 1;
    }
    return any ? v : -1;
  };
  char magic[3] = {0, 0, 0};
  if (fread(magic, 1, 2, fp) != 2 || magic[0] != 'P' || magic[1] != '5')
    return fail("not a binary PGM file");
  *w = read_int();
  *h = read_int();
  long maxv = read_int();
  if (*w <= 0 || *h <= 0 || maxv <= 0 || maxv > 255) return fail("bad or 16-bit PGM header");
  return true;
}

// Minimal binary PGM (P5) reader, 8-bit maxval.
bool decode_pgm_gray(FILE* fp, GrayImage* out) {
  long w = 0, h = 0;
  if (!read_pgm_header(fp, &w, &h)) return false;
  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->pix.resize(static_cast<size_t>(h) * w);
  if (fread(out->pix.data(), 1, out->pix.size(), fp) != out->pix.size())
    return fail("truncated PGM");
  return true;
}

// Opens `path` and hands it to `png` or `pgm` by its signature; a failure's
// reason gets the path in front.
template <typename Png, typename Pgm>
bool with_gray_file(const char* path, Png png, Pgm pgm) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return fail(std::string(path) + ": cannot open");
  uint8_t sig[8];
  size_t n = fread(sig, 1, 8, fp);
  rewind(fp);
  bool ok = false;
  if (n >= 8 && !std::memcmp(sig, kPngSignature, 8)) {
    ok = png(fp);
  } else if (n >= 2 && sig[0] == 'P' && sig[1] == '5') {
    ok = pgm(fp);
  } else {
    fail("neither a PNG nor a binary PGM file");
  }
  fclose(fp);
  if (!ok) g_error = std::string(path) + ": " + g_error;
  return ok;
}

bool read_gray(const char* path, GrayImage* out) {
  return with_gray_file(
      path, [&](FILE* fp) { return decode_png_gray(fp, out); },
      [&](FILE* fp) { return decode_pgm_gray(fp, out); });
}

// The image's size from its header alone.
bool probe_gray(const char* path, int* h, int* w) {
  return with_gray_file(
      path, [&](FILE* fp) { return probe_png_gray(fp, h, w); },
      [&](FILE* fp) {
        long pw = 0, ph = 0;
        if (!read_pgm_header(fp, &pw, &ph)) return false;
        *h = static_cast<int>(ph);
        *w = static_cast<int>(pw);
        return true;
      });
}

}  // namespace

SIO_API int sio_version() { return 1; }

// Why the last failed decode on the calling thread failed (a prefetcher's
// failed frame counts as the consumer's).
SIO_API const char* sio_last_error() { return g_error.c_str(); }

// Image dimensions from the header alone: the image data is neither read
// nor checked. -1: unreadable, or a kind the decoder refuses.
SIO_API int sio_probe_image(const char* path, int* h, int* w) {
  return probe_gray(path, h, w) ? 0 : -1;
}

// Decode into caller buffer of capacity max_h*max_w. Returns 0, or -1 on
// decode failure, -2 if the image exceeds the buffer.
SIO_API int sio_read_image_gray(const char* path, uint8_t* out, int* h,
                                int* w, int max_h, int max_w) {
  GrayImage img;
  if (!read_gray(path, &img)) return -1;
  if (img.h > max_h || img.w > max_w) return -2;
  std::memcpy(out, img.pix.data(), img.pix.size());
  *h = img.h;
  *w = img.w;
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetching stereo-frame loader
// ---------------------------------------------------------------------------
//
// N worker threads decode stereo pairs out of order into a bounded ring of
// `depth` slots; the consumer receives frames strictly in sequence order.
// A worker may only fill slot (frame % depth) once the consumer has drained
// frame-depth from it, enforced with per-ring condition variables.

namespace {

struct Slot {
  std::vector<uint8_t> left, right;
  int status = 0;  // 0 empty, 1 ready, -1 decode error
  std::string error;
};

struct Prefetcher {
  std::string left_dir, right_dir, ext;
  int start = 0, count = 0, h = 0, w = 0, depth = 0;
  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_free;    // workers wait for slot drained
  std::atomic<int> next_to_fetch{0};  // next frame index a worker claims
  int next_to_consume = 0;            // guarded by mu
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  std::string frame_path(const std::string& dir, int idx) const {
    char name[32];
    std::snprintf(name, sizeof(name), "%06d", start + idx);
    return dir + "/" + name + ext;
  }

  void worker() {
    GrayImage li, ri;
    for (;;) {
      int idx = next_to_fetch.fetch_add(1);
      if (idx >= count || stop.load()) return;
      bool ok = read_gray(frame_path(left_dir, idx).c_str(), &li) &&
                read_gray(frame_path(right_dir, idx).c_str(), &ri);
      if (ok && !(li.h == h && li.w == w && ri.h == h && ri.w == w)) {
        ok = fail("frame " + std::to_string(start + idx) + " is not " +
                  std::to_string(h) + "x" + std::to_string(w));
      }
      Slot& s = slots[idx % depth];
      std::unique_lock<std::mutex> lk(mu);
      // wait until the consumer has moved past frame idx-depth
      cv_free.wait(lk, [&] { return stop.load() || next_to_consume > idx - depth; });
      if (stop.load()) return;
      if (ok) {
        s.left.swap(li.pix);
        s.right.swap(ri.pix);
      } else {
        s.error = g_error;
      }
      s.status = ok ? 1 : -1;
      cv_ready.notify_all();
    }
  }
};

}  // namespace

SIO_API void* sio_prefetch_open(const char* left_dir, const char* right_dir,
                                const char* ext, int start, int count, int h,
                                int w, int depth, int n_workers) {
  if (count <= 0 || h <= 0 || w <= 0) return nullptr;
  auto* p = new Prefetcher();
  p->left_dir = left_dir;
  p->right_dir = right_dir;
  p->ext = ext && ext[0] ? ext : ".png";
  p->start = start;
  p->count = count;
  p->h = h;
  p->w = w;
  p->depth = depth > 0 ? depth : 8;
  p->slots.resize(p->depth);
  int nw = n_workers > 0 ? n_workers : 4;
  if (nw > p->depth) nw = p->depth;
  for (int i = 0; i < nw; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Copy the next in-order stereo pair into caller buffers (h*w each).
// Returns the frame index (relative to start), -1 at end of sequence, -2 on
// decode error for that frame.
SIO_API int sio_prefetch_next(void* handle, uint8_t* left, uint8_t* right) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (!p || p->next_to_consume >= p->count) return -1;
  int idx;
  Slot* s;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    idx = p->next_to_consume;
    s = &p->slots[idx % p->depth];
    p->cv_ready.wait(lk, [&] { return s->status != 0; });
    int st = s->status;
    if (st == 1) {
      std::memcpy(left, s->left.data(), s->left.size());
      std::memcpy(right, s->right.data(), s->right.size());
    }
    s->status = 0;
    p->next_to_consume = idx + 1;
    p->cv_free.notify_all();
    if (st != 1) {
      g_error = s->error;
      return -2;
    }
  }
  return idx;
}

SIO_API void sio_prefetch_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
  }
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Trajectory writer (KITTI rows, reference format of map.cpp:188-195)
// ---------------------------------------------------------------------------

namespace {
struct TrajWriter {
  FILE* fp = nullptr;
};
}  // namespace

SIO_API void* sio_traj_open(const char* path, int append) {
  FILE* fp = fopen(path, append ? "ab" : "wb");
  if (!fp) return nullptr;
  auto* t = new TrajWriter();
  t->fp = fp;
  return t;
}

// T_c_w: 16 doubles row-major (world->camera). Writes the row for
// T_w_c = T_c_w^-1 with 9 significant digits (matches the Python writer).
SIO_API int sio_traj_write(void* handle, long frame_id, const double* T_c_w) {
  auto* t = static_cast<TrajWriter*>(handle);
  if (!t || !t->fp) return -1;
  // closed-form inverse of a rigid transform: R' = R^T, t' = -R^T t
  double R[3][3], tr[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = T_c_w[4 * j + i];  // transpose
  for (int i = 0; i < 3; ++i)
    tr[i] = -(R[i][0] * T_c_w[3] + R[i][1] * T_c_w[7] + R[i][2] * T_c_w[11]);
  char buf[512];
  int n = std::snprintf(
      buf, sizeof(buf),
      "%ld %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g %.9g\n",
      frame_id, R[0][0], R[0][1], R[0][2], tr[0], R[1][0], R[1][1], R[1][2],
      tr[1], R[2][0], R[2][1], R[2][2], tr[2]);
  if (n <= 0 || fwrite(buf, 1, n, t->fp) != static_cast<size_t>(n)) return -1;
  return 0;
}

SIO_API int sio_traj_flush(void* handle) {
  auto* t = static_cast<TrajWriter*>(handle);
  return (t && t->fp && fflush(t->fp) == 0) ? 0 : -1;
}

SIO_API void sio_traj_close(void* handle) {
  auto* t = static_cast<TrajWriter*>(handle);
  if (!t) return;
  if (t->fp) fclose(t->fp);
  delete t;
}
