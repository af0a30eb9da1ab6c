// slamio — native host runtime of the PyTorch port
// (stereo_visual_slam_tpu_torch/utils/native.py binds it with ctypes).
//
// The port's copy of native/src/slamio.cpp. It differs in one part: PNG
// decode is the port's own (zlib's inflate, then the five row filters), so
// the library needs zlib only and builds where libpng is not installed.
// It decodes 8- and 16-bit grayscale, non-interlaced PNGs (the KITTI
// odometry sequences' format) and refuses every other colour type, bit depth
// or interlace with a reason that sio_last_error() returns. Everything else
// is the original's:
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

// An IHDR chunk's `len` bytes at `data`: the size and bit depth of a kind
// the decoder reads, or false with the reason it refuses the image.
bool parse_ihdr(uint32_t len, const uint8_t* data, uint32_t* w, uint32_t* h, int* depth) {
  if (len != 13) return fail("bad PNG header");
  *w = be32(data);
  *h = be32(data + 4);
  *depth = data[8];
  int color = data[9];
  if (*w == 0 || *h == 0 || *w > kPngMaxSide || *h > kPngMaxSide)
    return fail("bad PNG size " + std::to_string(*w) + "x" + std::to_string(*h));
  if (color != 0)
    return fail("unsupported PNG colour type " + std::to_string(color) + " (" +
                png_color_name(color) + "): only grayscale decodes");
  if (*depth != 8 && *depth != 16)
    return fail("unsupported PNG bit depth " + std::to_string(*depth) +
                ": only 8- and 16-bit grayscale decode");
  if (data[10] != 0 || data[11] != 0) return fail("bad PNG compression or filter method");
  if (data[12] != 0) return fail("unsupported interlaced PNG");
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

// 8- or 16-bit grayscale, non-interlaced PNG -> 8-bit gray. The critical
// chunks' CRCs are checked and ancillary chunks skipped, as libpng does by
// default; a 16-bit sample keeps its high byte (libpng's png_set_strip_16).
bool decode_png_gray(FILE* fp, GrayImage* out) {
  size_t size = 0;
  if (!file_size(fp, &size)) return false;
  std::vector<uint8_t> file(size);
  if (std::fread(file.data(), 1, file.size(), fp) != file.size()) return fail("short read");
  if (file.size() < 8 || std::memcmp(file.data(), kPngSignature, 8) != 0)
    return fail("not a PNG file");

  uint32_t w = 0, h = 0;
  int depth = 0;
  bool have_header = false, have_end = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (!have_end) {
    if (file.size() - pos < 12) return fail("truncated PNG");
    uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return fail("truncated PNG chunk");
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = type + 4;
    bool critical = !(type[0] & 0x20);
    if (critical && crc32(0L, type, len + 4) != be32(data + len))
      return fail("CRC error in PNG chunk " + std::string(reinterpret_cast<const char*>(type), 4));
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (have_header) return fail("bad PNG header");
      if (!parse_ihdr(len, data, &w, &h, &depth)) return false;
      have_header = true;
    } else if (!have_header) {
      return fail("PNG without a header");
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      have_end = true;
    } else if (critical && std::memcmp(type, "PLTE", 4) != 0) {
      return fail("unknown critical PNG chunk " + std::string(reinterpret_cast<const char*>(type), 4));
    }
    pos += size_t(len) + 12;
  }

  // one filter byte, then the row's samples (big-endian at 16 bits)
  const size_t bpp = depth / 8;
  const size_t stride = size_t(w) * bpp;
  if ((stride + 1) * h > kPngMaxBytes) return fail("PNG image too large");
  std::vector<uint8_t> raw((stride + 1) * h);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return fail("zlib inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  int rc = inflate(&zs, Z_FINISH);
  bool complete = rc == Z_STREAM_END && zs.avail_out == 0;
  inflateEnd(&zs);
  if (!complete) return fail("corrupt or short PNG image data");

  out->h = static_cast<int>(h);
  out->w = static_cast<int>(w);
  out->pix.resize(static_cast<size_t>(h) * w);
  const std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* cur = &raw[y * (stride + 1)];
    const int filter = *cur++;
    switch (filter) {
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
        return fail("bad PNG row filter " + std::to_string(filter));
    }
    uint8_t* dst = &out->pix[static_cast<size_t>(y) * w];
    if (bpp == 1) {
      std::memcpy(dst, cur, w);
    } else {
      for (uint32_t x = 0; x < w; ++x) dst[x] = cur[2 * x];
    }
    prev = cur;
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
    return fail("CRC error in PNG chunk " + std::string(reinterpret_cast<const char*>(type), 4));
  if (std::memcmp(type, "IHDR", 4) != 0) return fail("PNG without a header");
  uint32_t pw = 0, ph = 0;
  int depth = 0;
  if (!parse_ihdr(len, data, &pw, &ph, &depth)) return false;
  *h = static_cast<int>(ph);
  *w = static_cast<int>(pw);
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
