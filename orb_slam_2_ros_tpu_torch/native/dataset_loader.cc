// Native dataset loading: image decode and a threaded prefetcher.
//
// The port's own copy of orb_slam_2_ros_tpu/native/dataset_loader.cc, with
// two changes.
//
// 1. PNG is decoded here, with zlib for the inflate, not with libpng: the
//    PNG container (chunks, CRCs), the five scanline filters, Adam7
//    interlacing and the pixel formats are handled in this file, and the
//    result is what the reference's libpng set-up gives (palette expanded
//    to RGB, gray below 8 bits scaled to 8, alpha and tRNS dropped, 16-bit
//    samples big-endian in the file). A host that has zlib but no libpng
//    headers can build it.
// 2. The prefetcher's delivery cursor is raised under the mutex, after the
//    slot has been consumed; the reference raises it before taking the
//    mutex (its dataset_loader.cc:360-361).
//
// The reference's data path is C++ end to end: ROS image transport decodes
// frames and cv_bridge/cvtColor give the 8-bit gray image the tracker
// consumes (ros/src/MonoNode.cc:38-53, Tracking.cc:173-276); depth arrives
// as 16-bit images scaled by depth_map_factor (Tracking.cc:151-157). This
// module decodes PNG and binary PGM/PPM files straight into the wire format
// the tracker takes (u8 gray; u16 millimetre depth or a u8 right image),
// and worker threads prefetch upcoming frames into a ring of reusable slots
// so that decoding overlaps the device. Gray conversion uses OpenCV's
// fixed-point BT.601 weights, bit-exact with cv::cvtColor.
//
// Bound with ctypes (native/__init__.py).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// OpenCV's RGB->gray fixed-point coefficients (BT.601, 15-bit):
// gray = (9798*R + 19235*G + 3735*B + 16384) >> 15, bit-exact with
// cv::cvtColor(RGB2GRAY) (Tracking.cc:173-276).
inline uint8_t rgb2gray(unsigned r, unsigned g, unsigned b) {
  return static_cast<uint8_t>((9798u * r + 19235u * g + 3735u * b + 16384u)
                              >> 15);
}

struct Image {
  int w = 0, h = 0;
  int channels = 0;   // 1 or 3
  int bit_depth = 0;  // 8 or 16
  std::vector<uint16_t> px;  // row-major, channel-interleaved
};

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  buf->resize(static_cast<size_t>(n));
  const size_t got = n ? std::fread(buf->data(), 1, buf->size(), f) : 0;
  std::fclose(f);
  return got == buf->size();
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Samples per pixel of each PNG colour type (0 gray, 2 RGB, 3 palette,
// 4 gray + alpha, 6 RGBA); 0 for an invalid type.
int png_samples(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool png_depth_ok(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the scanline filters of `rows` rows, each a filter byte followed by
// `rowbytes` bytes, in place. bpp: bytes per complete pixel (at least 1).
bool unfilter(uint8_t* data, size_t rows, size_t rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* row = data + y * (rowbytes + 1);
    const int ft = row[0];
    uint8_t* cur = row + 1;
    for (size_t i = 0; i < rowbytes; ++i) {
      const int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= (size_t)bpp) ? prev[i - bpp] : 0;
      int v;
      switch (ft) {
        case 0: v = 0; break;
        case 1: v = a; break;
        case 2: v = b; break;
        case 3: v = (a + b) >> 1; break;
        case 4: v = paeth(a, b, c); break;
        default: return false;
      }
      cur[i] = static_cast<uint8_t>(cur[i] + v);
    }
    prev = cur;
  }
  return true;
}

// The i-th sample of an unfiltered row at bit depth `depth` (16-bit
// samples are big-endian in the file).
inline unsigned sample(const uint8_t* row, size_t i, int depth) {
  switch (depth) {
    case 16: return (unsigned(row[2 * i]) << 8) | row[2 * i + 1];
    case 8: return row[i];
    default: {
      const size_t bit = i * depth;
      const int shift = 8 - depth - int(bit & 7);
      return (row[bit >> 3] >> shift) & ((1u << depth) - 1);
    }
  }
}

bool decode_png(const char* path, Image* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::vector<uint8_t> f;
  if (!read_file(path, &f) || f.size() < 8 || std::memcmp(f.data(), kSig, 8))
    return false;
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  bool have_ihdr = false;
  std::vector<uint8_t> plte, idat;
  size_t pos = 8;
  while (pos + 12 <= f.size()) {
    const uint32_t len = be32(&f[pos]);
    if (len > f.size() - pos - 12) return false;
    const uint8_t* type = &f[pos + 4];
    const uint8_t* data = &f[pos + 8];
    const uint32_t crc = be32(&f[pos + 8 + len]);
    if (crc32(crc32(0L, Z_NULL, 0), type, len + 4) != crc) return false;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) return false;
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
      if (data[10] != 0 || data[11] != 0 || interlace > 1) return false;
      have_ihdr = true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      plte.assign(data, data + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!have_ihdr || w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24) ||
      !png_depth_ok(color, depth) || (color == 3 && plte.empty()))
    return false;
  const int spp = png_samples(color);
  const int bpp = std::max(1, spp * depth / 8);

  // Adam7 passes (x0, y0, dx, dy); a plain image is one pass
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int kPlain[1][4] = {{0, 0, 1, 1}};
  const int n_pass = interlace ? 7 : 1;
  const int (*passes)[4] = interlace ? kAdam7 : kPlain;
  // pixels of a pass along one axis: ceil((n - start) / step), 0 if none
  auto pass_len = [](long n, int start, int step) -> size_t {
    return n > start ? static_cast<size_t>((n - start + step - 1) / step) : 0;
  };
  size_t total = 0;
  for (int p = 0; p < n_pass; ++p) {
    const size_t pw = pass_len(w, passes[p][0], passes[p][2]);
    const size_t ph = pass_len(h, passes[p][1], passes[p][3]);
    if (pw && ph) total += ph * (1 + (pw * spp * depth + 7) / 8);
  }
  std::vector<uint8_t> raw(total);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  int zr = Z_OK;
  while (zs.avail_out > 0 && zr == Z_OK) zr = inflate(&zs, Z_NO_FLUSH);
  inflateEnd(&zs);
  if (zs.avail_out != 0) return false;

  out->w = static_cast<int>(w);
  out->h = static_cast<int>(h);
  out->channels = (color == 0 || color == 4) ? 1 : 3;
  out->bit_depth = depth == 16 ? 16 : 8;
  out->px.assign(static_cast<size_t>(w) * h * out->channels, 0);
  const unsigned gray_scale = depth == 1 ? 255 : depth == 2 ? 85
                              : depth == 4 ? 17 : 1;
  uint8_t* pass_data = raw.data();
  for (int p = 0; p < n_pass; ++p) {
    const int x0 = passes[p][0], y0 = passes[p][1];
    const int dx = passes[p][2], dy = passes[p][3];
    const size_t pw = pass_len(w, x0, dx);
    const size_t ph = pass_len(h, y0, dy);
    if (!pw || !ph) continue;
    const size_t rowbytes = (pw * spp * depth + 7) / 8;
    if (!unfilter(pass_data, ph, rowbytes, bpp)) return false;
    for (size_t py = 0; py < ph; ++py) {
      const uint8_t* row = pass_data + py * (rowbytes + 1) + 1;
      const size_t y = y0 + py * dy;
      for (size_t px = 0; px < pw; ++px) {
        const size_t x = x0 + px * dx;
        uint16_t* o = &out->px[(y * w + x) * out->channels];
        if (color == 3) {
          // an index past the palette reads as black, as libpng's
          // 256-entry palette does
          const unsigned k = sample(row, px, depth);
          for (int c = 0; c < 3; ++c)
            o[c] = 3 * k + c < plte.size() ? plte[3 * k + c] : 0;
        } else if (out->channels == 1) {
          o[0] = static_cast<uint16_t>(sample(row, px * spp, depth) *
                                       gray_scale);
        } else {
          for (int c = 0; c < 3; ++c)
            o[c] = static_cast<uint16_t>(sample(row, px * spp + c, depth));
        }
      }
    }
    pass_data += ph * (rowbytes + 1);
  }
  return true;
}

// Binary PGM (P5) / PPM (P6), 8- or 16-bit (big-endian 16).
bool decode_pnm(const char* path, Image* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  auto token = [&]() -> long {
    int c;
    do {
      c = std::fgetc(f);
      if (c == '#') {  // comment to end of line
        while (c != '\n' && c != EOF) c = std::fgetc(f);
      }
    } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
    long v = 0;
    bool any = false;
    while (c >= '0' && c <= '9') {
      v = v * 10 + (c - '0');
      any = true;
      c = std::fgetc(f);
    }
    return any ? v : -1;
  };
  int m0 = std::fgetc(f), m1 = std::fgetc(f);
  if (m0 != 'P' || (m1 != '5' && m1 != '6')) {
    std::fclose(f);
    return false;
  }
  const int ch = (m1 == '6') ? 3 : 1;
  long w = token(), h = token(), maxval = token();
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 65535) {
    std::fclose(f);
    return false;
  }
  const int depth = maxval > 255 ? 16 : 8;
  const size_t n = static_cast<size_t>(w) * h * ch;
  out->w = (int)w;
  out->h = (int)h;
  out->channels = ch;
  out->bit_depth = depth;
  out->px.resize(n);
  if (depth == 8) {
    std::vector<uint8_t> buf(n);
    if (std::fread(buf.data(), 1, n, f) != n) {
      std::fclose(f);
      return false;
    }
    for (size_t i = 0; i < n; ++i) out->px[i] = buf[i];
  } else {
    std::vector<uint8_t> buf(n * 2);
    if (std::fread(buf.data(), 1, n * 2, f) != n * 2) {
      std::fclose(f);
      return false;
    }
    for (size_t i = 0; i < n; ++i)
      out->px[i] = static_cast<uint16_t>((buf[2 * i] << 8) | buf[2 * i + 1]);
  }
  std::fclose(f);
  return true;
}

bool decode_any(const char* path, Image* out) {
  const char* dot = std::strrchr(path, '.');
  if (dot && (!std::strcmp(dot, ".pgm") || !std::strcmp(dot, ".ppm") ||
              !std::strcmp(dot, ".pnm")))
    return decode_pnm(path, out);
  return decode_png(path, out);
}

// A decoded image as u8 gray. 16-bit gray is divided by 257 (the exact
// 16->8 mapping for full-range data); 16-bit colour keeps its high byte.
void to_gray8(const Image& im, uint8_t* out) {
  const size_t n = static_cast<size_t>(im.w) * im.h;
  if (im.channels == 1) {
    if (im.bit_depth == 8)
      for (size_t i = 0; i < n; ++i) out[i] = (uint8_t)im.px[i];
    else
      for (size_t i = 0; i < n; ++i) out[i] = (uint8_t)(im.px[i] / 257);
  } else {
    const int shift = im.bit_depth == 16 ? 8 : 0;
    for (size_t i = 0; i < n; ++i)
      out[i] = rgb2gray(im.px[3 * i] >> shift, im.px[3 * i + 1] >> shift,
                        im.px[3 * i + 2] >> shift);
  }
}

// A decoded 16-bit depth image as u16 millimetres:
// mm = raw * 1000 / depth_factor, rounded (TUM factor 5000: mm = raw / 5).
void to_depth_mm(const Image& im, double depth_factor, uint16_t* out) {
  const size_t n = static_cast<size_t>(im.w) * im.h;
  const double s = 1000.0 / depth_factor;
  for (size_t i = 0; i < n; ++i) {
    double mm = im.px[i] * s + 0.5;
    out[i] = mm >= 65535.0 ? 65535 : static_cast<uint16_t>(mm);
  }
}

// ---------------------------------------------------------------- prefetcher

constexpr int kModeMono = 0;    // aux unused
constexpr int kModeRGBD = 1;    // aux = 16-bit depth -> u16 mm
constexpr int kModeStereo = 2;  // aux = right image -> u8 gray

struct Slot {
  std::vector<uint8_t> gray;
  std::vector<uint8_t> aux;  // u8 gray or u16 mm (byte storage)
  int status = 0;            // 0 decoding/free, 1 ready, -1 decode failed
  int index = -1;            // frame index occupying this slot; -1 = free
};

struct Loader {
  std::vector<std::string> paths_a, paths_b;
  int mode = kModeMono;
  int w = 0, h = 0;
  double depth_factor = 5000.0;
  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  int next_fetch = 0;    // next frame index a worker claims (under mu)
  int next_deliver = 0;  // next frame index the consumer takes (under mu)
  bool stop = false;

  size_t gray_bytes() const { return (size_t)w * h; }
  size_t aux_bytes() const {
    return mode == kModeRGBD ? (size_t)w * h * 2
                             : (mode == kModeStereo ? (size_t)w * h : 0);
  }

  void work() {
    const int cap = static_cast<int>(ring.size());
    const int n = static_cast<int>(paths_a.size());
    for (;;) {
      Slot* slot = nullptr;
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop || next_fetch >= n) return;
        idx = next_fetch++;
        Slot& s = ring[idx % cap];
        // Ordered claim: take the ring position only once it is free AND
        // every earlier frame mapping here has been consumed (idx within
        // one ring turn of the delivery cursor), so a worker holding frame
        // idx + cap cannot take the slot frame idx needs.
        cv_free.wait(lk, [&] {
          return stop || (s.index == -1 && idx < next_deliver + cap);
        });
        if (stop) return;
        s.index = idx;
        s.status = 0;
        slot = &s;
      }
      const int ok = decode_into(idx, slot) ? 1 : -1;
      {
        std::lock_guard<std::mutex> lk(mu);
        slot->status = ok;
      }
      cv_ready.notify_all();
    }
  }

  bool decode_into(int idx, Slot* s) {
    Image im;
    if (!decode_any(paths_a[idx].c_str(), &im) || im.w != w || im.h != h)
      return false;
    s->gray.resize(gray_bytes());
    to_gray8(im, s->gray.data());
    if (mode == kModeMono) return true;
    Image aux;
    if (!decode_any(paths_b[idx].c_str(), &aux) || aux.w != w || aux.h != h)
      return false;
    s->aux.resize(aux_bytes());
    if (mode == kModeRGBD) {
      if (aux.channels != 1) return false;
      to_depth_mm(aux, depth_factor,
                  reinterpret_cast<uint16_t*>(s->aux.data()));
    } else {
      to_gray8(aux, s->aux.data());
    }
    return true;
  }
};

}  // namespace

extern "C" {

// One-shot decode to u8 gray. Returns 0 and fills w/h on success (the
// caller passes its capacity as *w * *h); -1 on failure.
int decode_gray8(const char* path, uint8_t* out, int* w, int* h) {
  Image im;
  if (!decode_any(path, &im)) return -1;
  if ((long)im.w * im.h > (long)(*w) * (*h)) return -1;
  to_gray8(im, out);
  *w = im.w;
  *h = im.h;
  return 0;
}

// One-shot decode of a 16-bit depth image to u16 millimetres.
int decode_depth_mm(const char* path, double depth_factor, uint16_t* out,
                    int* w, int* h) {
  Image im;
  if (!decode_any(path, &im) || im.channels != 1) return -1;
  if ((long)im.w * im.h > (long)(*w) * (*h)) return -1;
  to_depth_mm(im, depth_factor, out);
  *w = im.w;
  *h = im.h;
  return 0;
}

// A threaded prefetcher. paths_a/paths_b: '\n'-joined file lists (paths_b
// ignored for mode 0). Returns an opaque handle or null.
void* loader_create(const char* paths_a, const char* paths_b, int mode,
                    int w, int h, double depth_factor, int n_threads,
                    int ring_cap) {
  auto split = [](const char* s) {
    std::vector<std::string> out;
    if (!s) return out;
    const char* p = s;
    while (*p) {
      const char* e = std::strchr(p, '\n');
      if (!e) e = p + std::strlen(p);
      if (e > p) out.emplace_back(p, e - p);
      p = *e ? e + 1 : e;
    }
    return out;
  };
  auto* ld = new Loader;
  ld->paths_a = split(paths_a);
  ld->paths_b = split(paths_b);
  ld->mode = mode;
  ld->w = w;
  ld->h = h;
  ld->depth_factor = depth_factor;
  if (ld->paths_a.empty() ||
      (mode != kModeMono && ld->paths_b.size() != ld->paths_a.size())) {
    delete ld;
    return nullptr;
  }
  if (ring_cap < 2) ring_cap = 2;
  if (n_threads < 1) n_threads = 1;
  ld->ring.resize(ring_cap);
  for (int i = 0; i < n_threads; ++i)
    ld->workers.emplace_back([ld] { ld->work(); });
  return ld;
}

// Blocking ordered fetch of the next frame into the caller's buffers (gray:
// w*h bytes; aux: w*h u16 for RGB-D, w*h u8 for stereo, ignored for mono).
// Returns the frame index, -1 at the end of the stream, -2 on a decode
// failure. The delivery cursor moves under the mutex, once the slot is
// consumed.
int loader_next(void* handle, uint8_t* gray, uint8_t* aux) {
  auto* ld = static_cast<Loader*>(handle);
  int idx, st;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    idx = ld->next_deliver;
    if (idx >= static_cast<int>(ld->paths_a.size())) return -1;
    Slot& s = ld->ring[idx % ld->ring.size()];
    ld->cv_ready.wait(lk, [&] { return s.index == idx && s.status != 0; });
    st = s.status;
    if (st == 1) {
      std::memcpy(gray, s.gray.data(), ld->gray_bytes());
      if (ld->aux_bytes() && aux)
        std::memcpy(aux, s.aux.data(), ld->aux_bytes());
    }
    s.status = 0;  // free the ring position for index idx + ring_cap
    s.index = -1;
    ld->next_deliver = idx + 1;
  }
  ld->cv_free.notify_all();
  return st == 1 ? idx : -2;
}

void loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop = true;
  }
  ld->cv_free.notify_all();
  ld->cv_ready.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
