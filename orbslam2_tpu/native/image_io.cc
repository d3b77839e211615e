// Native dataset IO: PNG/PGM decoding + threaded prefetching.
//
// The reference's runtime is all C++ (SURVEY.md §2); in this build the
// compute path is JAX/XLA, and this library is the native runtime piece
// around it: it decodes dataset images (TUM/KITTI/EuRoC PNGs, PGM/PPM)
// off the Python thread and prefetches frames ahead of the SLAM loop so
// host IO overlaps device compute. Exposed as a C API consumed via ctypes
// (no pybind11 in the image).
//
// PNG support: 8-bit grayscale, 8-bit RGB/RGBA (converted to grayscale),
// 16-bit grayscale (TUM depth maps), non-interlaced, via zlib inflate +
// the five standard scanline filters.

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;   // 1 or 3
  int bit_depth = 8;  // 8 or 16
  std::vector<float> data;  // grayscale float32, 16-bit kept as raw counts
  bool ok = false;
  std::string error;
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == size_t(n);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const std::vector<uint8_t>& buf) {
  Image img;
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), kSig, 8) != 0) {
    img.error = "not a png";
    return img;
  }
  size_t pos = 8;
  int color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) break;
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      img.width = be32(data);
      img.height = be32(data + 4);
      img.bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (img.width <= 0 || img.height <= 0) {
    img.error = "bad header";
    return img;
  }
  if (interlace != 0) {
    img.error = "interlaced png unsupported";
    return img;
  }
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default:
      img.error = "palette png unsupported";
      return img;
  }
  if (img.bit_depth != 8 && img.bit_depth != 16) {
    img.error = "bit depth unsupported";
    return img;
  }
  const int bytes_per_sample = img.bit_depth / 8;
  const size_t stride = size_t(img.width) * ch * bytes_per_sample;
  std::vector<uint8_t> raw(img.height * (stride + 1));
  {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit(&zs) != Z_OK) {
      img.error = "zlib init failed";
      return img;
    }
    zs.next_in = idat.data();
    zs.avail_in = idat.size();
    zs.next_out = raw.data();
    zs.avail_out = raw.size();
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END && rc != Z_OK) {
      img.error = "zlib inflate failed";
      return img;
    }
  }
  // unfilter scanlines
  const int bpp = ch * bytes_per_sample;
  std::vector<uint8_t> pix(img.height * stride);
  for (int y = 0; y < img.height; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* in = src + 1;
    uint8_t* out = &pix[y * stride];
    const uint8_t* prev = y > 0 ? &pix[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? out[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
      int v = in[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default:
          img.error = "bad filter";
          return img;
      }
      out[x] = uint8_t(v);
    }
  }
  // to grayscale float32
  img.data.resize(size_t(img.width) * img.height);
  const size_t npix = img.data.size();
  if (img.bit_depth == 8) {
    for (size_t i = 0; i < npix; ++i) {
      const uint8_t* p = &pix[i * bpp];
      float v;
      if (ch >= 3)
        v = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      else
        v = float(p[0]);
      img.data[i] = v;
    }
    img.channels = 1;
  } else {  // 16-bit big-endian (TUM depth): keep raw counts
    for (size_t i = 0; i < npix; ++i) {
      const uint8_t* p = &pix[i * bpp];
      img.data[i] = float((uint32_t(p[0]) << 8) | p[1]);
    }
    img.channels = 1;
  }
  img.ok = true;
  return img;
}

Image decode_pnm(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 2 || buf[0] != 'P') {
    img.error = "not pnm";
    return img;
  }
  int kind = buf[1] - '0';  // 5 = PGM, 6 = PPM
  if (kind != 5 && kind != 6) {
    img.error = "pnm kind unsupported";
    return img;
  }
  size_t pos = 2;
  auto next_int = [&](int* out) {
    while (pos < buf.size()) {
      if (isspace(buf[pos])) {
        ++pos;
      } else if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      } else {
        break;
      }
    }
    int v = 0;
    bool any = false;
    while (pos < buf.size() && isdigit(buf[pos])) {
      v = v * 10 + (buf[pos] - '0');
      ++pos;
      any = true;
    }
    *out = v;
    return any;
  };
  int maxval;
  if (!next_int(&img.width) || !next_int(&img.height) || !next_int(&maxval)) {
    img.error = "bad pnm header";
    return img;
  }
  ++pos;  // single whitespace after maxval
  int ch = kind == 5 ? 1 : 3;
  size_t need = size_t(img.width) * img.height * ch;
  if (buf.size() < pos + need) {
    img.error = "truncated pnm";
    return img;
  }
  img.data.resize(size_t(img.width) * img.height);
  for (size_t i = 0; i < img.data.size(); ++i) {
    const uint8_t* p = &buf[pos + i * ch];
    img.data[i] = ch == 3 ? 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2]
                          : float(p[0]);
  }
  img.channels = 1;
  img.ok = true;
  return img;
}

Image decode_path(const std::string& path) {
  std::vector<uint8_t> buf;
  if (!read_file(path.c_str(), &buf)) {
    Image img;
    img.error = "cannot read file";
    return img;
  }
  if (buf.size() >= 8 && buf[0] == 137 && buf[1] == 'P') return decode_png(buf);
  if (buf.size() >= 2 && buf[0] == 'P') return decode_pnm(buf);
  Image img;
  img.error = "unknown format";
  return img;
}

// ---------------------------------------------------------------------------
// prefetcher: worker threads decode a fixed file list ahead of consumption
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::deque<std::pair<int, Image>> ready;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  size_t max_ahead = 8;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= int(paths.size())) return;
      Image img = decode_path(paths[idx]);
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] {
        return stop.load() || idx < next_to_consume + int(max_ahead);
      });
      if (stop.load()) return;
      ready.emplace_back(idx, std::move(img));
      cv_ready.notify_all();
    }
  }

  bool get(int idx, Image* out) {
    std::unique_lock<std::mutex> lk(mu);
    // Advance the consume cursor on request, not on delivery: a consumer
    // skipping ahead (idx > cursor + max_ahead) would otherwise deadlock —
    // workers gate on `decode_idx < cursor + max_ahead` while the consumer
    // waits for an image those workers will never be allowed to decode.
    if (idx + 1 > next_to_consume) {
      next_to_consume = idx + 1;
      cv_ready.notify_all();
    }
    for (;;) {
      for (auto it = ready.begin(); it != ready.end();) {
        if (it->first == idx) {
          *out = std::move(it->second);
          ready.erase(it);
          cv_ready.notify_all();
          return true;
        } else if (it->first < idx) {
          it = ready.erase(it);  // consumer moved past: drop stale frames
        } else {
          ++it;
        }
      }
      if (stop.load()) return false;
      cv_ready.wait(lk);
    }
  }
};

}  // namespace

extern "C" {

// ---- single-image API -----------------------------------------------------

// Decode `path`; on success fills *width/*height and returns a malloc'd
// float32 grayscale buffer the caller must free via orbio_free. Returns
// nullptr on failure.
float* orbio_decode(const char* path, int* width, int* height) {
  Image img = decode_path(path);
  if (!img.ok) return nullptr;
  float* out = static_cast<float*>(malloc(img.data.size() * sizeof(float)));
  memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  *width = img.width;
  *height = img.height;
  return out;
}

void orbio_free(float* p) { free(p); }

// ---- prefetcher API -------------------------------------------------------

void* orbio_prefetcher_create(const char** paths, int n_paths, int n_threads,
                              int max_ahead) {
  auto* pf = new Prefetcher();
  pf->paths.assign(paths, paths + n_paths);
  pf->max_ahead = max_ahead > 0 ? max_ahead : 8;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) pf->workers.emplace_back(&Prefetcher::worker, pf);
  return pf;
}

// Blocks until image `idx` is decoded; returns a malloc'd float32 buffer
// (caller frees) or nullptr.
float* orbio_prefetcher_get(void* handle, int idx, int* width, int* height) {
  auto* pf = static_cast<Prefetcher*>(handle);
  Image img;
  if (!pf->get(idx, &img) || !img.ok) return nullptr;
  float* out = static_cast<float*>(malloc(img.data.size() * sizeof(float)));
  memcpy(out, img.data.data(), img.data.size() * sizeof(float));
  *width = img.width;
  *height = img.height;
  return out;
}

void orbio_prefetcher_destroy(void* handle) {
  auto* pf = static_cast<Prefetcher*>(handle);
  pf->stop.store(true);
  pf->cv_ready.notify_all();
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
