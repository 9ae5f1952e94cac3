// Native TFRecord reader with background prefetch, the JPEG decode of the
// image pipelines and a JPEG encoder: the port's copy of the JAX package's
// native/record_reader.cc, plus the transforms of its tf.data image path.
//
// A reader thread decodes the TFRecord framing (length + masked crc32c +
// payload + masked crc32c) and checks both CRCs, naming the file on a
// mismatch; a minimal tf.train.Example parser pulls one named Int64List or
// BytesList feature; whole batches reach Python through one copy, so the
// framing, the varint decode and the JPEG work run outside the
// interpreter lock.
//
// Exposed C ABI (consumed by ctypes in data/native_reader.py):
//   rr_open(paths, n_paths, prefetch, shuffle_window, shuffle_seed)
//                                                -> handle
//     shuffle_window > 1 turns on a windowed record-level shuffle
//     (tf.data shuffle-buffer semantics) applied to EVERY consumer of
//     the handle, deterministically from shuffle_seed.
//   rr_skip(h, n)                                -> records skipped, -1 err
//   rr_next_record(h, &buf, &len)                -> 1 ok, 0 EOF, <0 error
//   rr_free(buf)
//   rr_next_batch_i32(h, key, out, batch, width) -> 1 ok, 0 EOF, <0 error
//     short sequences are zero-padded, long ones cut at width.
//   rr_next_rows_i32(h, key, out, lengths, rows, width)
//                                                -> rows filled, 0 EOF, <0
//     like rr_next_batch_i32, but returns a short final chunk and writes
//     each record's value count (width + 1 meaning "more than width"), so
//     the caller can hold records to a fixed length as tf's
//     FixedLenFeature does.
//   rr_next_batch_images(h, ikey, lkey, imgs, labels, batch, th, tw,
//                        threads, crop_seeds, mean, std)
//                                                -> 1 ok, 0 EOF, <0 error
//   rr_next_batch_images_eval(h, ikey, lkey, imgs, labels, batch, th, tw,
//                             threads, central_frac, mean, std)
//                                                -> k filled, 0 EOF, <0 err
//     The JAX native ImageNet path, unchanged: per-image Inception-style
//     distorted crop + flip drawn from crop_seeds (splitmix64 here),
//     decoded via PARTIAL IDCT (DCT scaling + crop/skip scanlines),
//     bilinear-resized with per-channel standardization fused into the
//     output write, multi-threaded across the batch. crop_seeds=null ->
//     full-image resize; mean/std=null -> raw [0,255] pixels.
//   rr_decode_images(recs, lens, n, ikey, lkey, imgs, labels, th, tw,
//                    threads, crop_seeds, central_frac, mean, std)
//                                                -> 0 ok, -(i+1) record i
//     The transforms of the JAX tf.data path on the same sampler: at full
//     scale with tf.io.decode_jpeg's default IDCT (JDCT_IFAST); train
//     (crop_seeds given) decodes only the sampled window, as
//     decode_and_crop_jpeg does, eval decodes the frame and takes
//     tf.image.central_crop's window; then TF's bicubic resize (Keys
//     a = -0.5, half-pixel centres, no antialias), the flip, and
//     (v - mean) / std.
//   rr_decode_window(jpg, n, cx, cy, cw, ch, flip, th, tw, out)
//                                                -> 0 ok, -1 error
//     one JPEG's given window through the train transform, raw pixels.
//   rr_sample_crop(seed, W, H, window[4])        -> flip (0 or 1)
//   rr_encode_jpeg(rgb, w, h, quality, &buf, &len) -> 0 ok, -1 error
//     a baseline JPEG (4:2:0); free buf with rr_free.
//   rr_jpeg_backend()                            -> 1 libjpeg, 2 nvJPEG, 0
//     which codec the build has (see "JPEG codec" below).
//   rr_masked_crc32c(data, n)                    -> the TFRecord checksum
//   rr_error(h)                                  -> message or null
//   rr_close(h)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread record_reader.cc
//        -ljpeg -o librecord_reader.so
//   (nvJPEG: -DRR_NVJPEG -I$CUDA/include ... -lnvjpeg -lcudart; no codec:
//   -DRR_NO_JPEG)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if defined(RR_NVJPEG)
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#elif !defined(RR_NO_JPEG)
#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------- crc32c --
// Castagnoli CRC (the TFRecord checksum), software table version.
uint32_t kCrcTable[256];
std::once_flag kCrcOnce;

void InitCrcTable() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    kCrcTable[i] = c;
  }
}

uint32_t Crc32c(const char* data, size_t n) {
  std::call_once(kCrcOnce, InitCrcTable);
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    c = kCrcTable[(c ^ static_cast<uint8_t>(data[i])) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t MaskedCrc(const char* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// --------------------------------------------------------------- tiny rng --
// splitmix64 — deterministic PRNG shared by the crop sampler and the
// record shuffle; seeds are derived host-side through the core/prng.py
// discipline, the sampling algorithms are fixed here.
struct Rng {
  uint64_t s;
  uint64_t Next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  float Uniform() { return (Next() >> 40) * (1.0f / (1 << 24)); }
};

// ------------------------------------------------------------ ring buffer --
struct Record {
  std::vector<char> bytes;
};

struct Reader {
  std::vector<std::string> paths;
  size_t prefetch;
  std::deque<Record> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::thread worker;
  std::atomic<bool> done{false}, stop{false};
  std::string error;
  // Windowed record-level shuffle (tf.data shuffle-buffer semantics):
  // consumers pop a uniform-random slot out of a W-record window that is
  // refilled from the in-order stream. Deterministic given (file order,
  // seed, W) — the resume fast-skip replays the identical sequence.
  size_t shuffle_window = 0;
  Rng shuffle_rng{0};
  std::vector<Record> shuffle_buf;
  bool shuffle_primed = false;

  ~Reader() {
    {
      // Set stop under the lock: the worker checks the predicate while
      // holding mu inside cv.wait, so an unlocked store+notify can land
      // between its predicate check and its sleep (lost wakeup → join
      // hangs forever).
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    if (worker.joinable()) worker.join();
  }
};

void ReadLoop(Reader* r) {
  for (const auto& path : r->paths) {
    if (r->stop) break;
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) {
      std::lock_guard<std::mutex> lock(r->mu);
      r->error = "open failed: " + path;
      break;
    }
    while (!r->stop) {
      char header[12];
      size_t got = std::fread(header, 1, 12, f);
      if (got == 0) break;  // clean EOF
      if (got != 12) {
        std::lock_guard<std::mutex> lock(r->mu);
        r->error = "truncated header: " + path;
        break;
      }
      uint64_t len;
      std::memcpy(&len, header, 8);
      uint32_t len_crc;
      std::memcpy(&len_crc, header + 8, 4);
      if (MaskedCrc(header, 8) != len_crc) {
        std::lock_guard<std::mutex> lock(r->mu);
        r->error = "length crc mismatch: " + path;
        break;
      }
      Record rec;
      rec.bytes.resize(len);
      if (std::fread(rec.bytes.data(), 1, len, f) != len) {
        std::lock_guard<std::mutex> lock(r->mu);
        r->error = "truncated payload: " + path;
        break;
      }
      char footer[4];
      if (std::fread(footer, 1, 4, f) != 4) {
        std::lock_guard<std::mutex> lock(r->mu);
        r->error = "truncated footer: " + path;
        break;
      }
      uint32_t data_crc;
      std::memcpy(&data_crc, footer, 4);
      if (MaskedCrc(rec.bytes.data(), len) != data_crc) {
        std::lock_guard<std::mutex> lock(r->mu);
        r->error = "payload crc mismatch: " + path;
        break;
      }
      std::unique_lock<std::mutex> lock(r->mu);
      r->cv_push.wait(lock, [r] {
        return r->queue.size() < r->prefetch || r->stop;
      });
      if (r->stop) break;
      r->queue.push_back(std::move(rec));
      r->cv_pop.notify_one();
    }
    std::fclose(f);
    {
      std::lock_guard<std::mutex> lock(r->mu);
      if (!r->error.empty()) break;
    }
  }
  {
    // Set done under the lock, as the destructor sets stop: a consumer in
    // PopRecord checks its predicate holding mu, so an unlocked store +
    // notify can land between that check and its sleep (lost wakeup: the
    // consumer sleeps forever at EOF).
    std::lock_guard<std::mutex> lock(r->mu);
    r->done = true;
  }
  r->cv_pop.notify_all();
}

// ------------------------------------------------- minimal Example parser --
// Parses tf.train.Example just enough to pull one named Int64List feature.
// Wire layout (all protobuf):
//   Example        { features = 1 (msg) }
//   Features       { feature  = 1 (map<string, Feature>) }
//   map entry      { key = 1 (string), value = 2 (Feature msg) }
//   Feature        { int64_list = 3 (msg) }  [bytes_list=1, float_list=2]
//   Int64List      { value = 1 (repeated varint, possibly packed) }

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  // End pointer for a nested length-delimited view, clamped to this
  // view's end — a malformed length prefix (CRC only proves the writer
  // wrote it, not that it is sane) must not create an out-of-bounds
  // cursor.
  const uint8_t* Sub(uint64_t len) const {
    return len > static_cast<uint64_t>(end - p) ? end : p + len;
  }

  uint64_t Varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  void Skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: Varint(); break;
      case 1: p += 8; break;
      case 2: {
        uint64_t n = Varint();
        if (n > static_cast<uint64_t>(end - p)) { ok = false; p = end; }
        else { p += n; }
        break;
      }
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

// Extract int64s for `key` into out (up to width); returns count or -1.
int ParseExampleInt64(const char* data, size_t size, const char* key,
                      int32_t* out, int width) {
  Cursor ex{reinterpret_cast<const uint8_t*>(data),
            reinterpret_cast<const uint8_t*>(data) + size};
  size_t key_len = std::strlen(key);
  while (ex.ok && ex.p < ex.end) {
    uint64_t tag = ex.Varint();
    if (!ex.ok) return -1;
    if ((tag >> 3) != 1 || (tag & 7) != 2) { ex.Skip(tag & 7); continue; }
    uint64_t features_len = ex.Varint();
    Cursor feats{ex.p, ex.Sub(features_len)};
    ex.p += features_len;
    while (feats.ok && feats.p < feats.end) {
      uint64_t ftag = feats.Varint();
      if (!feats.ok) return -1;
      if ((ftag >> 3) != 1 || (ftag & 7) != 2) { feats.Skip(ftag & 7); continue; }
      uint64_t entry_len = feats.Varint();
      Cursor entry{feats.p, feats.Sub(entry_len)};
      feats.p += entry_len;
      bool key_match = false;
      Cursor value{nullptr, nullptr};
      while (entry.ok && entry.p < entry.end) {
        uint64_t etag = entry.Varint();
        if (!entry.ok) return -1;
        if ((etag >> 3) == 1 && (etag & 7) == 2) {
          uint64_t n = entry.Varint();
          // Bound BEFORE memcmp: a truncated entry may claim key bytes
          // that are not there (same malformed-length class Sub guards).
          if (n > static_cast<uint64_t>(entry.end - entry.p)) {
            entry.p = entry.end;
            break;
          }
          key_match = (n == key_len &&
                       std::memcmp(entry.p, key, key_len) == 0);
          entry.p += n;
        } else if ((etag >> 3) == 2 && (etag & 7) == 2) {
          uint64_t n = entry.Varint();
          value = Cursor{entry.p, entry.Sub(n)};
          entry.p += n;
        } else {
          entry.Skip(etag & 7);
        }
      }
      if (!key_match || value.p == nullptr) continue;
      // value: Feature { int64_list = 3 }
      while (value.ok && value.p < value.end) {
        uint64_t vtag = value.Varint();
        if (!value.ok) return -1;
        if ((vtag >> 3) != 3 || (vtag & 7) != 2) { value.Skip(vtag & 7); continue; }
        uint64_t list_len = value.Varint();
        Cursor list{value.p, value.Sub(list_len)};
        value.p += list_len;
        int count = 0;
        while (list.ok && list.p < list.end && count < width) {
          uint64_t ltag = list.Varint();
          if (!list.ok) return -1;
          if ((ltag >> 3) != 1) { list.Skip(ltag & 7); continue; }
          if ((ltag & 7) == 2) {  // packed
            uint64_t n = list.Varint();
            const uint8_t* stop_at = list.Sub(n);
            while (list.ok && list.p < stop_at && count < width)
              out[count++] = static_cast<int32_t>(list.Varint());
          } else {  // single varint
            out[count++] = static_cast<int32_t>(list.Varint());
          }
        }
        return list.ok ? count : -1;
      }
    }
  }
  return 0;  // key not found
}

// Extract the FIRST BytesList value for `key`; returns a view into `data`
// (no copy) — 1 found, 0 missing, -1 malformed.
int ParseExampleBytes(const char* data, size_t size, const char* key,
                      const char** out, uint64_t* out_len) {
  Cursor ex{reinterpret_cast<const uint8_t*>(data),
            reinterpret_cast<const uint8_t*>(data) + size};
  size_t key_len = std::strlen(key);
  while (ex.ok && ex.p < ex.end) {
    uint64_t tag = ex.Varint();
    if (!ex.ok) return -1;
    if ((tag >> 3) != 1 || (tag & 7) != 2) { ex.Skip(tag & 7); continue; }
    uint64_t features_len = ex.Varint();
    Cursor feats{ex.p, ex.Sub(features_len)};
    ex.p += features_len;
    while (feats.ok && feats.p < feats.end) {
      uint64_t ftag = feats.Varint();
      if (!feats.ok) return -1;
      if ((ftag >> 3) != 1 || (ftag & 7) != 2) { feats.Skip(ftag & 7); continue; }
      uint64_t entry_len = feats.Varint();
      Cursor entry{feats.p, feats.Sub(entry_len)};
      feats.p += entry_len;
      bool key_match = false;
      Cursor value{nullptr, nullptr};
      while (entry.ok && entry.p < entry.end) {
        uint64_t etag = entry.Varint();
        if (!entry.ok) return -1;
        if ((etag >> 3) == 1 && (etag & 7) == 2) {
          uint64_t n = entry.Varint();
          // Bound BEFORE memcmp: a truncated entry may claim key bytes
          // that are not there (same malformed-length class Sub guards).
          if (n > static_cast<uint64_t>(entry.end - entry.p)) {
            entry.p = entry.end;
            break;
          }
          key_match = (n == key_len &&
                       std::memcmp(entry.p, key, key_len) == 0);
          entry.p += n;
        } else if ((etag >> 3) == 2 && (etag & 7) == 2) {
          uint64_t n = entry.Varint();
          value = Cursor{entry.p, entry.Sub(n)};
          entry.p += n;
        } else {
          entry.Skip(etag & 7);
        }
      }
      if (!key_match || value.p == nullptr) continue;
      // value: Feature { bytes_list = 1 } ; BytesList { value = 1 (bytes) }
      while (value.ok && value.p < value.end) {
        uint64_t vtag = value.Varint();
        if (!value.ok) return -1;
        if ((vtag >> 3) != 1 || (vtag & 7) != 2) { value.Skip(vtag & 7); continue; }
        uint64_t list_len = value.Varint();
        Cursor list{value.p, value.Sub(list_len)};
        value.p += list_len;
        while (list.ok && list.p < list.end) {
          uint64_t ltag = list.Varint();
          if (!list.ok) return -1;
          if ((ltag >> 3) != 1 || (ltag & 7) != 2) { list.Skip(ltag & 7); continue; }
          uint64_t n = list.Varint();
          // Subtraction form: `list.p + n` could wrap on a near-2^64
          // varint and sail past the check.
          if (n > static_cast<uint64_t>(list.end - list.p)) return -1;
          *out = reinterpret_cast<const char*>(list.p);
          *out_len = n;
          return 1;
        }
      }
    }
  }
  return 0;
}

// Bilinear resize of an (sw,sh) RGB region within a row-stride buffer →
// float32 (tw,th) RGB, values in [0,255]. Half-pixel-center sampling (the
// TF2 tf.image.resize convention), so the native pipeline's geometry
// matches the tf.data pipeline's.
void ResizeBilinear(const uint8_t* src, int sw, int sh, int src_stride,
                    float* dst, int tw, int th,
                    const float* mean = nullptr,
                    const float* inv_std = nullptr) {
  const float x_scale = float(sw) / tw;
  const float y_scale = float(sh) / th;
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * y_scale - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = float(sh - 1);
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * x_scale - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = float(sw - 1);
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float a = src[(y0 * src_stride + x0) * 3 + c];
        float b = src[(y0 * src_stride + x1) * 3 + c];
        float d = src[(y1 * src_stride + x0) * 3 + c];
        float e = src[(y1 * src_stride + x1) * 3 + c];
        float top = a + (b - a) * wx;
        float bot = d + (e - d) * wx;
        float v = top + (bot - top) * wy;
        if (mean != nullptr) v = (v - mean[c]) * inv_std[c];
        dst[(y * tw + x) * 3 + c] = v;
      }
    }
  }
}

// ------------------------------------------------------------ crop sampler --
// Inception-style distorted crop in full-res pixel coords: area fraction
// U[0.08,1], aspect U[3/4,4/3], 10 attempts, central-full fallback.
void SampleCrop(Rng* rng, int W, int H, int* cx, int* cy, int* cw, int* ch) {
  for (int attempt = 0; attempt < 10; ++attempt) {
    float area = (0.08f + 0.92f * rng->Uniform()) * W * H;
    float ar = 0.75f + (4.0f / 3 - 0.75f) * rng->Uniform();
    int w = static_cast<int>(std::sqrt(area * ar) + 0.5f);
    int h = static_cast<int>(std::sqrt(area / ar) + 0.5f);
    if (w < 1) w = 1;
    if (h < 1) h = 1;
    if (w <= W && h <= H) {
      *cx = static_cast<int>(rng->Uniform() * (W - w + 1));
      *cy = static_cast<int>(rng->Uniform() * (H - h + 1));
      if (*cx > W - w) *cx = W - w;
      if (*cy > H - h) *cy = H - h;
      *cw = w;
      *ch = h;
      return;
    }
  }
  *cx = 0; *cy = 0; *cw = W; *ch = H;
}

// ------------------------------------------- the tf.data path's transforms --
// tf.image.resize(method="bicubic") as TF 2 runs it without antialias: the
// ResizeBicubic kernel with half-pixel centres and Keys' cubic (a = -0.5)
// read from a 1024-entry coefficient table; taps outside the image get
// weight 0 and the others are renormalised; rows are interpolated first,
// then columns, in f32, and the result is not clamped.
constexpr int kCubicTable = 1024;

const float* KeysCubicTable() {
  static const std::vector<float> table = [] {
    std::vector<float> t((kCubicTable + 1) * 2);
    const double a = -0.5;
    for (int i = 0; i <= kCubicTable; ++i) {
      float x = i * 1.0 / kCubicTable;
      t[i * 2] = ((a + 2) * x - (a + 3)) * x * x + 1;
      x += 1.0;
      t[i * 2 + 1] = ((a * x - 5 * a) * x + 8 * a) * x - 4 * a;
    }
    return t;
  }();
  return table.data();
}

struct CubicTaps {
  int index[4];
  float weight[4];
};

CubicTaps CubicTapsAt(float scale, int out_loc, int limit) {
  const float in_loc_f = (static_cast<float>(out_loc) + 0.5f) * scale - 0.5f;
  const int64_t in_loc = static_cast<int64_t>(std::floor(in_loc_f));
  const float delta = in_loc_f - in_loc;
  const int64_t offset = lrintf(delta * kCubicTable);
  const float* c = KeysCubicTable();
  const float w[4] = {c[offset * 2 + 1], c[offset * 2],
                      c[(kCubicTable - offset) * 2],
                      c[(kCubicTable - offset) * 2 + 1]};
  CubicTaps t;
  float sum = 0.0f;
  for (int k = 0; k < 4; ++k) {
    int64_t want = in_loc - 1 + k;
    int64_t got = want < 0 ? 0 : (want > limit - 1 ? limit - 1 : want);
    t.index[k] = static_cast<int>(got);
    t.weight[k] = got == want ? w[k] : 0.0f;
    sum += t.weight[k];
  }
  if (std::abs(sum) >= 1000.0f * std::numeric_limits<float>::min()) {
    const float inv = 1.0f / sum;
    for (int k = 0; k < 4; ++k) t.weight[k] *= inv;
  }
  return t;
}

// (sw, sh) RGB region with a row stride of `src_stride` pixels -> f32
// (tw, th) RGB.
void ResizeBicubicTF(const uint8_t* src, int sw, int sh, int src_stride,
                     float* dst, int tw, int th) {
  const float x_scale = static_cast<float>(sw) / tw;
  const float y_scale = static_cast<float>(sh) / th;
  std::vector<CubicTaps> xt(tw);
  for (int x = 0; x < tw; ++x) xt[x] = CubicTapsAt(x_scale, x, sw);
  for (int y = 0; y < th; ++y) {
    const CubicTaps yt = CubicTapsAt(y_scale, y, sh);
    const uint8_t* rows[4];
    for (int k = 0; k < 4; ++k)
      rows[k] = src + static_cast<size_t>(yt.index[k]) * src_stride * 3;
    for (int x = 0; x < tw; ++x) {
      for (int c = 0; c < 3; ++c) {
        float col[4];
        for (int j = 0; j < 4; ++j) {
          const int i = xt[x].index[j] * 3 + c;
          col[j] = static_cast<float>(rows[0][i]) * yt.weight[0] +
                   static_cast<float>(rows[1][i]) * yt.weight[1] +
                   static_cast<float>(rows[2][i]) * yt.weight[2] +
                   static_cast<float>(rows[3][i]) * yt.weight[3];
        }
        dst[(static_cast<size_t>(y) * tw + x) * 3 + c] =
            col[0] * xt[x].weight[0] + col[1] * xt[x].weight[1] +
            col[2] * xt[x].weight[2] + col[3] * xt[x].weight[3];
      }
    }
  }
}

// A window of a decoded frame: rows of `stride` pixels, the window starting
// `offset` bytes in.
struct Window {
  size_t offset = 0;
  int stride = 0, width = 0, height = 0;
};

// ------------------------------------------------------------ JPEG codec --
// Three builds (data/native_reader.py picks one): libjpeg (libjpeg-turbo,
// the JAX package's decoder; the default wherever jpeglib.h is found),
// nvJPEG from the CUDA toolkit (-DRR_NVJPEG, where libjpeg is absent), or
// none (-DRR_NO_JPEG: the record functions work, the image ones fail and
// rr_jpeg_backend() says why). Each provides DecodeJpeg, DecodeJpegWindow,
// DecodeJpegTF and EncodeJpeg.
#if defined(RR_NVJPEG)
constexpr int kJpegBackend = 2;

// One decoder context per concurrent worker: an nvJPEG state, a stream,
// and device and host buffers grown as frames need them. Contexts are
// taken from a pool and given back, and live as long as the process; the
// handle is shared (nvJPEG allows that across threads). The frames are
// decoded on the calling thread's current device (device 0 for the worker
// threads of this library).
struct NvContext {
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t dev_bytes = 0;
};

struct NvJpeg {
  std::mutex mu;
  nvjpegHandle_t handle = nullptr;
  bool failed = false;
  std::vector<NvContext*> idle;
};

NvJpeg& Nv() {
  static NvJpeg nv;
  return nv;
}

NvContext* AcquireNv() {
  NvJpeg& nv = Nv();
  std::lock_guard<std::mutex> lock(nv.mu);
  if (nv.failed) return nullptr;
  if (nv.handle == nullptr &&
      nvjpegCreateSimple(&nv.handle) != NVJPEG_STATUS_SUCCESS) {
    nv.failed = true;
    return nullptr;
  }
  if (!nv.idle.empty()) {
    NvContext* ctx = nv.idle.back();
    nv.idle.pop_back();
    return ctx;
  }
  auto* ctx = new NvContext();
  if (cudaStreamCreateWithFlags(&ctx->stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      nvjpegJpegStateCreate(nv.handle, &ctx->state) != NVJPEG_STATUS_SUCCESS) {
    delete ctx;
    return nullptr;
  }
  return ctx;
}

void ReleaseNv(NvContext* ctx) {
  NvJpeg& nv = Nv();
  std::lock_guard<std::mutex> lock(nv.mu);
  nv.idle.push_back(ctx);
}

// Holds a context for one decode or encode.
struct NvLease {
  NvContext* ctx = AcquireNv();
  ~NvLease() {
    if (ctx != nullptr) ReleaseNv(ctx);
  }
};

bool NvReserve(NvContext* ctx, size_t bytes) {
  if (ctx->dev_bytes >= bytes) return true;
  if (ctx->dev != nullptr) cudaFree(ctx->dev);
  ctx->dev = nullptr;
  ctx->dev_bytes = 0;
  if (cudaMalloc(reinterpret_cast<void**>(&ctx->dev), bytes) != cudaSuccess)
    return false;
  ctx->dev_bytes = bytes;
  return true;
}

// The frame's (W, H) from its header.
bool NvFrameSize(const char* data, size_t n, int* W, int* H) {
  NvJpeg& nv = Nv();
  {
    NvLease lease;  // creates the shared handle on first use
    if (lease.ctx == nullptr) return false;
  }
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(nv.handle, reinterpret_cast<const unsigned char*>(
                                        data),
                         n, &components, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return false;
  *W = widths[0];
  *H = heights[0];
  return *W > 0 && *H > 0;
}

// The whole frame as 8-bit interleaved RGB in host memory.
bool NvDecodeFrame(const char* data, size_t n, std::vector<uint8_t>* rgb,
                   int* W, int* H) {
  if (!NvFrameSize(data, n, W, H)) return false;
  NvLease lease;
  NvContext* ctx = lease.ctx;
  const size_t bytes = static_cast<size_t>(*W) * *H * 3;
  if (ctx == nullptr || !NvReserve(ctx, bytes)) return false;
  nvjpegImage_t out{};
  out.channel[0] = ctx->dev;
  out.pitch[0] = static_cast<size_t>(*W) * 3;
  if (nvjpegDecode(Nv().handle, ctx->state,
                   reinterpret_cast<const unsigned char*>(data), n,
                   NVJPEG_OUTPUT_RGBI, &out, ctx->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return false;
  rgb->resize(bytes);
  return cudaMemcpyAsync(rgb->data(), ctx->dev, bytes, cudaMemcpyDeviceToHost,
                         ctx->stream) == cudaSuccess &&
         cudaStreamSynchronize(ctx->stream) == cudaSuccess;
}

// libjpeg's DCT scaling by 1/denom has no nvJPEG counterpart: the frame is
// decoded whole and averaged over denom x denom blocks (the edge blocks
// over the pixels they hold) into libjpeg's scaled size, ceil(dim/denom),
// so the native path's window arithmetic is unchanged.
void BoxDownscale(const std::vector<uint8_t>& src, int W, int H, int denom,
                  std::vector<uint8_t>* dst, int* ow, int* oh) {
  *ow = (W + denom - 1) / denom;
  *oh = (H + denom - 1) / denom;
  dst->resize(static_cast<size_t>(*ow) * *oh * 3);
  for (int y = 0; y < *oh; ++y) {
    const int y1 = std::min(H, (y + 1) * denom);
    for (int x = 0; x < *ow; ++x) {
      const int x1 = std::min(W, (x + 1) * denom);
      for (int c = 0; c < 3; ++c) {
        int sum = 0, count = 0;
        for (int sy = y * denom; sy < y1; ++sy)
          for (int sx = x * denom; sx < x1; ++sx) {
            sum += src[(static_cast<size_t>(sy) * W + sx) * 3 + c];
            ++count;
          }
        (*dst)[(static_cast<size_t>(y) * *ow + x) * 3 + c] =
            static_cast<uint8_t>((sum + count / 2) / count);
      }
    }
  }
}

int ScaleDenom(int W, int H, int min_width, int min_height) {
  for (int denom = 8; denom >= 2; denom /= 2)
    if ((W + denom - 1) / denom >= min_width &&
        (H + denom - 1) / denom >= min_height)
      return denom;
  return 1;
}

// The native path's decode (libjpeg build: DCT-scaled to the smallest
// scale that covers min_width x min_height).
bool DecodeJpeg(const char* data, size_t n, std::vector<uint8_t>* rgb,
                int* width, int* height, int min_width = 0,
                int min_height = 0) {
  std::vector<uint8_t> frame;
  int W = 0, H = 0;
  if (!NvDecodeFrame(data, n, &frame, &W, &H)) return false;
  const int denom = (min_width > 0 && min_height > 0)
                        ? ScaleDenom(W, H, min_width, min_height)
                        : 1;
  if (denom == 1) {
    *rgb = std::move(frame);
    *width = W;
    *height = H;
    return true;
  }
  BoxDownscale(frame, W, H, denom, rgb, width, height);
  return true;
}

// The native path's window decode, with the libjpeg build's arithmetic:
// the scale chosen from the window, the window mapped into the scaled
// frame, the bilinear resize, the flip.
template <typename ChooseCrop>
bool DecodeJpegWindow(const char* data, size_t n, int tw, int th,
                      float* out /* th*tw*3 */, const float* mean,
                      const float* inv_std, ChooseCrop choose) {
  std::vector<uint8_t> frame, scaled;
  int W = 0, H = 0;
  if (!NvDecodeFrame(data, n, &frame, &W, &H)) return false;
  int cx, cy, cw, ch;
  bool flip = false;
  choose(W, H, &cx, &cy, &cw, &ch, &flip);
  int denom = 1;
  for (int d = 8; d >= 2; d /= 2) {
    if ((cw + d - 1) / d >= tw && (ch + d - 1) / d >= th) {
      denom = d;
      break;
    }
  }
  int ow = W, oh = H;
  const uint8_t* base = frame.data();
  if (denom > 1) {
    BoxDownscale(frame, W, H, denom, &scaled, &ow, &oh);
    base = scaled.data();
  }
  auto scl = [&](int v, int full, int s) {
    return static_cast<int>(static_cast<long>(v) * s / full);
  };
  int sx = scl(cx, W, ow), sy = scl(cy, H, oh);
  int sw = scl(cw, W, ow), sh = scl(ch, H, oh);
  if (sw < 1) sw = 1;
  if (sh < 1) sh = 1;
  if (sx + sw > ow) sx = ow - sw;
  if (sy + sh > oh) sy = oh - sh;
  if (sx < 0) sx = 0;
  if (sy < 0) sy = 0;
  ResizeBilinear(base + (static_cast<size_t>(sy) * ow + sx) * 3, sw, sh, ow,
                 out, tw, th, mean, inv_std);
  if (flip) {
    for (int y = 0; y < th; ++y)
      for (int x = 0; x < tw / 2; ++x)
        for (int c = 0; c < 3; ++c)
          std::swap(out[(y * tw + x) * 3 + c],
                    out[(y * tw + (tw - 1 - x)) * 3 + c]);
  }
  return true;
}

// The tf.data path's decode: the whole frame (nvJPEG has no partial
// decode), the window a view of it.
template <typename Choose>
bool DecodeJpegTF(const char* data, size_t n, bool /*partial*/, Choose choose,
                  std::vector<uint8_t>* rgb, Window* win) {
  int W = 0, H = 0;
  if (!NvFrameSize(data, n, &W, &H)) return false;
  int cx = 0, cy = 0, cw = W, ch = H;
  choose(W, H, &cx, &cy, &cw, &ch);
  if (cx < 0 || cy < 0 || cw < 1 || ch < 1 || cx + cw > W || cy + ch > H)
    return false;
  if (!NvDecodeFrame(data, n, rgb, &W, &H)) return false;
  win->stride = W;
  win->width = cw;
  win->height = ch;
  win->offset = (static_cast<size_t>(cy) * W + cx) * 3;
  return true;
}

// h x w x 3 RGB bytes -> a baseline JPEG at `quality`, 4:2:0 chroma,
// through nvJPEG's encoder, in a malloc'd buffer.
bool EncodeJpeg(const uint8_t* rgb, int w, int h, int quality, char** out,
                unsigned long* size) {
  NvLease lease;
  NvContext* ctx = lease.ctx;
  nvjpegHandle_t handle = Nv().handle;
  const size_t bytes = static_cast<size_t>(w) * h * 3;
  if (ctx == nullptr || !NvReserve(ctx, bytes)) return false;
  if (ctx->enc_state == nullptr &&
      (nvjpegEncoderStateCreate(handle, &ctx->enc_state, ctx->stream) !=
           NVJPEG_STATUS_SUCCESS ||
       nvjpegEncoderParamsCreate(handle, &ctx->enc_params, ctx->stream) !=
           NVJPEG_STATUS_SUCCESS))
    return false;
  if (nvjpegEncoderParamsSetQuality(ctx->enc_params, quality, ctx->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(ctx->enc_params, NVJPEG_CSS_420,
                                            ctx->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(ctx->dev, rgb, bytes, cudaMemcpyHostToDevice,
                      ctx->stream) != cudaSuccess)
    return false;
  nvjpegImage_t src{};
  src.channel[0] = ctx->dev;
  src.pitch[0] = static_cast<size_t>(w) * 3;
  size_t length = 0;
  if (nvjpegEncodeImage(handle, ctx->enc_state, ctx->enc_params, &src,
                        NVJPEG_INPUT_RGBI, w, h, ctx->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncodeRetrieveBitstream(handle, ctx->enc_state, nullptr, &length,
                                    ctx->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(ctx->stream) != cudaSuccess)
    return false;
  auto* buf = static_cast<unsigned char*>(std::malloc(length));
  if (buf == nullptr) return false;
  if (nvjpegEncodeRetrieveBitstream(handle, ctx->enc_state, buf, &length,
                                    ctx->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(ctx->stream) != cudaSuccess) {
    std::free(buf);
    return false;
  }
  *out = reinterpret_cast<char*>(buf);
  *size = length;
  return true;
}
#elif defined(RR_NO_JPEG)
constexpr int kJpegBackend = 0;

bool DecodeJpeg(const char*, size_t, std::vector<uint8_t>*, int*, int*,
                int = 0, int = 0) {
  return false;
}

template <typename ChooseCrop>
bool DecodeJpegWindow(const char*, size_t, int, int, float*, const float*,
                      const float*, ChooseCrop) {
  return false;
}

template <typename Choose>
bool DecodeJpegTF(const char*, size_t, bool, Choose, std::vector<uint8_t>*,
                  Window*) {
  return false;
}

bool EncodeJpeg(const uint8_t*, int, int, int, char**, unsigned long*) {
  return false;
}
#else  // libjpeg
constexpr int kJpegBackend = 1;

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf env;
};

void JpegErrorExit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(err->env, 1);
}

// Decode JPEG bytes to 8-bit RGB. When the caller only needs
// (min_width × min_height) output, DCT-scaled decode (1/2, 1/4, 1/8) does
// the IDCT at reduced resolution — the dominant decode cost drops nearly
// quadratically while staying ≥ the resize target (the libjpeg analogue
// of tf.data's decode_and_crop trick). Pass 0/0 for full resolution.
bool DecodeJpeg(const char* data, size_t n, std::vector<uint8_t>* rgb,
                int* width, int* height, int min_width = 0,
                int min_height = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, reinterpret_cast<const unsigned char*>(data), n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr → RGB conversion
  if (min_width > 0 && min_height > 0) {
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
    for (int denom = 8; denom >= 2; denom /= 2) {
      // Output dims at scale 1/denom are ceil(dim/denom).
      int ow = (static_cast<int>(cinfo.image_width) + denom - 1) / denom;
      int oh = (static_cast<int>(cinfo.image_height) + denom - 1) / denom;
      if (ow >= min_width && oh >= min_height) {
        cinfo.scale_denom = denom;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb->data() + static_cast<size_t>(cinfo.output_scanline) *
                                     *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Decode ONLY a chosen crop window: DCT-scaled decode sized to the
// crop, jpeg_crop_scanline for the column range (iMCU-aligned),
// jpeg_skip_scanlines for the rows above/below — the libjpeg-turbo
// equivalent of tf.data's fused decode_and_crop, so the IDCT cost tracks
// the CROP area, not the full frame. `choose(W, H, &cx, &cy, &cw, &ch,
// &flip)` picks the full-resolution window once the header is parsed —
// shared by the train distorted-crop and eval central-crop paths.
template <typename ChooseCrop>
bool DecodeJpegWindow(const char* data, size_t n, int tw, int th,
                      float* out /* th*tw*3 */, const float* mean,
                      const float* inv_std, ChooseCrop choose) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  std::vector<uint8_t> buf;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, reinterpret_cast<const unsigned char*>(data), n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  const int W = cinfo.image_width, H = cinfo.image_height;

  int cx, cy, cw, ch;
  bool flip = false;
  choose(W, H, &cx, &cy, &cw, &ch, &flip);

  // DCT-scale so the SCALED crop still covers the resize target.
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 2; denom /= 2) {
    if ((cw + denom - 1) / denom >= tw && (ch + denom - 1) / denom >= th) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int ow = cinfo.output_width, oh = cinfo.output_height;
  // Crop coords in scaled space (clamped).
  auto scl = [&](int v, int full, int scaled) {
    long r = static_cast<long>(v) * scaled / full;
    return static_cast<int>(r);
  };
  int sx = scl(cx, W, ow), sy = scl(cy, H, oh);
  int sw = scl(cw, W, ow), sh = scl(ch, H, oh);
  if (sw < 1) sw = 1;
  if (sh < 1) sh = 1;
  if (sx + sw > ow) sx = ow - sw;
  if (sy + sh > oh) sy = oh - sh;
  if (sx < 0) sx = 0;
  if (sy < 0) sy = 0;

  JDIMENSION xoff = sx, xw = sw;
  jpeg_crop_scanline(&cinfo, &xoff, &xw);  // aligns to the iMCU grid
  const int xpad = sx - static_cast<int>(xoff);  // crop offset inside buffer
  if (sy > 0) jpeg_skip_scanlines(&cinfo, sy);
  buf.resize(static_cast<size_t>(sh) * xw * 3);
  while (static_cast<int>(cinfo.output_scanline) < sy + sh) {
    JSAMPROW row = buf.data() +
        static_cast<size_t>(cinfo.output_scanline - sy) * xw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_abort_decompress(&cinfo);  // discard the remaining rows unread
  jpeg_destroy_decompress(&cinfo);

  ResizeBilinear(buf.data() + static_cast<size_t>(xpad) * 3, sw, sh,
                 static_cast<int>(xw), out, tw, th, mean, inv_std);
  if (flip) {
    for (int y = 0; y < th; ++y)
      for (int x = 0; x < tw / 2; ++x)
        for (int c = 0; c < 3; ++c)
          std::swap(out[(y * tw + x) * 3 + c],
                    out[(y * tw + (tw - 1 - x)) * 3 + c]);
  }
  return true;
}

// JPEG -> 8-bit RGB at full scale with tf.io.decode_jpeg's defaults
// (JDCT_IFAST, fancy upsampling). `choose(W, H, &cx, &cy, &cw, &ch)` picks
// the window once the header is read; one outside the frame fails. With
// `partial` only the window is decoded — its columns widened to the iMCU
// grid by jpeg_crop_scanline, the rows above skipped, the rows below never
// read — as decode_and_crop_jpeg does; otherwise the whole frame is, and
// the window is a view of it, as central_crop takes it.
template <typename Choose>
bool DecodeJpegTF(const char* data, size_t n, bool partial, Choose choose,
                  std::vector<uint8_t>* rgb, Window* win) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, reinterpret_cast<const unsigned char*>(data), n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_IFAST;
  const int W = cinfo.image_width, H = cinfo.image_height;
  int cx = 0, cy = 0, cw = W, ch = H;
  choose(W, H, &cx, &cy, &cw, &ch);
  if (cx < 0 || cy < 0 || cw < 1 || ch < 1 || cx + cw > W || cy + ch > H) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_start_decompress(&cinfo);
  JDIMENSION xoff = 0, xw = cinfo.output_width;
  int first = 0, rows = static_cast<int>(cinfo.output_height);
  if (partial) {
    xoff = cx;
    xw = cw;
    jpeg_crop_scanline(&cinfo, &xoff, &xw);
    if (cy > 0) jpeg_skip_scanlines(&cinfo, cy);
    first = cy;
    rows = ch;
  }
  rgb->resize(static_cast<size_t>(rows) * xw * 3);
  while (static_cast<int>(cinfo.output_scanline) < first + rows) {
    JSAMPROW row = rgb->data() +
        static_cast<size_t>(cinfo.output_scanline - first) * xw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  if (partial)
    jpeg_abort_decompress(&cinfo);  // the rows below are never read
  else
    jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  win->stride = static_cast<int>(xw);
  win->width = cw;
  win->height = ch;
  win->offset = (static_cast<size_t>(partial ? 0 : cy) * xw +
                 (cx - static_cast<int>(xoff))) * 3;
  return true;
}

struct MemDest {
  unsigned char* buf = nullptr;
  unsigned long len = 0;
};

// h x w x 3 RGB bytes -> a baseline JPEG at `quality`, libjpeg's
// defaults otherwise (4:2:0 chroma, the standard Huffman tables), in a
// malloc'd buffer.
bool EncodeJpeg(const uint8_t* rgb, int w, int h, int quality, char** out,
                unsigned long* size) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  MemDest dst;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = JpegErrorExit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_compress(&cinfo);
    std::free(dst.buf);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &dst.buf, &dst.len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = reinterpret_cast<char*>(dst.buf);
  *size = dst.len;
  return true;
}

#endif  // the JPEG codec

// Train path: seeded Inception-style distorted crop + coin-flip mirror.
bool DecodeJpegCropped(const char* data, size_t n, uint64_t seed, int tw,
                       int th, float* out, const float* mean = nullptr,
                       const float* inv_std = nullptr) {
  return DecodeJpegWindow(
      data, n, tw, th, out, mean, inv_std,
      [seed](int W, int H, int* cx, int* cy, int* cw, int* ch, bool* flip) {
        Rng rng{seed};
        SampleCrop(&rng, W, H, cx, cy, cw, ch);
        *flip = rng.Uniform() < 0.5f;  // horizontal flip, same stream
      });
}

// Eval path: deterministic central crop. The window arithmetic mirrors
// tf.image.central_crop — offset = int((D - D*frac) / 2) computed in
// float, target = D - 2*offset — so the native eval sees the same pixels
// as the tf.data eval twin (resize filter remains bilinear-vs-bicubic,
// the documented delta).
bool DecodeJpegCentral(const char* data, size_t n, float central_frac,
                       int tw, int th, float* out,
                       const float* mean = nullptr,
                       const float* inv_std = nullptr) {
  return DecodeJpegWindow(
      data, n, tw, th, out, mean, inv_std,
      [central_frac](int W, int H, int* cx, int* cy, int* cw, int* ch,
                     bool* flip) {
        *cx = static_cast<int>((W - W * central_frac) / 2);
        *cy = static_cast<int>((H - H * central_frac) / 2);
        *cw = W - 2 * *cx;
        *ch = H - 2 * *cy;
        *flip = false;
      });
}


void FlipRows(float* img, int tw, int th) {
  for (int y = 0; y < th; ++y)
    for (int x = 0; x < tw / 2; ++x)
      for (int c = 0; c < 3; ++c)
        std::swap(img[(static_cast<size_t>(y) * tw + x) * 3 + c],
                  img[(static_cast<size_t>(y) * tw + (tw - 1 - x)) * 3 + c]);
}

// One JPEG through the tf.data path's transform into out[th][tw][3].
// Train (`seed` given): the distorted-crop window and the flip from
// SampleCrop's stream, the window decoded alone; eval: the whole frame
// decoded and tf.image.central_crop's window of it (offsets computed in
// double, as TF computes them for a dynamic shape). Then the bicubic
// resize, the flip, and (v - mean) / std when `mean` is given.
bool TransformTF(const char* jpg, size_t n, const uint64_t* seed,
                 float central_frac, int tw, int th, float* out,
                 const float* mean, const float* stddev) {
  std::vector<uint8_t> rgb;
  Window win;
  bool flip = false;
  bool ok;
  if (seed != nullptr) {
    ok = DecodeJpegTF(jpg, n, true,
                      [&](int W, int H, int* cx, int* cy, int* cw, int* ch) {
                        Rng rng{*seed};
                        SampleCrop(&rng, W, H, cx, cy, cw, ch);
                        flip = rng.Uniform() < 0.5f;
                      },
                      &rgb, &win);
  } else {
    ok = DecodeJpegTF(jpg, n, false,
                      [central_frac](int W, int H, int* cx, int* cy, int* cw,
                                     int* ch) {
                        const double f = central_frac;
                        *cy = static_cast<int>((H - H * f) / 2);
                        *cx = static_cast<int>((W - W * f) / 2);
                        *ch = H - 2 * *cy;
                        *cw = W - 2 * *cx;
                      },
                      &rgb, &win);
  }
  if (!ok) return false;
  ResizeBicubicTF(rgb.data() + win.offset, win.width, win.height, win.stride,
                  out, tw, th);
  if (flip) FlipRows(out, tw, th);
  if (mean != nullptr) {
    const size_t pixels = static_cast<size_t>(tw) * th;
    for (size_t p = 0; p < pixels; ++p)
      for (int c = 0; c < 3; ++c)
        out[p * 3 + c] = (out[p * 3 + c] - mean[c]) / stddev[c];
  }
  return true;
}

// Pop one record out of the queue by MOVE — 1 ok, 0 EOF, -1 error.
int PopRecord(Reader* r, Record* out) {
  std::unique_lock<std::mutex> lock(r->mu);
  r->cv_pop.wait(lock, [r] {
    return !r->queue.empty() || r->done || r->stop;
  });
  if (!r->error.empty()) return -1;
  if (r->queue.empty()) return 0;  // EOF
  *out = std::move(r->queue.front());
  r->queue.pop_front();
  r->cv_push.notify_one();
  return 1;
}

// Pop through the shuffle window when one is configured. All consumers
// (raw records, i32 batches, image batches, skip) share this path, so a
// resume that skips k records replays exactly what reading-and-discarding
// k records would have produced. Single-consumer (the Python side is one
// thread per handle), so no extra locking.
int PopNext(Reader* r, Record* out) {
  if (r->shuffle_window <= 1) return PopRecord(r, out);
  if (!r->shuffle_primed) {
    r->shuffle_buf.reserve(r->shuffle_window);
    while (r->shuffle_buf.size() < r->shuffle_window) {
      Record rec;
      int rc = PopRecord(r, &rec);
      if (rc < 0) return rc;
      if (rc == 0) break;
      r->shuffle_buf.push_back(std::move(rec));
    }
    r->shuffle_primed = true;
  }
  if (r->shuffle_buf.empty()) return PopRecord(r, out);  // EOF (or error)
  size_t j = static_cast<size_t>(r->shuffle_rng.Next() % r->shuffle_buf.size());
  *out = std::move(r->shuffle_buf[j]);
  Record rec;
  int rc = PopRecord(r, &rec);
  if (rc < 0) return rc;
  if (rc == 1) {
    r->shuffle_buf[j] = std::move(rec);
  } else {  // stream drained: shrink the window
    r->shuffle_buf[j] = std::move(r->shuffle_buf.back());
    r->shuffle_buf.pop_back();
  }
  return 1;
}

}  // namespace

extern "C" {

// shuffle_window > 1 enables the windowed record shuffle (tf.data
// shuffle-buffer semantics, deterministic given shuffle_seed).
void* rr_open(const char** paths, int n_paths, int prefetch,
              long shuffle_window, uint64_t shuffle_seed) {
  auto* r = new Reader();
  for (int i = 0; i < n_paths; ++i) r->paths.emplace_back(paths[i]);
  r->prefetch = prefetch > 0 ? prefetch : 256;
  r->shuffle_window = shuffle_window > 1 ? static_cast<size_t>(shuffle_window)
                                         : 0;
  r->shuffle_rng.s = shuffle_seed;
  r->worker = std::thread(ReadLoop, r);
  return r;
}

// Skip `n` records of the (possibly shuffled) stream without the C-ABI
// handoff copy or JPEG decode — the resume fast-skip. Returns the number
// actually skipped (short on EOF), or -1 on a reader error.
long rr_skip(void* h, long n) {
  auto* r = static_cast<Reader*>(h);
  Record rec;
  long i = 0;
  for (; i < n; ++i) {
    int rc = PopNext(r, &rec);
    if (rc < 0) return -1;
    if (rc == 0) break;
  }
  return i;
}

// Pops one record; caller owns *buf (free with rr_free). (The malloc+
// copy is the C-ABI handoff cost; the batch paths below move instead.)
int rr_next_record(void* h, char** buf, long* len) {
  Record rec;
  int rc = PopNext(static_cast<Reader*>(h), &rec);
  if (rc <= 0) return rc;
  *len = static_cast<long>(rec.bytes.size());
  *buf = static_cast<char*>(std::malloc(rec.bytes.size()));
  std::memcpy(*buf, rec.bytes.data(), rec.bytes.size());
  return 1;
}

void rr_free(char* buf) { std::free(buf); }

// Fills out[batch][width] with the named Int64List feature of the next
// `batch` records. Returns 1 ok, 0 EOF (not enough records), <0 error.
int rr_next_batch_i32(void* h, const char* key, int32_t* out, int batch,
                      int width) {
  auto* r = static_cast<Reader*>(h);
  Record rec;
  for (int i = 0; i < batch; ++i) {
    int rc = PopNext(r, &rec);
    if (rc <= 0) return rc;
    int got = ParseExampleInt64(rec.bytes.data(), rec.bytes.size(), key,
                                out + i * width, width);
    if (got < 0) return -2;
    if (got < width)  // pad short sequences with zeros
      std::memset(out + i * width + got, 0, sizeof(int32_t) * (width - got));
  }
  return 1;
}

// Fills up to `rows` rows of out[rows][width] with the named Int64List
// feature of the next records, zero-padding short ones, and writes each
// record's value count to lengths[] (width + 1 when it holds more than
// width values; 0 when the key is missing). Returns the rows filled (short
// only at the end of the stream), 0 at EOF, <0 on error.
int rr_next_rows_i32(void* h, const char* key, int32_t* out,
                     int32_t* lengths, int rows, int width) {
  auto* r = static_cast<Reader*>(h);
  Record rec;
  std::vector<int32_t> scratch(static_cast<size_t>(width) + 1);
  int i = 0;
  for (; i < rows; ++i) {
    int rc = PopNext(r, &rec);
    if (rc < 0) return rc;
    if (rc == 0) break;
    int got = ParseExampleInt64(rec.bytes.data(), rec.bytes.size(), key,
                                scratch.data(), width + 1);
    if (got < 0) return -2;
    int keep = got < width ? got : width;
    std::memcpy(out + static_cast<size_t>(i) * width, scratch.data(),
                sizeof(int32_t) * keep);
    if (keep < width)
      std::memset(out + static_cast<size_t>(i) * width + keep, 0,
                  sizeof(int32_t) * (width - keep));
    lengths[i] = got;
  }
  return i;
}

// Pulls `batch` records, decodes their `image_key` JPEGs and bilinearly
// resizes to (th, tw) into out_images[batch][th][tw][3] (float32, 0..255),
// and writes the `label_key` int64 into out_labels[batch]. JPEG decode +
// resize run in `threads` parallel workers across the batch — the hot
// host-side cost at ImageNet rates. Returns 1 ok, 0 EOF, <0 error.
int rr_next_batch_images(void* h, const char* image_key,
                         const char* label_key, float* out_images,
                         int32_t* out_labels, int batch, int th, int tw,
                         int threads, const uint64_t* crop_seeds,
                         const float* mean, const float* stddev) {
  // Standardization fused into the resize output write: one multiply-add
  // per pixel instead of a second full pass over the batch in numpy.
  float inv_std_buf[3];
  const float* inv_std = nullptr;
  if (mean != nullptr && stddev != nullptr) {
    for (int c = 0; c < 3; ++c) inv_std_buf[c] = 1.0f / stddev[c];
    inv_std = inv_std_buf;
  } else {
    mean = nullptr;
  }
  // Records must be pulled serially (queue order = deterministic resume
  // contract); decode is the parallel part.
  std::vector<Record> records(batch);
  for (int i = 0; i < batch; ++i) {
    int rc = PopNext(static_cast<Reader*>(h), &records[i]);
    if (rc <= 0) return rc;  // records pulled by MOVE, no copies
  }
  std::atomic<int> next{0};
  std::atomic<int> failed{-1};
  int n_threads = threads > 0 ? threads : 8;
  if (n_threads > batch) n_threads = batch;
  auto work = [&] {
    std::vector<uint8_t> rgb;
    for (int i = next.fetch_add(1); i < batch; i = next.fetch_add(1)) {
      const auto& rec = records[i].bytes;
      const char* jpg = nullptr;
      uint64_t jpg_len = 0;
      if (ParseExampleBytes(rec.data(), rec.size(), image_key, &jpg,
                            &jpg_len) != 1) {
        failed = i;
        return;
      }
      float* dst = out_images + static_cast<size_t>(i) * th * tw * 3;
      if (crop_seeds != nullptr) {
        // Train path: distorted crop + flip decoded via partial IDCT.
        if (!DecodeJpegCropped(jpg, jpg_len, crop_seeds[i], tw, th, dst,
                               mean, inv_std)) {
          failed = i;
          return;
        }
      } else {
        int sw = 0, sh = 0;
        if (!DecodeJpeg(jpg, jpg_len, &rgb, &sw, &sh, tw, th) ||
            sw <= 0 || sh <= 0) {
          failed = i;
          return;
        }
        ResizeBilinear(rgb.data(), sw, sh, sw, dst, tw, th, mean, inv_std);
      }
      int32_t label = 0;
      // < 1 covers BOTH malformed (-1) and key-missing (0): a silently
      // defaulted label would train the model on garbage targets.
      if (ParseExampleInt64(rec.data(), rec.size(), label_key, &label, 1) < 1) {
        failed = i;
        return;
      }
      out_labels[i] = label;
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return failed.load() >= 0 ? -3 : 1;
}

// Eval twin of rr_next_batch_images: deterministic central-crop
// (central_frac) decode + bilinear resize, single pass — no crop seeds,
// no flip. Pops UP TO `batch` records and returns the number filled
// (0 = clean EOF, <0 error); rows past the returned count are untouched
// (the caller zero-pads and weights them) — this is what lets the exact-
// eval contract (every record once, padded final batch) run through the
// native path.
int rr_next_batch_images_eval(void* h, const char* image_key,
                              const char* label_key, float* out_images,
                              int32_t* out_labels, int batch, int th, int tw,
                              int threads, float central_frac,
                              const float* mean, const float* stddev) {
  float inv_std_buf[3];
  const float* inv_std = nullptr;
  if (mean != nullptr && stddev != nullptr) {
    for (int c = 0; c < 3; ++c) inv_std_buf[c] = 1.0f / stddev[c];
    inv_std = inv_std_buf;
  } else {
    mean = nullptr;
  }
  std::vector<Record> records;
  records.reserve(batch);
  for (int i = 0; i < batch; ++i) {
    Record rec;
    int rc = PopNext(static_cast<Reader*>(h), &rec);
    if (rc < 0) return rc;
    if (rc == 0) break;  // partial final batch
    records.push_back(std::move(rec));
  }
  const int k = static_cast<int>(records.size());
  if (k == 0) return 0;
  std::atomic<int> next{0};
  std::atomic<int> failed{-1};
  int n_threads = threads > 0 ? threads : 8;
  if (n_threads > k) n_threads = k;
  auto work = [&] {
    for (int i = next.fetch_add(1); i < k; i = next.fetch_add(1)) {
      const auto& rec = records[i].bytes;
      const char* jpg = nullptr;
      uint64_t jpg_len = 0;
      if (ParseExampleBytes(rec.data(), rec.size(), image_key, &jpg,
                            &jpg_len) != 1) {
        failed = i;
        return;
      }
      float* dst = out_images + static_cast<size_t>(i) * th * tw * 3;
      if (!DecodeJpegCentral(jpg, jpg_len, central_frac, tw, th, dst, mean,
                             inv_std)) {
        failed = i;
        return;
      }
      int32_t label = 0;
      if (ParseExampleInt64(rec.data(), rec.size(), label_key, &label, 1) < 1) {
        failed = i;
        return;
      }
      out_labels[i] = label;
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return failed.load() >= 0 ? -3 : k;
}

// Decodes `n` serialized tf.train.Examples (recs[i], lens[i] bytes): the
// `image_key` JPEG through TransformTF into out_images[n][th][tw][3] (train
// when crop_seeds is given, one seed per record; eval otherwise) and the
// `label_key` int64 into out_labels[n], in `threads` workers. Returns 0, or
// -(i + 1) when record i has no JPEG or label, or its JPEG fails to decode.
int rr_decode_images(const char* const* recs, const uint64_t* lens, int n,
                     const char* image_key, const char* label_key,
                     float* out_images, int32_t* out_labels, int th, int tw,
                     int threads, const uint64_t* crop_seeds,
                     float central_frac, const float* mean,
                     const float* stddev) {
  if (mean == nullptr || stddev == nullptr) mean = stddev = nullptr;
  std::atomic<int> next{0};
  std::atomic<int> failed{-1};
  int n_threads = threads > 0 ? threads : 8;
  if (n_threads > n) n_threads = n;
  auto work = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      const char* jpg = nullptr;
      uint64_t jpg_len = 0;
      int32_t label = 0;
      float* dst = out_images + static_cast<size_t>(i) * th * tw * 3;
      if (ParseExampleBytes(recs[i], lens[i], image_key, &jpg, &jpg_len) != 1
          || !TransformTF(jpg, jpg_len,
                          crop_seeds != nullptr ? crop_seeds + i : nullptr,
                          central_frac, tw, th, dst, mean, stddev)
          || ParseExampleInt64(recs[i], lens[i], label_key, &label, 1) < 1) {
        failed = i;
        return;
      }
      out_labels[i] = label;
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  return failed.load() >= 0 ? -(failed.load() + 1) : 0;
}

// The train transform of one JPEG with a given window and flip, raw
// [0, 255] pixels: the window decoded alone at full scale, TF's bicubic
// resize to (th, tw), the mirror. 0 ok, -1 when the JPEG fails or the
// window leaves the frame.
int rr_decode_window(const char* jpg, uint64_t n, int cx, int cy, int cw,
                     int ch, int flip, int th, int tw, float* out) {
  std::vector<uint8_t> rgb;
  Window win;
  if (!DecodeJpegTF(jpg, n, true,
                    [&](int, int, int* x, int* y, int* w, int* h) {
                      *x = cx;
                      *y = cy;
                      *w = cw;
                      *h = ch;
                    },
                    &rgb, &win))
    return -1;
  ResizeBicubicTF(rgb.data() + win.offset, win.width, win.height, win.stride,
                  out, tw, th);
  if (flip) FlipRows(out, tw, th);
  return 0;
}

// SampleCrop's window (cx, cy, cw, ch) for a W x H frame from `seed`, as
// both image paths draw it; returns the flip drawn after it.
int rr_sample_crop(uint64_t seed, int W, int H, int* window) {
  Rng rng{seed};
  SampleCrop(&rng, W, H, window, window + 1, window + 2, window + 3);
  return rng.Uniform() < 0.5f ? 1 : 0;
}
// Encodes h x w x 3 RGB bytes as a baseline JPEG at `quality` (4:2:0
// chroma) with the build's codec. *out is malloc'd: free it with rr_free.
// 0 ok, -1 error.
int rr_encode_jpeg(const uint8_t* rgb, int w, int h, int quality, char** out,
                   unsigned long* size) {
  return EncodeJpeg(rgb, w, h, quality, out, size) ? 0 : -1;
}

// The build's JPEG codec: 1 libjpeg, 2 nvJPEG, 0 none.
int rr_jpeg_backend() { return kJpegBackend; }

uint32_t rr_masked_crc32c(const char* data, size_t n) {
  return MaskedCrc(data, n);
}

const char* rr_error(void* h) {
  auto* r = static_cast<Reader*>(h);
  std::lock_guard<std::mutex> lock(r->mu);
  return r->error.empty() ? nullptr : r->error.c_str();
}

void rr_close(void* h) { delete static_cast<Reader*>(h); }

}  // extern "C"
