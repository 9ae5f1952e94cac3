// Native TFRecord reader with background prefetch: the MLM half of the JAX
// package's native/record_reader.cc.
//
// A reader thread decodes the TFRecord framing (length + masked crc32c +
// payload + masked crc32c) and checks both CRCs, naming the file on a
// mismatch; the minimal tf.train.Example parser pulls one named Int64List
// feature; whole batches reach Python through one copy, so the framing and
// the varint decode run outside the interpreter lock. The JPEG half of the
// JAX reader (rr_next_batch_images*, -ljpeg) is not here: it comes with
// the image pipelines.
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
//   rr_masked_crc32c(data, n)                    -> the TFRecord checksum
//   rr_error(h)                                  -> message or null
//   rr_close(h)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread record_reader.cc
//        -o librecord_reader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

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
// splitmix64 — the deterministic PRNG of the record shuffle; its seed is
// derived host-side through the core/prng.py discipline.
struct Rng {
  uint64_t s;
  uint64_t Next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
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
  r->done = true;
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

// Pulls `batch` records, decodes their `image_key` JPEGs and bilinearly
// resizes to (th, tw) into out_images[batch][th][tw][3] (float32, 0..255),
// and writes the `label_key` int64 into out_labels[batch]. JPEG decode +
// resize run in `threads` parallel workers across the batch — the hot

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
