// Native host data path of multimodal_similarity_tpu_torch.
//
// Implements the host-side hot loops of the input pipeline in C++17:
//   - TFRecord framing with masked-CRC32C validation;
//   - a minimal protobuf walker for the tf.train.SequenceExample subset the
//     on-disk contract uses (int64/bytes context + packed-float
//     FeatureLists), replacing the per-frame Python parse;
//   - a std::thread pool that parses one event file per task straight into
//     the caller's preallocated batch buffer.
//
// Exposed as a C ABI consumed via ctypes
// (multimodal_similarity_tpu_torch/data/native.py), built with g++ at first
// use.  No Python.h dependency.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), table-driven
// ---------------------------------------------------------------------------

uint32_t g_crc_table[256];
bool g_crc_init = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k)
      crc = (crc >> 1) ^ ((crc & 1) ? 0x82F63B78u : 0u);
    g_crc_table[i] = crc;
  }
  return true;
}();

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// Protobuf walking
// ---------------------------------------------------------------------------

struct Slice {
  const uint8_t* p;
  size_t n;
};

bool read_varint(Slice& s, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (s.n > 0) {
    uint8_t b = *s.p;
    s.p++;
    s.n--;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// Iterate fields of a message slice; calls fn(field, wire, payload_slice or
// varint value).  Returns false on malformed input.
template <typename Fn>
bool walk(Slice s, Fn&& fn) {
  while (s.n > 0) {
    uint64_t key;
    if (!read_varint(s, &key)) return false;
    uint32_t field = static_cast<uint32_t>(key >> 3);
    uint32_t wire = key & 7;
    if (wire == 0) {
      uint64_t v;
      if (!read_varint(s, &v)) return false;
      fn(field, wire, Slice{nullptr, 0}, v);
    } else if (wire == 2) {
      uint64_t len;
      if (!read_varint(s, &len) || len > s.n) return false;
      fn(field, wire, Slice{s.p, static_cast<size_t>(len)}, 0);
      s.p += len;
      s.n -= len;
    } else if (wire == 5) {
      if (s.n < 4) return false;
      fn(field, wire, Slice{s.p, 4}, 0);
      s.p += 4;
      s.n -= 4;
    } else if (wire == 1) {
      if (s.n < 8) return false;
      fn(field, wire, Slice{s.p, 8}, 0);
      s.p += 8;
      s.n -= 8;
    } else {
      return false;
    }
  }
  return true;
}

// Feature { 2: FloatList { 1: packed floats } } -> append to out
void decode_float_feature(Slice feature, std::vector<float>* out) {
  walk(feature, [&](uint32_t f, uint32_t w, Slice payload, uint64_t) {
    if (f == 2 && w == 2) {  // float_list
      walk(payload, [&](uint32_t f2, uint32_t w2, Slice p2, uint64_t) {
        if (f2 == 1 && (w2 == 2 || w2 == 5)) {
          size_t count = p2.n / 4;
          size_t base = out->size();
          out->resize(base + count);
          memcpy(out->data() + base, p2.p, count * 4);
        }
      });
    }
  });
}

// Feature { 3: Int64List { 1: varint } } -> value
bool decode_int_feature(Slice feature, int64_t* out) {
  bool found = false;
  walk(feature, [&](uint32_t f, uint32_t w, Slice payload, uint64_t) {
    if (f == 3 && w == 2) {
      walk(payload, [&](uint32_t f2, uint32_t w2, Slice p2, uint64_t v2) {
        if (f2 == 1 && w2 == 0) {
          *out = static_cast<int64_t>(v2);
          found = true;
        }
      });
    }
  });
  return found;
}

struct EventData {
  std::vector<float> frames;  // [T * D] for the requested key
  int64_t label = 0;
  int64_t length = 0;
  bool ok = false;
  bool found_key = false;     // the requested FeatureList exists
  int64_t frame_width = -1;   // floats per frame (-1: none; -2: ragged)
};

// Parse one SequenceExample payload for a single feature-list key.
// Untrusted input: ev.ok reflects whether the top-level message walked
// cleanly — a truncated or malformed record is rejected, not half-read.
EventData parse_event(const uint8_t* buf, size_t n, const std::string& key) {
  EventData ev;
  Slice root{buf, n};
  bool clean = walk(root, [&](uint32_t f, uint32_t w, Slice payload, uint64_t) {
    if (f == 1 && w == 2) {  // context Features
      walk(payload, [&](uint32_t f2, uint32_t, Slice entry, uint64_t) {
        if (f2 != 1) return;
        Slice name{nullptr, 0}, feat{nullptr, 0};
        walk(entry, [&](uint32_t f3, uint32_t, Slice p3, uint64_t) {
          if (f3 == 1) name = p3;
          if (f3 == 2) feat = p3;
        });
        std::string nm = name.p
            ? std::string(reinterpret_cast<const char*>(name.p), name.n)
            : std::string();
        if (nm == "label") decode_int_feature(feat, &ev.label);
        if (nm == "length") decode_int_feature(feat, &ev.length);
      });
    } else if (f == 2 && w == 2) {  // feature_lists
      walk(payload, [&](uint32_t f2, uint32_t, Slice entry, uint64_t) {
        if (f2 != 1) return;
        Slice name{nullptr, 0}, flist{nullptr, 0};
        walk(entry, [&](uint32_t f3, uint32_t, Slice p3, uint64_t) {
          if (f3 == 1) name = p3;
          if (f3 == 2) flist = p3;
        });
        std::string nm = name.p
            ? std::string(reinterpret_cast<const char*>(name.p), name.n)
            : std::string();
        if (nm != key) return;
        ev.found_key = true;
        walk(flist, [&](uint32_t f4, uint32_t, Slice feature, uint64_t) {
          if (f4 == 1) {
            size_t before = ev.frames.size();
            decode_float_feature(feature, &ev.frames);
            int64_t w = static_cast<int64_t>(ev.frames.size() - before);
            if (ev.frame_width == -1) ev.frame_width = w;
            else if (ev.frame_width != w) ev.frame_width = -2;  // ragged
          }
        });
      });
    }
  });
  ev.ok = clean;
  return ev;
}

// Read every TFRecord payload in a file (CRC-checked).
bool read_tfrecord_file(const char* path, std::vector<uint8_t>* record) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  // untrusted framing: a CRC-valid header can still claim an absurd
  // length — bound the allocation by what the file can actually hold
  // (header 8 + header crc 4 + payload + payload crc 4)
  fseek(f, 0, SEEK_END);
  int64_t file_size = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t header[8];
  uint8_t crcbuf[4];
  bool got = false;
  // one event per file in the on-disk contract; read the first record
  if (file_size >= 16 && fread(header, 1, 8, f) == 8) {
    uint64_t len;
    memcpy(&len, header, 8);
    if (fread(crcbuf, 1, 4, f) == 4) {
      uint32_t hcrc;
      memcpy(&hcrc, crcbuf, 4);
      if (masked_crc(header, 8) == hcrc &&
          len <= static_cast<uint64_t>(file_size) - 16) {
        record->resize(len);
        if (fread(record->data(), 1, len, f) == len &&
            fread(crcbuf, 1, 4, f) == 4) {
          uint32_t dcrc;
          memcpy(&dcrc, crcbuf, 4);
          got = masked_crc(record->data(), len) == dcrc;
        }
      }
    }
  }
  fclose(f);
  return got;
}

}  // namespace

extern "C" {

// crc32c of a buffer (exposed for tests / parity with the Python codec)
uint32_t msim_crc32c(const uint8_t* data, uint64_t n) {
  return crc32c(data, n);
}

// Parse a batch of one-event TFRecord files in parallel.
//   paths       n_paths C strings
//   key         feature-list name (e.g. "resnet", "sensors")
//   out         [n_paths, max_time, feat_dim] float32, caller-allocated
//   seq_len     [n_paths] int32 out
//   labels      [n_paths] int32 out
//   n_threads   worker count (<=0 -> hardware concurrency)
// Returns number of successfully parsed events.
int64_t msim_load_event_batch(const char** paths, int64_t n_paths,
                              const char* key, float* out, int64_t max_time,
                              int64_t feat_dim, int32_t* seq_len,
                              int32_t* labels, int32_t n_threads) {
  std::string k(key);
  std::atomic<int64_t> next(0), ok_count(0);
  int workers = n_threads > 0
                    ? n_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  if (workers < 1) workers = 1;
  if (workers > n_paths) workers = static_cast<int>(n_paths);

  auto work = [&]() {
    std::vector<uint8_t> record;
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_paths) return;
      float* dst = out + i * max_time * feat_dim;
      memset(dst, 0, sizeof(float) * max_time * feat_dim);
      seq_len[i] = 1;
      labels[i] = 0;
      if (!read_tfrecord_file(paths[i], &record)) continue;
      EventData ev = parse_event(record.data(), record.size(), k);
      // defer to the (loud) Python path when the key is absent or the
      // on-disk frame width disagrees with feat_dim — reinterpreting the
      // flat buffer as feat_dim-wide rows would silently misalign frames
      if (!ev.ok || !ev.found_key || feat_dim == 0) continue;
      if (ev.frame_width >= 0 && ev.frame_width != feat_dim) continue;
      if (ev.frame_width == -2) continue;  // ragged frames
      int64_t t = static_cast<int64_t>(ev.frames.size()) / feat_dim;
      if (t > max_time) t = max_time;
      if (t > 0) {
        memcpy(dst, ev.frames.data(), sizeof(float) * t * feat_dim);
        seq_len[i] = static_cast<int32_t>(t);
      }
      labels[i] = static_cast<int32_t>(ev.label);
      ok_count.fetch_add(1);
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int w = 0; w < workers; ++w) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return ok_count.load();
}

// Slice event windows out of a [T, D] float32 feature array and TSN-sample
// n_seg frames per event — the hot inner loop of load_data_and_label.
//   feats        [total_frames, dim]
//   starts/ends  [n_events] frame ranges (already length-filtered)
//   offsets      [n_events, n_seg] precomputed frame offsets (host PRNG)
//   out          [n_events, n_seg, dim]
void msim_gather_segments(const float* feats, int64_t dim,
                          const int64_t* starts, const int64_t* offsets,
                          int64_t n_events, int64_t n_seg, float* out) {
  for (int64_t e = 0; e < n_events; ++e) {
    for (int64_t s = 0; s < n_seg; ++s) {
      int64_t frame = starts[e] + offsets[e * n_seg + s];
      memcpy(out + (e * n_seg + s) * dim, feats + frame * dim,
             sizeof(float) * dim);
    }
  }
}

}  // extern "C"
