// ursa_dataio: native host-side data pipeline for URSABench-TPU.
//
// The TPU compute path keeps whole datasets device-resident (HBM), but
// ImageNet-scale configs (the reference ships ResNet50ImageNet tuned
// hyperparameters) must stream batches from host RAM. This library is the
// hot host loop of that path: permutation generation, batch gather, and
// fused uint8 -> normalized float32 NHWC conversion — the work the
// reference delegates to torch DataLoader worker processes
// (URSABench/datasets.py:244-261). Exposed via a plain C
// ABI consumed through ctypes (no pybind11 dependency).
//
// Build: make -C native   (produces libursa_dataio.so)

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Background prefetch stream: a worker thread gathers + normalizes batches
// ahead of the consumer into a ring of slots — the role torch DataLoader
// worker processes play in the reference, as one pthread with shared memory
// (ctypes releases the GIL around the blocking next() call, so the worker
// overlaps Python dispatch AND device compute).
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> x;     // normalized mode
  std::vector<uint8_t> x8;  // raw uint8 mode (normalize-on-device)
  std::vector<int32_t> y;
  int64_t batch_index = -1;  // which batch this slot holds, -1 = empty
};

struct UrsaStream {
  const uint8_t* images;
  const int64_t* labels;
  int64_t n, item_pixels, channels, batch, num_batches;
  bool u8 = false;  // raw uint8 output (4x smaller transfers; the device
                    // normalizes — same order as the in-HBM epoch path)
  float scale[16], bias[16];
  std::vector<int64_t> order;
  std::vector<Slot> ring;
  int64_t produced = 0, consumed = 0;
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_produced, cv_space;
  std::thread worker;
};

void fill_slot(UrsaStream* s, Slot* slot, int64_t bi) {
  const int64_t item_bytes = s->item_pixels * s->channels;
  const int64_t* idx = s->order.data() + bi * s->batch;
  for (int64_t b = 0; b < s->batch; ++b) {
    const uint8_t* src = s->images + idx[b] * item_bytes;
    if (s->u8) {
      std::memcpy(slot->x8.data() + b * item_bytes, src,
                  static_cast<size_t>(item_bytes));
    } else {
      float* dst = slot->x.data() + b * item_bytes;
      if (s->channels == 1) {
        const float sc = s->scale[0], o = s->bias[0];
        for (int64_t i = 0; i < item_bytes; ++i) dst[i] = src[i] * sc + o;
      } else {
        for (int64_t i = 0; i < item_bytes; i += s->channels) {
          for (int64_t c = 0; c < s->channels; ++c) {
            dst[i + c] = src[i + c] * s->scale[c] + s->bias[c];
          }
        }
      }
    }
    slot->y[b] = static_cast<int32_t>(s->labels[idx[b]]);
  }
  slot->batch_index = bi;
}

void worker_loop(UrsaStream* s) {
  const int64_t depth = static_cast<int64_t>(s->ring.size());
  for (int64_t bi = 0; bi < s->num_batches; ++bi) {
    {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_space.wait(lk, [s, depth] {
        return s->stop || s->produced - s->consumed < depth;
      });
      if (s->stop) return;
    }
    fill_slot(s, &s->ring[bi % depth], bi);
    {
      std::lock_guard<std::mutex> lk(s->mu);
      s->produced++;
    }
    s->cv_produced.notify_one();
  }
}

}  // namespace

extern "C" {

// Fisher-Yates permutation of [0, n) using a seeded 64-bit PCG stream.
void ursa_permutation(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  std::mt19937_64 rng(seed);
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = rng() % static_cast<uint64_t>(i + 1);
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// Gather rows of a uint8 image array (n, item_bytes) into a contiguous
// batch and simultaneously convert to normalized float32:
//   out[b, ..., c] = (img / 255 - mean[c]) / std[c]
// images: (n, H*W*C) uint8, channel-last within an item.
void ursa_gather_normalize(
    const uint8_t* images, const int64_t* labels, int64_t item_pixels,
    int64_t channels, const int64_t* indices, int64_t batch,
    const float* mean, const float* stddev, float* out_x, int32_t* out_y) {
  const int64_t item_bytes = item_pixels * channels;
  // precompute per-channel scale/bias: x*scale + bias
  if (channels > 16) return;  // caller contract: image data, <=16 channels
  float scale[16], bias[16];
  for (int64_t c = 0; c < channels; ++c) {
    scale[c] = 1.0f / (255.0f * stddev[c]);
    bias[c] = -mean[c] / stddev[c];
  }
  for (int64_t b = 0; b < batch; ++b) {
    const uint8_t* src = images + indices[b] * item_bytes;
    float* dst = out_x + b * item_bytes;
    if (channels == 1) {
      const float s = scale[0], o = bias[0];
      for (int64_t i = 0; i < item_bytes; ++i) dst[i] = src[i] * s + o;
    } else {
      for (int64_t i = 0; i < item_bytes; i += channels) {
        for (int64_t c = 0; c < channels; ++c) {
          dst[i + c] = src[i + c] * scale[c] + bias[c];
        }
      }
    }
    out_y[b] = static_cast<int32_t>(labels[indices[b]]);
  }
}

// Plain gather of uint8 rows (no conversion) — for augmentation-on-device
// paths that want raw pixels.
void ursa_gather_u8(
    const uint8_t* images, const int64_t* labels, int64_t item_bytes,
    const int64_t* indices, int64_t batch, uint8_t* out_x, int32_t* out_y) {
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out_x + b * item_bytes, images + indices[b] * item_bytes,
                static_cast<size_t>(item_bytes));
    out_y[b] = static_cast<int32_t>(labels[indices[b]]);
  }
}

// Create a prefetch stream over one shuffled epoch. The images/labels
// pointers must outlive the stream (the Python side keeps references).
// depth = ring size (2 = classic double buffering). Returns an opaque
// handle; NULL on bad arguments.
void* ursa_stream_create(
    const uint8_t* images, const int64_t* labels, int64_t n,
    int64_t item_pixels, int64_t channels, int64_t batch, const float* mean,
    const float* stddev, uint64_t seed, int32_t shuffle, int32_t depth) {
  if (channels > 16 || batch <= 0 || n < batch || depth < 1) return nullptr;
  auto* s = new UrsaStream();
  s->images = images;
  s->labels = labels;
  s->n = n;
  s->item_pixels = item_pixels;
  s->channels = channels;
  s->batch = batch;
  s->num_batches = n / batch;
  for (int64_t c = 0; c < channels; ++c) {
    s->scale[c] = 1.0f / (255.0f * stddev[c]);
    s->bias[c] = -mean[c] / stddev[c];
  }
  s->order.resize(n);
  ursa_permutation(n, seed, s->order.data());
  if (!shuffle) {
    for (int64_t i = 0; i < n; ++i) s->order[i] = i;
  }
  s->ring.resize(depth);
  const int64_t item_bytes = item_pixels * channels;
  for (auto& slot : s->ring) {
    slot.x.resize(batch * item_bytes);
    slot.y.resize(batch);
  }
  s->worker = std::thread(worker_loop, s);
  return s;
}

// uint8 variant: raw row gather with NO host normalization — the consumer
// ships 4x fewer bytes to the device and normalizes there (bit-identical
// to the in-HBM epoch path's on-device normalize). No channel limit (no
// per-channel affine on the host).
void* ursa_stream_create_u8(
    const uint8_t* images, const int64_t* labels, int64_t n,
    int64_t item_bytes, int64_t batch, uint64_t seed, int32_t shuffle,
    int32_t depth) {
  if (batch <= 0 || n < batch || depth < 1) return nullptr;
  auto* s = new UrsaStream();
  s->images = images;
  s->labels = labels;
  s->n = n;
  s->item_pixels = item_bytes;
  s->channels = 1;
  s->batch = batch;
  s->num_batches = n / batch;
  s->u8 = true;
  s->order.resize(n);
  ursa_permutation(n, seed, s->order.data());
  if (!shuffle) {
    for (int64_t i = 0; i < n; ++i) s->order[i] = i;
  }
  s->ring.resize(depth);
  for (auto& slot : s->ring) {
    slot.x8.resize(batch * item_bytes);
    slot.y.resize(batch);
  }
  s->worker = std::thread(worker_loop, s);
  return s;
}

int64_t ursa_stream_num_batches(void* handle) {
  return static_cast<UrsaStream*>(handle)->num_batches;
}

// Block until the next batch is ready, copy it out, free the slot.
// Returns the batch index, or -1 when the epoch is exhausted.
int64_t ursa_stream_next(void* handle, float* out_x, int32_t* out_y) {
  auto* s = static_cast<UrsaStream*>(handle);
  if (s->consumed >= s->num_batches) return -1;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_produced.wait(lk, [s] { return s->produced > s->consumed; });
  }
  const int64_t depth = static_cast<int64_t>(s->ring.size());
  Slot& slot = s->ring[s->consumed % depth];
  const int64_t bi = slot.batch_index;
  std::memcpy(out_x, slot.x.data(), slot.x.size() * sizeof(float));
  std::memcpy(out_y, slot.y.data(), slot.y.size() * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->consumed++;
  }
  s->cv_space.notify_one();
  return bi;
}

// uint8-mode next(): same protocol, raw uint8 batch out.
int64_t ursa_stream_next_u8(void* handle, uint8_t* out_x, int32_t* out_y) {
  auto* s = static_cast<UrsaStream*>(handle);
  if (s->consumed >= s->num_batches) return -1;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_produced.wait(lk, [s] { return s->produced > s->consumed; });
  }
  const int64_t depth = static_cast<int64_t>(s->ring.size());
  Slot& slot = s->ring[s->consumed % depth];
  const int64_t bi = slot.batch_index;
  std::memcpy(out_x, slot.x8.data(), slot.x8.size());
  std::memcpy(out_y, slot.y.data(), slot.y.size() * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->consumed++;
  }
  s->cv_space.notify_one();
  return bi;
}

// Rewind a stream for a new epoch: fresh permutation, SAME ring buffers.
// Reusing the slots matters beyond avoiding the malloc: with the TPU PJRT
// plugin loaded, anonymous first-touch page faults run ~170x slower than
// warm pages, so re-allocating multi-MB prefetch buffers every epoch
// (create/destroy) re-pays that fault cost each time. Valid whether or not
// the previous epoch was exhausted (the worker is stopped and restarted).
void ursa_stream_reset(void* handle, uint64_t seed, int32_t shuffle) {
  auto* s = static_cast<UrsaStream*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
  }
  s->cv_space.notify_all();
  if (s->worker.joinable()) s->worker.join();
  s->stop = false;
  s->produced = 0;
  s->consumed = 0;
  ursa_permutation(s->n, seed, s->order.data());
  if (!shuffle) {
    for (int64_t i = 0; i < s->n; ++i) s->order[i] = i;
  }
  for (auto& slot : s->ring) slot.batch_index = -1;
  s->worker = std::thread(worker_loop, s);
}

void ursa_stream_destroy(void* handle) {
  auto* s = static_cast<UrsaStream*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->stop = true;
  }
  s->cv_space.notify_all();
  if (s->worker.joinable()) s->worker.join();
  delete s;
}

int32_t ursa_dataio_version() { return 4; }

}  // extern "C"
