// Native host-side data-loader runtime of the PyTorch port.
//
// The port's own copy of the JAX package's data/_native/loader.cc, with the same C ABI
// (nl_abi_version() == 1). It plays the roles of the C++ the reference leans on for input
// handling: torch's DataLoader worker pool (num_workers=4, pin_memory=True, reference
// src/train_dist.py:43-45) and torchvision's on-disk MNIST cache reader (reference
// src/train.py:26-31): parse the raw IDX files, normalize pixels, and assemble shuffled
// batches ahead of the training loop with a threaded prefetcher. Plain C++17 with a C ABI
// (ctypes), no framework and no CUDA: it runs on the host beside the card.
//
// Callers (data/mnist.py, data/loader.py) take their numpy paths, which are bit-identical,
// where this library is not built; tests hold the two paths equal bitwise.
//
// Build: data/_native/build.py next to this file (g++ -O3 -std=c++17 -shared -fPIC
// -pthread ... -lz), at first use, into csrc/_build/.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Run fn(chunk_begin, chunk_end) over [0, n) on up to max_threads threads.
void parallel_for(long long n, int max_threads,
                  const std::function<void(long long, long long)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = max_threads > 0 ? max_threads : 1;
  if (hw > 0 && static_cast<unsigned>(nt) > hw) nt = static_cast<int>(hw);
  if (nt <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  long long chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    long long b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back(fn, b, e);
  }
  for (auto& th : threads) th.join();
}

uint32_t read_be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------------------
// IDX file reading (zlib's gzopen transparently reads both .gz and plain files).
// Layout (classic LeCun IDX): u32 magic (0x00 0x08=ubyte ndim), ndim × u32 big-endian dims,
// then the payload bytes. Mirrors the Python parser in data/mnist.py:_read_idx.
// ---------------------------------------------------------------------------------------

// Parse the header: fills ndim and shape[0..ndim). Returns 0 on success, negative on error.
int nl_idx_info(const char* path, int* ndim, long long* shape) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[4];
  if (gzread(f, hdr, 4) != 4) { gzclose(f); return -2; }
  if (hdr[0] != 0 || hdr[1] != 0 || hdr[2] != 0x08) { gzclose(f); return -3; }
  int nd = hdr[3];
  if (nd < 1 || nd > 4) { gzclose(f); return -3; }
  for (int i = 0; i < nd; ++i) {
    unsigned char dim[4];
    if (gzread(f, dim, 4) != 4) { gzclose(f); return -2; }
    shape[i] = read_be32(dim);
  }
  *ndim = nd;
  gzclose(f);
  return 0;
}

// Read the payload (n bytes after the header) into out. Returns 0 on success.
int nl_idx_read(const char* path, unsigned char* out, long long n) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  unsigned char hdr[4];
  if (gzread(f, hdr, 4) != 4) { gzclose(f); return -2; }
  int nd = hdr[3];
  if (gzseek(f, 4 + 4 * nd, SEEK_SET) < 0) { gzclose(f); return -2; }
  long long got = 0;
  while (got < n) {
    int chunk = static_cast<int>(std::min<long long>(n - got, 1 << 24));
    int r = gzread(f, out + got, chunk);
    if (r <= 0) { gzclose(f); return -2; }
    got += r;
  }
  gzclose(f);
  return 0;
}

// ---------------------------------------------------------------------------------------
// Normalization: uint8 pixels -> (x/255 - mean)/std float32 (reference src/train.py:28-30),
// threaded over samples. Output layout equals input layout (the [..., 1] channel axis added
// on the Python side is a free reshape).
// ---------------------------------------------------------------------------------------

int nl_normalize(const unsigned char* src, float* dst, long long n, float mean,
                 float stddev, int num_threads) {
  if (stddev == 0.0f) return -1;
  // Same operation order as the numpy path (x/255, -mean, /std) for bit-exact parity.
  parallel_for(n, num_threads, [&](long long b, long long e) {
    for (long long i = b; i < e; ++i)
      dst[i] = (float(src[i]) / 255.0f - mean) / stddev;
  });
  return 0;
}

// ---------------------------------------------------------------------------------------
// Batch gather: out[i] = images[idx[i]] — the DataLoader worker's per-batch job once
// transforms are pre-applied. Threaded over batch rows.
// ---------------------------------------------------------------------------------------

int nl_gather_f32(const float* images, long long n_images, long long sample_elems,
                  const int* idx, long long batch, float* out, int num_threads) {
  std::atomic<int> bad{0};
  parallel_for(batch, num_threads, [&](long long b, long long e) {
    for (long long i = b; i < e; ++i) {
      long long j = idx[i];
      if (j < 0 || j >= n_images) { bad.store(1); continue; }
      std::memcpy(out + i * sample_elems, images + j * sample_elems,
                  sizeof(float) * sample_elems);
    }
  });
  return bad.load() ? -1 : 0;
}

int nl_gather_i32(const int* labels, long long n, const int* idx, long long batch,
                  int* out) {
  for (long long i = 0; i < batch; ++i) {
    long long j = idx[i];
    if (j < 0 || j >= n) return -1;
    out[i] = labels[j];
  }
  return 0;
}

// ---------------------------------------------------------------------------------------
// Threaded batch prefetcher — the worker-pool analog (num_workers, prefetching queue).
// Workers claim steps of a [steps, batch] index plan, gather image/label batches into a
// bounded ring of slots; the consumer drains slots in step order.
// ---------------------------------------------------------------------------------------

namespace {

enum SlotState { kFree = 0, kFilling = 1, kReady = 2 };

struct Prefetcher {
  const float* images;
  const int* labels;
  long long n_examples, sample_elems, steps, batch;
  std::vector<int> plan;  // owned copy: [steps * batch]

  int capacity;
  std::vector<std::vector<float>> img_slots;
  std::vector<std::vector<int>> lab_slots;
  std::vector<int> state;           // SlotState per slot
  std::vector<long long> slot_step; // step id occupying the slot
  long long next_consume = 0;
  std::atomic<long long> next_claim{0};
  std::atomic<int> error{0};
  std::atomic<bool> stopping{false};
  std::mutex m;
  std::condition_variable cv_free, cv_ready;
  std::vector<std::thread> workers;

  void worker_loop() {
    for (;;) {
      long long s = next_claim.fetch_add(1);
      if (s >= steps || stopping) return;
      int slot = static_cast<int>(s % capacity);
      {
        std::unique_lock<std::mutex> lk(m);
        cv_free.wait(lk, [&] {
          return stopping || (state[slot] == kFree && s - next_consume <
                              static_cast<long long>(capacity));
        });
        if (stopping) return;
        state[slot] = kFilling;
        slot_step[slot] = s;
      }
      const int* idx = plan.data() + s * batch;
      float* img_out = img_slots[slot].data();
      int* lab_out = lab_slots[slot].data();
      for (long long i = 0; i < batch; ++i) {
        long long j = idx[i];
        if (j < 0 || j >= n_examples) { error.store(1); j = 0; }
        std::memcpy(img_out + i * sample_elems, images + j * sample_elems,
                    sizeof(float) * sample_elems);
        lab_out[i] = labels[j];
      }
      {
        std::lock_guard<std::mutex> lk(m);
        state[slot] = kReady;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

void* nl_prefetcher_create(const float* images, const int* labels, long long n_examples,
                           long long sample_elems, const int* plan, long long steps,
                           long long batch, int num_workers, int capacity) {
  if (steps <= 0 || batch <= 0 || capacity <= 0 || num_workers <= 0) return nullptr;
  auto* p = new Prefetcher();
  p->images = images;
  p->labels = labels;
  p->n_examples = n_examples;
  p->sample_elems = sample_elems;
  p->steps = steps;
  p->batch = batch;
  p->plan.assign(plan, plan + steps * batch);
  p->capacity = capacity;
  p->img_slots.assign(capacity, std::vector<float>(batch * sample_elems));
  p->lab_slots.assign(capacity, std::vector<int>(batch));
  p->state.assign(capacity, kFree);
  p->slot_step.assign(capacity, -1);
  for (int w = 0; w < num_workers; ++w)
    p->workers.emplace_back(&Prefetcher::worker_loop, p);
  return p;
}

// Copy the next batch (in step order) into out buffers. Returns the step index, -1 when the
// plan is exhausted, -2 on an out-of-range index in the plan.
long long nl_prefetcher_next(void* handle, float* out_images, int* out_labels) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (p->next_consume >= p->steps) return -1;
  long long s = p->next_consume;
  int slot = static_cast<int>(s % p->capacity);
  {
    std::unique_lock<std::mutex> lk(p->m);
    p->cv_ready.wait(lk, [&] { return p->state[slot] == kReady && p->slot_step[slot] == s; });
  }
  std::memcpy(out_images, p->img_slots[slot].data(),
              sizeof(float) * p->batch * p->sample_elems);
  std::memcpy(out_labels, p->lab_slots[slot].data(), sizeof(int) * p->batch);
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->state[slot] = kFree;
    p->slot_step[slot] = -1;
    p->next_consume = s + 1;
  }
  p->cv_free.notify_all();
  return p->error.load() ? -2 : s;
}

void nl_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->m);
    p->stopping = true;
  }
  p->cv_free.notify_all();
  p->next_claim.store(p->steps);  // stop claimers that haven't checked stopping yet
  for (auto& w : p->workers) w.join();
  delete p;
}

int nl_abi_version() { return 1; }

}  // extern "C"
