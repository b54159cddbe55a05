// Native input pipeline of thunder_tpu_torch: memory-mapped token files,
// random OR epoch-exact shuffled sampling, multi-host sharding, and a
// background prefetch thread.
//
// The port's own copy of the JAX package's loader (native/dataloader.cpp),
// with the same C entry points and the same bits: thunder_tpu_torch/data.py
// binds it via ctypes (the GIL is released around foreign calls) and builds
// it with g++ into thunder_tpu_torch/_build/ at first use. Design points:
//
// - ttdata_sample_batch: i.i.d. random windows, counter-based splitmix RNG
//   (deterministic per (seed, step, row)) — the round-2 API, kept.
// - ttdata_epoch_batch: EPOCH-EXACT shuffling. The shard is partitioned
//   into non-overlapping (T+1)-token windows visited in a Feistel-cipher
//   permutation of [0, n_windows): a full shuffle with O(1) state — no
//   shuffle buffer, bit-deterministic in (seed, step) alone, so elastic
//   replay (data_fn(step)) is exact across restarts, and each epoch
//   re-shuffles (the permutation is keyed on the epoch number).
//   Multi-host sharding is positional: host h of H draws global sample
//   index G = step*B*H + h*B + i, so hosts' windows are disjoint by
//   construction and their union covers every epoch exactly once.
// - ttdata_prefetch_submit/wait: one background std::thread per handle
//   fills the NEXT batch while the accelerator step runs.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libttdata.so dataloader.cpp
// (thunder_tpu_torch.data.build_native runs it).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Handle {
  void* base = nullptr;
  size_t bytes = 0;
  int dtype_bytes = 2;  // uint16 tokens by default
  // prefetch state (one outstanding batch)
  std::thread worker;
  std::vector<uint32_t> prefetch_buf;
  uint64_t prefetch_tag = ~0ull;  // (step<<1 | mode) of the buffered batch
  int prefetch_rc = -1;
  bool worker_live = false;
};

inline uint64_t mix(uint64_t x) {
  // splitmix64: counter-based, reproducible across platforms
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Feistel permutation of [0, n): 4 rounds over the next power-of-4 domain
// with cycle-walking. Mirrored bit-exactly by the plain Python version in
// thunder_tpu_torch/data.py — change BOTH together.
inline uint64_t feistel_perm(uint64_t idx, uint64_t n, uint64_t key) {
  int bits = 1;
  while ((1ull << bits) < n) ++bits;
  const int hb = (bits + 1) / 2;
  const uint64_t hmask = (1ull << hb) - 1;
  uint64_t x = idx;
  do {
    uint64_t l = x >> hb, r = x & hmask;
    for (int round = 0; round < 4; ++round) {
      const uint64_t f = mix(r ^ key ^ (static_cast<uint64_t>(round) * 0xA5A5A5A5ull)) & hmask;
      const uint64_t nl = r;
      r = (l ^ f) & hmask;
      l = nl;
    }
    x = (l << (hb)) | r;
    // swap halves each walk iteration is unnecessary; just re-walk
  } while (x >= n);
  return x;
}

void copy_window(const Handle* h, long long start, long long window, uint32_t* dst) {
  if (h->dtype_bytes == 2) {
    const uint16_t* src = static_cast<const uint16_t*>(h->base) + start;
    for (long long j = 0; j < window; ++j) dst[j] = src[j];
  } else {
    const uint32_t* src = static_cast<const uint32_t*>(h->base) + start;
    memcpy(dst, src, window * sizeof(uint32_t));
  }
}

}  // namespace

extern "C" {

void* ttdata_open(const char* path, int dtype_bytes) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) return nullptr;
  madvise(base, st.st_size, MADV_RANDOM);
  Handle* h = new Handle();
  h->base = base;
  h->bytes = static_cast<size_t>(st.st_size);
  h->dtype_bytes = dtype_bytes;
  return h;
}

void ttdata_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (h == nullptr) return;
  if (h->worker_live) {
    h->worker.join();
    h->worker_live = false;
  }
  munmap(h->base, h->bytes);
  delete h;
}

long long ttdata_num_tokens(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  return static_cast<long long>(h->bytes / h->dtype_bytes);
}

// Fill out[B * (T+1)] with B random contiguous windows of T+1 tokens.
// Deterministic in (seed, step): row i uses counter seed^step^i.
int ttdata_sample_batch(void* handle, uint64_t seed, uint64_t step, int B, int T,
                        uint32_t* out) {
  Handle* h = static_cast<Handle*>(handle);
  const long long n = ttdata_num_tokens(h);
  const long long window = static_cast<long long>(T) + 1;
  if (n < window) return -1;
  for (int i = 0; i < B; ++i) {
    uint64_t r = mix(mix(seed ^ (step * 0x51ED2701u)) ^ static_cast<uint64_t>(i));
    long long start = static_cast<long long>(r % static_cast<uint64_t>(n - window + 1));
    uint32_t* dst = out + static_cast<size_t>(i) * window;
    if (h->dtype_bytes == 2) {
      const uint16_t* src = static_cast<const uint16_t*>(h->base) + start;
      for (long long j = 0; j < window; ++j) dst[j] = src[j];
    } else {
      const uint32_t* src = static_cast<const uint32_t*>(h->base) + start;
      memcpy(dst, src, window * sizeof(uint32_t));
    }
  }
  return 0;
}

long long ttdata_num_windows(void* handle, int T) {
  Handle* h = static_cast<Handle*>(handle);
  return ttdata_num_tokens(h) / (static_cast<long long>(T) + 1);
}

// Epoch-exact shuffled batch for host `host` of `n_hosts` (see header
// comment). Deterministic in (seed, step) alone; epochs auto-advance and
// re-shuffle. Returns the epoch of the batch's FIRST sample, or -1 on error.
long long ttdata_epoch_batch(void* handle, uint64_t seed, uint64_t step, int B,
                             int T, int host, int n_hosts, uint32_t* out) {
  Handle* h = static_cast<Handle*>(handle);
  const long long window = static_cast<long long>(T) + 1;
  const uint64_t n_windows = static_cast<uint64_t>(ttdata_num_windows(h, T));
  if (n_windows == 0 || host < 0 || host >= n_hosts) return -1;
  long long first_epoch = -1;
  for (int i = 0; i < B; ++i) {
    const uint64_t G = step * static_cast<uint64_t>(B) * n_hosts
        + static_cast<uint64_t>(host) * B + i;
    const uint64_t epoch = G / n_windows;
    const uint64_t pos = G % n_windows;
    const uint64_t w = feistel_perm(pos, n_windows, mix(seed ^ mix(epoch)));
    if (i == 0) first_epoch = static_cast<long long>(epoch);
    copy_window(h, static_cast<long long>(w) * window, window,
                out + static_cast<size_t>(i) * window);
  }
  return first_epoch;
}

// -- background prefetch (one outstanding batch per handle) -----------------

int ttdata_prefetch_submit(void* handle, uint64_t seed, uint64_t step, int B,
                           int T, int host, int n_hosts, int epoch_mode) {
  Handle* h = static_cast<Handle*>(handle);
  if (h->worker_live) h->worker.join();
  h->prefetch_buf.resize(static_cast<size_t>(B) * (T + 1));
  h->prefetch_tag = (step << 1) | static_cast<uint64_t>(epoch_mode & 1);
  h->worker = std::thread([h, seed, step, B, T, host, n_hosts, epoch_mode]() {
    if (epoch_mode) {
      h->prefetch_rc = ttdata_epoch_batch(h, seed, step, B, T, host, n_hosts,
                                          h->prefetch_buf.data()) >= 0 ? 0 : -1;
    } else {
      h->prefetch_rc = ttdata_sample_batch(h, seed, step, B, T,
                                           h->prefetch_buf.data());
    }
  });
  h->worker_live = true;
  return 0;
}

// Collect a previously submitted prefetch. Returns 0 and fills `out` when
// the buffered batch matches (step, epoch_mode); -2 when no matching batch
// is buffered (caller falls back to a synchronous fill); the fill's rc
// otherwise.
int ttdata_prefetch_wait(void* handle, uint64_t step, int epoch_mode,
                         uint32_t* out) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h->worker_live) return -2;
  h->worker.join();
  h->worker_live = false;
  const uint64_t tag = (step << 1) | static_cast<uint64_t>(epoch_mode & 1);
  if (h->prefetch_tag != tag) return -2;
  if (h->prefetch_rc == 0) {
    memcpy(out, h->prefetch_buf.data(),
           h->prefetch_buf.size() * sizeof(uint32_t));
  }
  return h->prefetch_rc;
}

}  // extern "C"
