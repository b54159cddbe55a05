// Ragged T == 1 grouped-query attention over a paged KV cache.
//
// q (B, H, 1, hd); k/v pools (KV, P, ps, hd); block_tables (B, npg) int32
// page ids; lengths (B,) int32 context lengths including this step's row.
// Query head h reads kv head h / (H / KV). Out (B, H, 1, hd) in q's type.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_paged_decode_attention
// (:1316), whose body is _paged_decode_kernel (:1272). There the TPU walks a
// sequential page grid with the block tables as scalar-prefetch operands;
// here each block walks its own request's pages in a loop and reads the
// block table itself, only for pages p < ceil(len / ps).
//
// Bound on an H100: bytes. Every valid context row is read once from each
// pool (2 * KV * hd values per token per layer: 4 KB at KV = 8, hd = 128,
// bf16) against 4 * G * hd operations per token per kv head, ~1 operation
// per byte, far below the tensor cores' 295.
//
// Design (first version): one block of 256 threads per (request, kv head),
// holding the G = H / KV grouped query rows, so each K/V page is read from
// device memory once for all G heads that share it. Each page (ps x hd) of K
// and V is staged in shared memory as f32; a warp computes each (row, key)
// score with lanes across hd; G threads run the online softmax (running max
// m, sum l, rescale a) in f32; threads across (row, hd) keep the f32
// accumulators in registers. Columns at or past len inside the last page are
// masked. Pages are loaded one at a time without double-buffering, and only
// B * KV blocks run (64 at 8 requests x 8 kv heads, on 132 SMs): splitting the
// context across blocks and overlapping the next page's load are the later
// work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXR = 8;   // accumulators per thread: G * hd <= MAXR * THREADS

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV, int P,
                    int ps, int hd, int npg, float scale) {
  extern __shared__ float sm[];
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  float* qs = sm;              // G * hd   grouped query rows
  float* ks = qs + G * hd;     // ps * hd  staged K page
  float* vs = ks + ps * hd;    // ps * hd  staged V page
  float* ss = vs + ps * hd;    // G * ps   scores, then probabilities
  float* mrow = ss + G * ps;   // G        running max
  float* lrow = mrow + G;      // G        running sum
  float* arow = lrow + G;      // G        rescale of this page

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = THREADS >> 5;
  const size_t row0 = (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = tt::to_f(q[row0 + i]);
  if (tid < G) {
    mrow[tid] = -INFINITY;
    lrow[tid] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  const int len = lengths[b];
  const int n_pages = len > 0 ? (len + ps - 1) / ps : 0;
  for (int p = 0; p < n_pages; ++p) {
    const size_t page = static_cast<size_t>(block_tables[static_cast<size_t>(b) * npg + p]);
    const size_t base = ((static_cast<size_t>(kvh) * P + page) * ps) * hd;
    __syncthreads();   // the previous page's ks/vs/ss/arow are no longer read
    for (int i = tid; i < ps * hd; i += THREADS) {
      ks[i] = tt::to_f(kpool[base + i]);
      vs[i] = tt::to_f(vpool[base + i]);
    }
    __syncthreads();
    for (int pr = warp; pr < G * ps; pr += nwarps) {
      const int g = pr / ps, j = pr % ps;
      float d = 0.f;
      for (int e = lane; e < hd; e += 32) d += qs[g * hd + e] * ks[j * hd + e];
      d = tt::warp_sum(d);
      if (lane == 0) ss[pr] = (p * ps + j < len) ? d * scale : -INFINITY;
    }
    __syncthreads();
    if (tid < G) {
      float* s = ss + tid * ps;
      const float m_old = mrow[tid];
      float m_new = m_old;
      for (int j = 0; j < ps; ++j) m_new = fmaxf(m_new, s[j]);
      const bool empty = (m_new == -INFINITY);
      const float a = empty ? 1.f : expf(m_old - m_new);
      float l = lrow[tid] * a;
      for (int j = 0; j < ps; ++j) {
        const float e = empty ? 0.f : expf(s[j] - m_new);
        s[j] = e;
        l += e;
      }
      mrow[tid] = m_new;
      lrow[tid] = l;
      arow[tid] = a;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int i = tid + r * THREADS;
      if (i < G * hd) {
        const int g = i / hd, e = i % hd;
        float s = acc[r] * arow[g];
        const float* pg = ss + g * ps;
        for (int j = 0; j < ps; ++j) s += pg[j] * vs[j * hd + e];
        acc[r] = s;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int i = tid + r * THREADS;
    if (i < G * hd) {
      const float l = lrow[i / hd];
      out[row0 + i] = tt::from_f<T>(acc[r] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* ln,
           void* out, int B, int H, int KV, int P, int ps, int hd, int npg, float scale,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_decode_kernel<T><<<B * KV, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, ln,
      static_cast<T*>(out), H, KV, P, ps, hd, npg, scale);
  return 0;
}

}  // namespace

extern "C" int tt_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const void* block_tables, const void* lengths,
                                         void* out, int B, int H, int KV, int P, int ps, int hd,
                                         int npg, float scale, int dtype, int device,
                                         void* stream) {
  cudaSetDevice(device);
  if (B > 0) {
    const int G = H / KV;
    const size_t smem = sizeof(float) * (static_cast<size_t>(G) * hd + 2u * ps * hd +
                                         static_cast<size_t>(G) * ps + 3u * G);
    auto s = static_cast<cudaStream_t>(stream);
    const auto* bt = static_cast<const int*>(block_tables);
    const auto* ln = static_cast<const int*>(lengths);
    int rc = 0;
    const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
      rc = launch<decltype(tag)>(q, kp, vp, bt, ln, out, B, H, KV, P, ps, hd, npg, scale, smem,
                                 s);
      return cudaSuccess;
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
