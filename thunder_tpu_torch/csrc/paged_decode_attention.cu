// Ragged T == 1 grouped-query attention over a paged KV cache.
//
// q (B, H, 1, hd); k/v pools (KV, P, ps, hd); block_tables (B, npg) int32
// page ids; lengths (B,) int32 context lengths including this step's row.
// Query head h reads kv head h / (H / KV). Out (B, H, 1, hd) in q's type.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_paged_decode_attention
// (:1316), whose body is _paged_decode_kernel (:1272). There the TPU walks a
// sequential page grid with the block tables as scalar-prefetch operands,
// one online-softmax step per page; here the context is split across blocks
// and each block reads its own block-table entries.
//
// Bound on an H100: bytes. Every valid context row is read once from each
// pool (2 * KV * hd values per token per layer: 4 KB at KV = 8, hd = 128,
// bf16; 30.4 MB over the serving mix's 7425 tokens, 9.1 us at 3.35 TB/s)
// against 4 * G * hd operations per token per kv head, ~1 operation per
// byte, far below the 295 where the tensor cores would matter: f32 FMAs do
// the arithmetic, and the gain has to come from loads in flight.
//
// Design: split-context decoding, two launches, on attn_chunk.cuh's
// routines (which the decode layer's attention phases share).
//   chunk kernel: one block of 256 threads per (request, kv head, chunk of
//     C keys), the grid sized from the host-known page count; a block whose
//     chunk starts at or past lengths[b] exits at once (lengths stay on the
//     card: the wrapper never reads them). The block holds the G = H / KV
//     grouped query rows, so each K/V row is read from device memory once
//     for all G heads. It has every K and V row of its chunk in flight at
//     once (64 KB at bf16, hd 128, C = 128), scores and softmaxes in f32
//     and writes the chunk's (m, l, acc) in f32 to a workspace. Three
//     blocks fit on an SM, so one block's arithmetic overlaps the others'
//     loads.
//   combine kernel: one block per (request, kv head) merges that request's
//     chunks in chunk order, so two calls are bit-identical; a request of
//     length 0 has no chunk and gets zeros (the reference's lsafe). Lengths
//     past the block table's npg * ps keys attend those keys, as the plain
//     version does.
// C is a power of two (at most 256 keys) chosen by the wrapper
// (cudaex.paged_geometry) so that the block's shared memory (K and V
// chunks, the f32 query rows and scores, its block-table entries) stays
// within 72 KB (three blocks an SM): 128 keys at
// bf16/fp16 and hd 128, 64 at float32. The probabilities are not rounded
// before the PV product (the port's plain version, the reference's nn
// decomposition, does not round them; its Pallas body does). Rows of
// 16-byte multiples (hd * sizeof(T) % 16 == 0) are copied by cp.async, any
// other head dim by scalar copies.
#include "attn_chunk.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                   const T* __restrict__ vpool, const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, float* __restrict__ part, int H, int KV,
                   int P, int ps, int hd, int npg, int C, int nch, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(lengths[b], npg * ps), kbeg = c * C;
  if (kbeg >= len) return;   // past the context: the merge reads no such chunk
  const int G = H / KV;
  const size_t pool0 = static_cast<size_t>(kvh) * P * ps * hd;
  tt::chunk::run<T, THREADS, false>(
      q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd, kpool + pool0,
      vpool + pool0, block_tables + static_cast<size_t>(b) * npg, kbeg, min(C, len - kbeg), ps,
      hd, G, C, scale, -1, nullptr, nullptr, smem,
      part + ((static_cast<size_t>(b) * KV + kvh) * nch + c) * G * (2 + hd), threadIdx.x,
      tt::chunk::BlockSync{});
}

// one block per (kv head, request): the request's chunks merged in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                     T* __restrict__ out, int H, int KV, int hd, int C, int nch, int keys) {
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KV;
  const int len = min(lengths[b], keys);
  tt::chunk::merge<T, THREADS>(
      part + (static_cast<size_t>(b) * KV + kvh) * nch * G * (2 + hd),
      len > 0 ? (len + C - 1) / C : 0, G, hd,
      out + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* ln,
           void* out, float* part, int B, int H, int KV, int P, int ps, int hd, int npg, int C,
           int nch, float scale, int device, cudaStream_t stream) {
  if (nch > 0) {
    // the kernel's shared-memory attributes, set once a device for the
    // largest size asked so far (a decode step calls this once a layer: no
    // host call to spare); shared memory rather than L1, three chunk blocks
    // an SM
    static int smem_set[64] = {};
    if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    const int smem = static_cast<int>(tt::chunk::smem_bytes(H / KV, hd, C, sizeof(T), THREADS));
    cudaError_t e = cudaSuccess;
    if (smem > smem_set[device]) {
      e = cudaFuncSetAttribute(paged_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(paged_chunk_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set[device] = smem;
    }
    paged_chunk_kernel<T><<<dim3(nch, KV, B), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, ln,
        part, H, KV, P, ps, hd, npg, C, nch, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_combine_kernel<T><<<dim3(KV, B), THREADS, 0, stream>>>(part, ln, static_cast<T*>(out),
                                                                H, KV, hd, C, nch, npg * ps);
  return 0;
}

}  // namespace

// C: keys per chunk, a multiple of 4; nch = ceil(npg * ps / C); part: the
// (B, KV, nch, G, 2 + hd) float32 workspace (cudaex.paged_geometry).
extern "C" int tt_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const void* block_tables, const void* lengths,
                                         void* out, void* part, int B, int H, int KV, int P,
                                         int ps, int hd, int npg, int C, int nch, float scale,
                                         int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (C < 4 || C % 4 || static_cast<long long>(nch) * C < static_cast<long long>(npg) * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    const auto* bt = static_cast<const int*>(block_tables);
    const auto* ln = static_cast<const int*>(lengths);
    int rc = 0;
    const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
      rc = launch<decltype(tag)>(q, kp, vp, bt, ln, out, static_cast<float*>(part), B, H, KV, P,
                                 ps, hd, npg, C, nch, scale, device, s);
      return cudaSuccess;
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
