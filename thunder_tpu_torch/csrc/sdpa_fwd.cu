// Flash-attention forward: out = softmax(q k^T * scale [causal]) v and the row
// logsumexp lse, the flash-attention forward contract.
//
// q (BH, T, hd), k and v (BH, S, hd), contiguous, the same batch*heads; out
// (BH, T, hd) in q's type, lse (BH, T) f32. Causal masking is top-left
// aligned: row r attends columns c <= r (ops.tril_mask(T, S, 0)).
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_sdpa_fwd (:214), whose
// bodies are _sdpa_kernel (:98) and _sdpa_kernel_causal_resident (:173).
// Arithmetic follows them: scores and the online-softmax state (running max
// m, sum l, accumulator) in f32; P is rounded to the input type before the PV
// product (:139), while l sums the unrounded f32 P; rows whose l is 0 divide
// by 1 (lsafe, :147); lse = m + log(lsafe), in natural-log units.
//
// Bound on an H100: operations. At the train path's shape (8, 32, 2048, 128)
// bf16 causal the two products need 4 * BH * T * S * hd / 2 = 275 GFLOP,
// 0.278 ms at 989 TFLOP/s, against 0.16 ms for its 537 MB of bytes. Only
// wgmma reaches the tensor cores' full rate on this card, and the products
// must not wait for their tiles.
//
// Three designs, chosen by the wrapper (cudaex.sdpa_fwd_design) from the
// dtype and the head dim alone and passed in as `design`:
//
// wgmma (bf16 or fp16, hd 64 and 128: llama3-8b's and the TPU checker's head
//   dims; the instructions' .bf16 or .f16 form).
//   A block of three warpgroups owns a 128-row q tile of one batch*head and
//   walks 128-row kv tiles. Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 40) and one thread issues TMA loads, Q once and K
//   and V into a 2-stage ring, each stage with a full barrier for K, one for
//   V and an empty barrier the consumers release. Warpgroups 1 and 2 (setmaxnreg
//   232) each own 64 q rows: S = Q K^T as wgmma m64n128k16 with both operands
//   read from 128-byte-swizzled shared memory (K-major); the online softmax
//   on the f32 accumulator in registers, in base 2 with scale*log2(e) folded
//   into one multiply; P rounded to the input type in registers, where the accumulator
//   layout of two neighbouring 8-column groups is the A fragment of the next
//   wgmma; O += P V as wgmma m64n{hd}k16 with A from registers and V read
//   MN-major from shared memory as stored (the transpose bit). The TMA maps
//   are 3-D over (hd, rows, BH), so a tile past the end of a head's rows is
//   zero-filled by the hardware and never reads the next head's rows; the
//   128-byte swizzle makes a box 64 columns wide, so hd 128 takes two boxes.
//   Causal: the kv loop stops at the diagonal, the mask is applied only on
//   tiles that cross it or pass the ragged end S, and q tiles are launched
//   heaviest first across the whole grid. Shared memory at hd 128: Q 32 KB +
//   2 x (K 32 KB + V 32 KB) = 160 KB, one block per SM. What is left for
//   later: overlapping one tile's softmax with the next tile's QK^T inside a
//   warpgroup (FA3's ping-pong), a persistent grid, fp8.
//
// mma (bf16 or fp16, other head dims: multiples of 16 up to 256, the first
//   version; a head dim off the multiples of 16 is zero-padded by the wrapper,
//   cudaex.sdpa_fwd): one block of 4 warps owns a
//   64-row q tile and loops over 64-row kv tiles staged in shared memory with
//   16-byte loads; QK^T and PV on mma.sync m16n8k16 with the softmax state in
//   the fragments. Loads and products do not overlap.
//
// fma (float32, head dims up to 256): a plain FMA kernel, one thread per q row.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block (16 per warp)
constexpr int BKV = 64;   // kv rows per tile
constexpr int THREADS = 128;

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
sdpa_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, float* __restrict__ lse, int Tq, int S, float scale,
             int causal) {
  constexpr int LD = HD + 8;   // 16-bit row stride in shared memory (conflict-free fragments)
  constexpr int NT = HD / 8;   // 8-column tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BKV * LD;

  const int n_qt = (Tq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);   // heaviest first
  const size_t bh = blockIdx.x / n_qt;
  const int q0 = qt * BQ;
  const T* qb = q + bh * Tq * HD;
  const T* kb = k + bh * S * HD;
  const T* vb = v + bh * S * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;                  // the warp's first row in the tile
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  tt::stage_rows<HD>(Qs, LD, qb, q0, BQ, Tq);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();   // every warp is done with the previous K/V tile
    tt::stage_rows<HD>(Ks, LD, kb, kv0, BKV, S);
    tt::stage_rows<HD>(Vs, LD, vb, kv0, BKV, S);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 columns
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      tt::load_a(a, Qs, LD, wr, kk);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const T* kp = Ks + (j * 8 + g) * LD + kk + 2 * t;
        tt::mma16<T>(s[j], a, tt::ld_pair(kp), tt::ld_pair(kp + 8));
      }
    }

    // scale, mask, online softmax; a row's 64 columns live in the 4 threads of a quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (col >= S || (causal && col > row[e >> 1])) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far stays at p = 0
      alpha[r] = expf(m[r] - base[r]);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - base[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V, P rounded to T; V is (kv, d) row-major, read down a column
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = tt::pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = tt::pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = tt::pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = tt::pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* vp = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* c = vp + n * 8;
        tt::mma16<T>(acc[n], a, tt::pack2<T>(c[0], c[LD]), tt::pack2<T>(c[8 * LD], c[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Tq) continue;
    const float lsafe = l[r] == 0.f ? 1.f : l[r];
    T* orow = out + (bh * Tq + row[r]) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          tt::pack2<T>(acc[n][2 * r] / lsafe, acc[n][2 * r + 1] / lsafe);
    if (t == 0) lse[bh * Tq + row[r]] = m[r] + logf(lsafe);
  }
}

// float32: one thread per q row, the online softmax over every allowed key.
__global__ void __launch_bounds__(64)
sdpa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
             int T, int S, int hd, float scale, int causal) {
  const int n_qt = (T + 63) / 64;
  const size_t bh = blockIdx.x / n_qt;
  const int r = (blockIdx.x % n_qt) * 64 + threadIdx.x;
  if (r >= T) return;
  const float* qr = q + (bh * T + r) * hd;
  const float* kb = k + bh * S * hd;
  const float* vb = v + bh * S * hd;
  float acc[256];
  for (int d = 0; d < hd; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int end = causal ? min(S, r + 1) : S;
  for (int c = 0; c < end; ++c) {
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s += qr[d] * kb[static_cast<size_t>(c) * hd + d];
    s *= scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    for (int d = 0; d < hd; ++d) acc[d] = acc[d] * alpha + p * vb[static_cast<size_t>(c) * hd + d];
    m = m_new;
  }
  const float lsafe = l == 0.f ? 1.f : l;
  for (int d = 0; d < hd; ++d) out[(bh * T + r) * hd + d] = acc[d] / lsafe;
  lse[bh * T + r] = m + logf(lsafe);
}

// ---------------------------------------------------------------------------
// The wgmma design, on the Hopper primitives of hopper.cuh.
// ---------------------------------------------------------------------------

using namespace tt::hopper;

constexpr int WG_BQ = 128;          // q rows per block, 64 per consumer warpgroup
constexpr int WG_BKV = 128;         // kv rows per tile
constexpr int WG_STAGES = 2;        // K/V ring depth
constexpr int WG_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int BOX_COLS = 64;        // 16-bit columns of one 128-byte-swizzled TMA box
constexpr int BOX_BYTES = 128 * 128;  // one box: 128 rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.69314718055994531f;

// byte offsets in the block's shared memory (1024-aligned tiles)
template <int HD>
struct WgLayout {
  static constexpr int TILE = WG_BQ * HD * 2;   // a Q, K or V tile: HD / 64 boxes
  static constexpr int Q = 0;
  static constexpr int K = TILE;                // + stage * TILE
  static constexpr int V = K + WG_STAGES * TILE;
  static constexpr int BAR = V + WG_STAGES * TILE;   // q_full, k_full[], v_full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * WG_STAGES) + 1024;   // + alignment slack
};

template <typename TE, int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
sdpa_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, TE* __restrict__ out,
               float* __restrict__ lse, int BH, int T, int S, float scale_log2, int causal) {
  static_assert(HD == 64 || HD == 128, "the wgmma design takes head dims 64 and 128");
  using L = WgLayout<HD>;
  constexpr int BOXES = HD / BOX_COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle pattern repeats every 1024 bytes: tiles start on it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto v_full = [&](int s) { return q_full + 8 * (1 + WG_STAGES + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + 2 * WG_STAGES + s); };

  const int n_qt = (T + WG_BQ - 1) / WG_BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);   // heaviest tiles first
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = qt * WG_BQ;
  const int kv_end = causal ? min(S, q0 + WG_BQ) : S;
  const int n_kv = (kv_end + WG_BKV - 1) / WG_BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);   // every consumer thread releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::TILE);
      for (int b = 0; b < BOXES; ++b)
        tma_load_3d(base + L::Q + b * BOX_BYTES, &tq, q_full, b * BOX_COLS, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % WG_STAGES;
        if (j >= WG_STAGES) mbar_wait(empty(s), ((j / WG_STAGES) - 1) & 1);
        mbar_expect_tx(k_full(s), L::TILE);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(base + L::K + s * L::TILE + b * BOX_BYTES, &tk, k_full(s), b * BOX_COLS,
                      j * WG_BKV, bh);
        mbar_expect_tx(v_full(s), L::TILE);
        for (int b = 0; b < BOXES; ++b)
          tma_load_3d(base + L::V + s * L::TILE + b * BOX_BYTES, &tv, v_full(s), b * BOX_COLS,
                      j * WG_BKV, bh);
      }
    }
  } else {
    // consumers: warpgroup c owns q rows [q0 + 64 c, q0 + 64 c + 64)
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + 64 * c + 16 * warp + g;   // the thread's rows: row0, row0 + 8
    const uint32_t q_rows = base + L::Q + 64 * c * 128;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // running max in base-2 units; l is this thread's share of the row sum,
    // summed over the quad at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % WG_STAGES;
      const uint32_t ph = (j / WG_STAGES) & 1;
      const int kv0 = j * WG_BKV;
      const uint32_t k_tile = base + L::K + s * L::TILE, v_tile = base + L::V + s * L::TILE;

      // S = Q K^T: 64 x 128, f32
      float sc[64];
      mbar_wait(k_full(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
        wgmma_ss<TE, 0, 0>(sc, desc_sw128(q_rows + off, 16, 1024),
                           desc_sw128(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax in base 2; the mask only where the tile crosses the
      // diagonal or the ragged end S
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      if (kv0 + WG_BKV > S || (causal && kv0 + WG_BKV - 1 > q0 + 64 * c)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = kv0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col >= S || (causal && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        mb[r] = m_new == -INFINITY ? 0.f : m_new;   // a row masked so far stays at p = 0
        alpha[r] = exp2f(m[r] - mb[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = exp2f(sc[i] - mb[(i >> 1) & 1]);
        sc[i] = p;
        l[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P rounded to TE: two neighbouring 8-column groups of the
      // accumulator are one A fragment of the PV product
      uint32_t pa[WG_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < WG_BKV / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = tt::pack2<TE>(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      // O += P V, V MN-major as stored
      mbar_wait(v_full(s), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BKV / 16; ++kk)
        wgmma_rs<TE, 1>(o, pa[kk], desc_sw128(v_tile + kk * 16 * 128, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= T) continue;
      const float lsafe = l[r] == 0.f ? 1.f : l[r];
      TE* orow = out + (static_cast<size_t>(bh) * T + row) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            tt::pack2<TE>(o[4 * n + 2 * r] / lsafe, o[4 * n + 2 * r + 1] / lsafe);
      if (t == 0) lse[static_cast<size_t>(bh) * T + row] = m[r] * kLn2 + logf(lsafe);
    }
  }
}

template <typename TE, int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int T, int S, float scale, int causal, cudaStream_t s) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!map_heads<TE>(&tq, q, BH, T, HD, 128) || !map_heads<TE>(&tk, k, BH, S, HD, 128) ||
      !map_heads<TE>(&tv, v, BH, S, HD, 128))
    return cudaErrorInvalidValue;
  constexpr int smem = WgLayout<HD>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      sdpa_fwd_wgmma<TE, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BH) * ((T + WG_BQ - 1) / WG_BQ);
  sdpa_fwd_wgmma<TE, HD><<<blocks, WG_THREADS, smem, s>>>(
      tq, tk, tv, static_cast<TE*>(out), static_cast<float*>(lse), BH, T, S,
      scale * kLog2e, causal);
  return cudaSuccess;
}

template <typename TE, int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                       int T, int S, float scale, int causal, cudaStream_t s) {
  const int smem = (BQ + 2 * BKV) * (HD + 8) * static_cast<int>(sizeof(TE));
  cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_mma<TE, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BH) * ((T + BQ - 1) / BQ);
  sdpa_fwd_mma<TE, HD><<<blocks, THREADS, smem, s>>>(
      static_cast<const TE*>(q), static_cast<const TE*>(k), static_cast<const TE*>(v),
      static_cast<TE*>(out), static_cast<float*>(lse), T, S, scale, causal);
  return cudaSuccess;
}

// the 16-bit designs at head dim hd (a multiple of 16 up to 256)
template <typename TE>
cudaError_t launch16(int design, const void* q, const void* k, const void* v, void* out,
                     void* lse, int BH, int T, int S, int hd, float scale, int causal,
                     cudaStream_t s) {
  if (design == 2)
    return hd == 128 ? launch_wgmma<TE, 128>(q, k, v, out, lse, BH, T, S, scale, causal, s)
                     : launch_wgmma<TE, 64>(q, k, v, out, lse, BH, T, S, scale, causal, s);
  switch (hd) {
#define TT_MMA_HD(H) \
  case H: return launch_mma<TE, H>(q, k, v, out, lse, BH, T, S, scale, causal, s);
    TT_MMA_HD(16) TT_MMA_HD(32) TT_MMA_HD(48) TT_MMA_HD(80) TT_MMA_HD(96) TT_MMA_HD(112)
    TT_MMA_HD(144) TT_MMA_HD(160) TT_MMA_HD(176) TT_MMA_HD(192) TT_MMA_HD(208)
    TT_MMA_HD(224) TT_MMA_HD(240) TT_MMA_HD(256)
#undef TT_MMA_HD
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// design: 0 fma (float32), 1 mma (bf16 or fp16), 2 wgmma (bf16 or fp16, hd 64
// or 128), as cudaex.sdpa_fwd_design chooses; a design the inputs do not fit
// is refused. Head dims: multiples of 16 up to 256 (16-bit), up to 256 (f32).
extern "C" int tt_sdpa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                           int BH, int T, int S, int hd, float scale, int causal, int dtype,
                           int design, int device, void* stream) {
  cudaSetDevice(device);
  if ((design == 0) != (dtype == TT_F32) ||
      (design != 0 && ((design == 2) != (hd == 64 || hd == 128) || hd % 16)) || hd > 256 ||
      hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH > 0 && T > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (dtype == TT_BF16) {
      err = launch16<__nv_bfloat16>(design, q, k, v, out, lse, BH, T, S, hd, scale, causal, s);
    } else if (dtype == TT_F16) {
      err = launch16<__half>(design, q, k, v, out, lse, BH, T, S, hd, scale, causal, s);
    } else {
      const unsigned blocks = static_cast<unsigned>(BH) * ((T + 63) / 64);
      sdpa_fwd_f32<<<blocks, 64, 0, s>>>(static_cast<const float*>(q),
                                         static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(out),
                                         static_cast<float*>(lse), T, S, hd, scale, causal);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
