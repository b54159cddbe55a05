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
// wgmma (bf16, hd 64 and 128: llama3-8b's and the TPU checker's head dims).
//   A block of three warpgroups owns a 128-row q tile of one batch*head and
//   walks 128-row kv tiles. Warpgroup 0 is the producer: it gives up
//   registers (setmaxnreg 40) and one thread issues TMA loads, Q once and K
//   and V into a 2-stage ring, each stage with a full barrier for K, one for
//   V and an empty barrier the consumers release. Warpgroups 1 and 2 (setmaxnreg
//   232) each own 64 q rows: S = Q K^T as wgmma m64n128k16 with both operands
//   read from 128-byte-swizzled shared memory (K-major); the online softmax
//   on the f32 accumulator in registers, in base 2 with scale*log2(e) folded
//   into one multiply; P rounded to bf16 in registers, where the accumulator
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
// mma (bf16, other head dims, the first version): one block of 4 warps owns a
//   64-row q tile and loops over 64-row kv tiles staged in shared memory with
//   16-byte loads; QK^T and PV on mma.sync m16n8k16 with the softmax state in
//   the fragments. Loads and products do not overlap.
//
// fma (float32): a plain FMA kernel, one thread per q row.
#include <cuda.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block (16 per warp)
constexpr int BKV = 64;   // kv rows per tile
constexpr int THREADS = 128;

template <int HD>
__global__ void __launch_bounds__(THREADS)
sdpa_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, int T, int S, float scale, int causal) {
  constexpr int LD = HD + 8;   // bf16 row stride in shared memory (conflict-free fragments)
  constexpr int NT = HD / 8;   // 8-column tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BKV * LD;

  const int n_qt = (T + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);   // heaviest first
  const size_t bh = blockIdx.x / n_qt;
  const int q0 = qt * BQ;
  const __nv_bfloat16* qb = q + bh * T * HD;
  const __nv_bfloat16* kb = k + bh * S * HD;
  const __nv_bfloat16* vb = v + bh * S * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;                  // the warp's first row in the tile
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  tt::stage_rows<HD>(Qs, LD, qb, q0, BQ, T);

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
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LD + kk + 2 * t;
        tt::mma_bf16(s[j], a, tt::ld_pair(kp), tt::ld_pair(kp + 8));
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

    // acc += P V, P rounded to bf16; V is (kv, d) row-major, read down a column
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = tt::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = tt::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = tt::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = tt::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* c = vp + n * 8;
        tt::mma_bf16(acc[n], a, tt::pack_bf16(c[0], c[LD]),
                     tt::pack_bf16(c[8 * LD], c[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const float lsafe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = out + (bh * T + row[r]) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          tt::pack_bf16(acc[n][2 * r] / lsafe, acc[n][2 * r + 1] / lsafe);
    if (t == 0) lse[bh * T + row[r]] = m[r] + logf(lsafe);
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
  float acc[128];
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
// The wgmma design: Hopper primitives (PTX), then the kernel.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of `parity` to complete. A wait that lasts past ~2^31
// cycles (about a second) cannot be a tile in flight: it traps, so a broken
// barrier protocol ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

// TMA: the box at (c0, c1, c2) of a 3-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Ties every register of an accumulator to this point, so the compiler
// neither reads one before the wgmma that writes it has been waited on nor
// moves a write past the wgmma that reads it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (layout
// type 1). K-major (Q, K): rows of 128 bytes, 8-row groups SBO = 1024 bytes
// apart, LBO unused; a 16-deep k step inside the 64-column box moves the
// start by 32 bytes. MN-major (V): LBO is the distance between 64-column
// boxes, SBO = 1024 bytes between groups of 8 k rows.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int WG_BQ = 128;          // q rows per block, 64 per consumer warpgroup
constexpr int WG_BKV = 128;         // kv rows per tile
constexpr int WG_STAGES = 2;        // K/V ring depth
constexpr int WG_THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int BOX_COLS = 64;        // bf16 columns of one 128-byte-swizzled TMA box
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

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n64(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
sdpa_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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
        wgmma_ss_n128(sc, desc_sw128(q_rows + off, 16, 1024), desc_sw128(k_tile + off, 16, 1024),
                      kk > 0);
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
      // P rounded to bf16: two neighbouring 8-column groups of the
      // accumulator are one A fragment of the PV product
      uint32_t pa[WG_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < WG_BKV / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = tt::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      // O += P V, V MN-major as stored
      mbar_wait(v_full(s), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BKV / 16; ++kk)
        wgmma_pv<HD>(o, pa[kk], desc_sw128(v_tile + kk * 16 * 128, BOX_BYTES, 1024));
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
      __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * T + row) * HD;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            tt::pack_bf16(o[4 * n + 2 * r] / lsafe, o[4 * n + 2 * r + 1] / lsafe);
      if (t == 0) lse[static_cast<size_t>(bh) * T + row] = m[r] * kLn2 + logf(lsafe);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a (BH, rows, hd) bf16 tensor, (hd, rows, BH) innermost
// first, in 64-column x 128-row boxes with the 128-byte swizzle; rows past
// the end of a head read as zeros.
bool head_map(CUtensorMap* map, EncodeTiledFn fn, const void* base, int BH, int rows, int hd) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(rows) * hd * 2};
  const cuuint32_t box[3] = {BOX_COLS, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                         int BH, int T, int S, float scale, int causal, cudaStream_t s) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, fn, q, BH, T, HD) || !head_map(&tk, fn, k, BH, S, HD) ||
      !head_map(&tv, fn, v, BH, S, HD))
    return cudaErrorInvalidValue;
  constexpr int smem = WgLayout<HD>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      sdpa_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BH) * ((T + WG_BQ - 1) / WG_BQ);
  sdpa_fwd_wgmma<HD><<<blocks, WG_THREADS, smem, s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), BH, T, S,
      scale * kLog2e, causal);
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                       int T, int S, float scale, int causal, cudaStream_t s) {
  const int smem = (BQ + 2 * BKV) * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(sdpa_fwd_mma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(BH) * ((T + BQ - 1) / BQ);
  sdpa_fwd_mma<HD><<<blocks, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), T, S, scale, causal);
  return cudaSuccess;
}

}  // namespace

// design: 0 fma (float32), 1 mma (bf16), 2 wgmma (bf16, hd 64 or 128), as
// cudaex.sdpa_fwd_design chooses; a design the inputs do not fit is refused.
extern "C" int tt_sdpa_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                           int BH, int T, int S, int hd, float scale, int causal, int dtype,
                           int design, int device, void* stream) {
  cudaSetDevice(device);
  if ((design == 0) != (dtype == TT_F32) ||
      (design != 0 && (design == 2) != (hd == 64 || hd == 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH > 0 && T > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    if (design == 2) {
      err = hd == 128 ? launch_wgmma<128>(q, k, v, out, lse, BH, T, S, scale, causal, s)
                      : launch_wgmma<64>(q, k, v, out, lse, BH, T, S, scale, causal, s);
    } else if (design == 1) {
      switch (hd) {
        case 16: err = launch_mma<16>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 32: err = launch_mma<32>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 48: err = launch_mma<48>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 80: err = launch_mma<80>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 96: err = launch_mma<96>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        case 112: err = launch_mma<112>(q, k, v, out, lse, BH, T, S, scale, causal, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
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
