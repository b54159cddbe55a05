// The whole T == 1 decode layer in one cooperative launch, and its attention
// half (the MLP phases compiled out):
//   x = rms_norm(h, wn1); q, k, v = rope(x wq^T), rope(x wk^T), x wv^T
//   attn = paged attention of q over the pools, position len-1 from the fresh
//          k/v rows;  hacc = h + attn wo^T (f32, never rounded)
//   decode_layer:  x2 = rms_norm(hacc, wn2); y = T(act(x2 wg^T)) * T(x2 wu^T)
//                  out = T(hacc + y wd^T)
//   attn_subblock: out = T(attn wo^T)   (the residual add stays outside)
// h, out (S, D); wq (H hd, D); wk, wv (KV hd, D); wo (D, H hd); cos, sin
// (S, hd/2); pools (KV, P, ps, hd); block_tables (S, npg), lengths (S,)
// int32; wg, wu (F, D); wd (D, F); every float tensor of one dtype T. The
// fresh rows leave as k_rows, v_rows (KV, S, hd); the wrapper stores them in
// the pools after the launch.
//
// Replaces: thunder_tpu/executors/pallasex.py _decode_call (:1623), the
// kernel behind pallas_decode_layer (:1751) and pallas_attn_subblock
// (:1743). Rounding follows _decode_qkv_phase, _decode_attn_phase and
// _decode_mlp_phase: each head's projection rounded to T, then the rope's
// every multiply and add in T; scores in f32, probabilities rounded to T
// before the PV product, attn = T(acc / l); the out-projection summed in f32
// onto the f32 residual; the second norm from that f32 accumulator; act(gate)
// and up each rounded before their product; out rounded once.
//
// Bound on an H100: bytes. At S = 8 slots, D = 4096, H = 32, KV = 8, hd =
// 128, F = 14336, bf16 and 8 requests of 1..2048 tokens (7425 in all), one
// layer reads 83.9 MB of q/k/v/o weights, 352.3 MB of MLP weights and
// 30.4 MB of K/V: 466.6 MB, 0.139 ms at 3.35 TB/s. Its ~3.5 GFLOP take 3.5 us
// at the tensor cores' rate.
//
// Design. The TPU kernel is one sequential grid of three phases, each of
// which needs the whole of the one before. Here one cooperative launch
// (cudaLaunchCooperativeKernel, every block resident) walks six phases, each
// a grid-stride loop over its work items, separated by grid-wide barriers:
//   (a) QKV: each block forms the normed rows itself into shared memory; a
//       warp owns columns j and j + hd/2 of one head, so the rope runs on
//       the warp's own sums. q goes to a workspace, k and v to k_rows/v_rows.
//   (b) attention: each (slot, kv head) context is split into chunks of
//       ~128 keys, one block each; a thread per key forms the G scores, the
//       chunk's softmax runs in f32, a thread per (column, 4 heads) sums the
//       PV product; the chunk's (m, l, acc) go to a workspace. The fresh row
//       is read from k_rows/v_rows where the key is len-1, so a replay slot
//       (whose write goes to the scratch page) attends its fresh row, as on
//       the TPU. Pages at or past len are not read.
//   (c) combine: the chunks of each (slot, head) merged, attn rounded to T.
//   (d) out-projection: a warp owns two of the D columns; hacc in f32.
//   (e) gate/up: every block forms the second norm's rows from hacc; a warp
//       owns one ff column of w_gate and of w_up, writes y.
//   (f) down: a warp owns two of the D columns, y staged in chunks (8 slots
//       x 14336 bf16 is 229 KB, more than a block's shared memory).
// The products (a), (d), (e), (f) stream each weight row once with 16-byte
// loads and do f32 FMAs against the activation rows in shared memory: at 8
// rows a weight byte meets 8 operations, so the loads bound them. No tensor
// cores, TMA or tuned split yet.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "mlp_subblock.cuh"

namespace tt {
namespace decode {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RG = 8;                 // activation rows summed per pass
constexpr int ACT_BYTES = 64 * 1024;  // staged activation rows (RG x KC)
constexpr int KEYS = 128;             // attention keys per chunk, about

template <typename T>
struct Args {
  const T *h, *wn1, *wq, *wk, *wv, *wo, *cos, *sin, *kp, *vp;
  const int *bt, *ln;
  const T *wn2, *wg, *wu, *wd;   // decode_layer only
  T *out, *k_rows, *v_rows;
  T* q_ws;        // (S, H, hd)
  float* part;    // (S, KV, nch, G, 2 + hd): per chunk m, l, acc
  T* attn_ws;     // (S, H hd)
  float* hacc;    // (S, D), decode_layer only
  T* y_ws;        // (S, F), decode_layer only
  int S, D, H, KV, hd, P, ps, npg, F, chunk_pages, nch, act;
  float eps, scale;
};

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// shared memory of the attention phase, in bytes (q rows, scores, the
// chunk's k/v row pointers)
__host__ __device__ __forceinline__ int attn_smem(int G, int hd, int keys) {
  return align16(G * hd * 4) + align16(G * keys * 4) + 2 * align16(keys * 8);
}

template <typename T> __host__ __device__ constexpr int act_cols() {
  return ACT_BYTES / (RG * static_cast<int>(sizeof(T)));
}

// 1 / sqrt(mean(row^2) + eps) of each of the S rows of a (S, D) matrix, a
// warp per row, into r[S]; ends with a block barrier
template <typename V>
__device__ __forceinline__ void row_rsqrt(const V* __restrict__ a, int S, int D, float eps,
                                          float* r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < S; s += WARPS) {
    float ss = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float v = to_f(a[static_cast<size_t>(s) * D + k]);
      ss += v * v;
    }
    ss = warp_sum(ss);
    if (lane == 0) r[s] = 1.f / sqrtf(ss / static_cast<float>(D) + eps);
  }
  __syncthreads();
}

// One block-level pass of warp products: warp task t (WARPS tasks per item,
// items grid-strided) owns NR weight rows, rows(t, w) points w[r] at them;
// every row is summed against the S activation rows, which stage(s0, rows,
// k0, kc, a_s) writes into shared memory RG rows by KC columns at a time
// (a_s[r * KC + c] = a[s0 + r][k0 + c]). epi(t, s, v) takes the NR f32 sums of
// activation row s.
template <typename T, int NR, class Rows, class Stage, class Epi>
__device__ __forceinline__ void gemv(int n_tasks, int K, int S, T* a_s, Rows rows, Stage stage,
                                     Epi epi) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int KC = act_cols<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_items = (n_tasks + WARPS - 1) / WARPS;
  const bool once = K <= KC && S <= RG;
  if (once) {
    stage(0, S, 0, K, a_s);
    __syncthreads();
  }
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int task = item * WARPS + warp;
    const bool live = task < n_tasks;
    const T* w[NR];
    if (live) rows(task, w);
    for (int s0 = 0; s0 < S; s0 += RG) {
      const int nr = min(RG, S - s0);
      float acc[NR][RG];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int s = 0; s < RG; ++s) acc[r][s] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        const int kc = min(KC, K - k0);
        if (!once) {
          __syncthreads();
          stage(s0, nr, k0, kc, a_s);
          __syncthreads();
        }
        if (live) {
#pragma unroll 2
          for (int c = lane * V; c < kc; c += 32 * V) {
            uint4 wv[NR];
#pragma unroll
            for (int r = 0; r < NR; ++r) wv[r] = __ldg(reinterpret_cast<const uint4*>(w[r] + k0 + c));
#pragma unroll
            for (int s = 0; s < RG; ++s) {
              if (s < nr) {
                const uint4 av = *reinterpret_cast<const uint4*>(a_s + s * KC + c);
                const T* ae = reinterpret_cast<const T*>(&av);
#pragma unroll
                for (int r = 0; r < NR; ++r) {
                  const T* we = reinterpret_cast<const T*>(&wv[r]);
#pragma unroll
                  for (int e = 0; e < V; ++e) acc[r][s] = fmaf(to_f(we[e]), to_f(ae[e]), acc[r][s]);
                }
              }
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int s = 0; s < RG; ++s) acc[r][s] = warp_sum(acc[r][s]);
#pragma unroll
        for (int s = 0; s < RG; ++s) {
          if (lane == s && s < nr) {
            float v[NR];
#pragma unroll
            for (int r = 0; r < NR; ++r) v[r] = acc[r][s];
            epi(task, s0 + s, v);
          }
        }
      }
    }
  }
}

// (a) the normed rows, each head's projection, the rope
template <typename T>
__device__ void qkv_phase(const Args<T>& a, T* a_s, float* r_s) {
  const int D = a.D, hd = a.hd, hd2 = a.hd / 2, H = a.H, KV = a.KV, S = a.S;
  row_rsqrt(a.h, S, D, a.eps, r_s);
  gemv<T, 2>(
      (H + 2 * KV) * hd2, D, S, a_s,
      [&](int t, const T* (&w)[2]) {
        const int head = t / hd2, j = t % hd2;
        const T* base = head < H ? a.wq + static_cast<size_t>(head) * hd * D
                      : head < H + KV ? a.wk + static_cast<size_t>(head - H) * hd * D
                                      : a.wv + static_cast<size_t>(head - H - KV) * hd * D;
        w[0] = base + static_cast<size_t>(j) * D;
        w[1] = base + static_cast<size_t>(j + hd2) * D;
      },
      [&](int s0, int nr, int k0, int kc, T* dst) {
        constexpr int KC = act_cols<T>();
        for (int i = threadIdx.x; i < nr * kc; i += THREADS) {
          const int r = i / kc, k = i % kc, s = s0 + r;
          const float v = to_f(a.h[static_cast<size_t>(s) * D + k0 + k]);
          dst[r * KC + k] = from_f<T>(round_as<T>(v * r_s[s]) * to_f(a.wn1[k0 + k]));
        }
      },
      [&](int t, int s, const float (&v)[2]) {
        const int head = t / hd2, j = t % hd2;
        float t1 = round_as<T>(v[0]), t2 = round_as<T>(v[1]);
        if (head < H + KV) {   // q and k are roped, v is not
          const float c = to_f(a.cos[s * hd2 + j]), sn = to_f(a.sin[s * hd2 + j]);
          const float o1 = round_as<T>(round_as<T>(t1 * c) - round_as<T>(t2 * sn));
          const float o2 = round_as<T>(round_as<T>(t2 * c) + round_as<T>(t1 * sn));
          t1 = o1;
          t2 = o2;
        }
        T* dst = head < H ? a.q_ws + (static_cast<size_t>(s) * H + head) * hd
               : head < H + KV ? a.k_rows + (static_cast<size_t>(head - H) * S + s) * hd
                               : a.v_rows + (static_cast<size_t>(head - H - KV) * S + s) * hd;
        dst[j] = from_f<T>(t1);
        dst[j + hd2] = from_f<T>(t2);
      });
}

// (b) one chunk of keys of one (slot, kv head) per item: partial (m, l, acc)
template <typename T>
__device__ void attention_phase(const Args<T>& a, unsigned char* smem) {
  const int G = a.H / a.KV, hd = a.hd, keys = a.chunk_pages * a.ps;
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = reinterpret_cast<float*>(smem + align16(G * hd * 4));
  const T** kr_s = reinterpret_cast<const T**>(smem + align16(G * hd * 4) + align16(G * keys * 4));
  const T** vr_s = kr_s + align16(keys * 8) / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ngg = (G + 3) / 4;   // groups of 4 query rows
  const int n_items = a.S * a.KV * a.nch;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item % a.nch, kvh = (item / a.nch) % a.KV, b = item / (a.nch * a.KV);
    const int ln = a.ln[b], kbeg = c * keys;
    if (kbeg >= ln) continue;   // the same for the whole block
    const int nk = min(keys, ln - kbeg);
    __syncthreads();            // the previous item's reads of shared memory are done
    const T* qrow = a.q_ws + (static_cast<size_t>(b) * a.H + kvh * G) * hd;
    for (int i = tid; i < G * hd; i += THREADS) q_s[i] = to_f(qrow[i]);
    for (int j = tid; j < nk; j += THREADS) {
      const int pos = kbeg + j;
      if (pos == ln - 1) {      // this step's row, not the pool's
        const size_t o = (static_cast<size_t>(kvh) * a.S + b) * hd;
        kr_s[j] = a.k_rows + o;
        vr_s[j] = a.v_rows + o;
      } else {
        const size_t page = static_cast<size_t>(a.bt[static_cast<size_t>(b) * a.npg + pos / a.ps]);
        const size_t o = ((static_cast<size_t>(kvh) * a.P + page) * a.ps + pos % a.ps) * hd;
        kr_s[j] = a.kp + o;
        vr_s[j] = a.vp + o;
      }
    }
    __syncthreads();
    // scores: a thread per (key, 4 query rows)
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    for (int t = tid; t < nk * ngg; t += THREADS) {
      const int j = t % nk, g0 = (t / nk) * 4;
      const T* kr = kr_s[j];
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (hd % V == 0) {   // rows of whole 16-byte vectors
        for (int e0 = 0; e0 < hd; e0 += V) {
          const uint4 kv = *reinterpret_cast<const uint4*>(kr + e0);
          const T* ke = reinterpret_cast<const T*>(&kv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float k = to_f(ke[e]);
#pragma unroll
            for (int g = 0; g < 4; ++g)
              if (g0 + g < G) d[g] = fmaf(q_s[(g0 + g) * hd + e0 + e], k, d[g]);
          }
        }
      } else {             // any other even head dim: the rows are not 16-byte aligned
        for (int e = 0; e < hd; ++e) {
          const float k = to_f(kr[e]);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (g0 + g < G) d[g] = fmaf(q_s[(g0 + g) * hd + e], k, d[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (g0 + g < G) p_s[(g0 + g) * keys + j] = d[g] * a.scale;
    }
    __syncthreads();
    // the chunk's softmax, a warp per query row
    float* part = a.part + static_cast<size_t>(item) * G * (2 + hd);
    for (int g = warp; g < G; g += WARPS) {
      float* s = p_s + g * keys;
      float m = -INFINITY;
      for (int j = lane; j < nk; j += 32) m = fmaxf(m, s[j]);
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = expf(s[j] - m);
        s[j] = e;
        l += e;
      }
      l = warp_sum(l);
      if (lane == 0) {
        part[g * (2 + hd)] = m;
        part[g * (2 + hd) + 1] = l;
      }
    }
    __syncthreads();
    // PV: a thread per (column, 4 query rows), probabilities rounded to T
    for (int t = tid; t < hd * ngg; t += THREADS) {
      const int e = t % hd, g0 = (t / hd) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < nk; ++j) {
        const float v = to_f(vr_s[j][e]);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (g0 + g < G) acc[g] = fmaf(round_as<T>(p_s[(g0 + g) * keys + j]), v, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (g0 + g < G) part[(g0 + g) * (2 + hd) + 2 + e] = acc[g];
    }
  }
}

// (c) merge each (slot, head)'s chunks: attn = T(acc / l)
template <typename T>
__device__ void combine_phase(const Args<T>& a) {
  const int G = a.H / a.KV, hd = a.hd, keys = a.chunk_pages * a.ps;
  const size_t total = static_cast<size_t>(a.S) * a.H * hd;
  for (size_t i = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * THREADS) {
    const int e = static_cast<int>(i % hd), bh = static_cast<int>(i / hd);
    const int head = bh % a.H, b = bh / a.H, kvh = head / G, g = head % G;
    const int nc = (a.ln[b] + keys - 1) / keys;
    const size_t stride = static_cast<size_t>(G) * (2 + hd);
    const float* p = a.part + (static_cast<size_t>(b) * a.KV + kvh) * a.nch * stride + g * (2 + hd);
    float m = -INFINITY;
    for (int c = 0; c < nc; ++c) m = fmaxf(m, p[c * stride]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float w = expf(p[c * stride] - m);
      l = fmaf(p[c * stride + 1], w, l);
      acc = fmaf(p[c * stride + 2 + e], w, acc);
    }
    a.attn_ws[i] = from_f<T>(acc / (l == 0.f ? 1.f : l));
  }
}

// (d) the out-projection: hacc = h + attn wo^T (layer) or out = T(attn wo^T)
template <typename T, bool MLP>
__device__ void out_proj_phase(const Args<T>& a, T* a_s) {
  const int D = a.D, K = a.H * a.hd;
  gemv<T, 2>(
      D / 2, K, a.S, a_s,
      [&](int t, const T* (&w)[2]) {
        w[0] = a.wo + static_cast<size_t>(2 * t) * K;
        w[1] = w[0] + K;
      },
      [&](int s0, int nr, int k0, int kc, T* dst) {
        constexpr int KC = act_cols<T>();
        for (int i = threadIdx.x; i < nr * kc; i += THREADS) {
          const int r = i / kc, k = i % kc;
          dst[r * KC + k] = a.attn_ws[static_cast<size_t>(s0 + r) * K + k0 + k];
        }
      },
      [&](int t, int s, const float (&v)[2]) {
        const size_t o = static_cast<size_t>(s) * D + 2 * t;
        if (MLP) {
          a.hacc[o] = to_f(a.h[o]) + v[0];
          a.hacc[o + 1] = to_f(a.h[o + 1]) + v[1];
        } else {
          a.out[o] = from_f<T>(v[0]);
          a.out[o + 1] = from_f<T>(v[1]);
        }
      });
}

// (e) y = T(T(act(x2 wg^T)) * T(x2 wu^T)), x2 = T(T(hacc * r2) * wn2)
template <typename T>
__device__ void gate_up_phase(const Args<T>& a, T* a_s, float* r_s) {
  const int D = a.D, F = a.F;
  row_rsqrt(a.hacc, a.S, D, a.eps, r_s);
  gemv<T, 2>(
      F, D, a.S, a_s,
      [&](int t, const T* (&w)[2]) {
        w[0] = a.wg + static_cast<size_t>(t) * D;
        w[1] = a.wu + static_cast<size_t>(t) * D;
      },
      [&](int s0, int nr, int k0, int kc, T* dst) {
        constexpr int KC = act_cols<T>();
        for (int i = threadIdx.x; i < nr * kc; i += THREADS) {
          const int r = i / kc, k = i % kc, s = s0 + r;
          const float v = a.hacc[static_cast<size_t>(s) * D + k0 + k];
          dst[r * KC + k] = from_f<T>(round_as<T>(v * r_s[s]) * to_f(a.wn2[k0 + k]));
        }
      },
      [&](int t, int s, const float (&v)[2]) {
        const float ga = round_as<T>(mlp::act_fn(v[0], a.act));
        a.y_ws[static_cast<size_t>(s) * F + t] = from_f<T>(ga * round_as<T>(v[1]));
      });
}

// (f) out = T(hacc + y wd^T)
template <typename T>
__device__ void down_phase(const Args<T>& a, T* a_s) {
  const int D = a.D, F = a.F;
  gemv<T, 2>(
      D / 2, F, a.S, a_s,
      [&](int t, const T* (&w)[2]) {
        w[0] = a.wd + static_cast<size_t>(2 * t) * F;
        w[1] = w[0] + F;
      },
      [&](int s0, int nr, int k0, int kc, T* dst) {
        constexpr int KC = act_cols<T>();
        for (int i = threadIdx.x; i < nr * kc; i += THREADS) {
          const int r = i / kc, k = i % kc;
          dst[r * KC + k] = a.y_ws[static_cast<size_t>(s0 + r) * F + k0 + k];
        }
      },
      [&](int t, int s, const float (&v)[2]) {
        const size_t o = static_cast<size_t>(s) * D + 2 * t;
        a.out[o] = from_f<T>(a.hacc[o] + v[0]);
        a.out[o + 1] = from_f<T>(a.hacc[o + 1] + v[1]);
      });
}

template <typename T, bool MLP>
__global__ void __launch_bounds__(THREADS) decode_layer_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);
  const int main_bytes = max(ACT_BYTES, attn_smem(a.H / a.KV, a.hd, a.chunk_pages * a.ps));
  float* r_s = reinterpret_cast<float*>(smem + main_bytes);
  cg::grid_group grid = cg::this_grid();
  qkv_phase(a, a_s, r_s);
  grid.sync();
  attention_phase(a, smem);
  grid.sync();
  combine_phase(a);
  grid.sync();
  out_proj_phase<T, MLP>(a, a_s);
  if (MLP) {
    grid.sync();
    gate_up_phase(a, a_s, r_s);
    grid.sync();
    down_phase(a, a_s);
  }
}

// Shared memory of one block, in bytes: the staged activations or the
// attention phase's buffers, whichever is larger, then S row statistics.
__host__ __forceinline__ int smem_bytes(int S, int G, int hd, int keys) {
  const int a = attn_smem(G, hd, keys);
  return (a > ACT_BYTES ? a : ACT_BYTES) + align16(S * 4);
}

// One cooperative launch: as many blocks as fit on the card at once. Returns
// a CUDA error code (cudaErrorCooperativeLaunchTooLarge and the like when the
// card refuses), never falls back.
template <typename T, bool MLP>
int launch(const Args<T>& a, int device, cudaStream_t stream) {
  auto kernel = decode_layer_kernel<T, MLP>;
  const int smem = smem_bytes(a.S, a.H / a.KV, a.hd, a.chunk_pages * a.ps);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args<T> args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(per_sm * sms),
                                  dim3(THREADS), params, static_cast<size_t>(smem), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
}  // namespace tt
