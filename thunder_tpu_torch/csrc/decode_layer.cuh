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
//   (a) QKV: each block forms the normed rows itself into shared memory;
//       columns j and j + hd/2 of one head are summed together, so the
//       rope runs on their own sums. q goes to a workspace, k and v to
//       k_rows/v_rows.
//   (b) attention: each (slot, kv head) context is split into chunks of C
//       keys (cudaex.paged_geometry's, as paged_decode_attention splits
//       them), one block each, on attn_chunk.cuh's chunk routine: the
//       chunk's K and V rows staged by cp.async, scores and softmax in f32,
//       the probabilities rounded to T before the PV product; the chunk's
//       (m, l, acc) go to a workspace. The key at len - 1 is staged from
//       k_rows/v_rows, so a replay slot (whose write goes to the scratch
//       page) attends its fresh row, as on the TPU. Pages at or past len
//       are not read.
//   (c) combine: each (slot, kv head)'s chunks merged in chunk order
//       (attn_chunk.cuh), attn rounded to T.
//   (d) out-projection onto hacc in f32.
//   (e) gate/up: every block forms the second norm's rows from hacc; act(
//       gate) and up of one ff row are summed together, y written.
//   (f) down: y (8 slots x 14336 bf16 is 229 KB, more than a block's
//       shared memory) read in parts, out = T(hacc + y wd^T).
// The products (a), (d), (e), (f) read each weight row once; at 8 rows a
// weight byte meets 8 operations, so the loads bound them. Two designs of
// the products, chosen by the wrapper (cudaex.decode_design) from the dtype
// and S and passed in as `design`:
//   stream (bf16 or fp16, S <= 8, D and H hd <= 4096): wstream.cuh's swap-AB
//     weight stream, linear_act's decode path. 16 weight rows are the A
//     operand of mma.sync m16n8k16 and the <= 8 activation rows its B
//     operand. A work item is one 16-row weight tile, whose rows the
//     epilogue may pair: (a) rows j..j+7 of one head and their rope
//     partners j+hd/2..j+hd/2+7, so the rope runs on the item's own sums;
//     (e) is two tiles, the same 16 rows of w_gate and of w_up. The block's
//     8 warps split K into runs of 64-column slabs; each warp streams its
//     run of every item of its block through its own ring of 3 slabs (2 in
//     flight: 32-64 KB an SM, where ~30 KB keeps the memory busy),
//     continuing from one item into the next, and the warps' sums meet in
//     shared memory, added in warp order. A phase's first slabs are in
//     flight before its activations are staged. The activation rows of (a),
//     (d) and (e) (K = D or H hd) are staged once per phase, 8 rows x 4096
//     columns with 16 bytes of padding a row, so the B fragments come from
//     shared memory by ldmatrix without bank conflicts; (f)'s y (K = F, 229
//     KB at 8 rows x 14336) streams through the ring beside the weight. The
//     block's 168 KB leave one block of 256 threads an SM, so the attention
//     phase runs two chunks at once in each block (two groups of 128
//     threads with their own barriers).
//   fma (float32, any other S): each warp owns one or two weight rows,
//     streamed with synchronous 16-byte loads, and sums them in f32 FMAs
//     against the activation rows in shared memory, RG rows at a time.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "attn_chunk.cuh"
#include "common.cuh"
#include "mlp_subblock.cuh"
#include "wstream.cuh"

namespace tt {
namespace decode {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RG = 8;                 // activation rows summed per pass
constexpr int ACT_BYTES = 64 * 1024;  // staged activation rows (RG x KC)

// the designs of the products, by the code the C entries take
constexpr int DESIGN_FMA = 0, DESIGN_STREAM = 1;

// the stream design's shared memory: 8 staged activation rows of up to
// ST_COLS columns (row stride ST_LD: 16 bytes of padding put ldmatrix's 8
// rows in distinct banks), every warp's ring, the warps' partial sums of a
// 32-row item
constexpr int ST_ROWS = 8;
constexpr int ST_COLS = 4096;
constexpr int ST_LD = ST_COLS + 8;
constexpr int ST_ACT_BYTES = ST_ROWS * ST_LD * 2;
// 3 slabs a warp, 2 in flight: 32-64 KB of loads in flight an SM. Deeper
// rings (up to 8 slabs) and a shallower one (2) were slower on an H100: the
// extra requests only queue.
constexpr int RING_STAGES = 3;
constexpr int RING_WARP_BYTES = RING_STAGES * 32 * 64 * 2;   // stages of up to 32 rows
constexpr int RING_BYTES = WARPS * RING_WARP_BYTES;
constexpr int RED_BYTES = WARPS * 32 * ST_ROWS * 4;
constexpr int STREAM_BYTES = ST_ACT_BYTES + RING_BYTES + RED_BYTES;
constexpr int STREAM_GROUPS = 2;   // chunks the stream design's attention phase runs at once

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
  int S, D, H, KV, hd, P, ps, npg, F, keys, nch, act;
  float eps, scale;
};

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

template <typename T> __host__ __device__ constexpr int act_cols() {
  return ACT_BYTES / (RG * static_cast<int>(sizeof(T)));
}

// 1 / sqrt(mean(row^2) + eps) of each of the S rows of a (S, D) matrix, a
// warp per row with 16-byte loads, into r[S]; ends with a block barrier
template <typename V>
__device__ __forceinline__ void row_rsqrt(const V* __restrict__ a, int S, int D, float eps,
                                          float* r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < S; s += WARPS) {
    constexpr int VV = 16 / static_cast<int>(sizeof(V));   // D % 8 == 0: whole 16-byte vectors
    float ss = 0.f;
#pragma unroll 4
    for (int k = lane * VV; k < D; k += 32 * VV) {
      const uint4 u = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(s) * D + k);
      const V* e = reinterpret_cast<const V*>(&u);
#pragma unroll
      for (int i = 0; i < VV; ++i) {
        const float v = to_f(e[i]);
        ss += v * v;
      }
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

// (b) one chunk of keys of one (slot, kv head) per item: its (m, l, acc),
// probabilities rounded to T before the PV product, the key at len - 1
// taken from this step's fresh row. Only live chunks (those before len) are
// items: every block counts them from the lengths (ln_s: S ints of shared
// memory), and they go round-robin to the NG groups of THREADS / NG
// threads of every block (the stream design's shared memory holds two
// chunks, so two chunks' loads are in flight on each SM).
template <typename T, int NG>
__device__ void attention_phase(const Args<T>& a, unsigned char* smem, int* ln_s) {
  constexpr int GT = THREADS / NG;
  const int G = a.H / a.KV, hd = a.hd, S = a.S;
  const int grp = threadIdx.x / GT, tid = threadIdx.x - grp * GT;
  unsigned char* gsm =
      smem + grp * chunk::align16(chunk::smem_bytes(G, hd, a.keys, sizeof(T), GT));
  for (int b = threadIdx.x; b < S; b += THREADS) ln_s[b] = a.ln[b];
  __syncthreads();
  int live = 0;
  for (int b = 0; b < S; ++b) live += a.KV * ((ln_s[b] + a.keys - 1) / a.keys);
  for (int i = blockIdx.x * NG + grp; i < live; i += gridDim.x * NG) {
    int b = 0, rem = i, nc = 0;   // live chunk i: slot b, then kv head, then chunk
    for (;; ++b) {
      nc = (ln_s[b] + a.keys - 1) / a.keys;
      if (rem < a.KV * nc) break;
      rem -= a.KV * nc;
    }
    const int kvh = rem / nc, c = rem - kvh * nc, ln = ln_s[b], kbeg = c * a.keys;
    const int nk = min(a.keys, ln - kbeg), fresh = ln - 1 - kbeg;
    const size_t pool0 = static_cast<size_t>(kvh) * a.P * a.ps * hd;
    const size_t row = (static_cast<size_t>(kvh) * S + b) * hd;
    const T* q = a.q_ws + (static_cast<size_t>(b) * a.H + static_cast<size_t>(kvh) * G) * hd;
    float* out = a.part + ((static_cast<size_t>(b) * a.KV + kvh) * a.nch + c) * G * (2 + hd);
    const int* btr = a.bt + static_cast<size_t>(b) * a.npg;
    if constexpr (NG == 1)
      chunk::run<T, GT, true>(q, a.kp + pool0, a.vp + pool0, btr, kbeg, nk, a.ps, hd, G, a.keys,
                              a.scale, fresh < nk ? fresh : -1, a.k_rows + row, a.v_rows + row,
                              gsm, out, tid, chunk::BlockSync{});
    else
      chunk::run<T, GT, true>(q, a.kp + pool0, a.vp + pool0, btr, kbeg, nk, a.ps, hd, G, a.keys,
                              a.scale, fresh < nk ? fresh : -1, a.k_rows + row, a.v_rows + row,
                              gsm, out, tid, chunk::GroupSync<GT>{1 + grp});
  }
}

// (c) merge each (slot, kv head)'s chunks in chunk order: attn = T(acc / l)
template <typename T>
__device__ void combine_phase(const Args<T>& a) {
  const int G = a.H / a.KV, hd = a.hd;
  for (int item = blockIdx.x; item < a.S * a.KV; item += gridDim.x) {
    const int kvh = item % a.KV, b = item / a.KV, ln = a.ln[b];
    chunk::merge<T, THREADS>(a.part + static_cast<size_t>(item) * a.nch * G * (2 + hd),
                             ln > 0 ? (ln + a.keys - 1) / a.keys : 0, G, hd,
                             a.attn_ws + (static_cast<size_t>(b) * a.H + kvh * G) * hd);
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

// ---------------------------------------------------------------------------
// the stream design's products (16-bit T, S <= 8)
// ---------------------------------------------------------------------------

// One product phase on the weight stream: n_items items, grid-strided over
// the blocks, each TILES 16-row weight tiles (rows(item, r) points at the
// item's weight row r < 16 TILES, nullptr for a row of zeros). issue()
// starts the activation rows' copies (one cp.async commit group, or none),
// each warp starts its first slabs' copies, and once the activations have
// landed prep() stages them (ending with a block barrier) while the weight
// is in flight. The block's
// warps split K into runs of 64-column slabs, and each warp streams its run
// of every one of its block's items through its own ring, from one item
// straight into the next. The activation rows come from `a_s` (staged, row
// stride ST_LD, zeros up to K rounded to 64 and in rows S..7) or, with ACT,
// from act_row(s) in device memory through the ring beside the weight. At
// the end of an item the warps' sums meet in `red`, and every thread of the
// block calls epi(item, sum), where sum(r, s) is weight row r against
// activation row s added over the warps in order.
template <typename T, int TILES, bool ACT, class Issue, class Prep, class Rows, class ActRow,
          class Epi>
__device__ __forceinline__ void stream_product(int n_items, int K, const T* any, const T* a_s,
                                               unsigned char* ring_s, float* red, Issue&& issue,
                                               Prep&& prep, Rows&& rows, ActRow&& act_row,
                                               Epi&& epi) {
  constexpr int WR = 16 * TILES;                  // weight rows of an item
  constexpr int SR = WR + (ACT ? 8 : 0);          // rows of a stage tile
  constexpr int STAGE = SR * ws::BK;              // elements of a stage tile
  static_assert(RING_STAGES * STAGE * 2 <= RING_WARP_BYTES && WR <= 32, "a warp's ring");
  constexpr int STAGES = RING_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* ring = reinterpret_cast<T*>(ring_s + warp * RING_WARP_BYTES);
  const int slabs = (K + ws::BK - 1) / ws::BK;
  const int s0 = warp * slabs / WARPS, mine = (warp + 1) * slabs / WARPS - s0;
  const int my_items = static_cast<int>(blockIdx.x) < n_items
                           ? (n_items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int total = my_items * mine;
  const bool vec = K % 8 == 0;
  const auto load = [&](int buf, int i) {
    const int it = i / mine, item = blockIdx.x + it * gridDim.x;
    ws::load_slab<T, SR>(ring + buf * STAGE, (s0 + i - it * mine) * ws::BK, K, vec, any,
                         [&](int r) -> const T* { return r < WR ? rows(item, r) : act_row(r - WR); });
  };
  const int g = lane >> 2, t4 = lane & 3;
  issue();                               // the activations' copies (one commit group or none)
  ws::ring_start<STAGES>(total, load);   // the weight needs no activation: in flight too
  gemm::cp_async_wait<STAGES - 1>();     // the activations' copies have landed
  __syncthreads();
  prep();
  for (int it = 0; it < my_items; ++it) {
    float acc[TILES][4];
#pragma unroll
    for (int t = 0; t < TILES; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    for (int j = 0; j < mine; ++j) {
      const int i = it * mine + j;
      ws::ring_next<STAGES>(i, total, load);
      const T* st = ring + (i % STAGES) * STAGE;
      const int k0 = (s0 + j) * ws::BK;
#pragma unroll
      for (int kk = 0; kk < ws::BK / 16; ++kk) {
        uint32_t b[2];
        if constexpr (ACT)
          ws::frag_b(b, st, WR, kk);
        else
          ws::frag_b_rows(b, a_s, ST_LD, k0 + 16 * kk);
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
          uint32_t af[4];
          ws::frag_a(af, st, 16 * t, kk);
          mma16<T>(acc[t], af, b[0], b[1]);
        }
      }
    }
    // acc[t][e]: weight row 16 t + g + 8 (e >> 1), activation row 2 t4 + (e & 1)
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * WR + 16 * t + g + 8 * (e >> 1)) * ST_ROWS + 2 * t4 + (e & 1)] = acc[t][e];
    __syncthreads();
    epi(blockIdx.x + it * gridDim.x, [&](int r, int s) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[(w * WR + r) * ST_ROWS + s];
      return v;
    });
    __syncthreads();   // red is free for the next item
  }
  ws::ring_drain();
}

// Stage the activation rows of a product: a_s[s][k..k+7] = f(s, k) (8
// values packed in a uint4, K % 8 == 0) for s < S, k < K; zeros in rows
// S..7 and in columns K up to K rounded to 64. Four groups' loads are issued
// before their values are formed. Ends with a block barrier.
template <typename T, class F>
__device__ __forceinline__ void stage_act(T* a_s, int S, int K, F&& f) {
  const int c8 = ((K + ws::BK - 1) / ws::BK) * ws::BK / 8, n = ST_ROWS * c8;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, s = i / c8, k = (i - s * c8) * 8;
      v[u] = i < n && s < S && k < K ? f(s, k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, s = i / c8, k = (i - s * c8) * 8;
      if (i < n) *reinterpret_cast<uint4*>(a_s + s * ST_LD + k) = v[u];
    }
  }
  __syncthreads();
}

// Start the copies of rows [0, S) x columns [0, K) of a (S, K) 16-bit
// matrix into a_s (row stride ST_LD), K % 8 == 0: one commit group
template <typename T>
__device__ __forceinline__ void copy_rows(T* a_s, const T* __restrict__ src, int S, int K) {
  const int c8 = K / 8;
  for (int i = threadIdx.x; i < S * c8; i += THREADS) {
    const int s = i / c8, k = (i - s * c8) * 8;
    gemm::cp_async16(a_s + s * ST_LD + k, src + static_cast<size_t>(s) * K + k, true);
  }
  gemm::cp_async_commit();
}

// eight floats rounded to T and packed
template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack2<T>(x[0], x[1]), pack2<T>(x[2], x[3]), pack2<T>(x[4], x[5]),
                    pack2<T>(x[6], x[7]));
}

template <typename T>
__device__ __forceinline__ const T* no_rows(int) { return nullptr; }

// row_rsqrt over rows of a 16-bit tile in shared memory (row stride ST_LD)
template <typename T>
__device__ __forceinline__ void row_rsqrt_rows(const T* a_s, int S, int D, float eps, float* r) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < S; s += WARPS) {
    float ss = 0.f;
    for (int k = lane * 8; k < D; k += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(a_s + s * ST_LD + k);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = to_f(e[i]);
        ss += v * v;
      }
    }
    ss = warp_sum(ss);
    if (lane == 0) r[s] = 1.f / sqrtf(ss / static_cast<float>(D) + eps);
  }
  __syncthreads();
}

// (a) on the stream: the normed rows staged, each head's projection, the
// rope. An item is one 16-row tile: rows j..j+7 of a head and their rope
// partners j+hd/2..j+hd/2+7, so the rope pairs tile rows r and r + 8.
template <typename T>
__device__ void qkv_stream(const Args<T>& a, T* a_s, unsigned char* ring, float* red, float* r_s) {
  const int D = a.D, hd = a.hd, hd2 = a.hd / 2, H = a.H, KV = a.KV, S = a.S;
  const int jt = (hd2 + 7) / 8;   // items per head
  stream_product<T, 1, false>(
      (H + 2 * KV) * jt, D, a.wq, a_s, ring, red,
      [&] {   // h's rows into a_s, w_norm into red
        for (int i = threadIdx.x; i < D / 8; i += THREADS)
          gemm::cp_async16(reinterpret_cast<T*>(red) + 8 * i, a.wn1 + 8 * i, true);
        copy_rows(a_s, a.h, S, D);
      },
      [&] {   // x = T(T(h * r) * w_norm) in place
        const T* wn = reinterpret_cast<const T*>(red);
        row_rsqrt_rows(a_s, S, D, a.eps, r_s);
        stage_act(a_s, S, D, [&](int s, int k) {
          const uint4 hv = *reinterpret_cast<const uint4*>(a_s + s * ST_LD + k);
          const uint4 wv = *reinterpret_cast<const uint4*>(wn + k);
          const T* he = reinterpret_cast<const T*>(&hv);
          const T* we = reinterpret_cast<const T*>(&wv);
          float x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = round_as<T>(to_f(he[i]) * r_s[s]) * to_f(we[i]);
          return pack8<T>(x);
        });
      },
      [&](int item, int r) -> const T* {
        const int head = item / jt, j = (item % jt) * 8 + (r & 7);
        if (j >= hd2) return nullptr;
        const T* base = head < H ? a.wq + static_cast<size_t>(head) * hd * D
                      : head < H + KV ? a.wk + static_cast<size_t>(head - H) * hd * D
                                      : a.wv + static_cast<size_t>(head - H - KV) * hd * D;
        return base + static_cast<size_t>(r < 8 ? j : j + hd2) * D;
      },
      no_rows<T>,
      [&](int item, auto sum) {
        const int head = item / jt, jb = (item % jt) * 8;
        for (int i = threadIdx.x; i < 8 * S; i += THREADS) {
          const int r = i / S, s = i - r * S, j = jb + r;
          if (j >= hd2) continue;
          float t1 = round_as<T>(sum(r, s)), t2 = round_as<T>(sum(r + 8, s));
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
        }
      });
}

// (d) on the stream: hacc = h + attn wo^T (layer) or out = T(attn wo^T)
template <typename T, bool MLP>
__device__ void out_proj_stream(const Args<T>& a, T* a_s, unsigned char* ring, float* red) {
  const int D = a.D, K = a.H * a.hd, S = a.S;
  stream_product<T, 1, false>(
      (D + 15) / 16, K, a.wo, a_s, ring, red,
      [&] { copy_rows(a_s, a.attn_ws, S, K); },
      [&] {   // zeros in rows S..7 and past K
        stage_act(a_s, S, K, [&](int s, int k) {
          return *reinterpret_cast<const uint4*>(a_s + s * ST_LD + k);
        });
      },
      [&](int item, int r) -> const T* {
        const int n = item * 16 + r;
        return n < D ? a.wo + static_cast<size_t>(n) * K : nullptr;
      },
      no_rows<T>,
      [&](int item, auto sum) {
        for (int i = threadIdx.x; i < 16 * S; i += THREADS) {
          const int r = i / S, s = i - r * S, n = item * 16 + r;
          if (n >= D) continue;
          const size_t o = static_cast<size_t>(s) * D + n;
          if (MLP)
            a.hacc[o] = to_f(a.h[o]) + sum(r, s);
          else
            a.out[o] = from_f<T>(sum(r, s));
        }
      });
}

// (e) on the stream: y = T(T(act(x2 wg^T)) * T(x2 wu^T)), x2 = T(T(hacc * r2) * wn2)
template <typename T>
__device__ void gate_up_stream(const Args<T>& a, T* a_s, unsigned char* ring, float* red,
                               float* r_s) {
  const int D = a.D, F = a.F, S = a.S;
  stream_product<T, 2, false>(
      (F + 15) / 16, D, a.wg, a_s, ring, red, [] {},
      [&] {
        row_rsqrt(a.hacc, S, D, a.eps, r_s);
        stage_act(a_s, S, D, [&](int s, int k) {
          const float* hv = a.hacc + static_cast<size_t>(s) * D + k;
          const float4 h0 = *reinterpret_cast<const float4*>(hv);
          const float4 h1 = *reinterpret_cast<const float4*>(hv + 4);
          const uint4 wv = *reinterpret_cast<const uint4*>(a.wn2 + k);
          const T* we = reinterpret_cast<const T*>(&wv);
          float x[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = round_as<T>(x[i] * r_s[s]) * to_f(we[i]);
          return pack8<T>(x);
        });
      },
      [&](int item, int r) -> const T* {
        const int f = item * 16 + (r & 15);
        if (f >= F) return nullptr;
        return (r < 16 ? a.wg : a.wu) + static_cast<size_t>(f) * D;
      },
      no_rows<T>,
      [&](int item, auto sum) {
        for (int i = threadIdx.x; i < 16 * S; i += THREADS) {
          const int r = i / S, s = i - r * S, f = item * 16 + r;
          if (f >= F) continue;
          const float ga = round_as<T>(mlp::act_fn(sum(r, s), a.act));
          a.y_ws[static_cast<size_t>(s) * F + f] = from_f<T>(ga * round_as<T>(sum(r + 16, s)));
        }
      });
}

// (f) on the stream: out = T(hacc + y wd^T), y beside the weight in the ring
template <typename T>
__device__ void down_stream(const Args<T>& a, unsigned char* ring, float* red) {
  const int D = a.D, F = a.F, S = a.S;
  stream_product<T, 1, true>(
      (D + 15) / 16, F, a.wd, nullptr, ring, red, [] {}, [] {},
      [&](int item, int r) -> const T* {
        const int n = item * 16 + r;
        return n < D ? a.wd + static_cast<size_t>(n) * F : nullptr;
      },
      [&](int s) -> const T* { return s < S ? a.y_ws + static_cast<size_t>(s) * F : nullptr; },
      [&](int item, auto sum) {
        for (int i = threadIdx.x; i < 16 * S; i += THREADS) {
          const int r = i / S, s = i - r * S, n = item * 16 + r;
          if (n >= D) continue;
          const size_t o = static_cast<size_t>(s) * D + n;
          a.out[o] = from_f<T>(a.hacc[o] + sum(r, s));
        }
      });
}

// Shared memory of one block, in bytes: the design's product buffers or the
// attention phase's chunks (the stream design's two groups: two), whichever
// is larger, then S row statistics.
template <typename T>
__host__ __device__ __forceinline__ int smem_bytes(bool stream, int S, int G, int hd, int keys) {
  const int ng = stream ? STREAM_GROUPS : 1;
  const int a = ng * static_cast<int>(
                         chunk::align16(chunk::smem_bytes(G, hd, keys, sizeof(T), THREADS / ng)));
  const int m = stream ? STREAM_BYTES : ACT_BYTES;
  return (a > m ? a : m) + align16(S * 4);
}

template <typename T, bool MLP, bool STREAM>
__global__ void __launch_bounds__(THREADS) decode_layer_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* a_s = reinterpret_cast<T*>(smem);
  float* r_s = reinterpret_cast<float*>(smem + smem_bytes<T>(STREAM, 0, a.H / a.KV, a.hd, a.keys));
  cg::grid_group grid = cg::this_grid();
  if constexpr (STREAM) {
    unsigned char* ring = smem + ST_ACT_BYTES;
    float* red = reinterpret_cast<float*>(smem + ST_ACT_BYTES + RING_BYTES);
    qkv_stream(a, a_s, ring, red, r_s);
    grid.sync();
    attention_phase<T, STREAM_GROUPS>(a, smem, reinterpret_cast<int*>(r_s));
    grid.sync();
    combine_phase(a);
    grid.sync();
    out_proj_stream<T, MLP>(a, a_s, ring, red);
    if (MLP) {
      grid.sync();
      gate_up_stream(a, a_s, ring, red, r_s);
      grid.sync();
      down_stream(a, ring, red);
    }
  } else {
    qkv_phase(a, a_s, r_s);
    grid.sync();
    attention_phase<T, 1>(a, smem, reinterpret_cast<int*>(r_s));
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
}

// Whether `design` takes these shapes (the wrapper's cudaex.decode_design
// picks one that does): stream needs a 16-bit T, S <= 8 and every staged K
// (D, H hd) within ST_COLS.
template <typename T>
__host__ bool design_fits(int design, int S, int D, int H, int hd) {
  if (design == DESIGN_FMA) return true;
  return design == DESIGN_STREAM && is_16bit<T>() && S <= ST_ROWS && D <= ST_COLS &&
         H * hd <= ST_COLS;
}

// One cooperative launch: as many blocks as fit on the card at once. Returns
// a CUDA error code (cudaErrorCooperativeLaunchTooLarge and the like when the
// card refuses), never falls back.
template <typename T, bool MLP, bool STREAM>
int launch_design(const Args<T>& a, int device, cudaStream_t stream) {
  auto kernel = decode_layer_kernel<T, MLP, STREAM>;
  const int smem = smem_bytes<T>(STREAM, a.S, a.H / a.KV, a.hd, a.keys);
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

template <typename T, bool MLP>
int launch(const Args<T>& a, int design, int device, cudaStream_t stream) {
  if (!design_fits<T>(design, a.S, a.D, a.H, a.hd) || a.keys < 4 || a.keys % 4 ||
      static_cast<long long>(a.nch) * a.keys < static_cast<long long>(a.npg) * a.ps)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (is_16bit<T>()) {
    if (design == DESIGN_STREAM) return launch_design<T, MLP, true>(a, device, stream);
  }
  return launch_design<T, MLP, false>(a, device, stream);
}

}  // namespace decode
}  // namespace tt
