// One chunk of split-context decode attention, and the merge of a context's
// chunks: the routines of paged_decode_attention.cu and of the decode
// layer's attention phases (decode_layer.cuh).
//
// A block takes one chunk of C keys of one (request, kv head) context and
// the G grouped query rows that read it. It reads the chunk's block-table
// entries into shared memory, starts 16-byte cp.async copies of every K row
// of the chunk, then of every V row (each row's page from those entries;
// rows off the 16-byte multiples by scalar copies), scores all keys x G rows
// while V is still landing (a thread per (key, 4 rows), the K rows padded
// so that its 16-byte reads meet no bank conflict), runs
// the chunk's softmax in f32 a warp per row, and sums P V with each thread
// owning a column pair and one of up to 8 runs of keys for 4 rows (V read
// once per 4 rows, the probabilities four keys per 16-byte read), the runs
// added in order. It writes the chunk's (m, l, acc) in f32: m the largest
// score, l the sum of exp(s - m), acc the sum of p v, p unrounded or (the
// decode layer's rule) rounded to T first.
//
// The merge takes a context's chunks in chunk order: out = T(sum_c acc_c
// e^(m_c - m) / sum_c l_c e^(m_c - m)), a warp per query row, so that two
// calls give bit-identical results; a context of no chunk gives zeros.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tt {
namespace chunk {

constexpr int KPARTS_MAX = 8;   // runs of keys of the PV sums

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// column pairs of the PV sums, and the runs of keys that split them over
// `threads` threads
__host__ __device__ inline int col_pairs(int hd) { return (hd + 1) / 2; }
__host__ __device__ inline int key_parts(int hd, int threads) {
  const int k = threads / col_pairs(hd);
  return k < 1 ? 1 : (k > KPARTS_MAX ? KPARTS_MAX : k);
}

// Row stride of the staged K rows, in elements: 16 bytes of padding past
// rows of whole 16-byte vectors, so the 8 rows one 16-byte phase of the
// scores reads fall in distinct banks; one element past any other row.
__host__ __device__ inline int k_ld(int hd, int esize) {
  const int v = 16 / esize;
  return hd % v == 0 ? hd + v : hd + 1;
}

// Shared memory of one chunk of C keys, in bytes: the K rows (whose space
// the PV partial sums take once the scores are done), the V rows, the f32
// query rows, the f32 scores, the chunk's block-table entries (at most
// C + 1 pages). cudaex.paged_chunk_keys mirrors it.
__host__ __device__ inline size_t smem_bytes(int G, int hd, int C, int esize, int threads) {
  const size_t k = align16(static_cast<size_t>(C) * k_ld(hd, esize) * esize);
  const size_t v = align16(static_cast<size_t>(C) * hd * esize);
  const size_t red = align16(static_cast<size_t>(key_parts(hd, threads)) * col_pairs(hd) * 32);
  return (k > red ? k : red) + v + align16(static_cast<size_t>(G) * hd * 4) +
         align16(static_cast<size_t>(G) * C * 4) + align16(static_cast<size_t>(C + 1) * 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy keys [kbeg, kbeg + n4) of one kv head's pool (`pool`: its page 0)
// into `dst` as rows of hd at stride ld, each row's page from pg[] (the chunk's
// pages, from page kbeg / ps on); key `fresh` of the chunk (-1: none) comes
// from `fresh_row`, and keys at or past nk are zeros. One commit group.
template <typename T, int THREADS>
__device__ __forceinline__ void stage(T* dst, int ld, const T* __restrict__ pool, const int* pg,
                                      int kbeg, int nk, int n4, int ps, int hd, int fresh,
                                      const T* fresh_row, int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int p0 = kbeg / ps;
  if (hd % V == 0) {
    const int CH = hd / V;
#pragma unroll 4
    for (int i = tid; i < n4 * CH; i += THREADS) {
      const int j = i / CH, e = (i - j * CH) * V, pos = kbeg + j;
      const T* src = pool;
      if (j == fresh)
        src = fresh_row + e;
      else if (j < nk)
        src = pool + (static_cast<size_t>(pg[pos / ps - p0]) * ps + pos % ps) * hd + e;
      cp_async16(dst + static_cast<size_t>(j) * ld + e, src, j < nk);
    }
  } else {
    for (int i = tid; i < n4 * hd; i += THREADS) {
      const int j = i / hd, e = i - j * hd, pos = kbeg + j;
      dst[static_cast<size_t>(j) * ld + e] =
          j == fresh ? fresh_row[e]
          : j < nk   ? pool[(static_cast<size_t>(pg[pos / ps - p0]) * ps + pos % ps) * hd + e]
                     : from_f<T>(0.f);
    }
  }
  cp_async_commit();
}

// A barrier of the whole block, or of one group of THREADS threads that
// runs a chunk of its own (named barrier 1 + group; 0 is __syncthreads's).
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
template <int THREADS>
struct GroupSync {
  int id;
  __device__ __forceinline__ void operator()() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
  }
};

// One chunk: keys [kbeg, kbeg + nk) of the context whose block-table row is
// btr, against the G query rows q (T); writes out[g * (2 + hd) + {0, 1, 2 +
// e}] = (m, l, acc[e]) for each row g. THREADS threads call it, tid their
// index among them and sync() their barrier; it ends with that barrier,
// after which `smem` may be reused.
template <typename T, int THREADS, bool ROUND_P, class Sync>
__device__ void run(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ btr, int kbeg, int nk,
                    int ps, int hd, int G, int C, float scale, int fresh, const T* fresh_k,
                    const T* fresh_v, unsigned char* smem, float* __restrict__ out, int tid,
                    Sync sync) {
  constexpr int WARPS = THREADS / 32;
  const int n4 = (nk + 3) & ~3;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int ld = k_ld(hd, sizeof(T));
  const size_t k_bytes = align16(static_cast<size_t>(C) * ld * sizeof(T));
  const size_t v_bytes = align16(static_cast<size_t>(C) * hd * sizeof(T));
  const size_t red_bytes = align16(static_cast<size_t>(key_parts(hd, THREADS)) * col_pairs(hd) * 32);
  T* ks = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem);   // over ks, once the scores are done
  unsigned char* p = smem + (k_bytes > red_bytes ? k_bytes : red_bytes);
  T* vs = reinterpret_cast<T*>(p);
  float* qs = reinterpret_cast<float*>(p + v_bytes);
  float* ss = qs + align16(static_cast<size_t>(G) * hd * 4) / 4;
  int* pg = reinterpret_cast<int*>(ss + align16(static_cast<size_t>(G) * C * 4) / 4);

  const int p0 = kbeg / ps, np = (kbeg + nk - 1) / ps - p0 + 1;
  for (int i = tid; i < np; i += THREADS) pg[i] = btr[p0 + i];
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = to_f(q[i]);
  sync();
  stage<T, THREADS>(ks, ld, kpool, pg, kbeg, nk, n4, ps, hd, fresh, fresh_k, tid);
  stage<T, THREADS>(vs, hd, vpool, pg, kbeg, nk, n4, ps, hd, fresh, fresh_v, tid);
  cp_async_wait<1>();   // the K rows have landed; V may still be in flight
  sync();

  // scores: a thread per (key, 4 query rows), each K row read 16 bytes at a
  // time from its padded row, the query rows' values broadcast
  const int ngg = (G + 3) / 4;
  for (int t = tid; t < nk * ngg; t += THREADS) {
    const int j = t % nk, g0 = (t / nk) * 4;
    const T* kr = ks + static_cast<size_t>(j) * ld;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (hd % V == 0) {
      for (int e0 = 0; e0 < hd; e0 += V) {
        const uint4 kv = *reinterpret_cast<const uint4*>(kr + e0);
        const T* ke = reinterpret_cast<const T*>(&kv);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (g0 + g >= G) break;
          const float4* qv = reinterpret_cast<const float4*>(qs + (g0 + g) * hd + e0);
#pragma unroll
          for (int h = 0; h < V / 4; ++h) {
            const float4 qq = qv[h];
            d[g] = fmaf(qq.x, to_f(ke[4 * h]), d[g]);
            d[g] = fmaf(qq.y, to_f(ke[4 * h + 1]), d[g]);
            d[g] = fmaf(qq.z, to_f(ke[4 * h + 2]), d[g]);
            d[g] = fmaf(qq.w, to_f(ke[4 * h + 3]), d[g]);
          }
        }
      }
    } else {   // rows off the 16-byte multiples
      for (int e = 0; e < hd; ++e) {
        const float k = to_f(kr[e]);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (g0 + g < G) d[g] = fmaf(qs[(g0 + g) * hd + e], k, d[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (g0 + g < G) ss[(g0 + g) * C + j] = d[g] * scale;
  }
  sync();

  // the chunk's softmax, a warp per query row: (m, l) out, the probabilities
  // in place of the scores (zeros up to n4)
  for (int g = warp; g < G; g += WARPS) {
    float* s = ss + g * C;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, s[j]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < n4; j += 32) {
      const float e = j < nk ? expf(s[j] - m) : 0.f;
      s[j] = ROUND_P ? round_as<T>(e) : e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      out[g * (2 + hd)] = m;
      out[g * (2 + hd) + 1] = l;
    }
  }
  cp_async_wait<0>();
  sync();   // V has landed; the probabilities are written; ks is free

  // PV, 4 query rows at a time: a thread per (column pair, run of keys), V
  // read once for the 4 rows, the probabilities 4 keys per read; the runs'
  // sums meet in `red` and are added in run order
  const int ncp = col_pairs(hd), kparts = key_parts(hd, THREADS);
  const int kper = ((n4 / 4 + kparts - 1) / kparts) * 4;
  for (int g0 = 0; g0 < G; g0 += 4) {
    for (int t = tid; t < ncp * kparts; t += THREADS) {
      const int cp = t % ncp, kp = t / ncp, e = 2 * cp;
      const bool two = e + 1 < hd;
      const int j0 = kp * kper, j1 = min(n4, j0 + kper);
      float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      for (int j = j0; j < j1; j += 4) {
        float4 pr[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pr[g] = g0 + g < G ? *reinterpret_cast<const float4*>(ss + (g0 + g) * C + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const T* vr = vs + static_cast<size_t>(j + jj) * hd + e;
          const float v0 = to_f(vr[0]), v1 = two ? to_f(vr[1]) : 0.f;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float pv = jj == 0 ? pr[g].x : jj == 1 ? pr[g].y : jj == 2 ? pr[g].z : pr[g].w;
            acc[g][0] = fmaf(pv, v0, acc[g][0]);
            acc[g][1] = fmaf(pv, v1, acc[g][1]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        red[((kp * 4 + g) * ncp + cp) * 2] = acc[g][0];
        red[((kp * 4 + g) * ncp + cp) * 2 + 1] = acc[g][1];
      }
    }
    sync();
    for (int i = tid; i < 4 * hd; i += THREADS) {
      const int g = i / hd, e = i - g * hd;
      if (g0 + g >= G) continue;
      float s = 0.f;
      for (int kp = 0; kp < kparts; ++kp) s += red[((kp * 4 + g) * ncp + e / 2) * 2 + (e & 1)];
      out[(g0 + g) * (2 + hd) + 2 + e] = s;
    }
    sync();
  }
}

// Merge the first nc chunks of one context: part[c * G * (2 + hd) + g * (2 +
// hd) + ...] = chunk c's (m, l, acc) of row g; out[g * hd + e] = T(sum_c
// acc_c e^(m_c - m) / sum_c l_c e^(m_c - m)), in chunk order, zeros where nc
// is 0. A warp per (row, 128 columns), each lane 4 columns. The chunks go
// 32 at a time: lane c holds chunk c's weight e^(m_c - m) and l_c, which
// every lane takes in order by shuffles, and the acc loads of four chunks
// are issued before their sums, so the loads overlap.
template <typename T, int THREADS>
__device__ void merge(const float* __restrict__ part, int nc, int G, int hd, T* __restrict__ out) {
  constexpr int WARPS = THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = static_cast<size_t>(G) * (2 + hd);
  const int spans = (hd + 127) / 128;
  for (int t = warp; t < G * spans; t += WARPS) {
    const int g = t / spans, e0 = (t - g * spans) * 128 + lane;
    const float* pg = part + g * (2 + hd);
    float m = -INFINITY;
    for (int c = lane; c < nc; c += 32) m = fmaxf(m, pg[c * stride]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int n = min(32, nc - c0);
      const float* pc = pg + (c0 + lane) * stride;
      const float w_mine = lane < n ? expf(pc[0] - m) : 0.f;
      const float l_mine = lane < n ? pc[1] : 0.f;
      for (int c = 0; c < n; c += 4) {
        float v[4][4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[cc][i] = c + cc < n && e0 + 32 * i < hd
                           ? pg[(c0 + c + cc) * stride + 2 + e0 + 32 * i] : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float w = __shfl_sync(0xffffffffu, w_mine, (c + cc) & 31);
          const float lc = __shfl_sync(0xffffffffu, l_mine, (c + cc) & 31);
          if (c + cc < n) {
            l = fmaf(lc, w, l);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] = fmaf(v[cc][i], w, acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (e0 + 32 * i < hd) out[g * hd + e0 + 32 * i] = from_f<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

}  // namespace chunk
}  // namespace tt
