// The one-read RMS norm row shared by rms_norm.cu and rms_norm_residual.cu:
// their `vector` design.
//
// The block is sized to the row, so no thread loops: a thread loads V 16-byte
// vectors of the row (8 bf16/fp16 or 4 f32 values each; V = 1, 2, 4 or 8,
// the fewest that keep a row within THREADS threads) and keeps them in
// registers, so the sum of squares and the scaled output come from one read
// of device memory. With RES (rms_norm_residual) the row is h = r + x,
// rounded to T before any statistics and stored as 16-byte vectors as it is
// formed; without it the row is x. The weight is read as vectors of the same
// values, the output written as vectors. Rows of at most 32 threads share a
// block (BLOCK threads) and reduce with warp shuffles alone; a longer row has
// a block of its own and reduces with a warp shuffle plus one shared-memory
// step. Neighbouring threads read neighbouring 16-byte vectors.
//
// Rounding, as the reference's kernels: the normalised row is rounded to T
// before the weight multiply (in f32), and the product is rounded to O.
//
// Statistics: 16-bit rows sum their squares in float32. float32 rows (the
// configuration the card is compared with the CPU in) sum them in float64
// and round the mean once, so the card's statistics are exact to float32
// rounding and a card-vs-CPU difference is the CPU sum's own rounding: with
// float32 sums in this routine's order, the f32 tiny-gqa bench step's bf16
// m slab drifted past chip_smoke.py's phase-12 bound at one element.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rowvec {

constexpr int THREADS = 512;   // most threads a row takes
constexpr int BLOCK = 256;     // a block of rows of at most 32 threads each

// N values of T read or written as one access of N * sizeof(T) bytes (two
// 16-byte accesses for 32: the wrappers align every base to 16 bytes only)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

// One row of the vector design: `tpr` threads a row (a power of two up to
// 32, several rows a block; or a multiple of 32, the whole block), `active`
// of them holding V vectors of N values each, vector v of thread j at column
// (v * active + j) * N; nv = D / N vectors a row. `red` holds THREADS / 32
// doubles of shared memory. r and h are read and written only with RES.
template <typename T, typename W, typename O, int V, bool RES>
__device__ __forceinline__ void norm_row(const T* __restrict__ r, const T* __restrict__ x,
                                         const W* __restrict__ w, T* __restrict__ h,
                                         O* __restrict__ out, long long n_rows, int D, int tpr,
                                         int active, float eps, void* red_raw) {
  constexpr int N = 16 / sizeof(T);
  // the sum of squares: float, or double for float32 rows (below)
  using A = typename std::conditional<std::is_same<T, float>::value, double, float>::type;
  A* red = static_cast<A*>(red_raw);
  const int j = threadIdx.x % tpr;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < n_rows && j < active;
  const int nv = D / N;
  const long long off = row * D;

  float xv[V][N];
  A ss = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = v * active + j;
    if (live && c < nv) {
      const Vec<T, N> a = *reinterpret_cast<const Vec<T, N>*>(x + off + c * N);
      if constexpr (RES) {
        const Vec<T, N> b = *reinterpret_cast<const Vec<T, N>*>(r + off + c * N);
        Vec<T, N> hv;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          hv.v[e] = tt::from_f<T>(tt::to_f(b.v[e]) + tt::to_f(a.v[e]));
          xv[v][e] = tt::to_f(hv.v[e]);
          ss += static_cast<A>(xv[v][e]) * static_cast<A>(xv[v][e]);
        }
        *reinterpret_cast<Vec<T, N>*>(h + off + c * N) = hv;
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          xv[v][e] = tt::to_f(a.v[e]);
          ss += static_cast<A>(xv[v][e]) * static_cast<A>(xv[v][e]);
        }
      }
    }
  }
  if (tpr <= 32) {
    for (int o = tpr / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  } else {
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) ss += red[i];
  }
  if (!live) return;
  const float inv = 1.f / sqrtf(static_cast<float>(ss / static_cast<A>(D)) + eps);
  O* orow = out + off;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int c = v * active + j;
    if (c >= nv) continue;
    Vec<W, N> wv{};
    if (w != nullptr) wv = *reinterpret_cast<const Vec<W, N>*>(w + c * N);
    Vec<O, N> y;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float o = tt::round_as<T>(xv[v][e] * inv);
      if (w != nullptr) o *= tt::to_f(wv.v[e]);
      y.v[e] = tt::from_f<O>(o);
    }
    *reinterpret_cast<Vec<O, N>*>(orow + c * N) = y;
  }
}

// The launch of a row of D values of T: V vectors a thread for `active`
// threads, rows of `tpr` threads, `per_block` rows a block. `fits` is false
// where D is off the 16-byte multiples or the row does not fit the
// registers (more than 8 * THREADS vectors): the caller refuses the design.
struct Geometry {
  bool fits;
  int V, active, tpr, per_block;
  unsigned blocks;
};

inline Geometry geometry(long long n_rows, int D, int elem_bytes) {
  Geometry g{};
  const int N = 16 / elem_bytes;
  const int nv = D / N;
  g.fits = D % N == 0 && nv > 0 && nv <= 8 * THREADS;
  if (!g.fits) return g;
  // the fewest vectors a thread that keep the row within THREADS threads
  g.V = nv <= THREADS ? 1 : nv <= 2 * THREADS ? 2 : nv <= 4 * THREADS ? 4 : 8;
  g.active = (nv + g.V - 1) / g.V;
  g.tpr = g.active <= 32 ? 1 : (g.active + 31) / 32 * 32;
  if (g.active <= 32)
    while (g.tpr < g.active) g.tpr *= 2;
  g.per_block = g.tpr <= 32 ? BLOCK / g.tpr : 1;
  g.blocks = static_cast<unsigned>((n_rows + g.per_block - 1) / g.per_block);
  return g;
}

// f(std::integral_constant<int, V>{}) for the geometry's V
template <typename F>
void with_vectors(int V, F&& f) {
  switch (V) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default: f(std::integral_constant<int, 8>{}); break;
  }
}

}  // namespace rowvec
