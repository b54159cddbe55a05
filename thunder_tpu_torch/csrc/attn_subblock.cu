// The attention sub-block of one T == 1 decode step in one cooperative
// launch: the kernel of decode_layer.cuh with its MLP phases compiled out,
// out = T(merge_heads(attn) wo^T) before the residual add.
//
// Replaces: thunder_tpu/executors/pallasex.py pallas_attn_subblock (:1743),
// which runs _decode_call (:1623). Bound on an H100: bytes, 114.3 MB at
// S = 8, D = 4096, H = 32, KV = 8, hd = 128, bf16 with 7425 context tokens
// (q/k/v/o weights 83.9 MB, K/V 30.4 MB): 0.034 ms at 3.35 TB/s.
#include "decode_layer.cuh"

namespace {

template <typename T>
int run(const void* h, const void* wn1, const void* wq, const void* wk, const void* wv,
        const void* wo, const void* cos, const void* sin, const void* kp, const void* vp,
        const void* bt, const void* ln, void* out, void* k_rows, void* v_rows, void* q_ws,
        void* part, void* attn_ws, int S, int D, int H, int KV, int hd, int P, int ps, int npg,
        int keys, int nch, float eps, float scale, int design, int device,
        cudaStream_t stream) {
  tt::decode::Args<T> a{};
  a.h = static_cast<const T*>(h);
  a.wn1 = static_cast<const T*>(wn1);
  a.wq = static_cast<const T*>(wq);
  a.wk = static_cast<const T*>(wk);
  a.wv = static_cast<const T*>(wv);
  a.wo = static_cast<const T*>(wo);
  a.cos = static_cast<const T*>(cos);
  a.sin = static_cast<const T*>(sin);
  a.kp = static_cast<const T*>(kp);
  a.vp = static_cast<const T*>(vp);
  a.bt = static_cast<const int*>(bt);
  a.ln = static_cast<const int*>(ln);
  a.out = static_cast<T*>(out);
  a.k_rows = static_cast<T*>(k_rows);
  a.v_rows = static_cast<T*>(v_rows);
  a.q_ws = static_cast<T*>(q_ws);
  a.part = static_cast<float*>(part);
  a.attn_ws = static_cast<T*>(attn_ws);
  a.S = S; a.D = D; a.H = H; a.KV = KV; a.hd = hd; a.P = P; a.ps = ps; a.npg = npg;
  a.keys = keys; a.nch = nch; a.eps = eps; a.scale = scale;
  return tt::decode::launch<T, false>(a, design, device, stream);
}

}  // namespace

// design: 0 fma, 1 stream, as cudaex.decode_design chooses; a design the
// shapes do not fit is refused (decode_layer.cuh design_fits).
extern "C" int tt_attn_subblock(const void* h, const void* wn1, const void* wq, const void* wk,
                                const void* wv, const void* wo, const void* cos, const void* sin,
                                const void* kp, const void* vp, const void* bt, const void* ln,
                                void* out, void* k_rows, void* v_rows, void* q_ws, void* part,
                                void* attn_ws, int S, int D, int H, int KV, int hd, int P, int ps,
                                int npg, int keys, int nch, float eps, float scale,
                                int design, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  auto s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  const cudaError_t err = tt::with_dtype(dtype, [&](auto tag) {
    rc = run<decltype(tag)>(h, wn1, wq, wk, wv, wo, cos, sin, kp, vp, bt, ln, out, k_rows, v_rows,
                            q_ws, part, attn_ws, S, D, H, KV, hd, P, ps, npg, keys, nch,
                            eps, scale, design, device, s);
    return cudaSuccess;
  });
  return err != cudaSuccess ? static_cast<int>(err) : rc;
}
