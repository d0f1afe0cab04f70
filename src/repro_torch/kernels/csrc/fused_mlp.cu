// Fused OISMA gated MLP: act(x @ w_gate) * (x @ w_up) on the card.
//
// Replaces: repro/kernels/fused.py, fused_mlp_pallas (kernel
// _fused_mlp_kernel).
//
// Bound on the H100: bytes.  The two (K x F) f32 weights dominate
// (2 x 2560 x 6912 x 4 bytes on h2o-danube) and each is read once; x
// (M <= 64 rows) is tiny.
//
// Design: the integer core of fused_matmul.cu (bp_tile.cuh) with two
// weight operands: one encode of each x tile feeds two exact int32
// accumulators (up and gate), split over K like the matmul.  The epilogue
// rescales each sum in the reference's association, applies silu
// (g * (1 / (1 + exp(-g)))), tanh-gelu or relu to the gate, and
// multiplies; only the int32 sums, never the f32 projections, touch
// device memory between the two kernels.  Tolerance against the plain
// version: 1e-5 (expf/tanhf differ from the host's in the last bits).
#include "bp_tile.cuh"

extern "C" int oisma_fused_mlp(const float* x, const void* w_up,
                               const void* w_gate, int w_coded,
                               const float* sx, const float* s_up,
                               const float* s_gate, float* out, int* ws,
                               int M, int K, int F, int act, unsigned thr_r,
                               unsigned thr_l, cudaStream_t stream) {
  using namespace oisma;
  if (w_coded)
    return launch_bp<2, true>(x, w_up, w_gate, sx, s_up, s_gate, out, ws, M,
                              K, F, act, thr_r, thr_l, stream);
  return launch_bp<2, false>(x, w_up, w_gate, sx, s_up, s_gate, out, ws, M, K,
                             F, act, thr_r, thr_l, stream);
}
