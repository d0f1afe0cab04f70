// Fused OISMA gated MLP: act(x @ w_gate) * (x @ w_up) on the int8 tensor
// cores.
//
// Replaces: repro/kernels/fused.py, fused_mlp_pallas (kernel
// _fused_mlp_kernel).
//
// Bound on the H100: bytes at decode and prefill.  The two (K x F) weights
// dominate and each is read once, in its stored dtype: bf16 on the served
// path (2 x 2560 x 6912 x 2 bytes on h2o-danube), f32 or int8 codes where
// the caller holds those; x (M <= 64 rows) is tiny.  At 64 rows the BP
// products (2 x 2 x M x F x 8K int8 operations) take about as long at the
// tensor cores' rate as the bytes.
//
// Design (bp_mma.cuh, two weights): each block encodes its x plane tile
// once per k step and multiplies it with the plane tiles of up and gate
// over the same columns, on mma.sync m16n8k32 s8, into two sets of exact
// int32 sums; both weights stream through the block's cp.async ring and
// are encoded by comparison with their own plane boundaries.  K is split
// at decode as for the matmul; both weights' split sums share one
// workspace and one memset, and the last split of a tile applies the
// epilogue: each sum rescaled in the reference's association, silu
// (g * (1 / (1 + exp(-g)))), tanh-gelu or relu on the gate, times up.  A
// call is at most two launches (the memset when K is split, the tiles),
// and the (M, F) projections never reach device memory.  Tolerance
// against the plain version: 1e-5 (expf/tanhf differ from the host's in
// the last bits); relu is bitwise.
#include "bp_mma.cuh"

// w_kind: 0 f32, 1 bf16, 2 int8 sign*level codes (both weights alike);
// act: 0 silu, 1 gelu, 2 relu.
extern "C" int oisma_fused_mlp(const float* x, const void* w_up,
                               const void* w_gate, int w_kind,
                               const float* sx, const float* s_up,
                               const float* s_gate, float* out, int* ws,
                               int M, int K, int F, int act, unsigned thr_r,
                               unsigned thr_l, cudaStream_t stream) {
  oisma_mma::Params p{};
  p.x = x;
  p.y[0] = w_up;
  p.y[1] = w_gate;
  p.sx = sx;
  p.sy[0] = s_up;
  p.sy[1] = s_gate;
  p.out = out;
  p.ws = ws;
  p.M = M;
  p.K = K;
  p.N = F;
  p.act = act;
  p.thr_r = thr_r;
  p.thr_l = thr_l;
  return oisma_mma::with_kind(w_kind, [&](auto t) {
    return oisma_mma::launch_bp_mma<decltype(t), 2>(p, stream);
  });
}

// int32 words of workspace a call at (M, K, F) needs.
extern "C" long long oisma_fused_mlp_workspace(int M, int K, int F,
                                               int w_kind) {
  return oisma_mma::with_kind(w_kind, [&](auto t) {
    return (long long)oisma_mma::workspace_words<decltype(t), 2>(M, K, F);
  });
}
