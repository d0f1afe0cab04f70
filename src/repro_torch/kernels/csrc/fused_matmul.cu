// Fused OISMA matmul: encode, AND+popcount, rescale on the card.
//
// Replaces: repro/kernels/fused.py, fused_bp_matmul_pallas (kernel
// _fused_matmul_kernel, encode _encode_planes).
//
// Bound on the H100: bytes.  On the main path M is 1-8 rows at decode and
// up to 64 at prefill, so each weight element is used by only M rows; the
// f32 weight (the reference casts bf16 weights to f32 per call) is read
// once, 4 bytes per element, and the arithmetic (2 popcounts per 4 k per
// output) stays far below the integer rate.
//
// Design (bp_tile.cuh): each block owns a (BM x 64) output tile and a
// share of K, encodes its x and y tiles into packed BP8 sign words in
// shared memory once per 64 k, accumulates exact int32 sums, and adds them
// into an int32 workspace; a second kernel applies the f32 epilogue.  The
// split over K gives every SM several blocks at decode, where the output
// alone gives only 10-40 tiles.  Integer sums make the split and its
// atomics order-free: the result is bitwise the reference's.  wgmma and
// TMA pipelining are later work.
#include "bp_tile.cuh"

extern "C" int oisma_fused_matmul(const float* x, const void* y, int y_coded,
                                  const float* sx, const float* sy,
                                  float* out, int* ws, int M, int K, int N,
                                  unsigned thr_r, unsigned thr_l,
                                  cudaStream_t stream) {
  using namespace oisma;
  if (y_coded)
    return launch_bp<1, true>(x, y, nullptr, sx, sy, nullptr, out, ws, M, K,
                              N, kNone, thr_r, thr_l, stream);
  return launch_bp<1, false>(x, y, nullptr, sx, sy, nullptr, out, ws, M, K, N,
                             kNone, thr_r, thr_l, stream);
}
