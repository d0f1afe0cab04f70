// Fused OISMA matmul: encode, multiply on the int8 tensor cores, rescale.
//
// Replaces: repro/kernels/fused.py, fused_bp_matmul_pallas (kernel
// _fused_matmul_kernel, encode _encode_planes).
//
// Bound on the H100: bytes at decode and prefill, operations from a few
// hundred rows up.  On the main path M is 1-8 rows at decode and up to 64
// at prefill, so each weight element is used by only M rows; the f32
// weight (the reference casts bf16 weights to f32 per call) is read once,
// 4 bytes per element.  As the BP product over 8x-expanded planes it is
// 2 x M x N x 8K int8 operations: at 256 rows and more that, at the
// tensor cores' 1979 TOP/s, outweighs the bytes.
//
// Design (bp_mma.cuh): the weight streams through a cp.async ring of
// shared-memory stages while the current tile is encoded by comparison
// with per-call plane boundaries (no division) into {-1, 0, 1} int8
// planes and multiplied with mma.sync m16n8k32 s8 into exact int32 sums.
// At decode the K split puts several blocks on every SM; the split sums
// meet in an int32 workspace by atomics (exact in any order) and the last
// split of each tile applies acc * ((sx * sy) * 0.1f): bitwise the
// reference.  A call is at most two launches: the workspace's memset
// (only when K is split) and the tiles.
#include "bp_mma.cuh"

extern "C" int oisma_fused_matmul(const float* x, const void* y, int y_coded,
                                  const float* sx, const float* sy,
                                  float* out, int* ws, int M, int K, int N,
                                  unsigned thr_r, unsigned thr_l,
                                  cudaStream_t stream) {
  using namespace oisma_mma;
  if (y_coded)
    return launch_bp_mma<true>(x, y, sx, sy, out, ws, M, K, N, thr_r, thr_l,
                               stream);
  return launch_bp_mma<false>(x, y, sx, sy, out, ws, M, K, N, thr_r, thr_l,
                              stream);
}

// int32 words of workspace a call at (M, K, N) needs.
extern "C" long long oisma_fused_matmul_workspace(int M, int K, int N,
                                                  int y_coded) {
  return (long long)oisma_mma::workspace_words(M, K, N, y_coded);
}


// Dynamic shared memory of the tile kernel a call at M rows uses.
extern "C" int oisma_fused_matmul_smem(int M, int y_coded) {
  using namespace oisma_mma;
  const int bm = plan(M, 1, 1, y_coded).bm;
  if (bm == 16) return y_coded ? Cfg<16, true>::kSmem : Cfg<16, false>::kSmem;
  if (bm == 64) return y_coded ? Cfg<64, true>::kSmem : Cfg<64, false>::kSmem;
  return y_coded ? Cfg<128, true>::kSmem : Cfg<128, false>::kSmem;
}
