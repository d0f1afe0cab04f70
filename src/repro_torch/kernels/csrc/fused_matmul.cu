// Fused OISMA matmul: encode, multiply on the int8 tensor cores, rescale.
//
// Replaces: repro/kernels/fused.py, fused_bp_matmul_pallas (kernel
// _fused_matmul_kernel, encode _encode_planes).
//
// Bound on the H100: bytes at decode and prefill, operations from a few
// hundred rows up.  On the main path M is 1-8 rows at decode and up to 64
// at prefill, so each weight element is used by only M rows; the weight is
// read once in the dtype the model stores it in (bf16, 2 bytes an element;
// f32 or int8 codes where the caller holds those).  As the BP product over
// 8x-expanded planes it is 2 x M x N x 8K int8 operations: at 256 rows and
// more that, at the tensor cores' 1979 TOP/s, outweighs the bytes.
//
// Design (bp_mma.cuh, one weight): the weight streams through a cp.async
// ring of shared-memory stages while the current tile is encoded by
// comparison with per-call plane boundaries (no division; a bf16 value is
// widened to f32 first, exactly as the TPU kernel casts its tile) into
// {-1, 0, 1} int8 planes and multiplied with mma.sync m16n8k32 s8 into
// exact int32 sums.  At decode the K split puts several blocks on every
// SM; the split sums meet in an int32 workspace by atomics (exact in any
// order) and the last split of each tile applies acc * ((sx * sy) * 0.1f):
// bitwise the reference.  A call is at most two launches: the workspace's
// memset (only when K is split) and the tiles.
#include "bp_mma.cuh"

// y_kind: 0 f32, 1 bf16, 2 int8 sign*level codes (oisma_mma::Kind).
extern "C" int oisma_fused_matmul(const float* x, const void* y, int y_kind,
                                  const float* sx, const float* sy,
                                  float* out, int* ws, int M, int K, int N,
                                  unsigned thr_r, unsigned thr_l,
                                  cudaStream_t stream) {
  oisma_mma::Params p{};
  p.x = x;
  p.y[0] = p.y[1] = y;
  p.sx = sx;
  p.sy[0] = p.sy[1] = sy;
  p.out = out;
  p.ws = ws;
  p.M = M;
  p.K = K;
  p.N = N;
  p.thr_r = thr_r;
  p.thr_l = thr_l;
  return oisma_mma::with_kind(y_kind, [&](auto t) {
    return oisma_mma::launch_bp_mma<decltype(t), 1>(p, stream);
  });
}

// int32 words of workspace a call at (M, K, N) needs.
extern "C" long long oisma_fused_matmul_workspace(int M, int K, int N,
                                                  int y_kind) {
  return oisma_mma::with_kind(y_kind, [&](auto t) {
    return (long long)oisma_mma::workspace_words<decltype(t), 1>(M, K, N);
  });
}

// Dynamic shared memory of the tile kernel a call at M rows uses.
extern "C" int oisma_fused_matmul_smem(int M, int y_kind) {
  return oisma_mma::with_kind(y_kind, [&](auto t) {
    return oisma_mma::smem_bytes<decltype(t), 1>(M);
  });
}
