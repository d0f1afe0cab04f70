// Codes matmul of the unfused OISMA pipeline: the signed BP8 product of
// int8 sign*level codes, returned as the exact integer sums in f32.
//
// Replaces: repro/kernels/bp_matmul.py, bp_matmul_pallas (kernel
// _bp_matmul_kernel, expansion _expand_planes).
//
// Bound on the H100: operations at the pipeline's prefill shapes (256 rows:
// each code of y meets 256 rows, 8 plane products each, counted as int8
// tensor-core operations, 2 x M x N x 8K at 1979 TOP/s), bytes at decode
// (4 rows: y's codes are read once, one byte each).
//
// Design (bp_mma.cuh, coded x and one coded weight): the TPU kernel
// expands both code tiles into 8 signed f32 or bf16 bitplanes in VMEM and
// runs one MXU dot.  Here both code tiles stream through a cp.async ring
// (16 codes a copy), each code is expanded in shared memory into its 8
// plane bytes in {-1, 0, 1} by comparing |code| with the plane thresholds
// (the level is the code itself: no boundary search, no scale), and the
// int8 tensor cores take the products: wgmma m64n128k32 at 128 rows, with
// the next step's encode overlapping the products, mma.sync m16n8k32 at
// 16 and 64.  The sums are exact integers (|acc| <= 8K), so the split
// over K gives the same bits in any order: the splits add their sums
// straight into the output as f32 (two columns an atomic), exact because
// every partial sum and total is an integer below 2^24, and that unscaled
// f32 result equals the TPU kernel's bitwise, whatever its compute dtype.
// A call is at most two launches, the output's memset (only when K is
// split) and the tiles, and needs no workspace.  No operand is padded: the
// tiles mask their edges, and a zero code adds nothing.
#include "bp_mma.cuh"

extern "C" int oisma_bp_matmul(const int8_t* x, const int8_t* y, float* out,
                               int M, int K, int N, unsigned thr_r,
                               unsigned thr_l, cudaStream_t stream) {
  oisma_mma::Params p{};
  p.x = x;
  p.y[0] = p.y[1] = y;
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.thr_r = thr_r;
  p.thr_l = thr_l;
  return oisma_mma::launch_bp_mma<int8_t, 1, int8_t>(p, stream);
}
