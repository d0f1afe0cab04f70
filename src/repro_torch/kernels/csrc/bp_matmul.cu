// Codes matmul of the unfused OISMA pipeline: the signed BP8 product of
// int8 sign*level codes, returned as the exact integer sums in f32.
//
// Replaces: repro/kernels/bp_matmul.py, bp_matmul_pallas (kernel
// _bp_matmul_kernel, expansion _expand_planes).
//
// Bound on the H100: operations at the pipeline's prefill shapes (256 rows:
// each code of y meets 256 rows, 8 plane products each, counted as int8
// tensor-core operations), bytes at decode (4 rows: y's codes are read
// once, one byte each).
//
// Design (bp_tile.cuh): the TPU kernel expands both code tiles into
// 8 signed f32 or bf16 bitplanes in VMEM and runs one MXU dot.  Here each
// code expands, through the plane thresholds, into its BP8 mask; four k
// pack into one word per sign and one product of four k is two popcounts
// of ANDs.  The sums are exact integers (|acc| <= 8K), so the split over K
// and its int32 atomics give the same bits in any order, and the unscaled
// f32 epilogue equals the TPU kernel's f32 result bitwise, whatever its
// compute dtype.  No operand is padded: the tiles mask their edges, and a
// zero code adds nothing.
#include "bp_tile.cuh"

extern "C" int oisma_bp_matmul(const int8_t* x, const int8_t* y, float* out,
                               int* ws, int M, int K, int N, unsigned thr_r,
                               unsigned thr_l, cudaStream_t stream) {
  return oisma::launch_bp(x, y, out, ws, M, K, N, thr_r, thr_l, stream);
}
