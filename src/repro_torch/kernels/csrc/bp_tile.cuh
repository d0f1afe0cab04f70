// Integer core of the codes matmul of the unfused pipeline (bp_matmul.cu).
// The fused matmul and the fused MLP run on bp_mma.cuh instead.
//
// The TPU kernel (repro/kernels/bp_matmul.py) expands each int8
// sign*level code tile into 8 signed bitplanes in VMEM and runs one MXU
// dot over the 8x-wide tiles.  Here the planes are never expanded.  Each
// code expands once per tile into its BP8 word -- an 8-bit mask, bit p set
// iff its level reaches the plane's threshold -- and four consecutive k of
// one row or column are packed into a 32-bit word, split by sign into a
// positive and a negative word.  One product of four k is then the
// in-array operation itself: AND, then popcount (the paper's parallel
// counters):
//
//   sum_k sx*sy*popc(mx & my) = popc((xp&yp)|(xn&yn)) - popc((xp&yn)|(xn&yp))
//
// (the positive and negative words of one operand never share a bit, so
// each OR joins disjoint sets).  The sum is an exact integer (|acc| <= 8K),
// so K can be split across blocks that add their partial sums into an int32
// workspace with atomics: integer addition in any order gives the same
// bits.  A second kernel writes the sums as f32, unscaled.
//
// Bytes: at decode M is a few rows, so the y codes are read once and used
// M times.  Each thread loads a 4 x 4 block of the y tile with four
// 4-byte loads in flight, and the split over K puts several blocks on
// every SM, so enough loads are in flight to cover the memory latency.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace oisma {

constexpr int kThreads = 256;
constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 64;          // k per step
constexpr int kKW = kBK / 4;     // packed words per row per step
constexpr int kBlocksPerSm = 4;  // split-K target occupancy

// BP8 word of a level: bit p set iff level >= threshold p (thresholds
// packed 4 bits each, plane p at bits 4p..4p+3; derived on the host from
// the Bent-Pyramid datasets).
__device__ __forceinline__ uint32_t level_mask(int lvl, uint32_t thr) {
  uint32_t m = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p)
    m |= (uint32_t)(lvl >= (int)((thr >> (4 * p)) & 0xFu)) << p;
  return m;
}

// Adds code c (k offset j within its word) to the (pos, neg) word pair.
__device__ __forceinline__ void pack_code(int code, uint32_t thr, int j,
                                          uint32_t& p, uint32_t& q) {
  const uint32_t mk = level_mask(code < 0 ? -code : code, thr) << (8 * j);
  if (code > 0) p |= mk;
  else if (code < 0) q |= mk;
}

__device__ __forceinline__ int bp_dot4(uint32_t xp, uint32_t xn, uint32_t yp,
                                       uint32_t yn) {
  return __popc((xp & yp) | (xn & yn)) - __popc((xp & yn) | (xn & yp));
}

// x tile (BM rows x kBK k) of codes -> packed right-biased words; out of
// range = 0.  One word = 4 consecutive k of a row: one 4-byte load when
// aligned.
template <int BM>
__device__ __forceinline__ void load_x(const int8_t* __restrict__ x, int M,
                                       int K, int m0, int k0, uint32_t thr,
                                       bool vec, uint32_t (*xp)[kKW],
                                       uint32_t (*xn)[kKW]) {
  for (int w = threadIdx.x; w < BM * kKW; w += kThreads) {
    const int r = w / kKW, kw = w % kKW, m = m0 + r, kb = k0 + 4 * kw;
    int v[4] = {0, 0, 0, 0};
    if (m < M) {
      const int8_t* row = x + (size_t)m * K;
      if (vec && kb + 3 < K) {
        const char4 b = *reinterpret_cast<const char4*>(row + kb);
        v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kb + j < K) v[j] = row[kb + j];
      }
    }
    uint32_t p = 0, q = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) pack_code(v[j], thr, j, p, q);
    xp[r][kw] = p;
    xn[r][kw] = q;
  }
}

// y tile (kBK k x kBN columns) of codes -> packed left-biased words.
// Thread t owns k rows 4*(t/16)..+3 and columns 4*(t%16)..+3: four 4-byte
// loads when the rows allow it.
__device__ __forceinline__ void load_y(const int8_t* __restrict__ y, int K,
                                       int N, int k0, int n0, uint32_t thr,
                                       bool vec, uint32_t (*yp)[kBN],
                                       uint32_t (*yn)[kBN]) {
  const int kw = threadIdx.x / (kBN / 4), c = 4 * (threadIdx.x % (kBN / 4));
  const int kb = k0 + 4 * kw, n = n0 + c;
  uint32_t p[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
  int v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kb + j;
    if (k < K && vec && n + 3 < N) {
      const char4 b = *reinterpret_cast<const char4*>(y + (size_t)k * N + n);
      v[j][0] = b.x; v[j][1] = b.y; v[j][2] = b.z; v[j][3] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[j][i] = (k < K && n + i < N) ? y[(size_t)k * N + n + i] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pack_code(v[j][i], thr, j, p[i], q[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yp[kw][c + i] = p[i];
    yn[kw][c + i] = q[i];
  }
}

// One (BM x kBN) output tile over the k steps [z*steps, (z+1)*steps) of
// split z = blockIdx.z, added into the int32 workspace ws (M x N).
template <int BM>
__global__ void __launch_bounds__(kThreads)
bp_tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y,
               int* __restrict__ ws, int M, int K, int N, int steps,
               uint32_t thr_r, uint32_t thr_l, bool x_vec, bool y_vec) {
  constexpr int TM = BM * kBN / kThreads;  // rows per thread
  __shared__ uint32_t xp[BM][kKW], xn[BM][kKW];
  __shared__ uint32_t yp[kKW][kBN], yn[kKW][kBN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int tn = threadIdx.x % kBN, tm = (threadIdx.x / kBN) * TM;
  int acc[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i] = 0;

  const int z = (int)blockIdx.z;
  const int k_end = min(K, (z + 1) * steps * kBK);
  for (int k0 = z * steps * kBK; k0 < k_end; k0 += kBK) {
    load_x<BM>(x, M, K, m0, k0, thr_r, x_vec, xp, xn);
    load_y(y, K, N, k0, n0, thr_l, y_vec, yp, yn);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      const uint32_t wp = yp[kw][tn], wn = yn[kw][tn];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        acc[i] += bp_dot4(xp[tm + i][kw], xn[tm + i][kw], wp, wn);
    }
    __syncthreads();
  }

  const int n = n0 + tn;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i;
    if (m < M && acc[i]) atomicAdd(ws + (size_t)m * N + n, acc[i]);
  }
}

// The integer sums as f32, unscaled.
__global__ void bp_epilogue_kernel(const int* __restrict__ ws,
                                   float* __restrict__ out, long long size) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < size) out[i] = (float)ws[i];
}

inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Zero the workspace, run the tiles split over K so that about
// kBlocksPerSm blocks land on every SM, then the epilogue.
inline int launch_bp(const int8_t* x, const int8_t* y, float* out, int* ws,
                     int M, int K, int N, uint32_t thr_r, uint32_t thr_l,
                     cudaStream_t stream) {
  const size_t size = (size_t)M * N;
  cudaError_t err = cudaMemsetAsync(ws, 0, size * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int bm = M <= 8 ? 8 : 32;
  const int tiles_n = (N + kBN - 1) / kBN, tiles_m = (M + bm - 1) / bm;
  const int total = (K + kBK - 1) / kBK;
  int splits = (kBlocksPerSm * sm_count() + tiles_n * tiles_m - 1) /
               (tiles_n * tiles_m);
  splits = splits > total ? total : splits;
  splits = splits < 1 ? 1 : splits;
  const int steps = total > splits ? (total + splits - 1) / splits : 1;
  splits = (total + steps - 1) / steps;
  const bool x_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  const bool y_vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 3) == 0;
  const dim3 grid(tiles_n, tiles_m, splits);
  if (bm == 8 && total > 0)       // K = 0: the zeroed workspace is the sum
    bp_tile_kernel<8><<<grid, kThreads, 0, stream>>>(
        x, y, ws, M, K, N, steps, thr_r, thr_l, x_vec, y_vec);
  else if (total > 0)
    bp_tile_kernel<32><<<grid, kThreads, 0, stream>>>(
        x, y, ws, M, K, N, steps, thr_r, thr_l, x_vec, y_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const unsigned blocks = (unsigned)((size + threads - 1) / threads);
  bp_epilogue_kernel<<<blocks, threads, 0, stream>>>(ws, out,
                                                     (long long)size);
  return (int)cudaGetLastError();
}

}  // namespace oisma
