// Integer core shared by the fused BP matmul, the fused BP MLP and the
// codes matmul of the unfused pipeline.
//
// The TPU kernels (repro/kernels/fused.py) expand each operand tile into
// 8 signed bitplanes in VMEM and run one f32 MXU dot over the 8x-wide
// tiles.  Here the planes are never expanded.  Each value is encoded once
// per tile into its BP8 word -- an 8-bit mask, bit p set iff its level
// reaches the plane's threshold -- and four consecutive k of one row or
// column are packed into a 32-bit word, split by sign into a positive and
// a negative word.  One product of four k is then the in-array operation
// itself: AND, then popcount (the paper's parallel counters):
//
//   sum_k sx*sy*popc(mx & my) = popc((xp&yp)|(xn&yn)) - popc((xp&yn)|(xn&yp))
//
// (the positive and negative words of one operand never share a bit, so
// each OR joins disjoint sets).  The sum is an exact integer (|acc| <= 8K),
// so K can be split across blocks that add their partial sums into an int32
// workspace with atomics: integer addition in any order gives the same
// bits.  A second kernel turns the sums into f32 only in the epilogue,
// acc * ((sx * sy) * 0.1f), in the reference's association, so the result
// is bitwise the reference's.  The codes matmul (XC: x given as int8
// sign*level codes, y too) skips the encode and writes the integer sums as
// f32 unscaled.
//
// Encode: level = clip(rint(|v| / s * 10), 0, 9): a true f32 division, a
// multiply, round half to even (rintf, not roundf).  The build uses no fast
// math, so the division is IEEE and no FMA can form (there is no add).
//
// Bytes: at decode M is a few rows, so the weight is read once and used M
// times; the kernel is bound by reading it.  Each thread loads a 4 x 4
// block of the weight tile with four 16-byte loads in flight, and the split
// over K puts several blocks on every SM, so enough loads are in flight to
// cover the memory latency.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace oisma {

constexpr int kThreads = 256;
constexpr int kBN = 64;          // output columns per block
constexpr int kBK = 64;          // k per step
constexpr int kKW = kBK / 4;     // packed words per row per step
constexpr int kBlocksPerSm = 4;  // split-K target occupancy

enum Act { kNone = -1, kSilu = 0, kGelu = 1, kRelu = 2 };

__device__ __forceinline__ int bp_level(float v, float s) {
  float l = rintf(fabsf(v) / s * 10.0f);
  return (int)fminf(fmaxf(l, 0.0f), 9.0f);
}

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

// Adds value v (k offset j within its word) to the (pos, neg) word pair.
__device__ __forceinline__ void pack_real(float v, float s, uint32_t thr,
                                          int j, uint32_t& p, uint32_t& q) {
  const uint32_t mk = level_mask(bp_level(v, s), thr) << (8 * j);
  if (v > 0.0f) p |= mk;
  else if (v < 0.0f) q |= mk;
}

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

// x tile (BM rows x kBK k) -> packed right-biased words; out of range = 0.
// One word = 4 consecutive k of a row: one 16-byte load when aligned.
template <int BM>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int M,
                                       int K, int m0, int k0, float sx,
                                       uint32_t thr, bool vec,
                                       uint32_t (*xp)[kKW],
                                       uint32_t (*xn)[kKW]) {
  for (int w = threadIdx.x; w < BM * kKW; w += kThreads) {
    const int r = w / kKW, kw = w % kKW, m = m0 + r, kb = k0 + 4 * kw;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m < M) {
      const float* row = x + (size_t)m * K;
      if (vec && kb + 3 < K) {
        const float4 f = *reinterpret_cast<const float4*>(row + kb);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (kb + j < K) v[j] = row[kb + j];
      }
    }
    uint32_t p = 0, q = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) pack_real(v[j], sx, thr, j, p, q);
    xp[r][kw] = p;
    xn[r][kw] = q;
  }
}

// The same x tile from int8 sign*level codes: one 4-byte load per word
// when aligned, expanded with the right-biased thresholds, not encoded.
template <int BM>
__device__ __forceinline__ void load_x_codes(const int8_t* __restrict__ x,
                                             int M, int K, int m0, int k0,
                                             uint32_t thr, bool vec,
                                             uint32_t (*xp)[kKW],
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

// y tile (kBK k x kBN columns) -> packed left-biased words.  Thread t owns
// k rows 4*(t/16)..+3 and columns 4*(t%16)..+3: four 16-byte loads (f32)
// or four 4-byte loads (int8 codes) when the rows allow it.  CODED: y holds
// int8 sign*level codes (prepare_bp_weight), expanded, not encoded.
template <bool CODED>
__device__ __forceinline__ void load_y(const void* __restrict__ y, int K,
                                       int N, int k0, int n0, float sy,
                                       uint32_t thr, bool vec,
                                       uint32_t (*yp)[kBN],
                                       uint32_t (*yn)[kBN]) {
  const int kw = threadIdx.x / (kBN / 4), c = 4 * (threadIdx.x % (kBN / 4));
  const int kb = k0 + 4 * kw, n = n0 + c;
  uint32_t p[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
  if (CODED) {
    const int8_t* yc = static_cast<const int8_t*>(y);
    int v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + j;
      if (k < K && vec && n + 3 < N) {
        const char4 b = *reinterpret_cast<const char4*>(yc + (size_t)k * N + n);
        v[j][0] = b.x; v[j][1] = b.y; v[j][2] = b.z; v[j][3] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[j][i] = (k < K && n + i < N) ? yc[(size_t)k * N + n + i] : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pack_code(v[j][i], thr, j, p[i], q[i]);
  } else {
    const float* yf = static_cast<const float*>(y);
    float v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + j;
      if (k < K && vec && n + 3 < N) {
        const float4 f = *reinterpret_cast<const float4*>(yf + (size_t)k * N + n);
        v[j][0] = f.x; v[j][1] = f.y; v[j][2] = f.z; v[j][3] = f.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[j][i] = (k < K && n + i < N) ? yf[(size_t)k * N + n + i] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pack_real(v[j][i], sy, thr, j, p[i], q[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yp[kw][c + i] = p[i];
    yn[kw][c + i] = q[i];
  }
}

// One (BM x kBN) output tile over the k steps [z*steps, (z+1)*steps) of
// split z = blockIdx.z, added into the int32 workspace ws (NW planes of
// M x N: ws[w] += x @ y_w).  XC: x holds int8 codes (f32 otherwise); a
// coded operand's scale is not read and may be null.
template <int BM, int NW, bool CODED, bool XC>
__global__ void __launch_bounds__(kThreads)
bp_tile_kernel(const void* __restrict__ x, const void* __restrict__ y0,
               const void* __restrict__ y1, const float* __restrict__ sx_p,
               const float* __restrict__ s0_p, const float* __restrict__ s1_p,
               int* __restrict__ ws, int M, int K, int N, int steps,
               uint32_t thr_r, uint32_t thr_l, bool x_vec, bool y_vec) {
  constexpr int TM = BM * kBN / kThreads;  // rows per thread
  __shared__ uint32_t xp[BM][kKW], xn[BM][kKW];
  __shared__ uint32_t yp[NW][kKW][kBN], yn[NW][kKW][kBN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int tn = threadIdx.x % kBN, tm = (threadIdx.x / kBN) * TM;
  const float sx = XC ? 0.0f : *sx_p, s0 = CODED ? 0.0f : *s0_p,
              s1 = NW == 2 && !CODED ? *s1_p : 0.0f;
  int acc[NW][TM];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[w][i] = 0;

  const int z = (int)blockIdx.z;
  const int k_end = min(K, (z + 1) * steps * kBK);
  for (int k0 = z * steps * kBK; k0 < k_end; k0 += kBK) {
    if (XC)
      load_x_codes<BM>(static_cast<const int8_t*>(x), M, K, m0, k0, thr_r,
                       x_vec, xp, xn);
    else
      load_x<BM>(static_cast<const float*>(x), M, K, m0, k0, sx, thr_r,
                 x_vec, xp, xn);
    load_y<CODED>(y0, K, N, k0, n0, s0, thr_l, y_vec, yp[0], yn[0]);
    if (NW == 2)
      load_y<CODED>(y1, K, N, k0, n0, s1, thr_l, y_vec, yp[NW - 1], yn[NW - 1]);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      uint32_t wp[NW], wn[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        wp[w] = yp[w][kw][tn];
        wn[w] = yn[w][kw][tn];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint32_t p = xp[tm + i][kw], q = xn[tm + i][kw];
#pragma unroll
        for (int w = 0; w < NW; ++w) acc[w][i] += bp_dot4(p, q, wp[w], wn[w]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tn;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i;
    if (m >= M) continue;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (acc[w][i]) atomicAdd(ws + (size_t)w * M * N + (size_t)m * N + n, acc[w][i]);
  }
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g * (1.0f / (1.0f + expf(-g)));
  if (act == kGelu)
    return 0.5f * g *
           (1.0f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.0f);
}

// Epilogue: NW = 0 (the codes matmul): out = (float)acc, unscaled.
// NW = 1: out = acc * ((sx * s0) * 0.1f).  NW = 2 (the MLP):
// out = act(acc_gate * ((sx * s1) * 0.1f)) * (acc_up * ((sx * s0) * 0.1f)).
template <int NW>
__global__ void bp_epilogue_kernel(const int* __restrict__ ws,
                                   const float* __restrict__ sx_p,
                                   const float* __restrict__ s0_p,
                                   const float* __restrict__ s1_p,
                                   float* __restrict__ out, long long size,
                                   int act) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  if (NW == 0) {
    out[i] = (float)ws[i];
    return;
  }
  const float sx = *sx_p;
  const float u = (float)ws[i] * ((sx * *s0_p) * 0.1f);
  if (NW == 1) {
    out[i] = u;
  } else {
    const float g = (float)ws[size + i] * ((sx * *s1_p) * 0.1f);
    out[i] = activate(g, act) * u;
  }
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
// kBlocksPerSm blocks land on every SM, then the epilogue (unscaled when x
// is coded).
template <int NW, bool CODED, bool XC = false>
inline int launch_bp(const void* x, const void* y0, const void* y1,
                     const float* sx, const float* s0, const float* s1,
                     float* out, int* ws, int M, int K, int N, int act,
                     uint32_t thr_r, uint32_t thr_l, cudaStream_t stream) {
  const size_t size = (size_t)M * N;
  cudaError_t err = cudaMemsetAsync(ws, 0, NW * size * sizeof(int), stream);
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
  const bool x_vec = K % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & (XC ? 3 : 15)) == 0;
  const uintptr_t align = CODED ? 3 : 15;
  const bool y_vec = N % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(y0) & align) == 0 &&
                     (NW == 1 || (reinterpret_cast<uintptr_t>(y1) & align) == 0);
  const dim3 grid(tiles_n, tiles_m, splits);
  if (bm == 8 && total > 0)       // K = 0: the zeroed workspace is the sum
    bp_tile_kernel<8, NW, CODED, XC><<<grid, kThreads, 0, stream>>>(
        x, y0, y1, sx, s0, s1, ws, M, K, N, steps, thr_r, thr_l, x_vec, y_vec);
  else if (total > 0)
    bp_tile_kernel<32, NW, CODED, XC><<<grid, kThreads, 0, stream>>>(
        x, y0, y1, sx, s0, s1, ws, M, K, N, steps, thr_r, thr_l, x_vec, y_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const unsigned blocks = (unsigned)((size + threads - 1) / threads);
  bp_epilogue_kernel<(XC ? 0 : NW)><<<blocks, threads, 0, stream>>>(
      ws, sx, s0, s1, out, (long long)size, act);
  return (int)cudaGetLastError();
}

}  // namespace oisma
