// Integer core of the fused BP matmul on Hopper's int8 tensor cores.
//
// The TPU kernel (repro/kernels/fused.py, _fused_matmul_kernel) expands
// each operand tile into 8 signed bitplanes and runs one MXU dot over the
// 8x-wide tiles.  This core does the same with int8 operands: every value
// becomes 8 plane bytes in {-1, 0, 1} (plane p of value v is sign(v) if
// v's BP level reaches the plane's threshold, else 0), laid out k-major
// (byte k*8 + p), so the product over K' = 8K is
//
//   acc[m][n] = sum_k sum_p xplane[m][k][p] * yplane[k][n][p],
//
// taken by mma.sync m16n8k32 .s32.s8.s8.s32.  Every partial sum is an
// exact int32 (|acc| <= 8K), so K can be split across blocks that add
// into an int32 workspace with atomics in any order.  The epilogue stays
// acc * ((sx * sy) * 0.1f), so the result is bitwise that of the
// popcount core (bp_tile.cuh) and of the reference.
//
// Encode by comparison, no division.  The level
// clip(rint(fl(fl(|v| / s) * 10)), 0, 9) never decreases as |v| grows, so
// for each scale there is, for each level l, a least f32 b_l whose level
// is l or more; a value's level reaches l iff |v| >= b_l.  Each block
// finds the 8 plane boundaries of x (right thresholds) and of a real y
// (left thresholds) by bisection on the f32 bit pattern of |v|, running
// the reference's own division, once, in its first half-warp, while its
// first loads are in flight.  The scales stay on the card.  A boundary no
// f32 reaches is NaN (no value passes).  A coded y compares |code| with
// the thresholds themselves.
//
// Streaming: raw tiles (x f32, y f32 or int8 codes) go through a ring of
// STAGES shared-memory buffers with cp.async (16-byte copies, zero-filled
// past the edges), so the next tiles' bytes are in flight while the
// current ones are encoded into plane tiles and multiplied.  Tile shapes:
// 128 output columns and 16 k per step a block of 8 warps; rows BM = 16
// (decode), 64 (prefill chunks) or 128.  Padding columns and the K tail
// are zero planes; rows past M are skipped (their outputs are not
// stored).  Shapes whose
// rows cannot take 16-byte copies (K or N not a multiple of 4, or of 16
// for int8 codes) load element by element instead.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace oisma_mma {

constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 16;           // k per stage
constexpr int kThreads = 256;     // 8 warps
constexpr int kPad = 16;          // bytes after each plane row (banks)
constexpr int kRow = kBK * 8 + kPad;   // plane row bytes

__device__ __forceinline__ float bp_level(float a, float s) {
  return fminf(fmaxf(rintf(a / s * 10.0f), 0.0f), 9.0f);
}

// Least f32 a >= 0 whose level under scale s is t or more (NaN if no f32
// reaches t), found by eight lanes together: one round of eight patterns
// next to the estimate (t - 0.5) / 10 * s, or else rounds in which they
// test eight evenly spaced bit patterns of [lo, hi] and keep the eighth
// before the first that passes (~11 rounds over all 2^31 patterns).  All
// 32 lanes of the warp call it (four searches a warp, lanes 8g..8g+7 for
// one).
__device__ float level_boundary8(float s, int t) {
  const int lane = threadIdx.x & 31, j = lane & 7, sh = lane & 24;
  uint32_t lo = 0, hi = 0x7f800000u;           // pred(hi) assumed
  // First the eight patterns e-3 .. e+4 around e = (t - 0.5) / 10 * s,
  // within a few ulps of the boundary unless s or the boundary is
  // subnormal or out of range: if the first fails and one passes, the
  // first that passes is the boundary.  Otherwise the search spans every
  // pattern.
  const float e = ((float)t - 0.5f) * 0.1f * s;
  const uint32_t eb = __float_as_uint(e);
  const bool fits = e > 0.0f && eb > 3u && eb < 0x7f800000u - 4u;
  const uint32_t q0 = eb - 3u + (uint32_t)j;
  const bool ok0 = fits && bp_level(__uint_as_float(q0), s) >= (float)t;
  const uint32_t m0 = (__ballot_sync(0xffffffffu, ok0) >> sh) & 0xFFu;
  if (fits && (m0 & 1u) == 0u && m0 != 0u) lo = hi = eb - 3u + (__ffs(m0) - 1);
  while (__any_sync(0xffffffffu, lo < hi)) {
    const uint32_t q =
        lo + (uint32_t)(((unsigned long long)(hi - lo) * j) >> 3);
    const bool ok = lo < hi && bp_level(__uint_as_float(q), s) >= (float)t;
    const uint32_t m = (__ballot_sync(0xffffffffu, ok) >> sh) & 0xFFu;
    if (lo < hi) {
      // first passing point f (8: none, q_8 = hi): the answer lies in
      // (q_{f-1}, q_f], or is lo itself when f = 0
      const int f = m ? __ffs(m) - 1 : 8;
      const unsigned long long span = hi - lo;
      if (f == 0) {
        hi = lo;
      } else {
        hi = f == 8 ? hi : lo + (uint32_t)((span * f) >> 3);
        lo = lo + (uint32_t)((span * (f - 1)) >> 3) + 1;
      }
    }
  }
  const float b = __uint_as_float(hi);
  return bp_level(b, s) >= (float)t ? b : __uint_as_float(0x7fc00000u);
}

// 0xFF in byte p of the result where a >= b[p], p = 0..3.
__device__ __forceinline__ uint32_t ge4(float a, float b0, float b1, float b2,
                                        float b3) {
  uint32_t s0, s1, s2, s3, t01, t23, r;
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(s0) : "f"(a), "f"(b0));
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(s1) : "f"(a), "f"(b1));
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(s2) : "f"(a), "f"(b2));
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(s3) : "f"(a), "f"(b3));
  asm("prmt.b32 %0, %1, %2, 0x0040;" : "=r"(t01) : "r"(s0), "r"(s1));
  asm("prmt.b32 %0, %1, %2, 0x0040;" : "=r"(t23) : "r"(s2), "r"(s3));
  asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(r) : "r"(t01), "r"(t23));
  return r;
}

// Plane bytes p = 0..3 (lo) and 4..7 (hi) of one value: |v| >= b[p],
// times the sign (0x01 per set byte, 0xFF for -1).
__device__ __forceinline__ void encode8(float a, bool neg, const float* b,
                                        uint32_t& lo, uint32_t& hi) {
  const uint32_t m = neg ? 0xFFFFFFFFu : 0x01010101u;
  lo = ge4(a, b[0], b[1], b[2], b[3]) & m;
  hi = ge4(a, b[4], b[5], b[6], b[7]) & m;
}

__device__ __forceinline__ void encode_val(float v, const float* b,
                                           uint32_t& lo, uint32_t& hi) {
  encode8(fabsf(v), v < 0.0f, b, lo, hi);
}

__device__ __forceinline__ void encode_val(int8_t c, const float* b,
                                           uint32_t& lo, uint32_t& hi) {
  encode8((float)(c < 0 ? -(int)c : (int)c), c < 0, b, lo, hi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Per row count BM: how the 8 warps tile the (BM x 128) output, how many
// stages the copy ring holds, and how many blocks an SM should hold (the
// register cap that follows).  A warp takes WM x WN outputs.
template <int BM, bool CODED>
struct Cfg {
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;              // 16, 32 or 64
  static constexpr int kWN = kBN / kWarpsN;             // 16 or 32
  static constexpr int kStages = BM == 16 ? 4 : 3;
  static constexpr int kMinBlocks = BM == 16 ? 3 : 2;
  static constexpr int kXRaw = BM * kBK * 4;            // f32 x stage
  static constexpr int kYRaw = kBK * kBN * (CODED ? 1 : 4);  // y stage
  static constexpr int kSmem =
      (BM + kBN) * kRow + kStages * (kXRaw + kYRaw) + 16 * (int)sizeof(float);
};

// One (BM x kBN) output tile over the k steps [z*steps, (z+1)*steps) of
// split z = blockIdx.z.  splits == 1: out = acc * ((sx * sy) * 0.1f).
// Otherwise each split adds its sums into ws (M x N int32, zeroed), and
// the last split to finish a tile (counted in ws[M*N + tile]) writes the
// tile's out from ws.
template <int BM, bool CODED>
__global__ void __launch_bounds__(kThreads, (Cfg<BM, CODED>::kMinBlocks))
bp_mma_kernel(const float* __restrict__ x, const void* __restrict__ y,
              const float* __restrict__ sx_p, const float* __restrict__ sy_p,
              float* __restrict__ out, int* __restrict__ ws, int M, int K,
              int N, int steps, uint32_t thr_r, uint32_t thr_l, bool x_vec,
              bool y_vec) {
  using C = Cfg<BM, CODED>;
  constexpr int BK = kBK, ST = C::kStages, T = kThreads, ROW = kRow;
  constexpr int MT = C::kWM / 16, NT = C::kWN / 8;
  using YT = typename std::conditional<CODED, int8_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);                 // BM x ROW
  int8_t* Bs = As + BM * ROW;                                   // kBN x ROW
  unsigned char* raw = reinterpret_cast<unsigned char*>(Bs + kBN * ROW);
  constexpr int kStage = C::kXRaw + C::kYRaw;
  float* bnd = reinterpret_cast<float*>(raw + ST * kStage);     // 16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int total = (K + BK - 1) / BK;
  const int s0 = blockIdx.z * steps;
  const int s1 = min(total, s0 + steps);
  const YT* yt = static_cast<const YT*>(y);

  // Rows past M are neither loaded nor encoded: their outputs are never
  // stored, so what their plane rows hold does not matter.
  const int rows = min(BM, M - m0);
  constexpr int V = 16 / (int)sizeof(YT);     // y values per copy
  constexpr int kYCopies = BK * kBN / V;      // y copies a step
  constexpr int kYChunks = (kYCopies + T - 1) / T;  // per thread
  // a thread's y copies sit at the same place of every stage: row r of
  // the stage, columns n..n+V-1
  const YT* ysrc[kYChunks];
  int ydst[kYChunks];
  bool yin[kYChunks];
#pragma unroll
  for (int i = 0; i < kYChunks; ++i) {
    const int c = tid + i * T, r = c / (kBN / V), j = c % (kBN / V);
    const int n = n0 + V * j;
    yin[i] = c < kYCopies && n < N;
    ysrc[i] = yt + (size_t)r * N + (yin[i] ? n : 0);
    ydst[i] = r * kBN + V * j;
  }

  auto issue = [&](int step) {
    unsigned char* st = raw + (step % ST) * kStage;
    float* xr = reinterpret_cast<float*>(st);
    YT* yr = reinterpret_cast<YT*>(st + C::kXRaw);
    const int k0 = step * BK;
    if (x_vec) {
      for (int c = tid; c < rows * BK / 4; c += T) {
        const int r = c / (BK / 4), kq = c % (BK / 4), k = k0 + 4 * kq;
        const bool in = k < K;
        cp_async16(xr + r * BK + 4 * kq,
                   in ? x + (size_t)(m0 + r) * K + k : x, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * BK; e += T) {
        const int k = k0 + e % BK;
        xr[e] = k < K ? x[(size_t)(m0 + e / BK) * K + k] : 0.0f;
      }
    }
    if (y_vec) {
#pragma unroll
      for (int i = 0; i < kYChunks; ++i) {
        if (tid + i * T >= kYCopies) break;
        const int k = k0 + (tid + i * T) / (kBN / V);
        const bool in = yin[i] && k < K;
        cp_async16(yr + ydst[i], in ? ysrc[i] + (size_t)k0 * N : yt,
                   in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * kBN; e += T) {
        const int k = k0 + e / kBN, n = n0 + e % kBN;
        yr[e] = k < K && n < N ? yt[(size_t)k * N + n] : (YT)0;
      }
    }
  };

  // the first stages' copies fly while the boundaries are found
  for (int i = 0; i < ST - 1; ++i) {
    if (s0 + i < s1) issue(s0 + i);
    cp_async_commit();
  }
  if (tid < 128) {       // warp w finds boundaries 4w..4w+3
    const int i = tid >> 3, p = i & 7;
    const int t = ((i < 8 ? thr_r : thr_l) >> (4 * p)) & 0xF;
    float b = (float)t;    // a coded y compares |code| with t itself
    if (i < 8 || !CODED) b = level_boundary8(i < 8 ? *sx_p : *sy_p, t);
    if ((tid & 7) == 0) bnd[i] = b;
  }
  __syncthreads();
  float by[8];           // y's boundaries stay in registers
#pragma unroll
  for (int p = 0; p < 8; ++p) by[p] = bnd[8 + p];
  const int wm0 = (warp / C::kWarpsN) * C::kWM;
  const int wn0 = (warp % C::kWarpsN) * C::kWN;
  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int step = s0; step < s1; ++step) {
    if (step + ST - 1 < s1) issue(step + ST - 1);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();     // this stage's bytes are in; the last MMAs done

    const unsigned char* st = raw + (step % ST) * kStage;
    const float* xr = reinterpret_cast<const float*>(st);
    const YT* yr = reinterpret_cast<const YT*>(st + C::kXRaw);
    for (int u = tid; u < rows * BK / 4; u += T) {
      const int r = u / (BK / 4), kq = u % (BK / 4);
      const float4 v = *reinterpret_cast<const float4*>(xr + r * BK + 4 * kq);
      float bx[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) bx[p] = bnd[p];
      uint4 w0, w1;
      encode_val(v.x, bx, w0.x, w0.y);
      encode_val(v.y, bx, w0.z, w0.w);
      encode_val(v.z, bx, w1.x, w1.y);
      encode_val(v.w, bx, w1.z, w1.w);
      uint4* dst = reinterpret_cast<uint4*>(As + r * ROW + 32 * kq);
      dst[0] = w0;
      dst[1] = w1;
    }
    for (int u = tid; u < kBN * BK / 4; u += T) {
      const int n = u % kBN, kq = u / kBN;
      const YT* col = yr + 4 * kq * kBN + n;
      uint4 w0, w1;
      encode_val(col[0], by, w0.x, w0.y);
      encode_val(col[kBN], by, w0.z, w0.w);
      encode_val(col[2 * kBN], by, w1.x, w1.y);
      encode_val(col[3 * kBN], by, w1.z, w1.w);
      uint4* dst = reinterpret_cast<uint4*>(Bs + n * ROW + 32 * kq);
      dst[0] = w0;
      dst[1] = w1;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK * 8; kk += 32) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], As + (wm0 + 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                              kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (wn0 + 8 * j + (lane & 7) + (lane >> 4) * 8) * ROW +
                           kk + ((lane >> 3) & 1) * 16);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  const float scale = (*sx_p * *sy_p) * 0.1f;
  const bool split = gridDim.z > 1;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm0 + 16 * i + g + (e >> 1) * 8;
        const int n = n0 + wn0 + 8 * j + 2 * tig + (e & 1);
        if (m >= M || n >= N) continue;
        if (!split) out[(size_t)m * N + n] = (float)acc[i][j][e] * scale;
        else if (acc[i][j][e]) atomicAdd(ws + (size_t)m * N + n, acc[i][j][e]);
      }
  if (!split) return;

  // the last split of this tile applies the epilogue
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* count = ws + (size_t)M * N + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(count, 1) == (int)gridDim.z - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < BM * kBN; e += T) {
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m < M && n < N)
      out[(size_t)m * N + n] =
          (float)__ldcg(ws + (size_t)m * N + n) * scale;
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

// Blocks of one kernel instance an SM holds at once (its shared memory
// allowance is raised on first use).
template <int BM, bool CODED>
inline int resident() {
  static int n = 0;
  if (!n) {
    using C = Cfg<BM, CODED>;
    cudaFuncSetAttribute(bp_mma_kernel<BM, CODED>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    // all of L1 as shared memory, so that several blocks fit on an SM
    cudaFuncSetAttribute(bp_mma_kernel<BM, CODED>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bp_mma_kernel<BM, CODED>, kThreads, C::kSmem);
    if (n < 1) n = 1;
  }
  return n;
}

struct Plan {
  int bm, tiles_m, tiles_n, splits, steps;
};

// Rows per block from M.  When the output has fewer tiles than the SMs
// hold blocks (decode), K is split so that one wave of blocks fills every
// SM, with at least two k steps per split so that the copy ring has work
// to overlap.
inline Plan plan(int M, int K, int N, bool coded) {
  Plan p;
  p.bm = M <= 16 ? 16 : M <= 64 ? 64 : 128;
  int fit;
  if (p.bm == 16) fit = coded ? resident<16, true>() : resident<16, false>();
  else if (p.bm == 64) fit = coded ? resident<64, true>() : resident<64, false>();
  else fit = coded ? resident<128, true>() : resident<128, false>();
  p.tiles_m = (M + p.bm - 1) / p.bm;
  p.tiles_n = (N + kBN - 1) / kBN;
  const int total = (K + kBK - 1) / kBK;
  const int tiles = p.tiles_m * p.tiles_n;
  int splits = fit * sm_count() / tiles;
  const int most = (total + 1) / 2;
  splits = splits > most ? most : splits;
  splits = splits < 1 ? 1 : splits;
  p.steps = total > 0 ? (total + splits - 1) / splits : 0;
  p.splits = p.steps > 0 ? (total + p.steps - 1) / p.steps : 1;
  return p;
}

// Words of int32 workspace a call needs: the M x N sums and one counter
// per output tile (none when K is not split).
inline size_t workspace_words(int M, int K, int N, bool coded) {
  const Plan p = plan(M, K, N, coded);
  return p.splits > 1 ? (size_t)M * N + (size_t)p.tiles_m * p.tiles_n : 0;
}

template <int BM, bool CODED>
inline int launch_tiles(const Plan& p, const float* x, const void* y,
                        const float* sx, const float* sy, float* out, int* ws,
                        int M, int K, int N, uint32_t thr_r, uint32_t thr_l,
                        bool x_vec, bool y_vec, cudaStream_t stream) {
  using C = Cfg<BM, CODED>;
  const dim3 grid(p.tiles_n, p.tiles_m, p.splits);
  bp_mma_kernel<BM, CODED><<<grid, kThreads, C::kSmem, stream>>>(
      x, y, sx, sy, out, ws, M, K, N, p.steps, thr_r, thr_l, x_vec, y_vec);
  return (int)cudaGetLastError();
}

// At most two launches: a memset of the workspace when K is split, and
// the tiles (which apply the epilogue themselves).
template <bool CODED>
inline int launch_bp_mma(const float* x, const void* y, const float* sx,
                         const float* sy, float* out, int* ws, int M, int K,
                         int N, uint32_t thr_r, uint32_t thr_l,
                         cudaStream_t stream) {
  const Plan p = plan(M, K, N, CODED);
  if (p.splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        ws, 0, workspace_words(M, K, N, CODED) * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const bool x_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool y_vec = N % (CODED ? 16 : 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (p.bm == 16)
    return launch_tiles<16, CODED>(p, x, y, sx, sy, out, ws, M, K, N, thr_r,
                                   thr_l, x_vec, y_vec, stream);
  if (p.bm == 64)
    return launch_tiles<64, CODED>(p, x, y, sx, sy, out, ws, M, K, N, thr_r,
                                   thr_l, x_vec, y_vec, stream);
  return launch_tiles<128, CODED>(p, x, y, sx, sy, out, ws, M, K, N, thr_r,
                                  thr_l, x_vec, y_vec, stream);
}

}  // namespace oisma_mma
