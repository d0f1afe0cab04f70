// Integer core of the fused BP matmul and the fused BP MLP on Hopper's
// int8 tensor cores.
//
// The TPU kernels (repro/kernels/fused.py, _fused_matmul_kernel and
// _fused_mlp_kernel) expand each operand tile into 8 signed bitplanes and
// run one MXU dot over the 8x-wide tiles.  This core does the same with
// int8 operands: every value becomes 8 plane bytes in {-1, 0, 1} (plane p
// of value v is sign(v) if v's BP level reaches the plane's threshold,
// else 0), laid out k-major (byte k*8 + p), so the product over K' = 8K is
//
//   acc[m][n] = sum_k sum_p xplane[m][k][p] * yplane[k][n][p],
//
// taken by mma.sync m16n8k32 .s32.s8.s8.s32.  Every partial sum is an
// exact int32 (|acc| <= 8K), so K can be split across blocks that add
// into an int32 workspace with atomics in any order.  The epilogue stays
// acc * ((sx * sy) * 0.1f), so the result is bitwise the reference's.
//
// One or two weight operands (NW).  With two (the MLP: up, then gate) the
// block's x plane tile is encoded once and feeds two weight plane tiles
// over the same columns, into two sets of int32 sums; the epilogue is
// act(acc_gate * ((sx * s_gate) * 0.1f)) * (acc_up * ((sx * s_up) * 0.1f)).
//
// Encode by comparison, no division.  The level
// clip(rint(fl(fl(|v| / s) * 10)), 0, 9) never decreases as |v| grows, so
// for each scale there is, for each level l, a least f32 b_l whose level
// is l or more; a value's level reaches l iff |v| >= b_l.  Each block
// finds the 8 plane boundaries of x (right thresholds) and of each real
// weight (left thresholds, under its own scale) by bisection on the f32
// bit pattern of |v|, running the reference's own division, once, while
// its first loads are in flight.  The scales stay on the card.  A boundary
// no f32 reaches is NaN (no value passes).  A coded weight compares |code|
// with the thresholds themselves.
//
// Weights in their stored dtype (YT): f32, bf16 or int8 sign*level codes
// from prepare_bp_weight; x is f32.  A bf16 weight is encoded two values
// to a word: its bits are compared as integers with the boundaries
// rounded up to bf16, which gives exactly the planes of its f32 cast (the
// TPU kernel casts its tile to f32) in about half the instructions of the
// f32 compares.
//
// Streaming: raw tiles go through a ring of STAGES shared-memory buffers
// with cp.async (16-byte copies: 4 f32, 8 bf16 or 16 codes; zero-filled
// past the edges), so the next tiles' bytes are in flight while the
// current ones are encoded into plane tiles and multiplied.  Tiles: 16 k
// per step, 8 warps a block; rows BM = 16 (decode), 64 (prefill chunks) or
// 128; 128 output columns, or 64 for two weights at BM 64 and 128, so that
// every warp holds the same 16-64 sums per weight as with one.  Padding
// columns and the K tail are zero planes; rows past M are skipped (their
// outputs are not stored).  Shapes whose rows cannot take 16-byte copies
// (K not a multiple of 4, or N not a multiple of the values per copy)
// load element by element instead.
//
// Users: fused_matmul.cu (one weight) and fused_mlp.cu (two).  The codes
// matmul of the unfused pipeline keeps the popcount core, bp_tile.cuh.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace oisma_mma {

constexpr int kBK = 16;           // k per stage
constexpr int kThreads = 256;     // 8 warps
constexpr int kPad = 16;          // bytes after each plane row (banks)
constexpr int kRow = kBK * 8 + kPad;   // plane row bytes

// Weight dtypes, as the C entry points number them.
enum Kind { kF32 = 0, kBF16 = 1, kCodes = 2 };
enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

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
static __device__ float level_boundary8(float s, int t) {
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

// A plane boundary b (f32) as bf16 bits, in both halves of a word: the
// least bf16 whose value is b or more, so that for any bf16 |v|,
// |v| >= b iff bits(|v|) >= the result's half.  0x8000 (no half of |v|
// reaches it) for a boundary no value reaches (NaN).
__device__ __forceinline__ uint32_t bf16_boundary2(float b) {
  if (b != b) return 0x80008000u;
  const uint32_t u = __float_as_uint(b);
  const uint32_t h = (u >> 16) + ((u & 0xFFFFu) != 0u);
  return h | (h << 16);
}

// Plane words of two bf16 values at once (v0 in the low half of `pair`,
// v1 in the high half): lo0/hi0 for v0, lo1/hi1 for v1, as encode8 gives
// them for the values widened to f32.  Integer compares of the bits:
// (|v| | 0x8000) - B stays inside its 16-bit half and has bit 15 set iff
// bits(|v|) >= B (bq[p], from bf16_boundary2), so one subtraction tests
// both values against a plane; prmt's sign replication turns that bit
// into a 0xFF plane byte.  The sign is applied as in encode8.
__device__ __forceinline__ void encode_bf16x2(uint32_t pair,
                                              const uint32_t* bq,
                                              uint32_t& lo0, uint32_t& hi0,
                                              uint32_t& lo1, uint32_t& hi1) {
  const uint32_t a = (pair & 0x7FFF7FFFu) | 0x80008000u;
  uint32_t t[4], m0, m1;
#pragma unroll
  for (int i = 0; i < 4; ++i)    // planes 2i, 2i+1 of v0, then of v1
    asm("prmt.b32 %0, %1, %2, 0xFBD9;"
        : "=r"(t[i]) : "r"(a - bq[2 * i]), "r"(a - bq[2 * i + 1]));
  asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(lo0) : "r"(t[0]), "r"(t[1]));
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(lo1) : "r"(t[0]), "r"(t[1]));
  asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(hi0) : "r"(t[2]), "r"(t[3]));
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(hi1) : "r"(t[2]), "r"(t[3]));
  // 0xFFFFFFFF for a negative value (its half's sign), else 0x01010101
  asm("prmt.b32 %0, %1, %2, 0x9999;" : "=r"(m0) : "r"(pair), "r"(0u));
  asm("prmt.b32 %0, %1, %2, 0xBBBB;" : "=r"(m1) : "r"(pair), "r"(0u));
  m0 |= 0x01010101u;
  m1 |= 0x01010101u;
  lo0 &= m0;
  hi0 &= m0;
  lo1 &= m1;
  hi1 &= m1;
}

// Eight plane boundaries from shared memory (16-byte aligned) in two
// vector loads; kept out of registers across the k loop, which the sums
// and fragments need.
template <typename T>
__device__ __forceinline__ void load8(T (&b)[8], const T* s) {
  static_assert(sizeof(T) == 4, "four-byte words");
  const uint4 lo = reinterpret_cast<const uint4*>(s)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(s)[1];
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = *reinterpret_cast<const T*>(&w[i]);
}

__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g * (1.0f / (1.0f + expf(-g)));
  if (act == kGelu)
    return 0.5f * g *
           (1.0f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  return fmaxf(g, 0.0f);
}

// The output of one (m, n): NW = 1, acc * scale; NW = 2,
// act(gate) * up with up = a0 * scale[0], gate = a1 * scale[1].
template <int NW>
__device__ __forceinline__ float finish(int a0, int a1, const float* scale,
                                        int act) {
  const float u = (float)a0 * scale[0];
  if (NW == 1) return u;
  return activate((float)a1 * scale[NW - 1], act) * u;
}

// Per row count BM, weight dtype YT and weight count NW: how the 8 warps
// tile the (BM x BN) output, how many stages the copy ring holds, and how
// many blocks an SM should hold (the register cap that follows).  A warp
// takes WM x WN outputs of each weight.
template <int BM, typename YT, int NW>
struct Cfg {
  static constexpr bool kCoded = std::is_same<YT, int8_t>::value;
  static constexpr int kBN = NW == 2 && BM > 16 ? 64 : 128;
  static constexpr int kWarpsM = BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;              // 16, 32 or 64
  static constexpr int kWN = kBN / kWarpsN;             // 16 or 32
  static constexpr int kStages = BM == 16 && NW == 1 ? 4 : 3;
  static constexpr int kMinBlocks = BM == 16 ? 3 : 2;
  static constexpr int kXRaw = BM * kBK * 4;            // f32 x stage
  static constexpr int kYRaw = kBK * kBN * (int)sizeof(YT);  // a weight's
  static constexpr int kStage = kXRaw + NW * kYRaw;
  // plane boundaries: 8 f32 for x and for each weight, then each
  // weight's 8 as bf16 pairs (bf16_boundary2)
  static constexpr int kSmem = (BM + NW * kBN) * kRow + kStages * kStage +
                               8 * (1 + 2 * NW) * (int)sizeof(float);
};

// What a launch is given.  y, sy: the NW weights and their scales (up
// first, then gate); act: the MLP's activation.
struct Params {
  const float* x;
  const void* y[2];
  const float* sx;
  const float* sy[2];
  float* out;
  int* ws;
  int M, K, N, steps, act;
  uint32_t thr_r, thr_l;
  bool x_vec, y_vec;
};

// One (BM x BN) output tile over the k steps [z*steps, (z+1)*steps) of
// split z = blockIdx.z.  splits == 1: out is written from the sums in
// registers.  Otherwise each split adds its sums into ws (NW planes of
// M x N int32, zeroed), and the last split to finish a tile (counted in
// ws[NW*M*N + tile]) writes the tile's out from ws.
template <int BM, typename YT, int NW>
__global__ void __launch_bounds__(kThreads, (Cfg<BM, YT, NW>::kMinBlocks))
bp_mma_kernel(const Params p) {
  using C = Cfg<BM, YT, NW>;
  constexpr int BK = kBK, BN = C::kBN, ST = C::kStages, T = kThreads;
  constexpr int ROW = kRow, MT = C::kWM / 16, NT = C::kWN / 8;
  constexpr bool CODED = C::kCoded;
  // the raw bits of a weight value (loads that are not 16-byte copies)
  using YS = typename std::conditional<
      sizeof(YT) == 1, int8_t,
      typename std::conditional<sizeof(YT) == 2, uint16_t,
                                uint32_t>::type>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);                 // BM x ROW
  int8_t* Bs = As + BM * ROW;                              // NW x BN x ROW
  unsigned char* raw = reinterpret_cast<unsigned char*>(Bs + NW * BN * ROW);
  float* bnd = reinterpret_cast<float*>(raw + ST * C::kStage);  // 8 (1+NW)
  uint32_t* bnd16 = reinterpret_cast<uint32_t*>(bnd + 8 * (1 + NW));  // 8 NW

  const int M = p.M, K = p.K, N = p.N;
  const float* __restrict__ x = p.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int total = (K + BK - 1) / BK;
  const int s0 = blockIdx.z * p.steps;
  const int s1 = min(total, s0 + p.steps);

  // Rows past M are neither loaded nor encoded: their outputs are never
  // stored, so what their plane rows hold does not matter.
  const int rows = min(BM, M - m0);
  constexpr int V = 16 / (int)sizeof(YT);     // weight values per copy
  constexpr int kYCopies = BK * BN / V;       // copies a step, a weight
  constexpr int kYChunks = (kYCopies + T - 1) / T;  // per thread
  // a thread's weight copies sit at the same place of every stage and of
  // every weight: row r of the stage, columns n..n+V-1
  int yoff[kYChunks], ydst[kYChunks];
  bool yin[kYChunks];
#pragma unroll
  for (int i = 0; i < kYChunks; ++i) {
    const int c = tid + i * T, r = c / (BN / V), j = c % (BN / V);
    const int n = n0 + V * j;
    yin[i] = c < kYCopies && n < N;
    yoff[i] = r * N + (yin[i] ? n : 0);
    ydst[i] = r * BN + V * j;
  }

  auto issue = [&](int step) {
    unsigned char* st = raw + (step % ST) * C::kStage;
    float* xr = reinterpret_cast<float*>(st);
    const int k0 = step * BK;
    if (p.x_vec) {
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
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      YS* yr = reinterpret_cast<YS*>(st + C::kXRaw + w * C::kYRaw);
      const YS* yt = static_cast<const YS*>(p.y[w]);
      if (p.y_vec) {
#pragma unroll
        for (int i = 0; i < kYChunks; ++i) {
          if (tid + i * T >= kYCopies) break;
          const int k = k0 + (tid + i * T) / (BN / V);
          const bool in = yin[i] && k < K;
          cp_async16(yr + ydst[i], in ? yt + (size_t)k0 * N + yoff[i] : yt,
                     in ? 16 : 0);
        }
      } else {
        for (int e = tid; e < BK * BN; e += T) {
          const int k = k0 + e / BN, n = n0 + e % BN;
          yr[e] = k < K && n < N ? yt[(size_t)k * N + n] : (YS)0;
        }
      }
    }
  };

  // the first stages' copies fly while the boundaries are found
  for (int i = 0; i < ST - 1; ++i) {
    if (s0 + i < s1) issue(s0 + i);
    cp_async_commit();
  }
  if (tid < 64 * (1 + NW)) {   // warp w finds boundaries 4w..4w+3
    const int i = tid >> 3, q = i & 7;
    const int t = ((i < 8 ? p.thr_r : p.thr_l) >> (4 * q)) & 0xF;
    const float* s = i < 8 ? p.sx : i < 16 ? p.sy[0] : p.sy[NW - 1];
    float b = (float)t;    // a coded weight compares |code| with t itself
    if (i < 8 || !CODED) b = level_boundary8(*s, t);
    if ((tid & 7) == 0) {
      bnd[i] = b;
      if (i >= 8) bnd16[i - 8] = bf16_boundary2(b);
    }
  }
  __syncthreads();
  const int wm0 = (warp / C::kWarpsN) * C::kWM;
  const int wn0 = (warp % C::kWarpsN) * C::kWN;
  int acc[NW][MT][NT][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0;

  for (int step = s0; step < s1; ++step) {
    if (step + ST - 1 < s1) issue(step + ST - 1);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();     // this stage's bytes are in; the last MMAs done

    const unsigned char* st = raw + (step % ST) * C::kStage;
    const float* xr = reinterpret_cast<const float*>(st);
    for (int u = tid; u < rows * BK / 4; u += T) {
      const int r = u / (BK / 4), kq = u % (BK / 4);
      const float4 v = *reinterpret_cast<const float4*>(xr + r * BK + 4 * kq);
      float bx[8];
      load8(bx, bnd);
      uint4 w0, w1;
      encode_val(v.x, bx, w0.x, w0.y);
      encode_val(v.y, bx, w0.z, w0.w);
      encode_val(v.z, bx, w1.x, w1.y);
      encode_val(v.w, bx, w1.z, w1.w);
      uint4* dst = reinterpret_cast<uint4*>(As + r * ROW + 32 * kq);
      dst[0] = w0;
      dst[1] = w1;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const YT* yr = reinterpret_cast<const YT*>(st + C::kXRaw + w * C::kYRaw);
      int8_t* Bw = Bs + w * BN * ROW;
      if constexpr (std::is_same<YT, __nv_bfloat16>::value) {
        // bf16: a unit is 4 k x 2 columns, two values per compare
        for (int u = tid; u < BN / 2 * (BK / 4); u += T) {
          const int n = 2 * (u % (BN / 2)), kq = u / (BN / 2);
          const uint32_t* col =
              reinterpret_cast<const uint32_t*>(yr + 4 * kq * BN + n);
          uint32_t bq[8];
          load8(bq, bnd16 + 8 * w);
          uint4 a0, a1, c0, c1;     // columns n and n + 1
          encode_bf16x2(col[0], bq, a0.x, a0.y, c0.x, c0.y);
          encode_bf16x2(col[BN / 2], bq, a0.z, a0.w, c0.z, c0.w);
          encode_bf16x2(col[BN], bq, a1.x, a1.y, c1.x, c1.y);
          encode_bf16x2(col[3 * BN / 2], bq, a1.z, a1.w, c1.z, c1.w);
          uint4* d0 = reinterpret_cast<uint4*>(Bw + n * ROW + 32 * kq);
          uint4* d1 = reinterpret_cast<uint4*>(Bw + (n + 1) * ROW + 32 * kq);
          d0[0] = a0;
          d0[1] = a1;
          d1[0] = c0;
          d1[1] = c1;
        }
      } else {
        for (int u = tid; u < BN * BK / 4; u += T) {
          const int n = u % BN, kq = u / BN;
          const YT* col = yr + 4 * kq * BN + n;
          float by[8];
          load8(by, bnd + 8 * (1 + w));
          uint4 w0, w1;
          encode_val(col[0], by, w0.x, w0.y);
          encode_val(col[BN], by, w0.z, w0.w);
          encode_val(col[2 * BN], by, w1.x, w1.y);
          encode_val(col[3 * BN], by, w1.z, w1.w);
          uint4* dst = reinterpret_cast<uint4*>(Bw + n * ROW + 32 * kq);
          dst[0] = w0;
          dst[1] = w1;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK * 8; kk += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], As + (wm0 + 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                              kk + (lane >> 4) * 16);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t b[NT][2];
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, Bs + (w * BN + wn0 + 8 * j + (lane & 7) + (lane >> 4) * 8) * ROW +
                             kk + ((lane >> 3) & 1) * 16);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_s8(acc[w][i][j], a[i], b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  float scale[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) scale[w] = (*p.sx * *p.sy[w]) * 0.1f;
  const bool split = gridDim.z > 1;
  const size_t MN = (size_t)M * N;
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
        const size_t o = (size_t)m * N + n;
        if (!split) {
          p.out[o] = finish<NW>(acc[0][i][j][e], acc[NW - 1][i][j][e], scale,
                                p.act);
        } else {
#pragma unroll
          for (int w = 0; w < NW; ++w)
            if (acc[w][i][j][e]) atomicAdd(p.ws + w * MN + o, acc[w][i][j][e]);
        }
      }
  if (!split) return;

  // the last split of this tile applies the epilogue
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* count = p.ws + NW * MN + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(count, 1) == (int)gridDim.z - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < BM * BN; e += T) {
    const int m = m0 + e / BN, n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    const size_t o = (size_t)m * N + n;
    p.out[o] = finish<NW>(__ldcg(p.ws + o),
                          NW == 2 ? __ldcg(p.ws + MN + o) : 0, scale, p.act);
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
template <int BM, typename YT, int NW>
inline int resident() {
  static int n = 0;
  if (!n) {
    using C = Cfg<BM, YT, NW>;
    cudaFuncSetAttribute(bp_mma_kernel<BM, YT, NW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    // all of L1 as shared memory, so that several blocks fit on an SM
    cudaFuncSetAttribute(bp_mma_kernel<BM, YT, NW>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bp_mma_kernel<BM, YT, NW>, kThreads, C::kSmem);
    if (n < 1) n = 1;
  }
  return n;
}

struct Plan {
  int bm, tiles_m, tiles_n, splits, steps;
};

inline int rows_per_block(int M) { return M <= 16 ? 16 : M <= 64 ? 64 : 128; }

// Rows per block from M.  When the output has fewer tiles than the SMs
// hold blocks (decode), K is split so that one wave of blocks fills every
// SM, with at least two k steps per split so that the copy ring has work
// to overlap.
template <typename YT, int NW>
inline Plan plan(int M, int K, int N) {
  Plan p;
  p.bm = rows_per_block(M);
  int fit, bn;
  if (p.bm == 16) {
    fit = resident<16, YT, NW>();
    bn = Cfg<16, YT, NW>::kBN;
  } else if (p.bm == 64) {
    fit = resident<64, YT, NW>();
    bn = Cfg<64, YT, NW>::kBN;
  } else {
    fit = resident<128, YT, NW>();
    bn = Cfg<128, YT, NW>::kBN;
  }
  p.tiles_m = (M + p.bm - 1) / p.bm;
  p.tiles_n = (N + bn - 1) / bn;
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

// Words of int32 workspace a call needs: the NW planes of M x N sums and
// one counter per output tile (none when K is not split).
template <typename YT, int NW>
inline size_t workspace_words(int M, int K, int N) {
  const Plan p = plan<YT, NW>(M, K, N);
  return p.splits > 1
             ? NW * (size_t)M * N + (size_t)p.tiles_m * p.tiles_n : 0;
}

template <int BM, typename YT, int NW>
inline int launch_tiles(const Plan& pl, const Params& p,
                        cudaStream_t stream) {
  const dim3 grid(pl.tiles_n, pl.tiles_m, pl.splits);
  bp_mma_kernel<BM, YT, NW><<<grid, kThreads, Cfg<BM, YT, NW>::kSmem,
                              stream>>>(p);
  return (int)cudaGetLastError();
}

// At most two launches: one memset of the workspace (every weight's sums
// and the tile counters) when K is split, and the tiles, which apply the
// epilogue themselves.
template <typename YT, int NW>
inline int launch_bp_mma(Params p, cudaStream_t stream) {
  const Plan pl = plan<YT, NW>(p.M, p.K, p.N);
  if (pl.splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        p.ws, 0, workspace_words<YT, NW>(p.M, p.K, p.N) * sizeof(int),
        stream);
    if (err != cudaSuccess) return (int)err;
  }
  p.steps = pl.steps;
  p.x_vec = p.K % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  p.y_vec = p.N % (16 / (int)sizeof(YT)) == 0;
  for (int w = 0; w < NW; ++w)
    p.y_vec = p.y_vec && (reinterpret_cast<uintptr_t>(p.y[w]) & 15) == 0;
  if (pl.bm == 16) return launch_tiles<16, YT, NW>(pl, p, stream);
  if (pl.bm == 64) return launch_tiles<64, YT, NW>(pl, p, stream);
  return launch_tiles<128, YT, NW>(pl, p, stream);
}

// The entry points' dispatch on the weight dtype (Kind): f(YT{}).
template <typename F>
inline auto with_kind(int kind, F f) {
  if (kind == kCodes) return f(int8_t{});
  if (kind == kBF16) return f(__nv_bfloat16{});
  return f(float{});
}

template <typename YT, int NW>
inline int smem_bytes(int M) {
  const int bm = rows_per_block(M);
  return bm == 16   ? Cfg<16, YT, NW>::kSmem
         : bm == 64 ? Cfg<64, YT, NW>::kSmem
                    : Cfg<128, YT, NW>::kSmem;
}

}  // namespace oisma_mma
