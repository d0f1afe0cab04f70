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
// bit pattern of |v| (level_boundary8, bp_levels.cuh), running the
// reference's own division, once, while its first loads are in flight.
// The scales stay on the card.  A boundary no f32 reaches is NaN (no
// value passes).  A coded weight compares |code| with the thresholds
// themselves.
//
// Weights in their stored dtype (YT): f32, bf16 or int8 sign*level codes
// from prepare_bp_weight; x is f32 (or codes, below).  A bf16 weight is
// encoded two values to a word: its bits are compared as integers with the
// boundaries rounded up to bf16, which gives exactly the planes of its f32
// cast (the TPU kernel casts its tile to f32) in about half the
// instructions of the f32 compares.
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
// Coded x (XT = int8_t, the codes matmul of the unfused pipeline): x is
// int8 sign*level codes, streamed through the same ring (16 codes a
// copy).  The level is the code itself, so there is no boundary search
// and no scale: each block builds a table of the plane words of the 19
// codes -9..9 of each operand (encode_val, |code| against the plane
// thresholds), and a code's encode is one 8-byte load.  The epilogue
// then writes the exact sums unscaled, (float)acc, as the TPU kernel's f32
// result of integers.  At 128 rows (kCodesWgmma) the products run on
// wgmma m64n128k32 .s32.s8.s8 instead of mma.sync: each of the two
// warpgroups takes 64 rows x 128 columns from shared memory, whose plane
// rows (16 k x 8 planes = 128 bytes) take the 128-byte swizzle in place of
// the padded rows, in two plane buffers, so that one step's encode
// overlaps the previous step's products.
//
// Users: fused_matmul.cu (one weight), fused_mlp.cu (two) and
// bp_matmul.cu (coded x and one coded weight).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bp_levels.cuh"

namespace oisma_mma {

using oisma_levels::bp_level;
using oisma_levels::level_boundary8;

constexpr int kBK = 16;           // k per stage
constexpr int kThreads = 256;     // 8 warps
constexpr int kPad = 16;          // bytes after each plane row (banks)
constexpr int kRow = kBK * 8 + kPad;   // plane row bytes
// The codes matmul's 128-row instance multiplies with wgmma (else
// mma.sync, as every other instance).
constexpr bool kCodesWgmma = true;

// Weight dtypes, as the C entry points number them.
enum Kind { kF32 = 0, kBF16 = 1, kCodes = 2 };
enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

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

// The codes matmul's encode: the plane words of code c from a table of
// the 19 codes -9..9 (built once a block with encode_val from the plane
// thresholds `thr`, which the comparison form of the encode would read
// instead), one 8-byte shared-memory load.
__device__ __forceinline__ void encode_code(int c, const uint2* tab,
                                            const float* thr, uint32_t& lo,
                                            uint32_t& hi) {
  const uint2 e = tab[c + 9];
  lo = e.x;
  hi = e.y;
}

// relu keeps a NaN, as the reference's jnp.maximum(x, 0.0) does (fmaxf
// would give 0): PTX max.NaN.f32 is fmaxf but for NaN
__device__ __forceinline__ float activate(float g, int act) {
  if (act == kSilu) return g * (1.0f / (1.0f + expf(-g)));
  if (act == kGelu)
    return 0.5f * g *
           (1.0f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(g), "f"(0.0f));
  return r;
}

// The output of one (m, n): NW = 1, acc * scale; NW = 2,
// act(gate) * up with up = a0 * scale[0], gate = a1 * scale[1];
// UNSCALED (coded x), the exact sum itself.
template <int NW, bool UNSCALED>
__device__ __forceinline__ float finish(int a0, int a1, const float* scale,
                                        int act) {
  if (UNSCALED) return (float)a0;
  const float u = (float)a0 * scale[0];
  if (NW == 1) return u;
  return activate((float)a1 * scale[NW - 1], act) * u;
}

// One value's 8 plane bytes (lo: planes 0-3, hi: 4-7) of 4 k, k-major
// (32 bytes: 16-byte chunks 2kq and 2kq + 1), into plane row r of a plane
// tile: padded rows of `row` bytes, or (SW) 128-byte rows under the
// 128-byte swizzle (chunk c of row r at chunk c ^ (r % 8)).
template <bool SW>
__device__ __forceinline__ void put_planes(int8_t* tile, int row, int r,
                                           int kq, const uint4& w0,
                                           const uint4& w1) {
  if (SW) {
    uint4* line = reinterpret_cast<uint4*>(tile + r * 128);
    line[(2 * kq) ^ (r & 7)] = w0;
    line[(2 * kq + 1) ^ (r & 7)] = w1;
  } else {
    uint4* dst = reinterpret_cast<uint4*>(tile + r * row + 32 * kq);
    dst[0] = w0;
    dst[1] = w1;
  }
}

// wgmma's shared-memory matrix descriptor of a K-major tile of 128-byte
// swizzled rows (8-row groups 1024 bytes apart), at a 1024-byte aligned
// address; adding 2 moves it 32 bytes (one k32 slice) along K.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFFu) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128 int32, this warp's 16 rows as mma.sync's C fragments of
// 16 column blocks) += A (64 x 32 bytes) * B (32 bytes x 128), both from
// shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[16][4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// Ties the sums to this point, so that no read of them moves above the
// wgmma wait that precedes it.
__device__ __forceinline__ void hold(int (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
}

// Per row count BM, weight dtype YT, weight count NW and x dtype XT: how
// the 8 warps tile the (BM x BN) output, how many stages the copy ring
// holds, and how many blocks an SM should hold (the register cap that
// follows).  A warp takes WM x WN outputs of each weight; on wgmma (kWG)
// a warpgroup takes 64 rows and each warp holds 16 of them.
template <int BM, typename YT, int NW, typename XT = float>
struct Cfg {
  static constexpr bool kCoded = std::is_same<YT, int8_t>::value;
  static constexpr bool kXCoded = std::is_same<XT, int8_t>::value;
  static constexpr bool kWG = kXCoded && BM == 128 && NW == 1 && kCodesWgmma;
  static constexpr int kBN = NW == 2 && BM > 16 ? 64 : 128;
  static constexpr int kWarpsM = kWG ? 8 : BM == 16 ? 1 : 2;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWM = BM / kWarpsM;              // 16, 32 or 64
  static constexpr int kWN = kBN / kWarpsN;             // 16, 32 or 128
  static constexpr int kStages = BM == 16 && NW == 1 ? 4 : 3;
  static constexpr int kMinBlocks = BM == 16 ? 3 : 2;
  static constexpr int kRow = kWG ? 128 : oisma_mma::kRow;   // plane row
  static constexpr int kPlanes = kWG ? 2 : 1;           // plane buffers
  static constexpr int kXRaw = BM * kBK * (int)sizeof(XT);   // x stage
  static constexpr int kYRaw = kBK * kBN * (int)sizeof(YT);  // a weight's
  static constexpr int kStage = kXRaw + NW * kYRaw;
  // plane boundaries: 8 f32 for x and for each weight, then each
  // weight's 8 as bf16 pairs (bf16_boundary2); with coded x, the code
  // tables of x and of the weight; on wgmma, room to align the plane
  // tiles to 1024 bytes
  static constexpr int kSmem = kPlanes * (BM + NW * kBN) * kRow +
                               kStages * kStage +
                               8 * (1 + 2 * NW) * (int)sizeof(float) +
                               (kXCoded ? 2 * 19 * 8 : 0) + (kWG ? 1024 : 0);
};

// What a launch is given.  x: f32 or int8 codes; y, sy: the NW weights
// and their scales (up first, then gate); act: the MLP's activation.
struct Params {
  const void* x;
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
// ws[NW*M*N + tile]) writes the tile's out from ws; with coded x the
// splits add into out itself.
template <int BM, typename YT, int NW, typename XT = float>
__global__ void __launch_bounds__(kThreads, (Cfg<BM, YT, NW, XT>::kMinBlocks))
bp_mma_kernel(const Params p) {
  using C = Cfg<BM, YT, NW, XT>;
  static_assert(!C::kXCoded || C::kCoded, "coded x takes a coded weight");
  constexpr int BK = kBK, BN = C::kBN, ST = C::kStages, T = kThreads;
  constexpr int ROW = C::kRow, MT = C::kWM / 16, NT = C::kWN / 8;
  constexpr bool CODED = C::kCoded, XC = C::kXCoded, WG = C::kWG;
  // the raw bits of a weight value (loads that are not 16-byte copies)
  using YS = typename std::conditional<
      sizeof(YT) == 1, int8_t,
      typename std::conditional<sizeof(YT) == 2, uint16_t,
                                uint32_t>::type>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem;
  if constexpr (WG) base += (1024u - (smem_addr(smem) & 1023u)) & 1023u;
  // kPlanes x (BM x ROW), then kPlanes x (NW x BN x ROW)
  int8_t* As = reinterpret_cast<int8_t*>(base);
  int8_t* Bs = As + C::kPlanes * BM * ROW;
  unsigned char* raw =
      reinterpret_cast<unsigned char*>(Bs + C::kPlanes * NW * BN * ROW);
  float* bnd = reinterpret_cast<float*>(raw + ST * C::kStage);  // 8 (1+NW)
  uint32_t* bnd16 = reinterpret_cast<uint32_t*>(bnd + 8 * (1 + NW));  // 8 NW
  uint2* ctab = reinterpret_cast<uint2*>(bnd16 + 8 * NW);   // XC: 2 x 19

  const int M = p.M, K = p.K, N = p.N;
  const XT* __restrict__ x = static_cast<const XT*>(p.x);
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
    XT* xr = reinterpret_cast<XT*>(st);
    const int k0 = step * BK;
    constexpr int XV = 16 / (int)sizeof(XT);    // x values per copy
    if (p.x_vec) {
      for (int c = tid; c < rows * BK / XV; c += T) {
        const int r = c / (BK / XV), kq = c % (BK / XV), k = k0 + XV * kq;
        const bool in = k < K;
        cp_async16(xr + r * BK + XV * kq,
                   in ? x + (size_t)(m0 + r) * K + k : x, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * BK; e += T) {
        const int k = k0 + e % BK;
        xr[e] = k < K ? x[(size_t)(m0 + e / BK) * K + k] : (XT)0;
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
    float b = (float)t;    // a coded operand compares |code| with t itself
    if (!XC && (i < 8 || !CODED)) b = level_boundary8(*s, t);
    if ((tid & 7) == 0) {
      bnd[i] = b;
      if (i >= 8) bnd16[i - 8] = bf16_boundary2(b);
    }
  }
  if (XC && tid < 2 * 19) {    // code tables: x (right), then the weight
    const uint32_t thr = tid < 19 ? p.thr_r : p.thr_l;
    float t[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = (float)((thr >> (4 * q)) & 0xF);
    encode_val((int8_t)(tid % 19 - 9), t, ctab[tid].x, ctab[tid].y);
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
    // this step's plane tiles (on wgmma, two buffers in turn)
    int8_t* Ap = As + (WG ? (step & 1) * BM * ROW : 0);
    int8_t* Bp = Bs + (WG ? (step & 1) * NW * BN * ROW : 0);
    for (int u = tid; u < rows * BK / 4; u += T) {
      const int r = u / (BK / 4), kq = u % (BK / 4);
      uint4 w0, w1;
      if constexpr (XC) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(st + r * BK +
                                                               4 * kq);
        encode_code((int8_t)v, ctab, bnd, w0.x, w0.y);
        encode_code((int8_t)(v >> 8), ctab, bnd, w0.z, w0.w);
        encode_code((int8_t)(v >> 16), ctab, bnd, w1.x, w1.y);
        encode_code((int8_t)(v >> 24), ctab, bnd, w1.z, w1.w);
      } else {
        const float4 v = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(st) + r * BK + 4 * kq);
        float bx[8];
        load8(bx, bnd);
        encode_val(v.x, bx, w0.x, w0.y);
        encode_val(v.y, bx, w0.z, w0.w);
        encode_val(v.z, bx, w1.x, w1.y);
        encode_val(v.w, bx, w1.z, w1.w);
      }
      put_planes<WG>(Ap, ROW, r, kq, w0, w1);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const YT* yr = reinterpret_cast<const YT*>(st + C::kXRaw + w * C::kYRaw);
      int8_t* Bw = Bp + w * BN * ROW;
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
          put_planes<WG>(Bw, ROW, n, kq, a0, a1);
          put_planes<WG>(Bw, ROW, n + 1, kq, c0, c1);
        }
      } else if constexpr (XC) {
        // coded x and weight (the codes matmul): table lookups
        for (int u = tid; u < BN * BK / 4; u += T) {
          const int n = u % BN, kq = u / BN;
          const YT* col = yr + 4 * kq * BN + n;
          const uint2* tab = ctab + 19;
          const float* thr = bnd + 8;
          uint4 w0, w1;
          encode_code(col[0], tab, thr, w0.x, w0.y);
          encode_code(col[BN], tab, thr, w0.z, w0.w);
          encode_code(col[2 * BN], tab, thr, w1.x, w1.y);
          encode_code(col[3 * BN], tab, thr, w1.z, w1.w);
          put_planes<WG>(Bw, ROW, n, kq, w0, w1);
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
          put_planes<WG>(Bw, ROW, n, kq, w0, w1);
        }
      }
    }
    if constexpr (WG) {
      // the planes, written by this thread, become visible to wgmma; the
      // previous step's products may still run (on the other buffer)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint64_t da = sw128_desc(Ap + (warp >> 2) * 64 * ROW);
      const uint64_t db = sw128_desc(Bp);
#pragma unroll
      for (int kk = 0; kk < BK * 8 / 32; ++kk)
        wgmma_s8(acc[0][0], da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the products of the step before are done: its buffer is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      continue;
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
  if constexpr (WG) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold(acc[0][0]);
  }

  float scale[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) scale[w] = XC ? 0.0f : (*p.sx * *p.sy[w]) * 0.1f;
  const bool split = gridDim.z > 1;
  const size_t MN = (size_t)M * N;
  const int g = lane >> 2, tig = lane & 3;
  if constexpr (XC) {
    if (split) {
      // The splits add their sums straight into out (zeroed), as f32, two
      // columns an atomic where N and out allow: every partial sum and
      // every total is an integer below 2^24, so the f32 additions are
      // exact in any order.  No workspace and no last split.
      const bool pairs =
          ((N & 1) | (reinterpret_cast<uintptr_t>(p.out) & 7)) == 0;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm0 + 16 * i + g + 8 * h;
            const int n = n0 + wn0 + 8 * j + 2 * tig;
            if (m >= M || n >= N) continue;
            const int a = acc[0][i][j][2 * h], b = acc[0][i][j][2 * h + 1];
            float* o = p.out + (size_t)m * N + n;
            if (pairs) {
              if (a | b)
                atomicAdd(reinterpret_cast<float2*>(o),
                          make_float2((float)a, (float)b));
            } else {
              if (a) atomicAdd(o, (float)a);
              if (b && n + 1 < N) atomicAdd(o + 1, (float)b);
            }
          }
      return;
    }
  }
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
          p.out[o] = finish<NW, XC>(acc[0][i][j][e], acc[NW - 1][i][j][e],
                                    scale, p.act);
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
    p.out[o] = finish<NW, XC>(__ldcg(p.ws + o),
                              NW == 2 ? __ldcg(p.ws + MN + o) : 0, scale,
                              p.act);
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
template <int BM, typename YT, int NW, typename XT>
inline int resident() {
  static int n = 0;
  if (!n) {
    using C = Cfg<BM, YT, NW, XT>;
    cudaFuncSetAttribute(bp_mma_kernel<BM, YT, NW, XT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    // all of L1 as shared memory, so that several blocks fit on an SM
    cudaFuncSetAttribute(bp_mma_kernel<BM, YT, NW, XT>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bp_mma_kernel<BM, YT, NW, XT>, kThreads, C::kSmem);
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
template <typename YT, int NW, typename XT = float>
inline Plan plan(int M, int K, int N) {
  Plan p;
  p.bm = rows_per_block(M);
  int fit, bn;
  if (p.bm == 16) {
    fit = resident<16, YT, NW, XT>();
    bn = Cfg<16, YT, NW, XT>::kBN;
  } else if (p.bm == 64) {
    fit = resident<64, YT, NW, XT>();
    bn = Cfg<64, YT, NW, XT>::kBN;
  } else {
    fit = resident<128, YT, NW, XT>();
    bn = Cfg<128, YT, NW, XT>::kBN;
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
// one counter per output tile (none when K is not split, nor with coded x,
// whose splits add into out).
template <typename YT, int NW, typename XT = float>
inline size_t workspace_words(int M, int K, int N) {
  const Plan p = plan<YT, NW, XT>(M, K, N);
  return p.splits > 1 && !std::is_same<XT, int8_t>::value
             ? NW * (size_t)M * N + (size_t)p.tiles_m * p.tiles_n : 0;
}

template <int BM, typename YT, int NW, typename XT>
inline int launch_tiles(const Plan& pl, const Params& p,
                        cudaStream_t stream) {
  const dim3 grid(pl.tiles_n, pl.tiles_m, pl.splits);
  bp_mma_kernel<BM, YT, NW, XT><<<grid, kThreads,
                                  Cfg<BM, YT, NW, XT>::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// At most two launches: one memset when K is split, of the workspace
// (every weight's sums and the tile counters), or with coded x of out
// itself, and the tiles, which apply the epilogue themselves.
template <typename YT, int NW, typename XT = float>
inline int launch_bp_mma(Params p, cudaStream_t stream) {
  const Plan pl = plan<YT, NW, XT>(p.M, p.K, p.N);
  if (pl.splits > 1) {
    cudaError_t err =
        std::is_same<XT, int8_t>::value
            ? cudaMemsetAsync(p.out, 0, (size_t)p.M * p.N * sizeof(float),
                              stream)
            : cudaMemsetAsync(
                  p.ws, 0,
                  workspace_words<YT, NW, XT>(p.M, p.K, p.N) * sizeof(int),
                  stream);
    if (err != cudaSuccess) return (int)err;
  }
  p.steps = pl.steps;
  p.x_vec = p.K % (16 / (int)sizeof(XT)) == 0 &&
            (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  p.y_vec = p.N % (16 / (int)sizeof(YT)) == 0;
  for (int w = 0; w < NW; ++w)
    p.y_vec = p.y_vec && (reinterpret_cast<uintptr_t>(p.y[w]) & 15) == 0;
  if (pl.bm == 16) return launch_tiles<16, YT, NW, XT>(pl, p, stream);
  if (pl.bm == 64) return launch_tiles<64, YT, NW, XT>(pl, p, stream);
  return launch_tiles<128, YT, NW, XT>(pl, p, stream);
}

// The entry points' dispatch on the weight dtype (Kind): f(YT{}).
template <typename F>
inline auto with_kind(int kind, F f) {
  if (kind == kCodes) return f(int8_t{});
  if (kind == kBF16) return f(__nv_bfloat16{});
  return f(float{});
}

template <typename YT, int NW, typename XT = float>
inline int smem_bytes(int M) {
  const int bm = rows_per_block(M);
  return bm == 16   ? Cfg<16, YT, NW, XT>::kSmem
         : bm == 64 ? Cfg<64, YT, NW, XT>::kSmem
                    : Cfg<128, YT, NW, XT>::kSmem;
}

}  // namespace oisma_mma
