// BP quantise: f32 or bf16 values and one f32 scale -> int8 sign*level
// codes, code = sign(x) * clip(rint(|x| / s * 10), 0, 9), of the f32
// value of each element.
//
// Replaces: repro/kernels/bp_matmul.py, bp_quantize_pallas (kernel
// _bp_quantize_kernel), which casts its tile to f32 inside, so it takes
// bf16 as well and quantises the f32 value.
//
// Expression: the TPU kernel computes |x| * (10 / s); its own docstring,
// its oracle ref.bp_quantize_ref and core.quantize.quantize_bp compute
// |x| / s * 10.  The two part on a few per cent of the inputs that lie
// next to a half-level boundary (x = 4.358984, s = 5.128217: level 8 one
// way, 9 the other).  This kernel gives the levels of |x| / s * 10, the
// only form whose codes equal quantize_bp's bitwise, as the unfused
// pipeline needs them to equal the fused kernel's encode.
//
// Bound on the H100: bytes (4 or 2 read and 1 written per element).
//
// Design: no division per element.  Each block first issues its first
// 16-byte loads, then three warps find the 9 exact level boundaries of
// the call's scale (bp_levels.cuh, level_boundary8, which runs the
// level's own division) while those loads are in flight; a value's level
// is the count of boundaries at or below |x|, which equals the division
// form by construction (the division per element measured 1-3% slower on
// f32 inputs on the H100, so the count stays).  A thread's round is a unit of 16 values, four
// 16-byte loads of f32 or two of bf16 in flight at once (bf16 is widened
// in registers, which is exact), whose 16 codes leave in one 16-byte
// store; the grid covers the units once where it can, so that most
// threads take one round.  That measured faster than 128 bytes a thread,
// and than resident blocks that walk their rounds with the next
// round's loads in flight.  Elements after the last whole unit, or all of
// them when x or out is not 16-byte aligned, go one at a time.  The scale
// is read on the card from its pointer, so the host never waits for the
// absmax that produced it; a call is one launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bp_levels.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 1;         // 16-value units of a thread's round

// A unit's 16 values as loaded: 16 * sizeof(T) bytes.
template <typename T>
struct Raw {
  uint4 w[sizeof(T)];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void load(Raw<T>& r, const T* src) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i) r.w[i] = __ldcs(p + i);
}

// The code of one value: its level is the count of the boundaries b_1..9
// that |v| reaches (NaN boundaries none).
__device__ __forceinline__ int code_of(float v, const float (&b)[9], float s) {
  const float a = fabsf(v);
  int l = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) l += a >= b[t];
  return v < 0.0f ? -l : l;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Value j (0-15) of a unit as f32 (j is a constant once unrolled, so the
// unit stays in registers).
__device__ __forceinline__ float value(const Raw<float>& r, int j) {
  return __uint_as_float(word(r.w[j >> 2], j & 3));
}
__device__ __forceinline__ float value(const Raw<__nv_bfloat16>& r, int j) {
  const uint32_t pair = word(r.w[j >> 3], (j >> 1) & 3);
  return __uint_as_float(j & 1 ? pair & 0xFFFF0000u : pair << 16);
}

template <typename T>
__device__ __forceinline__ void quantise(const Raw<T>& r, const float (&b)[9],
                                         float s, int8_t* dst) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      packed |= ((uint32_t)code_of(value(r, 4 * q + j), b, s) & 0xFFu)
                << (8 * j);
    w[q] = packed;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The first `units` units of 16 values with 16-byte loads and stores,
// the elements after them one at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bp_quantize_kernel(const T* __restrict__ x, const float* __restrict__ s_p,
                   int8_t* __restrict__ out, long long n, long long units) {
  __shared__ float bnd[9];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  constexpr int U = kUnits;
  Raw<T> r[U];              // a round: units i0 + u * stride
  auto fetch = [&](long long i0) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * stride < units) load(r[u], x + 16 * (i0 + u * stride));
  };
  fetch(start);          // in flight while the boundaries are found
  const float s = *s_p;
  if (threadIdx.x < 96) {   // warps 0-2: lanes 8g..8g+7 find b_{4w+g+1}
    const int i = threadIdx.x >> 3;
    const float bi = oisma_levels::level_boundary8(s, i < 9 ? i + 1 : 9);
    if ((threadIdx.x & 7) == 0 && i < 9) bnd[i] = bi;
  }
  __syncthreads();
  float b[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) b[t] = bnd[t];
  for (long long i0 = start; i0 < units; i0 += U * stride) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * stride < units)
        quantise(r[u], b, s, out + 16 * (i0 + u * stride));
    fetch(i0 + U * stride);
  }
  for (long long i = 16 * units + start; i < n; i += stride)
    out[i] = (int8_t)code_of(widen(x[i]), b, s);
}

int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <typename T>
int launch(const T* x, const float* scale, int8_t* out, long long n,
           cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long units = vec ? n / 16 : 0;
  const long long single = n - 16 * units;     // the tail
  const long long rounds = (units + kUnits - 1) / kUnits;
  const long long work = rounds > single ? rounds : single;
  long long blocks = (work + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : blocks;
  const long long most = 32LL * sm_count();
  blocks = blocks > most ? most : blocks;
  bp_quantize_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(
      x, scale, out, n, units);
  return (int)cudaGetLastError();
}

}  // namespace

// x_kind: 0 f32, 1 bf16.
extern "C" int oisma_bp_quantize(const void* x, int x_kind,
                                 const float* scale, int8_t* out, long long n,
                                 cudaStream_t stream) {
  if (x_kind == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), scale, out, n,
                  stream);
  return launch(static_cast<const float*>(x), scale, out, n, stream);
}
