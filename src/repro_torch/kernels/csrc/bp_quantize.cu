// BP quantise: f32 values and one f32 scale -> int8 sign*level codes,
// code = sign(x) * clip(rint(|x| / s * 10), 0, 9).
//
// Replaces: repro/kernels/bp_matmul.py, bp_quantize_pallas (kernel
// _bp_quantize_kernel).
//
// Expression: the TPU kernel computes |x| * (10 / s); its own docstring,
// its oracle ref.bp_quantize_ref and core.quantize.quantize_bp compute
// |x| / s * 10.  The two part on a few per cent of the inputs that lie
// next to a half-level boundary (x = 4.358984, s = 5.128217: level 8 one
// way, 9 the other).  This kernel computes |x| / s * 10 (bp_level), the
// only form whose codes equal quantize_bp's bitwise, as the unfused
// pipeline needs them to equal the fused kernel's encode.
//
// Bound on the H100: bytes (4 read and 1 written per element; a division,
// a multiply and a rounding each).
//
// Design: a grid-stride loop, float4 in and char4 out where both pointers
// allow it, the scalar tail after.  The scale is read on the card from its
// pointer, so the host never waits for the absmax that produced it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// clip(rint(|v| / s * 10), 0, 9): a true f32 division (the build uses no
// fast math), a multiply, round half to even.
__device__ __forceinline__ int bp_level(float v, float s) {
  const float l = rintf(fabsf(v) / s * 10.0f);
  return (int)fminf(fmaxf(l, 0.0f), 9.0f);
}

__device__ __forceinline__ signed char bp_code(float v, float s) {
  const int l = bp_level(v, s);
  return (signed char)(v > 0.0f ? l : (v < 0.0f ? -l : 0));
}

__global__ void __launch_bounds__(kThreads)
bp_quantize_kernel(const float* __restrict__ x, const float* __restrict__ s_p,
                   int8_t* __restrict__ out, long long n, bool vec) {
  const float s = *s_p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* o4 = reinterpret_cast<char4*>(out);
    for (long long i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      o4[i] = make_char4(bp_code(v.x, s), bp_code(v.y, s), bp_code(v.z, s),
                         bp_code(v.w, s));
    }
    tail = n4 * 4;
  }
  for (long long i = tail + start; i < n; i += stride) out[i] = bp_code(x[i], s);
}

}  // namespace

extern "C" int oisma_bp_quantize(const float* x, const float* scale,
                                 int8_t* out, long long n,
                                 cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  bp_quantize_kernel<<<(int)blocks, kThreads, 0, stream>>>(x, scale, out, n,
                                                           vec);
  return (int)cudaGetLastError();
}
