// Per-tensor max|x| (the BP scale pass).
//
// Replaces: repro/kernels/fused.py, absmax_pallas (kernel _absmax_kernel).
//
// Bound on the H100: bytes (4 per element read, one compare each).
//
// Design: the TPU grid accumulates into one output cell in order; blocks
// here run in no order, so each block reduces its grid-stride share (float4
// loads where aligned) through warp shuffles and shared memory, and one
// thread per block folds the block's maximum into the output with atomicMax
// on the f32 bit pattern read as an int.  Every value is >= 0, where int
// order equals float order, and max is order-free: the result is bitwise
// the reference's.  The output is zeroed on the stream first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long n, float* out) {
  float m = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long tail = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const long long n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = start; i < n4; i += stride) {
      const float4 v = x4[i];
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    tail = n4 * 4;
  }
  for (long long i = tail + start; i < n; i += stride) m = fmaxf(m, fabsf(x[i]));
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.0f;
    for (int o = 16; o; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(reinterpret_cast<int*>(out), __float_as_int(m));
  }
}

}  // namespace

extern "C" int oisma_absmax(const float* x, long long n, float* out,
                            cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 8) blocks = 132 * 8;
  absmax_kernel<<<(int)blocks, kThreads, 0, stream>>>(x, n, out);
  return (int)cudaGetLastError();
}
