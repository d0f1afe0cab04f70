// Per-tensor max|x| floored at a given value (the BP scale pass), for an
// f32 or a bf16 array, in one launch.
//
// Replaces: repro/kernels/fused.py, absmax_pallas (kernel _absmax_kernel),
// with the caller's floor (ops.py's jnp.maximum(., tiny)) folded in.  The
// TPU kernel casts its tile to f32 in the body; widening bf16 to f32 is
// exact, so reading the stored bf16 and widening in registers gives the
// max of the cast tensor bit for bit.
//
// Bound on the H100: bytes (2 or 4 per element read, one compare each).
// The served path scans each bf16 weight once per call, 2 bytes an
// element.
//
// Design: a grid sized to fill the SMs; each thread keeps kUnroll 16-byte
// loads (4 f32 or 8 bf16) in flight before it folds them, and the
// unaligned head and tail take scalar loads.  Each block reduces through
// warp shuffles and shared memory and writes its maximum to a partials
// slot, then fences and takes a ticket from a counter; the block that
// takes the last ticket folds the partials, writes max(result, floor) and
// resets the counter to 0.  Max is order-free, so the result is bitwise
// the reference's in any block order.  One launch a call, no memset.
//
// NaN: the reference folds with jnp.max and jnp.maximum, which return NaN
// when any element is NaN.  CUDA's fmaxf drops a NaN operand, so every
// fold here (the per-element fold, both shuffle folds, the partials fold
// and the floor) is max_nan: PTX max.NaN.f32, which returns NaN when
// either operand is NaN and is fmaxf otherwise.
//
// The counter and the partials are device globals of this library, zeroed
// once per device when the module loads.  A call leaves the counter at 0
// again, and calls on one stream run one after another, which is what
// keeps reusing them safe: two calls running at once on two streams would
// share them and must not be made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;            // 16-byte loads in flight a thread
constexpr int kMaxBlocks = 2048;      // partials slots

__device__ float g_partials[kMaxBlocks];
__device__ unsigned int g_tickets;

// max(a, b), NaN if either is NaN (fmaxf would return the other one)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max|.| of the V elements of one 16-byte vector
template <typename T>
__device__ __forceinline__ float vec_absmax(const uint4& u) {
  constexpr int V = 16 / (int)sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  float m = fabsf(widen(e[0]));
#pragma unroll
  for (int i = 1; i < V; ++i) m = max_nan(m, fabsf(widen(e[i])));
  return m;
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
  for (int o = 16; o; o >>= 1)
    m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.0f;
  if (threadIdx.x < 32)
    for (int o = 16; o; o >>= 1)
      m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;         // thread 0 holds the block's maximum
}

// x: n elements; the first `head` are scalar, then `nvec` 16-byte
// vectors, then the scalar tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, long long n, long long head,
              long long nvec, float lo, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float m = 0.0f;
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  for (long long i = tid; i < nvec; i += stride * kUnroll) {
    uint4 u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i + j * stride < nvec) u[j] = __ldg(v + i + j * stride);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (i + j * stride < nvec) m = max_nan(m, vec_absmax<T>(u[j]));
  }
  constexpr int V = 16 / (int)sizeof(T);
  const long long body_end = head + nvec * V;
  const long long rest = head + (n - body_end);    // scalar elements
  for (long long i = tid; i < rest; i += stride)
    m = max_nan(m, fabsf(widen(x[i < head ? i : body_end + (i - head)])));

  m = block_max(m);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    g_partials[blockIdx.x] = m;
    __threadfence();                 // the slot is seen before the ticket
    last = atomicAdd(&g_tickets, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
    m = max_nan(m, __ldcg(g_partials + b));
  m = block_max(m);
  if (threadIdx.x == 0) {
    out[0] = max_nan(m, lo);
    g_tickets = 0;                   // ready for the next call
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <typename T>
int launch(const T* x, long long n, float lo, float* out,
           cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T);
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) & 15;
  long long head = mis ? (long long)((16 - mis) / sizeof(T)) : 0;
  if (mis % sizeof(T) || head > n) head = n;     // no aligned vector at all
  const long long nvec = (n - head) / V;
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (nvec + per_block - 1) / per_block;
  const long long most = 8LL * sm_count();       // 2048 threads an SM
  if (blocks > most) blocks = most;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  absmax_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(x, n, head, nvec,
                                                          lo, out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: f32, 1: bf16.  One launch.
extern "C" int oisma_absmax(const void* x, int dtype, long long n,
                            float lo, float* out, cudaStream_t stream) {
  if (dtype == 1)
    return launch(static_cast<const __nv_bfloat16*>(x), n, lo, out,
                  stream);
  return launch(static_cast<const float*>(x), n, lo, out, stream);
}
