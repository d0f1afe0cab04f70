// Accumulation periphery: the int32 sum of each row of a byte matrix (the
// popcount of a row of 0/1 bits).
//
// Replaces: repro/kernels/bp_matmul.py, popcount_accumulate_pallas (kernel
// _popcount_kernel).
//
// Bound on the H100: bytes (one byte read per element, 4 written per row).
//
// Design: the TPU kernel halves a (256-row, 2^n) tile column-wise, the
// adder tree of the paper's periphery.  Here one warp owns a row: its
// lanes read the row's aligned middle as 16-byte words and add each word's
// bytes with __dp4a against 0x01010101 (signed for int8, unsigned for uint8
// and bool), take the unaligned head and tail byte by byte, and fold the
// lanes' sums by warp shuffles.  The bytes are summed as values, not
// counted as set bits, so any int8 row gives its exact sum, and any R and
// C work without padding (the TPU wrapper pads to 256 rows and a power-of-
// two width, where zeros add nothing).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <bool SIGNED>
__device__ __forceinline__ int add_bytes(uint32_t w, int acc) {
  if (SIGNED) return __dp4a((int)w, 0x01010101, acc);
  return (int)__dp4a(w, 0x01010101u, (unsigned)acc);
}

template <bool SIGNED>
__device__ __forceinline__ int byte_value(uint8_t b) {
  return SIGNED ? (int)(int8_t)b : (int)b;
}

template <bool SIGNED>
__global__ void __launch_bounds__(kThreads)
popcount_kernel(const uint8_t* __restrict__ bits, int* __restrict__ out,
                int R, int C) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const uint8_t* row = bits + (size_t)r * C;
  const int misalign = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(C, misalign ? 16 - misalign : 0);
  const int nvec = (C - head) / 16;
  const uint4* mid = reinterpret_cast<const uint4*>(row + head);
  int acc = 0;
  for (int i = lane; i < head; i += 32) acc += byte_value<SIGNED>(row[i]);
  for (int i = lane; i < nvec; i += 32) {
    const uint4 w = mid[i];
    acc = add_bytes<SIGNED>(w.x, acc);
    acc = add_bytes<SIGNED>(w.y, acc);
    acc = add_bytes<SIGNED>(w.z, acc);
    acc = add_bytes<SIGNED>(w.w, acc);
  }
  for (int i = head + 16 * nvec + lane; i < C; i += 32)
    acc += byte_value<SIGNED>(row[i]);
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[r] = acc;
}

}  // namespace

extern "C" int oisma_popcount(const uint8_t* bits, int is_signed, int* out,
                              int R, int C, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((R + kRowsPerBlock - 1) / kRowsPerBlock);
  if (is_signed)
    popcount_kernel<true><<<blocks, kThreads, 0, stream>>>(bits, out, R, C);
  else
    popcount_kernel<false><<<blocks, kThreads, 0, stream>>>(bits, out, R, C);
  return (int)cudaGetLastError();
}
