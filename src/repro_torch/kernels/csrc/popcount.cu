// Accumulation periphery: the int32 sum of each row of a byte matrix (the
// popcount of a row of 0/1 bits).
//
// Replaces: repro/kernels/bp_matmul.py, popcount_accumulate_pallas (kernel
// _popcount_kernel).
//
// Bound on the H100: bytes (one byte read per element, 4 written per row).
// An 8 MB tile is 2.5 us at 3.35 TB/s: one wave of the card, so the time
// is set by how soon every load is in flight and by the launch, not by
// the bandwidth of a long stream.
//
// Design: the TPU kernel halves a (256-row, 2^n) tile column-wise, the
// adder tree of the paper's periphery, whose widths are 16, 64 and 256
// columns.  Here a row gets LANES lanes of a warp, a power of two chosen
// by the wrapper from the width (C / 16 clamped to 1..32: a row of 16
// bytes is one 16-byte load), and a warp holds 32 / LANES rows, so that at
// every width each lane loads 16 bytes and a warp reads 512 contiguous
// bytes.  A lane reads its row's aligned middle as 16-byte words, up to
// kUnroll of them into registers before any is added, adds each word's
// bytes with __dp4a against 0x01010101 (signed for int8, unsigned for
// uint8 and bool), takes the unaligned head and tail byte by byte, and
// the row's lanes fold their sums by a segmented __shfl_xor_sync (the xor
// offsets below LANES stay within the row's lanes).  The grid is sized to
// the SMs and steps over groups of rows, so a call is one launch of at
// most a few thousand warps, whatever R.  The bytes are summed as values,
// not counted as set bits, so any int8 row gives its exact sum, and any R
// and C work without padding (the TPU wrapper pads to 256 rows and a
// power-of-two width, where zeros add nothing).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // 16-byte loads in flight a lane
constexpr int kBlocksPerSm = 8;      // 2048 threads an SM

template <bool SIGNED>
__device__ __forceinline__ int add_bytes(uint32_t w, int acc) {
  if (SIGNED) return __dp4a((int)w, 0x01010101, acc);
  return (int)__dp4a(w, 0x01010101u, (unsigned)acc);
}

template <bool SIGNED>
__device__ __forceinline__ int byte_value(uint8_t b) {
  return SIGNED ? (int)(int8_t)b : (int)b;
}

// The share of row `row` (C bytes) that lane `sub` of its LANES lanes sums.
template <bool SIGNED, int LANES>
__device__ __forceinline__ int lane_sum(const uint8_t* __restrict__ row,
                                        int C, int sub) {
  const int misalign = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(C, (16 - misalign) & 15);
  const int nvec = (C - head) >> 4;
  const uint4* mid = reinterpret_cast<const uint4*>(row + head);
  int acc = 0;
  for (int i = sub; i < head; i += LANES) acc += byte_value<SIGNED>(row[i]);
  for (int i0 = sub; i0 < nvec; i0 += kUnroll * LANES) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * LANES;
      w[u] = i < nvec ? __ldcs(mid + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc = add_bytes<SIGNED>(w[u].x, acc);
      acc = add_bytes<SIGNED>(w[u].y, acc);
      acc = add_bytes<SIGNED>(w[u].z, acc);
      acc = add_bytes<SIGNED>(w[u].w, acc);
    }
  }
  for (int i = head + 16 * nvec + sub; i < C; i += LANES)
    acc += byte_value<SIGNED>(row[i]);
  return acc;
}

template <bool SIGNED, int LANES>
__global__ void __launch_bounds__(kThreads)
popcount_kernel(const uint8_t* __restrict__ bits, int* __restrict__ out,
                int R, int C) {
  constexpr int kRowsPerWarp = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES, slot = lane / LANES;
  const long long groups = (R + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long step = (long long)gridDim.x * kWarps;
  // the loop bound is the warp's own, so all 32 lanes reach the shuffles
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < groups; g += step) {
    const long long r = g * kRowsPerWarp + slot;
    int acc = r < R ? lane_sum<SIGNED, LANES>(bits + r * C, C, sub) : 0;
#pragma unroll
    for (int o = LANES / 2; o; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (sub == 0 && r < R) out[r] = acc;
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

template <bool SIGNED, int LANES>
int launch(const uint8_t* bits, int* out, int R, int C, cudaStream_t stream) {
  constexpr int kRowsPerWarp = 32 / LANES;
  const long long groups = ((long long)R + kRowsPerWarp - 1) / kRowsPerWarp;
  long long blocks = (groups + kWarps - 1) / kWarps;
  const long long most = (long long)kBlocksPerSm * sm_count();
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  popcount_kernel<SIGNED, LANES>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(bits, out, R, C);
  return (int)cudaGetLastError();
}

template <bool SIGNED>
int launch_lanes(const uint8_t* bits, int* out, int R, int C, int lanes,
                 cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch<SIGNED, 1>(bits, out, R, C, stream);
    case 2: return launch<SIGNED, 2>(bits, out, R, C, stream);
    case 4: return launch<SIGNED, 4>(bits, out, R, C, stream);
    case 8: return launch<SIGNED, 8>(bits, out, R, C, stream);
    case 16: return launch<SIGNED, 16>(bits, out, R, C, stream);
    case 32: return launch<SIGNED, 32>(bits, out, R, C, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// lanes: a row's lanes, a power of two in 1..32 (bp_matmul.popcount_lanes).
extern "C" int oisma_popcount(const uint8_t* bits, int is_signed, int* out,
                              int R, int C, int lanes, cudaStream_t stream) {
  if (is_signed) return launch_lanes<true>(bits, out, R, C, lanes, stream);
  return launch_lanes<false>(bits, out, R, C, lanes, stream);
}
