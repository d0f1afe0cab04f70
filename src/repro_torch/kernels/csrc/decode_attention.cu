// Decode attention over a BP8-quantised KV cache: one query token per row,
// split over the cache (flash-decoding).
//
// Replaces: repro/kernels/attention.py, bp8_decode_attention (kernel
// _decode_attn_kernel).
//
// Bound on the H100: bytes.  The cache streams as int8 codes (1 byte per
// element) plus one f32 scale per (token, kv-head); each code is used by
// the G query heads of its group, 2 flops each for scores and values.  At
// B 4, KH 8, D 80, S 1024 that is 5.2 MB, 1.7 us at 3.35 TB/s, so the
// kernel is bound by how many loads it keeps in flight and by how short
// its chain of dependent steps is, not by arithmetic.
//
// Design: the grid runs over (row x kv-head, split).  A split is a
// contiguous run of `split` cache tokens (32, 64 or 128, chosen by the
// wrapper so that the grid fills the SMs a few times over; no split is
// empty).  Each block
//   1. loads its split's K and V codes with 16-byte loads when D allows
//      (a head's D codes of one token are contiguous), all in flight at
//      once, and dequantises them on read into shared memory as
//      (float)code / 10.0f * scale, the reference's kc / 10.0 * ks (the
//      quotients from a 256-entry table the block builds first: an IEEE
//      division per element would cost more than the rest of the block);
//   2. scores: 128 / split threads per token, each holding its share of
//      the token's G dots in registers (q is read from shared memory as a
//      broadcast), then the
//      softcap and the three masks of the reference (kv_pos >= 0, causal
//      kv_pos <= q_pos, q_pos - kv_pos < window) with the sentinel -1e30f,
//      not -inf; tokens past S get -inf, weight exactly 0;
//   3. one warp per query head takes the split's max m and the weights
//      p = exp(s - m) and their sum l;
//   4. P.V, one output element per thread, and writes (m, l, acc[G x D])
//      to the f32 workspace.
// A second kernel merges a row's partials: M = max m_i,
// L = sum l_i exp(m_i - M), out = sum acc_i exp(m_i - M) / max(L, 1e-30).
// With the -1e30 sentinel a fully masked split merges with weight 0 as
// soon as any split of the row is live, and a fully masked row (the
// padding rows of the paged batch read the null block) gives the
// reference's uniform average over all S.  No split is skipped.
// Tolerance 1e-5: the softmax is reassociated across splits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // also the most tokens a split may hold
constexpr int kMaxG = 16;          // query heads per kv-head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (float)c / 10.0f for every int8 c, built once per block: the IEEE
// division costs tens of instructions, a table read one.
__device__ __forceinline__ void tenths_table(float* tab) {
  for (int c = threadIdx.x; c < 256; c += blockDim.x)
    tab[c] = (float)(c - 128) / 10.0f;
}

__device__ __forceinline__ float dequant(const float* tab, int8_t c,
                                         float s) {
  return tab[c + 128] * s;
}

template <int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const float* __restrict__ q,
                      const int8_t* __restrict__ kc,
                      const float* __restrict__ ks,
                      const int8_t* __restrict__ vc,
                      const float* __restrict__ vs,
                      const int* __restrict__ kv_pos,
                      const int* __restrict__ q_pos, float* __restrict__ ws,
                      int S, int KH, int G, int D, int split, int window,
                      float softcap, int causal) {
  extern __shared__ float smem[];
  const int row = blockIdx.x, b = row / KH, h = row % KH;
  const int nsplit = gridDim.y, part = row * nsplit + blockIdx.y;
  const int t0 = blockIdx.y * split;
  const int GD = G * D, KD = D + 1;     // K rows padded: no bank conflicts
  float* qs = smem;                     // G*D
  float* kf = qs + GD;                  // split*KD
  float* vf = kf + split * KD;          // split*D
  float* p = vf + split * D;            // G*split: scores, then weights
  float* tab = p + G * split;           // 256: code / 10
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const float* qb = q + (size_t)row * GD;
  for (int i = tid; i < GD; i += kThreads) qs[i] = qb[i];
  tenths_table(tab);
  __syncthreads();

  const bool vec = D % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kc) |
                     reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
  if (vec) {
    // up to kLoads 16-byte loads of K and of V per thread in flight at once
    constexpr int kLoads = 4;
    const int units = D / 16, total = split * units;
    for (int u0 = tid; u0 < total; u0 += kLoads * kThreads) {
      union { uint4 v; int8_t b[16]; } kr[kLoads], vr[kLoads];
      float ksc[kLoads], vsc[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int u = u0 + i * kThreads, t = t0 + u / units;
        kr[i].v = vr[i].v = make_uint4(0, 0, 0, 0);
        ksc[i] = vsc[i] = 0.0f;
        if (u < total && t < S) {
          const size_t r = ((size_t)b * S + t) * KH + h;
          const int d0 = (u % units) * 16;
          kr[i].v = __ldg(reinterpret_cast<const uint4*>(kc + r * D + d0));
          vr[i].v = __ldg(reinterpret_cast<const uint4*>(vc + r * D + d0));
          ksc[i] = ks[r];
          vsc[i] = vs[r];
        }
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int u = u0 + i * kThreads;
        if (u >= total) break;
        const int c = u / units, d0 = (u % units) * 16;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          kf[c * KD + d0 + e] = dequant(tab, kr[i].b[e], ksc[i]);
          vf[c * D + d0 + e] = dequant(tab, vr[i].b[e], vsc[i]);
        }
      }
    }
  } else {
    for (int u = tid; u < split * D; u += kThreads) {
      const int c = u / D, d = u % D, t = t0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (t < S) {
        const size_t r = ((size_t)b * S + t) * KH + h;
        kv = dequant(tab, kc[r * D + d], ks[r]);
        vv = dequant(tab, vc[r * D + d], vs[r]);
      }
      kf[c * KD + d] = kv;
      vf[c * D + d] = vv;
    }
  }
  __syncthreads();

  // scores: kThreads / split threads per token, each with every
  // (kThreads / split)-th of its G dots in registers
  {
    const int groups = kThreads / split, c = tid % split, grp = tid / split;
    const int t = t0 + c;
    float acc[GMAX];
#pragma unroll
    for (int i = 0; i < GMAX; ++i) acc[i] = 0.0f;
    const float* kr = kf + c * KD;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int i = 0; i < GMAX; ++i) {
        const int g = grp + i * groups;
        if (g < G) acc[i] += qs[g * D + d] * kv;
      }
    }
    bool ok = false;
    if (t < S) {
      const int qp = q_pos[b], kp = kv_pos[(size_t)b * S + t];
      ok = kp >= 0 && (!causal || kp <= qp) && (qp - kp < window);
    }
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      const int g = grp + i * groups;
      if (g >= G) break;
      float s = acc[i];
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      if (!ok) s = kNegInf;
      if (t >= S) s = -INFINITY;      // past the cache: weight exactly 0
      p[g * split + c] = s;
    }
  }
  __syncthreads();

  // per query head: the split's max, weights and their sum
  float* wm = ws + (size_t)gridDim.x * nsplit * GD;
  float* wl = wm + (size_t)gridDim.x * nsplit * G;
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int c = lane; c < split; c += 32) m = fmaxf(m, p[g * split + c]);
    m = warp_max(m);                   // finite: a split has a token < S
    float l = 0.0f;
    for (int c = lane; c < split; c += 32) {
      const float e = expf(p[g * split + c] - m);
      p[g * split + c] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      wm[(size_t)part * G + g] = m;
      wl[(size_t)part * G + g] = l;
    }
  }
  __syncthreads();

  float* wa = ws + (size_t)part * GD;
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* pg = p + g * split;
    float a = 0.0f;
    for (int c = 0; c < split; ++c) a += pg[c] * vf[c * D + d];
    wa[i] = a;
  }
}

// One output element per thread: grid (row x kv-head, ceil(G*D / 128)).
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ ws, float* __restrict__ out,
                      int nsplit, int G, int D) {
  const int row = blockIdx.x, rows = gridDim.x, GD = G * D;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= GD) return;
  const int g = j / D;
  const size_t p0 = (size_t)row * nsplit;
  const float* wm = ws + (size_t)rows * nsplit * GD + p0 * G + g;
  const float* wl = ws + (size_t)rows * nsplit * (GD + G) + p0 * G + g;
  const float* wa = ws + p0 * GD + j;
  float m = -INFINITY;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i) m = fmaxf(m, wm[(size_t)i * G]);
  float l = 0.0f, a = 0.0f;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i) {
    const float w = expf(wm[(size_t)i * G] - m);
    l += wl[(size_t)i * G] * w;
    a += wa[(size_t)i * GD] * w;
  }
  out[(size_t)row * GD + j] = a / fmaxf(l, 1e-30f);
}

}  // namespace

static size_t partial_smem(int G, int D, int split) {
  return (size_t)(G * D + split * (D + 1) + split * D + G * split + 256) *
         sizeof(float);
}

// ws: B*KH*nsplit*(G*D + 2*G) floats, nsplit = ceil(S / split).
extern "C" int oisma_decode_attention(const float* q, const int8_t* kc,
                                      const float* ks, const int8_t* vc,
                                      const float* vs, const int* kv_pos,
                                      const int* q_pos, float* out, float* ws,
                                      int B, int S, int KH, int G, int D,
                                      int split, int window, float softcap,
                                      int causal, cudaStream_t stream) {
  if (G > kMaxG || split < 32 || split > kThreads || kThreads % split)
    return (int)cudaErrorInvalidValue;
  const size_t smem = partial_smem(G, D, split);
  const int nsplit = (S + split - 1) / split;
  const dim3 grid(B * KH, nsplit);
  // the G dots of a token live in registers: size them to G
  auto kernel = G <= 4 ? decode_partial_kernel<4>
                : G <= 8 ? decode_partial_kernel<8> : decode_partial_kernel<16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of L1 as shared memory, so that several blocks fit on an SM
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(q, kc, ks, vc, vs, kv_pos, q_pos,
                                            ws, S, KH, G, D, split, window,
                                            softcap, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 cgrid(B * KH, (G * D + kThreads - 1) / kThreads);
  decode_combine_kernel<<<cgrid, kThreads, 0, stream>>>(ws, out, nsplit, G, D);
  return (int)cudaGetLastError();
}
