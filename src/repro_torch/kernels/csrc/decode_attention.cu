// Decode attention over a BP8-quantised KV cache: one query token per row.
//
// Replaces: repro/kernels/attention.py, bp8_decode_attention (kernel
// _decode_attn_kernel).
//
// Bound on the H100: bytes.  The cache streams as int8 codes (1 byte per
// element) plus one f32 scale per (token, kv-head); each code is used by
// the G query heads of its group, 2 flops each for scores and values.
//
// Design: one block per (row, kv-head) holds its G grouped query heads.
// It walks the cache in chunks of 32 tokens: loads the chunk's codes with
// 16-byte loads (a head's D codes of one token are contiguous), dequantises
// K and V into shared memory as (float)code / 10 * scale (the reference's
// division),
// scores one token per lane with one warp per query head, and carries the
// online softmax (m, l, acc) in shared memory across chunks.  Masks follow
// the reference: kv_pos >= 0, causal kv_pos <= q_pos, q_pos - kv_pos <
// window, with the sentinel -1e30f (not -inf): a fully masked chunk then
// weighs its tokens uniformly until a live chunk wipes it with
// alpha = exp(-1e30 - m) = 0, and a fully masked row (a padding row of the
// paged batch gathers the null block) gives the reference's uniform
// average.  Tokens past the end of a partial last chunk get -inf, weight
// exactly 0.  Output acc / max(l, 1e-30).  Tolerance 1e-5: the softmax is
// reassociated across chunks.  A split over the cache (flash-decoding)
// for more blocks is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;          // tokens per step: one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ kc,
                        const float* __restrict__ ks,
                        const int8_t* __restrict__ vc,
                        const float* __restrict__ vs,
                        const int* __restrict__ kv_pos,
                        const int* __restrict__ q_pos, float* __restrict__ out,
                        int S, int KH, int G, int D, int window, float softcap,
                        int causal) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KH, h = blockIdx.x % KH;
  const int GD = G * D, KD = D + 1;     // K rows padded: no bank conflicts
  float* qs = smem;                     // G*D
  float* acc = qs + GD;                 // G*D
  float* kf = acc + GD;                 // kChunk*KD
  float* vf = kf + kChunk * KD;         // kChunk*D
  float* p = vf + kChunk * D;           // G*kChunk
  float* m_s = p + G * kChunk;          // G
  float* l_s = m_s + G;                 // G
  float* a_s = l_s + G;                 // G
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  const float* qb = q + ((size_t)b * KH + h) * GD;
  for (int i = tid; i < GD; i += kThreads) {
    qs[i] = qb[i];
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  const int qp = q_pos[b];
  __syncthreads();

  // a token's D codes of one head are contiguous: 16-byte loads when D
  // allows, so a chunk's loads are all in flight at once
  const bool vec = D % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(kc) |
                     reinterpret_cast<uintptr_t>(vc)) & 15) == 0;
  const int units = vec ? D / 16 : D;   // loads per token row
  const int width = vec ? 16 : 1;       // codes per load
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    for (int u = tid; u < kChunk * units; u += kThreads) {
      const int c = u / units, d0 = (u % units) * width, t = c0 + c;
      union { uint4 v; int8_t b[16]; } kr, vr;
      float ksc = 0.0f, vsc = 0.0f;
      if (t < S) {
        const size_t row = ((size_t)b * S + t) * KH + h;
        if (vec) {
          kr.v = *reinterpret_cast<const uint4*>(kc + row * D + d0);
          vr.v = *reinterpret_cast<const uint4*>(vc + row * D + d0);
        } else {
          kr.b[0] = kc[row * D + d0];
          vr.b[0] = vc[row * D + d0];
        }
        ksc = ks[row];
        vsc = vs[row];
      } else {
        for (int i = 0; i < width; ++i) kr.b[i] = vr.b[i] = 0;
      }
      for (int i = 0; i < width; ++i) {
        kf[c * KD + d0 + i] = (float)kr.b[i] / 10.0f * ksc;
        vf[c * D + d0 + i] = (float)vr.b[i] / 10.0f * vsc;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      const int t = c0 + lane;
      float s = -INFINITY;
      if (t < S) {
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot += qs[g * D + d] * kf[lane * KD + d];
        s = dot;
        if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
        const int kp = kv_pos[(size_t)b * S + t];
        const bool ok = kp >= 0 && (!causal || kp <= qp) && (qp - kp < window);
        if (!ok) s = kNegInf;
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pv = expf(s - m_new);
      const float psum = warp_sum(pv);
      p[g * kChunk + lane] = pv;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / D, d = i % D;
      float sacc = 0.0f;
      for (int c = 0; c < kChunk; ++c) sacc += p[g * kChunk + c] * vf[c * D + d];
      acc[i] = acc[i] * a_s[g] + sacc;
    }
    __syncthreads();
  }

  float* ob = out + ((size_t)b * KH + h) * GD;
  for (int i = tid; i < GD; i += kThreads) ob[i] = acc[i] / fmaxf(l_s[i / D], 1e-30f);
}

}  // namespace

extern "C" int oisma_decode_attention(const float* q, const int8_t* kc,
                                      const float* ks, const int8_t* vc,
                                      const float* vs, const int* kv_pos,
                                      const int* q_pos, float* out, int B,
                                      int S, int KH, int G, int D, int window,
                                      float softcap, int causal,
                                      cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * G * D + kChunk * (D + 1) + kChunk * D + G * kChunk + 3 * G) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attention_kernel<<<B * KH, kThreads, smem, stream>>>(
      q, kc, ks, vc, vs, kv_pos, q_pos, out, S, KH, G, D, window, softcap,
      causal);
  return (int)cudaGetLastError();
}
