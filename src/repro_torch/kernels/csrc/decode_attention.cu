// Single-query GQA decode attention over the int8 KV cache (kernel 3) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   repro/kernels/abfp_decode_fused.py  fused_quantized_decode_attention
// scores = (q * d^-1/2) . k_codes * (k_scale / 127) per cached position,
// positions >= length masked (-1e30), an f32 softmax over the key axis,
// then PV with the value codes weighted by p * (v_scale / 127).
//
// What bounds it: the int8 cache read (2 * length * KH * D bytes per batch
// row) from device memory; the arithmetic is a few f32 operations per byte.
//
// Design (simple first): one block per (batch row, KV head) serves that
// head's rep = H / KH query heads, so each K/V code is read once for all
// of them.  Threads stride over positions for the scores (kept in shared
// memory), block reductions give each query head's max and sum, and
// threads then own (query head, d) outputs for the PV sum.  Masked
// positions contribute exactly 0 in f32 (exp(-1e30 - max) underflows), so
// only the first `length` positions are visited; a row with length 0
// keeps the reference's uniform softmax over all positions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Block-wide reduction (max when is_max, else sum); every thread gets it.
__device__ float block_reduce(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = red[0];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
      a = is_max ? fmaxf(a, red[i]) : __fadd_rn(a, red[i]);
    red[32] = a;
  }
  __syncthreads();
  float r = red[32];
  __syncthreads();
  return r;
}

template <typename QT>
__global__ void __launch_bounds__(THREADS)
decode_attention(const QT* __restrict__ q, const int8_t* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ ks,
                 const int8_t* __restrict__ vc,
                 const __nv_bfloat16* __restrict__ vs,
                 const int32_t* __restrict__ lengths, QT* __restrict__ out,
                 int S, int H, int KH, int D, float qscale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / KH, g = blockIdx.x % KH;
  const int rep = H / KH;
  const int len = lengths[b];
  const bool all_masked = len <= 0;
  const int L = all_masked ? S : min(len, S);
  float* qf = smem;                 // [rep][D]
  float* sc = qf + rep * D;         // [rep][L]
  float* red = sc + rep * L;        // [33]

  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    int r = i / D, d = i % D;
    qf[i] = __fmul_rn(to_f(q[((long)b * H + g * rep + r) * D + d]), qscale);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < L; s += blockDim.x) {
    long pos = ((long)b * S + s) * KH + g;
    if (all_masked) {
      for (int r = 0; r < rep; ++r) sc[r * L + s] = -1e30f;
      continue;
    }
    float kscale = __fdiv_rn(__bfloat162float(ks[pos]), 127.0f);
    const int8_t* kp = kc + pos * D;
    for (int r = 0; r < rep; ++r) {
      float dot = 0.0f;
      for (int d = 0; d < D; ++d)
        dot = __fadd_rn(dot, __fmul_rn(qf[r * D + d], (float)kp[d]));
      sc[r * L + s] = __fmul_rn(dot, kscale);
    }
  }
  __syncthreads();

  for (int r = 0; r < rep; ++r) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int s = threadIdx.x; s < L; s += blockDim.x)
      mx = fmaxf(mx, sc[r * L + s]);
    mx = block_reduce(mx, true, red);
    float sum = 0.0f;
    for (int s = threadIdx.x; s < L; s += blockDim.x) {
      float e = expf(__fsub_rn(sc[r * L + s], mx));
      sc[r * L + s] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_reduce(sum, false, red);
    for (int s = threadIdx.x; s < L; s += blockDim.x) {
      float vscale = __fdiv_rn(__bfloat162float(vs[((long)b * S + s) * KH + g]),
                               127.0f);
      sc[r * L + s] = __fmul_rn(__fdiv_rn(sc[r * L + s], sum), vscale);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    int r = i / D, d = i % D;
    float acc = 0.0f;
    for (int s = 0; s < L; ++s)
      acc = __fadd_rn(acc, __fmul_rn(sc[r * L + s],
                                     (float)vc[(((long)b * S + s) * KH + g) * D + d]));
    store(&out[((long)b * H + g * rep + r) * D + d], acc);
  }
}

template <typename QT>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* lengths, void* out, int B, int S,
           int H, int KH, int D, float qscale, cudaStream_t st) {
  int rep = H / KH;
  size_t smem = sizeof(float) * ((size_t)rep * D + (size_t)rep * S + 33);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attention<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_attention<QT><<<B * KH, THREADS, smem, st>>>(
      (const QT*)q, (const int8_t*)kc, (const __nv_bfloat16*)ks,
      (const int8_t*)vc, (const __nv_bfloat16*)vs, (const int32_t*)lengths,
      (QT*)out, S, H, KH, D, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, int q_bf16,
                                       const void* kc, const void* ks,
                                       const void* vc, const void* vs,
                                       const void* lengths, void* out, int B,
                                       int S, int H, int KH, int D,
                                       float qscale, void* stream) {
  if (H % KH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return q_bf16 ? launch<__nv_bfloat16>(q, kc, ks, vc, vs, lengths, out, B, S,
                                        H, KH, D, qscale, st)
                : launch<float>(q, kc, ks, vc, vs, lengths, out, B, S, H, KH,
                                D, qscale, st);
}
