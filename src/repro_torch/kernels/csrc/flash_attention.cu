// Forward flash attention (kernel 5) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py flash_attention
// (body _flash_kernel): q (B, Sq, H, D), k and v (B, Skv, KH, D) with
// H % KH == 0, out (B, Sq, H, D) in q's type.  Scores (q * D^-0.5) . k in
// f32, an f32 online softmax (running max, denominator, exp correction),
// masks of -1e30 (key padding, causal kpos <= qpos, window kpos > qpos -
// window), the denominator guarded at 1e-30.  GQA reads KV head
// h / (H / KH) in place: no repeated K/V is materialized.
//
// What bounds it: one forward of smollm-360m (4 x 512 tokens, causal)
// does about 2 GFLOP of f32 dot products per layer against 10 MB of
// q/k/v/out, so the f32 operations bound it, not the bytes.  This first
// kernel runs them on the f32 FMA units (67 TFLOP/s peak), not on the
// tensor cores, which would not give the same f32 result; tensor cores and
// TMA are later work.
//
// Design (simple first):
//   * one block per (64-query block, batch x head); 4 threads per query
//     row, each holding the scaled query and the f32 accumulator of every
//     4th dimension (interleaved, so the 4 threads of a row read 4
//     neighbouring shared-memory words and the 8 rows of a warp broadcast);
//   * the block loops over KV tiles of 4,096 / D positions, staged in
//     shared memory as f32 (32 KB for K and V together), only over the KV
//     range some query of the block can see (causal: up to the block's last
//     query; window: from its first query's window start), so it skips every
//     block the TPU kernel skips, at a finer grain;
//   * within a tile, 16 keys at a time: partial dots, two shuffles to sum
//     the 4 threads' parts, mask, then one online-softmax update.
// The sum order differs from the plain version's (bq = bk = 512 blocks), so
// results agree to f32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int TPR = 4;                // threads per query row
constexpr int THREADS = BQ * TPR;     // 256
constexpr int TILE_ELEMS = 4096;      // BK x D floats of one staged tile
constexpr int SUB = 16;               // keys per online-softmax update
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int KH,
          int Sq, int Skv, float scale, int causal, int window) {
  constexpr int BK = TILE_ELEMS / D;  // 128, 64, 32 positions
  constexpr int DP = D / TPR;         // dimensions per thread
  __shared__ float ks[TILE_ELEMS];
  __shared__ float vs[TILE_ELEMS];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int sub = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const bool active = qi < Sq;

  const long q_off = (((long)b * Sq + qi) * H + h) * D + sub;
  float qr[DP], acc[DP];
#pragma unroll
  for (int t = 0; t < DP; ++t) {
    qr[t] = active ? __fmul_rn(to_f(q[q_off + TPR * t]), scale) : 0.0f;
    acc[t] = 0.0f;
  }
  float m = NEG, l = 0.0f;

  // The KV positions some query of this block can see.
  const int k_hi = causal ? min(Skv, q0 + BQ) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const long kv_base = (long)b * Skv * KH * D + (long)kvh * D;
  const long kv_step = (long)KH * D;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < TILE_ELEMS; e += THREADS) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kk = 0.0f, vv = 0.0f;
      if (kp < Skv) {
        const long off = kv_base + kp * kv_step + d;
        kk = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[e] = kk;
      vs[e] = vv;
    }
    __syncthreads();
    const int nk = min(BK, k_hi - k0);
    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float s[SUB];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float* kr = ks + (j0 + jj) * D + sub;
        float p = 0.0f;
#pragma unroll
        for (int t = 0; t < DP; ++t) p = fmaf(qr[t], kr[TPR * t], p);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        const int kp = k0 + j0 + jj;
        bool valid = kp < Skv;
        if (causal) valid = valid && kp <= qi;
        if (window > 0) valid = valid && kp > qi - window;
        s[jj] = valid ? p : NEG;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      float psum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        s[jj] = expf(s[jj] - mx);
        psum += s[jj];
      }
      l = l * corr + psum;
#pragma unroll
      for (int t = 0; t < DP; ++t) acc[t] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float* vr = vs + (j0 + jj) * D + sub;
#pragma unroll
        for (int t = 0; t < DP; ++t) acc[t] = fmaf(s[jj], vr[TPR * t], acc[t]);
      }
      m = mx;
    }
  }

  if (!active) return;
  const float den = fmaxf(l, 1e-30f);
  T* o = out + q_off;
#pragma unroll
  for (int t = 0; t < DP; ++t) store(o + TPR * t, __fdiv_rn(acc[t], den));
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int H, int KH, int Sq, int Skv, int D, float scale,
                 int causal, int window, cudaStream_t st) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const T* qq = (const T*)q;
  const T* kk = (const T*)k;
  const T* vv = (const T*)v;
  T* oo = (T*)out;
  switch (D) {
    case 32:
      flash_fwd<T, 32><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq,
                                                 Skv, scale, causal, window);
      break;
    case 64:
      flash_fwd<T, 64><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq,
                                                 Skv, scale, causal, window);
      break;
    case 128:
      flash_fwd<T, 128><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq,
                                                  Skv, scale, causal, window);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int B, int H, int KH, int Sq, int Skv,
                                      int D, float scale, int causal,
                                      int window, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Skv, D,
                                       scale, causal, window, st);
  return launch_typed<float>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                             causal, window, st);
}
