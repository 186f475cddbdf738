// Packed ABFP matmul (kernel 1), fused QKV projection (kernel 2) and the
// unpacked ABFP matmul's weight quantizer (kernel 4) for Hopper (sm_90a),
// with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernels
//   repro/kernels/abfp_matmul.py        abfp_matmul_packed_pallas
//   repro/kernels/abfp_decode_fused.py  fused_qkv_packed_pallas
//   repro/kernels/abfp_matmul.py        abfp_matmul_pallas (kernel 4:
//                                       abfp_quantize_w_launch, then the
//                                       kernel-1 launches)
// Both compute y = ABFP(x @ W) from int8 weight codes, bf16 per-(tile,
// column) scales and optional f32 per-tile ADC gains.  Kernel 2 is kernel 1
// run over up to three weights whose column blocks are concatenated; each
// segment keeps its own noise seed, column-block count and local block
// index, so it draws the noise a stand-alone call for that weight draws.
//
// What bounds it: at decode (M = 4 rows) the int8 codes are read once and
// every code feeds 4 multiply-adds, so the weight stream from device memory
// is the bound.  At prefill (M = 4 x 128 rows) the integer dots and the
// per-(row, tile, column) ADC epilogue dominate.
//
// Design (simple first):
//   1. abfp_quantize_x: one warp per (row, K-tile) derives the bf16-rounded
//      max-abs activation scale and the 8-bit DAC codes once per call (the
//      TPU kernel re-derived them in every grid step).
//   2. abfp_tile_terms: one block per (128-column block, K-tile, row block);
//      a thread owns one column.  Codes come in a kernel layout made at
//      pack time (int32 words of four K rows of one column), so a warp reads
//      128 contiguous bytes and feeds __dp4a.  The exact integer tile dot
//      goes through the ADC (gain, hash noise, round-half-even, clamp) in
//      registers and the rescaled per-tile term is stored in f32.  Splitting
//      over K-tiles gives every weight enough blocks to fill the card.
//   3. abfp_reduce: one thread per output sums the terms in the reference's
//      order (tiles of one reference K block, then blocks) and rounds to bf16.
// The noise depends on the reference grid (bm = auto_bm(M), bn = 128,
// bk = default_bk(n, K)), not on this tiling: every coordinate of the
// reference hash (salt, row, column) is recomputed here.
// The epilogue keeps the reference's f32 operation order; build with
// --fmad=false and without fast math (the __f*_rn intrinsics below also
// forbid contraction).
//
// Kernel 4 (abfp_matmul_pallas) is the same function on a float W: the TPU
// kernel re-derives the bf16 max-abs weight scales and the DAC codes of
// every (K-tile, column) in every grid step.  Here one launch,
// abfp_quantize_w, does that once per call and writes the codes straight
// into kernel 1's kcodes word layout and the bf16 scales into scratch;
// then kernel 1's three launches run on it with the scalar gain and no
// per-tile gains.  So kernel 4 equals kernel 1 on pack_abfp_weight(W) bit
// for bit by construction.  What bounds it: reading W once (bf16 at full
// width) adds K x N x 2 bytes to kernel 1's traffic, and the quantizer's
// int8 codes make one more round trip through device memory (K x N bytes
// written and read); at the evaluation shape (M = 2,048 rows) the f32 ADC
// epilogue per (row, K-tile, column) dominates both, as in kernel 1 at
// prefill.  A thread owns one (K-tile, column): its reads and writes are
// coalesced across the warp's 32 neighbouring columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;  // output columns per block (the reference bn)

__device__ __forceinline__ float hash_uniform(uint32_t r, uint32_t c,
                                              uint32_t seed, uint32_t salt) {
  uint32_t x = r * 0x9E3779B9u + c * 0x85EBCA6Bu + seed * 0xC2B2AE35u +
               salt * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return __fdiv_rn((float)(x >> 8), 16777216.0f);
}

__device__ __forceinline__ float load_x(const void* x, int x_bf16, long i) {
  return x_bf16 ? __bfloat162float(((const __nv_bfloat16*)x)[i])
                : ((const float*)x)[i];
}

// One warp per (row m, tile t): scale = bf16(max |x|), codes = clamp(
// rint(x / scale * lx)).  Elements past K (zero padding) quantize to 0.
__global__ void abfp_quantize_x(const void* __restrict__ x, int x_bf16, int M,
                                int K, int Kp, int T, int n, float lx,
                                int8_t* __restrict__ xq,
                                float* __restrict__ sx) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= M * T) return;
  int m = warp / T, t = warp % T;
  long base = (long)m * K;
  float mx = 0.0f;
  for (int i = lane; i < n; i += 32) {
    int k = t * n + i;
    float v = k < K ? load_x(x, x_bf16, base + k) : 0.0f;
    mx = fmaxf(mx, fabsf(v));
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float s = __bfloat162float(__float2bfloat16_rn(mx));
  float ss = s == 0.0f ? 1.0f : s;
  for (int i = lane; i < n; i += 32) {
    int k = t * n + i;
    float v = k < K ? load_x(x, x_bf16, base + k) : 0.0f;
    float q = rintf(__fmul_rn(__fdiv_rn(v, ss), lx));
    q = fminf(fmaxf(q, -lx), lx);
    xq[(long)m * Kp + k] = (int8_t)q;
  }
  if (lane == 0) sx[m * T + t] = s;
}

// One thread per (K-tile t, padded column c): scale = bf16(max |w|) over
// the tile's n rows, codes = clamp(rint(w / safe(scale) * lw)) (divide,
// then multiply, as the reference), packed four K rows to an int32 word
// (kcodes layout, lowest row in the lowest byte).  Rows past K and columns
// past N are zero padding: codes 0, scale 0 (the pack stores the raw
// scale; only the division uses 1 in place of 0).
__global__ void abfp_quantize_w(const void* __restrict__ w, int w_bf16,
                                int K, int N, int Np, int n, float lw,
                                int32_t* __restrict__ kcodes,
                                __nv_bfloat16* __restrict__ scales) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= Np) return;
  const bool real = c < N;
  float mx = 0.0f;
  for (int i = 0; i < n; ++i) {
    int k = t * n + i;
    float v = real && k < K ? load_x(w, w_bf16, (long)k * N + c) : 0.0f;
    mx = fmaxf(mx, fabsf(v));
  }
  const __nv_bfloat16 sb = __float2bfloat16_rn(mx);
  const float s = __bfloat162float(sb);
  const float ss = s == 0.0f ? 1.0f : s;
  const int nq = n >> 2;
  for (int q = 0; q < nq; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int k = t * n + 4 * q + b;
      float v = real && k < K ? load_x(w, w_bf16, (long)k * N + c) : 0.0f;
      float code = rintf(__fmul_rn(__fdiv_rn(v, ss), lw));
      code = fminf(fmaxf(code, -lw), lw);
      word |= (uint32_t)(uint8_t)(int8_t)code << (8 * b);
    }
    kcodes[((long)t * nq + q) * Np + c] = (int32_t)word;
  }
  scales[(long)t * Np + c] = sb;
}

struct Segments {
  int start1, start2;      // first column block of segments 1 and 2
  int nj[3];               // column-block count of each segment's own grid
  int seed[3];             // noise seed of each segment
  int nseg;
};

struct Adc {
  float scale;    // f32(adc_code_scale), or f32(adc_base_scale) with gains
  float noise2;   // f32(2 * noise_lsb)
  float ly;       // output levels L_y
  float bin_y;    // f32(n * delta_y)
  int noisy;
  int has_gains;
};

template <int RB>
__global__ void __launch_bounds__(BN)
abfp_tile_terms(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int32_t* __restrict__ kcodes,
                const __nv_bfloat16* __restrict__ scales,
                const float* __restrict__ gains, int M, int Kp, int T, int n,
                int Ntot, int bm, int tk, int nk, Segments seg, Adc adc,
                float* __restrict__ terms) {
  extern __shared__ int32_t sxq[];  // [RB][n / 4] activation code words
  const int jj = blockIdx.x;        // column block in the concatenated layout
  const int t = blockIdx.y;         // global K-tile
  const int m0 = blockIdx.z * RB;
  const int cc = threadIdx.x;       // column within the block
  const int c = jj * BN + cc;
  const int nq = n >> 2;

  for (int w = threadIdx.x; w < RB * nq; w += blockDim.x) {
    int r = w / nq, q = w % nq;
    int m = m0 + r;
    sxq[w] = m < M ? ((const int32_t*)(xq + (long)m * Kp))[t * nq + q] : 0;
  }
  __syncthreads();

  int acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0;
  const int32_t* wp = kcodes + (long)t * nq * Ntot + c;
  for (int q = 0; q < nq; ++q) {
    int32_t w = wp[(long)q * Ntot];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = __dp4a(sxq[r * nq + q], w, acc[r]);
  }

  const int s = seg.nseg > 2 && jj >= seg.start2 ? 2
              : (seg.nseg > 1 && jj >= seg.start1 ? 1 : 0);
  const int j_local = jj - (s == 2 ? seg.start2 : (s == 1 ? seg.start1 : 0));
  const float g = adc.has_gains ? gains[t * seg.nseg + s] : 1.0f;
  const float sw = __bfloat162float(scales[(long)t * Ntot + c]);
  const int kb = t / tk, tt = t % tk;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    int m = m0 + r;
    if (m >= M) break;
    float v = __fmul_rn((float)acc[r], adc.scale);
    if (adc.has_gains) v = __fmul_rn(v, g);
    if (adc.noisy) {
      int i = m / bm, rr = m % bm;
      uint32_t salt = (uint32_t)((i * seg.nj[s] + j_local) * nk + kb);
      float u = hash_uniform((uint32_t)(tt * bm + rr), (uint32_t)cc,
                             (uint32_t)seg.seed[s], salt);
      v = __fadd_rn(v, __fmul_rn(__fsub_rn(u, 0.5f), adc.noise2));
    }
    float yq = __fmul_rn(fminf(fmaxf(rintf(v), -adc.ly), adc.ly), adc.bin_y);
    float term = __fmul_rn(__fmul_rn(yq, sx[m * T + t]), sw);
    if (adc.has_gains) term = __fdiv_rn(term, g);
    terms[((long)t * M + m) * Ntot + c] = term;
  }
}

// Sums the per-tile terms in the reference order: within each reference K
// block of tk tiles first (divided by the scalar gain on the gain-free
// path), then block after block into the f32 accumulator; rounds to bf16.
__global__ void abfp_reduce(const float* __restrict__ terms, int M, int T,
                            int Ntot, int tk, int nk, int has_gains,
                            float gain, __nv_bfloat16* __restrict__ out) {
  long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)M * Ntot) return;
  int m = (int)(idx / Ntot), c = (int)(idx % Ntot);
  float acc = 0.0f;
  for (int kb = 0; kb < nk; ++kb) {
    int t0 = kb * tk;
    if (t0 >= T) break;
    float bs = terms[((long)t0 * M + m) * Ntot + c];
    for (int t = t0 + 1; t < t0 + tk && t < T; ++t)
      bs = __fadd_rn(bs, terms[((long)t * M + m) * Ntot + c]);
    if (!has_gains) bs = __fdiv_rn(bs, gain);
    acc = __fadd_rn(acc, bs);
  }
  out[idx] = __float2bfloat16_rn(acc);
}

}  // namespace

extern "C" int abfp_matmul_packed_launch(
    const void* x, int x_bf16, int M, int K, const void* kcodes,
    const void* scales, const void* gains, int Kp, int T, int n, int Ntot,
    int nseg, int start1, int start2, int nj0, int nj1, int nj2, int seed0,
    int seed1, int seed2, int bm, int tk, int nk, float adc_scale,
    float noise2, int noisy, float ly, float bin_y, float gain, float lx,
    void* xq, void* sx, void* terms, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 != 0 || Ntot % BN != 0 || nseg < 1 || nseg > 3)
    return (int)cudaErrorInvalidValue;
  {
    long warps = (long)M * T;
    int threads = 128;
    long blocks = (warps * 32 + threads - 1) / threads;
    abfp_quantize_x<<<(unsigned)blocks, threads, 0, st>>>(
        x, x_bf16, M, K, Kp, T, n, lx, (int8_t*)xq, (float*)sx);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Segments seg;
  seg.start1 = start1;
  seg.start2 = start2;
  seg.nj[0] = nj0; seg.nj[1] = nj1; seg.nj[2] = nj2;
  seg.seed[0] = seed0; seg.seed[1] = seed1; seg.seed[2] = seed2;
  seg.nseg = nseg;
  Adc adc;
  adc.scale = adc_scale;
  adc.noise2 = noise2;
  adc.ly = ly;
  adc.bin_y = bin_y;
  adc.noisy = noisy;
  adc.has_gains = gains != nullptr;

  const int rb = M <= 8 ? 8 : 32;
  dim3 grid(Ntot / BN, T, (M + rb - 1) / rb);
  size_t smem = (size_t)rb * n;
  if (rb == 8)
    abfp_tile_terms<8><<<grid, BN, smem, st>>>(
        (const int8_t*)xq, (const float*)sx, (const int32_t*)kcodes,
        (const __nv_bfloat16*)scales, (const float*)gains, M, Kp, T, n, Ntot,
        bm, tk, nk, seg, adc, (float*)terms);
  else
    abfp_tile_terms<32><<<grid, BN, smem, st>>>(
        (const int8_t*)xq, (const float*)sx, (const int32_t*)kcodes,
        (const __nv_bfloat16*)scales, (const float*)gains, M, Kp, T, n, Ntot,
        bm, tk, nk, seg, adc, (float*)terms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  long outs = (long)M * Ntot;
  abfp_reduce<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
      (const float*)terms, M, T, Ntot, tk, nk, gains != nullptr, gain,
      (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}

extern "C" int abfp_quantize_w_launch(const void* w, int w_bf16, int K, int N,
                                      int Np, int T, int n, float lw,
                                      void* kcodes, void* scales,
                                      void* stream) {
  if (n % 4 != 0 || Np % BN != 0 || N > Np || (long)T * n < K)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Np / BN, T);
  abfp_quantize_w<<<grid, BN, 0, (cudaStream_t)stream>>>(
      w, w_bf16, K, N, Np, n, lw, (int32_t*)kcodes, (__nv_bfloat16*)scales);
  return (int)cudaGetLastError();
}
