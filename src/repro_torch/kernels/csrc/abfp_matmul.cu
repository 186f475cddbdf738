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
// segment keeps its own noise seed, column-block count and block index,
// so it draws the noise a stand-alone call for that weight draws.  A
// segment may be a column shard of a weight (tensor-parallel serving): it
// then takes the whole weight's block count and its first block's global
// index, and draws the noise the whole weight's call draws for its columns
// (the TPU kernels' col_block_offset / num_col_blocks).
// The seeds are read from device memory (a slice of the pass's seed
// table), never passed by value: a CUDA graph that captured a launch then
// draws the noise of whatever seeds the table holds at each replay.
//
// What bounds it: at decode (M = 4 rows) the int8 codes are read once and
// every code feeds 4 multiply-adds, so the weight stream from device memory
// is the bound; below a few MB per call (every layer weight of the served
// model) a call is bound by its latency instead: the launch and one
// block's serial chain of quantizer, weight copy, dots, epilogue and sum.
// Above decode size (prefill, the evaluation forward) the
// f32 ADC epilogue, once per (row, K-tile, column), sets the pace: the
// integer dots are exact and cheap on int8 tensor cores, and the epilogue's
// murmur-style noise hash is integer work at half the f32 rate.
//
// Design, by route (the wrapper picks it from M, n and the tile count):
//   1. M <= 8 (decode), every tile width: abfp_decode, one launch.  Each
//      block quantizes the activations itself (abfp_quantize_x's
//      operations, with x / s_x through an exact reciprocal test, the
//      division only where a code could differ) while its first two
//      stages of code words stream into shared memory with cp.async; a
//      block owns a 32-column slice for all K-tiles (walking several
//      slices when the grid would pass two blocks per SM: the LM head),
//      its warps take one K-tile each per round, and the per-tile terms
//      stay in shared memory until a thread per (row, column) folds them
//      in the reference's order.  No (T, M, N) term array, no second
//      launch.  See abfp_decode below.
//   2. Every other route starts with abfp_quantize_x: one warp per (row,
//      K-tile) derives the bf16-rounded max-abs activation scale and the
//      8-bit DAC codes once per call (the TPU kernel re-derived them in
//      every grid step).
//   3. M > 8, n a power of two from 32, at most 128 K-tiles: abfp_fused,
//      one launch.  One block per (BM-row block, 128-column block); it
//      walks the K-tiles in order, as the TPU grid's sequential K axis did,
//      so nothing carries between blocks and no per-tile term reaches
//      device memory.  The block's s_x and s_w of every K-tile are loaded
//      into shared memory once; each K-tile's activation codes (BM x n
//      bytes) and code words (n / 4 x 128 int32, the kcodes layout made at
//      pack time) are staged with cp.async, double-buffered, rows padded so
//      that the lanes of a fragment quad hit distinct banks (a thread
//      copies the same chunks of every tile, so its addresses are computed
//      once).  A warp owns 16 rows x 32 columns:
//      the exact integer tile dots run on mma.sync m16n8k32 s8 x s8 -> s32
//      (a kcodes word is exactly one B-fragment register), and the ADC
//      epilogue (scale, gain, hash noise, round half to even, clamp, LSB,
//      rescale) runs on the accumulator fragment in registers, into the
//      reference-order sums: a block sum over the tiles of one reference K
//      block, divided by the scalar gain, then the f32 accumulator; bf16
//      once at the end.  BM (16, 32 or 64 rows) is the wrapper's choice:
//      16 for a weight that stays in L2 across row blocks, 32 for one that
//      does not (the LM head), which halves its re-reads from device memory.
//   4. Otherwise (above M = 8: n = 8 or 16, since m16n8k32 needs whole
//      32-deep k steps; more than 128 K-tiles; a tile dot or ADC level that
//      could reach 2^22; and, for timing only, any call that asks for it):
//      the two-launch route, abfp_tile_terms, one block per (128-column
//      block, K-tile, row block) with a thread per column and __dp4a dots,
//      writes the rescaled per-tile f32 terms; abfp_reduce sums them in
//      the reference's order.
// The noise depends on the reference grid (bm = auto_bm(M), bn = 128,
// bk = default_bk(n, K)), not on this tiling: every coordinate of the
// reference hash (salt, row, column) is recomputed here.
// The epilogue keeps the reference's f32 operation order; build with
// --fmad=false and without fast math (the __f*_rn intrinsics below also
// forbid contraction).  The fused route replaces slow conversions by
// bit-identical arithmetic: the s32 accumulator starts at the bits of
// 1.5 * 2^23, so the dot (|p| < 2^22) becomes an exact f32 by one
// subtraction; round half to even of the clamped ADC value is the add and
// subtraction of 1.5 * 2^23; the hash's / 2^24 is * 2^-24; a division by a
// power-of-two gain is a multiplication by its exact reciprocal (the last
// two in the decode route as well).
//
// Kernel 4 (abfp_matmul_pallas) is the same function on a float W: the TPU
// kernel re-derives the bf16 max-abs weight scales and the DAC codes of
// every (K-tile, column) in every grid step.  Here one launch,
// abfp_quantize_w, does that once per call and writes the codes straight
// into kernel 1's kcodes word layout and the bf16 scales into scratch;
// then kernel 1's launches run on it with the scalar gain and no per-tile
// gains.  So kernel 4 equals kernel 1 on pack_abfp_weight(W) bit for bit
// by construction.  What bounds it: reading W once (bf16 at full width)
// adds K x N x 2 bytes to kernel 1's traffic; at the evaluation shape
// (M = 2,048 rows) the f32 ADC epilogue dominates, as in kernel 1 at
// prefill.  The quantizer gives each (K-tile, 32-column group) a block of
// eight warps: a warp's 32 lanes read 32 neighbouring columns, the eight
// warps split the tile's rows and meet in a shared-memory max.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int BN = 128;  // output columns per block (the reference bn)

// The reference's lattice hash minus 0.5: u = (x >> 8) / 2^24 is exact, so
// one fma gives the reference's f32 u - 0.5 bit for bit (the fused route
// computes the same inline).
__device__ __forceinline__ float hash_u05(uint32_t r, uint32_t c,
                                          uint32_t seed, uint32_t salt) {
  uint32_t x = r * 0x9E3779B9u + c * 0x85EBCA6Bu + seed * 0xC2B2AE35u +
               salt * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return __fmaf_rn((float)(x >> 8), 0x1p-24f, -0.5f);
}

__device__ __forceinline__ float load_x(const void* x, int x_bf16, long i) {
  return x_bf16 ? __bfloat162float(((const __nv_bfloat16*)x)[i])
                : ((const float*)x)[i];
}

// True when g is a power of two whose reciprocal is a normal float: then
// t / g and t * (1 / g) are both the correctly rounded t * 2^-e.
__host__ __device__ __forceinline__ bool exact_reciprocal(uint32_t bits) {
  const uint32_t e = (bits >> 23) & 0xFFu;
  return (bits & 0x7FFFFFu) == 0 && e >= 1 && e <= 253;
}

// The activation quantizer's arithmetic, shared by every route: scale =
// bf16(max |x|) over the tile (1 in place of 0 for the division), code =
// clamp(rint(x / scale * lx)) (divide, then multiply, as the reference).
__device__ __forceinline__ float x_scale(float mx) {
  return __bfloat162float(__float2bfloat16_rn(mx));
}

__device__ __forceinline__ int8_t x_code(float e, float ss, float lx) {
  float q = rintf(__fmul_rn(__fdiv_rn(e, ss), lx));
  return (int8_t)fminf(fmaxf(q, -lx), lx);
}

// x_code without a division per element, bit for bit: rs = RN(1 / ss),
// computed once per tile.  With |e / ss| <= 1.004 (ss is max |x| rounded
// to bf16), RN(RN(e * rs) * lx) differs from the reference's RN(RN(e / ss)
// * lx) by at most 5 * 2^-24 * lx * 1.004 < 4e-5 (lx <= 127), so both
// round to the same integer unless the scaled value lies within 2^-13 of a
// half-integer (or is not below 256, or the scale lies outside [2^-100,
// 2^100], where the reciprocal may lose bits).  Returns false there: the
// caller then redoes the code with x_code's division.
__device__ __forceinline__ bool x_code_rcp(float e, float rs, bool rs_ok,
                                           float lx, int8_t& code) {
  const float ta = __fmul_rn(__fmul_rn(e, rs), lx);
  const float tie = fabsf(__fsub_rn(__fsub_rn(ta, floorf(ta)), 0.5f));
  code = (int8_t)fminf(fmaxf(rintf(ta), -lx), lx);
  return rs_ok && fabsf(ta) < 256.0f && tie > 0x1p-13f;
}

// One warp per (row m, tile t): scale = bf16(max |x|), codes = clamp(
// rint(x / scale * lx)).  Elements past K (zero padding) quantize to 0.  A
// lane keeps its first QX_CACHE elements in registers between the max and
// the codes (all of them for n <= 32 * QX_CACHE).
constexpr int QX_CACHE = 4;

__global__ void abfp_quantize_x(const void* __restrict__ x, int x_bf16, int M,
                                int K, int Kp, int T, int n, float lx,
                                int8_t* __restrict__ xq,
                                float* __restrict__ sx) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= M * T) return;
  int m = warp / T, t = warp % T;
  long base = (long)m * K;
  auto elem = [&](int i) {
    const int k = t * n + i;
    return i < n && k < K ? load_x(x, x_bf16, base + k) : 0.0f;
  };
  auto store = [&](int i, float e, float ss) {
    if (i < n) xq[(long)m * Kp + t * n + i] = x_code(e, ss, lx);
  };
  float v[QX_CACHE];
  float mx = 0.0f;
#pragma unroll
  for (int c = 0; c < QX_CACHE; ++c) {
    v[c] = elem(lane + 32 * c);
    mx = fmaxf(mx, fabsf(v[c]));
  }
  for (int i = lane + 32 * QX_CACHE; i < n; i += 32)
    mx = fmaxf(mx, fabsf(elem(i)));
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float s = x_scale(mx);
  const float ss = s == 0.0f ? 1.0f : s;
#pragma unroll
  for (int c = 0; c < QX_CACHE; ++c) store(lane + 32 * c, v[c], ss);
  for (int i = lane + 32 * QX_CACHE; i < n; i += 32) store(i, elem(i), ss);
  if (lane == 0) sx[m * T + t] = s;
}

// Block (32 columns, QW_GROUPS row groups) per (32-column group, K-tile t):
// lane x owns column c, warp y the tile's code words y, y + QW_GROUPS, ...
// (the first QW_CACHE of them held in registers between the two passes).
// scale = bf16(max |w|) over the tile's n rows (a shared-memory max across
// the warps), codes = clamp(rint(w / safe(scale) * lw)) (divide, then
// multiply, as the reference), packed four K rows to an int32 word (kcodes
// layout, lowest row in the lowest byte).  Rows past K and columns past N
// are zero padding: codes 0, scale 0 (the pack stores the raw scale; only
// the division uses 1 in place of 0).
constexpr int QW_COLS = 32;
constexpr int QW_GROUPS = 8;
constexpr int QW_CACHE = 4;

__global__ void __launch_bounds__(QW_COLS * QW_GROUPS)
abfp_quantize_w(const void* __restrict__ w, int w_bf16, int K, int N, int Np,
                int n, float lw, int32_t* __restrict__ kcodes,
                __nv_bfloat16* __restrict__ scales) {
  __shared__ float part[QW_GROUPS][QW_COLS];
  const int c = blockIdx.x * QW_COLS + threadIdx.x;
  const int t = blockIdx.y;
  const bool real = c < N;
  const int nq = n >> 2;
  auto word_values = [&](int q, float (&e)[4]) {   // zeros past the tile
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int k = t * n + 4 * q + b;
      e[b] = real && q < nq && k < K ? load_x(w, w_bf16, (long)k * N + c)
                                     : 0.0f;
    }
  };
  auto store = [&](int q, const float (&e)[4], float ss) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float code = rintf(__fmul_rn(__fdiv_rn(e[b], ss), lw));
      code = fminf(fmaxf(code, -lw), lw);
      word |= (uint32_t)(uint8_t)(int8_t)code << (8 * b);
    }
    kcodes[((long)t * nq + q) * Np + c] = (int32_t)word;
  };
  float v[QW_CACHE][4];
  float mx = 0.0f;
#pragma unroll
  for (int i = 0; i < QW_CACHE; ++i) {
    const int q = threadIdx.y + QW_GROUPS * i;
    word_values(q, v[i]);
#pragma unroll
    for (int b = 0; b < 4; ++b) mx = fmaxf(mx, fabsf(v[i][b]));
  }
  for (int q = threadIdx.y + QW_GROUPS * QW_CACHE; q < nq; q += QW_GROUPS) {
    float e[4];
    word_values(q, e);
#pragma unroll
    for (int b = 0; b < 4; ++b) mx = fmaxf(mx, fabsf(e[b]));
  }
  part[threadIdx.y][threadIdx.x] = mx;
  __syncthreads();
#pragma unroll
  for (int y = 0; y < QW_GROUPS; ++y) mx = fmaxf(mx, part[y][threadIdx.x]);
  const __nv_bfloat16 sb = __float2bfloat16_rn(mx);
  const float s = __bfloat162float(sb);
  const float ss = s == 0.0f ? 1.0f : s;
#pragma unroll
  for (int i = 0; i < QW_CACHE; ++i) {
    const int q = threadIdx.y + QW_GROUPS * i;
    if (q < nq) store(q, v[i], ss);
  }
  for (int q = threadIdx.y + QW_GROUPS * QW_CACHE; q < nq; q += QW_GROUPS) {
    float e[4];
    word_values(q, e);
    store(q, e, ss);
  }
  if (threadIdx.y == 0) scales[(long)t * Np + c] = sb;
}

struct Segments {
  int start1, start2;      // first column block of segments 1 and 2
  int nj[3];               // column-block count of each segment's global
                           // grid (the whole weight's, for a column shard)
  int off[3];              // global index of each segment's first column
                           // block (0 unless the segment is a column shard)
  const int* seeds;        // noise seed of each segment, in device
                           // memory (read only when adc.noisy)
  int nseg;
};

struct Adc {
  float scale;    // f32(adc_code_scale), or f32(adc_base_scale) with gains
  float noise2;   // f32(2 * noise_lsb)
  float ly;       // output levels L_y
  float bin_y;    // f32(n * delta_y)
  float gain;     // f32(gain), the scalar gain of the gain-free path
  float inv_gain; // 1 / gain when exact (gain_pow2)
  int noisy;
  int has_gains;
  int gain_pow2;  // gain is a power of two with a normal reciprocal
};

// Segment s's noise seed (0 without noise, where `seeds` may be null).
__device__ __forceinline__ uint32_t seed_of(const Segments& seg,
                                            const Adc& adc, int s) {
  return adc.noisy ? (uint32_t)__ldg(seg.seeds + s) : 0u;
}

__device__ __forceinline__ void segment_of(const Segments& seg, int jj,
                                           int& s, int& j_local) {
  s = seg.nseg > 2 && jj >= seg.start2 ? 2
    : (seg.nseg > 1 && jj >= seg.start1 ? 1 : 0);
  j_local = jj - (s == 2 ? seg.start2 : (s == 1 ? seg.start1 : 0));
}

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

  int s, j_local;
  segment_of(seg, jj, s, j_local);
  const float g = adc.has_gains ? gains[t * seg.nseg + s] : 1.0f;
  const uint32_t seed = seed_of(seg, adc, s);
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
      uint32_t salt =
          (uint32_t)((i * seg.nj[s] + seg.off[s] + j_local) * nk + kb);
      v = __fadd_rn(v, __fmul_rn(hash_u05((uint32_t)(tt * bm + rr),
                                          (uint32_t)cc, seed, salt),
                                 adc.noise2));
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

// ---------------------------------------------------------------------------
// The decode route (M <= 8): one weight-streaming launch
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 4- or 8-byte copy (cached in L1 on its way: scales and gains).
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES)
               : "memory");
}

constexpr int DEC_ROWS = 8;      // the route's `rows` value: M <= 8
constexpr int DEC_COLS = 32;     // columns per slice: 128 bytes of code words
constexpr int DEC_WARPS = 8;     // warp w takes K-tiles w, w + 8, w + 16, ...
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_LOADS = 8;     // 16-byte code chunks per lane per stage
constexpr int DEC_QX_LANES = 8;  // lanes per (row, K-tile) in the quantizer
constexpr int DEC_QX_CACHE = 16; // elements a quantizer lane keeps (n <= 128)
constexpr int DEC_BLOCKS_PER_SM = 2;

// Shared memory of one block: the activation codes (M x Kp bytes), the
// scales s_x (M x T), two rounds of per-tile terms (DEC_WARPS tiles x M
// rows x DEC_COLS columns, f32), and two stages of each thread's own code
// chunks, column scales and tile gain.
struct DecodeSmem {
  int sx, terms, w, sc, g, total;
  __host__ __device__ DecodeSmem(int M, int Kp, int T) {
    sx = (M * Kp + 15) / 16 * 16;
    terms = (sx + M * T * 4 + 15) / 16 * 16;
    w = terms + 2 * DEC_WARPS * M * DEC_COLS * 4;
    sc = w + 2 * DEC_LOADS * DEC_THREADS * 16;
    g = sc + 2 * DEC_THREADS * 8;
    total = g + 2 * DEC_THREADS * 4;
  }
};

// The bf16 value in the low 16 bits of v.
__device__ __forceinline__ float bf16_bits(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)v));
}

// A block walks 32-column slices blockIdx.x, blockIdx.x + gridDim.x, ...
// of the (concatenated) weight, each for all K-tiles; MR = M live rows.
// Lane (gq, ch) of warp w takes, for K-tile t = w, w + 8, ..., code-word
// rows q = gq, gq + 4, ... as 16-byte chunks: the words of columns 4 ch ..
// 4 ch + 3, so the eight lanes of a row group read one 128-byte line.  A
// stage is DEC_LOADS such chunks (a whole tile for n <= 128) with the
// tile's column scales and gain; each thread copies its own stages into
// shared memory with cp.async, two stages ahead, and reads them back
// itself, so the weight stream runs under the activation quantizer and
// under the previous stage's arithmetic.  The exact dots (__dp4a, M rows x
// 4 columns) are summed over the four row groups with shuffles; row group
// gq then runs the ADC epilogue (abfp_tile_terms' f32 order) for rows gq
// and gq + 4 and leaves the tile's terms in shared memory.  After each
// round of DEC_WARPS tiles, a thread per (row, column) folds them into the
// reference-order sums in tile order: block sums over the tk tiles of a
// reference K block, / gain on the gain-free path, then the f32
// accumulator; bf16 at the end of the slice.  A call is bound by this
// serial chain, not by its bytes, so nothing is unrolled over rows but the
// dots (code that runs once per block), and no integer division by a
// runtime value (a serial chain of conversions and a reciprocal) runs
// after the start.
template <int MR>
__global__ void __launch_bounds__(DEC_THREADS)
abfp_decode(const void* __restrict__ x, int x_bf16, int K, int Kp, int T,
            int n, float lx, const int32_t* __restrict__ kcodes,
            const __nv_bfloat16* __restrict__ scales,
            const float* __restrict__ gains, int Ntot, int bm, int tk, int nk,
            Segments seg, Adc adc, __nv_bfloat16* __restrict__ out) {
  constexpr int M = MR;
  extern __shared__ __align__(128) unsigned char smem[];
  const DecodeSmem L(M, Kp, T);
  int8_t* xs = (int8_t*)smem;                  // [M][Kp]
  float* sxs = (float*)(smem + L.sx);          // [M][T]
  float* terms = (float*)(smem + L.terms);     // [2][DEC_WARPS][M][DEC_COLS]
  uint4* wb = (uint4*)(smem + L.w);            // [2][DEC_LOADS][DEC_THREADS]
  uint2* sb = (uint2*)(smem + L.sc);           // [2][DEC_THREADS]
  float* gb = (float*)(smem + L.g);            // [2][DEC_THREADS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 3, ch = lane & 7;
  const int nq = n >> 2;
  const int kq = Kp >> 2;                      // code words per x row
  const int nslices = Ntot / DEC_COLS;
  // Stages of DEC_LOADS word rows per tile (one for n <= 128); a lane with
  // no word row (n < 16) still copies the tile's scales and gain.
  const int batches = nq > gq ? ((nq - 1 - gq) >> 2) / DEC_LOADS + 1 : 1;
  const int my_tiles = warp < T ? (T - 1 - warp) / DEC_WARPS + 1 : 0;
  const int my_slices =
      (int)blockIdx.x < nslices
          ? (nslices - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  const int per_slice = my_tiles * batches;
  const int stages = per_slice * my_slices;

  // The thread's next stage to copy, k, is batch ib of tile it of slice
  // column ic (a cursor, so that no integer division runs between stages).
  // Stage k goes into buffer k & 1; one commit group per stage, empty past
  // the last.
  int ik = 0, ib = 0, it = warp;
  int ic = (int)blockIdx.x * DEC_COLS + 4 * ch;
  auto issue = [&]() {
    if (ik < stages) {
      const int t = it, b = ib, c = ic;
      const int buf = ik & 1;
#pragma unroll
      for (int i = 0; i < DEC_LOADS; ++i) {
        const int q = gq + 4 * (b * DEC_LOADS + i);
        if (q < nq)
          cp_async16(wb + (buf * DEC_LOADS + i) * DEC_THREADS + tid,
                     kcodes + (long)(t * nq + q) * Ntot + c);
      }
      if (b == 0) {
        cp_async_small<8>(sb + buf * DEC_THREADS + tid,
                          scales + (long)t * Ntot + c);
        if (adc.has_gains) {
          int sg, jl;
          segment_of(seg, c / BN, sg, jl);
          cp_async_small<4>(gb + buf * DEC_THREADS + tid,
                            gains + t * seg.nseg + sg);
        }
      }
      if (++ib == batches) {
        ib = 0;
        it += DEC_WARPS;
        if (it >= T) {
          it = warp;
          ic += (int)gridDim.x * DEC_COLS;
        }
      }
    }
    ++ik;
    cp_async_commit();
  };
  issue();
  issue();

  // The activation quantizer, abfp_quantize_x's operations: eight lanes per
  // (row, K-tile), four of them per warp in one pass; a lane takes the
  // tile's elements sub, sub + 8, ... (the first DEC_QX_CACHE kept in
  // registers between the max and the codes).
  {
    const int sub = lane & (DEC_QX_LANES - 1), slot = lane / DEC_QX_LANES;
    constexpr int PER_WARP = 32 / DEC_QX_LANES;
    constexpr int STRIDE = DEC_WARPS * PER_WARP;
    const int p_first = warp * PER_WARP + slot;
    int m = p_first / T, t = p_first % T;      // this lane's (row, K-tile)
#pragma unroll 1
    for (int p0 = warp * PER_WARP; p0 < M * T; p0 += STRIDE) {
      const bool live = m < M;
      const long base = (long)m * K + t * n;
      const int kmax = live ? min(n, K - t * n) : 0;   // elements in the tile
      float v[DEC_QX_CACHE];
      if (x_bf16) {
        const __nv_bfloat16* xb = (const __nv_bfloat16*)x + base;
#pragma unroll
        for (int e = 0; e < DEC_QX_CACHE; ++e) {
          const int i = sub + DEC_QX_LANES * e;
          v[e] = i < kmax ? __bfloat162float(xb[i]) : 0.0f;
        }
      } else {
        const float* xf = (const float*)x + base;
#pragma unroll
        for (int e = 0; e < DEC_QX_CACHE; ++e) {
          const int i = sub + DEC_QX_LANES * e;
          v[e] = i < kmax ? xf[i] : 0.0f;
        }
      }
      float mx = 0.0f;
#pragma unroll
      for (int e = 0; e < DEC_QX_CACHE; ++e) mx = fmaxf(mx, fabsf(v[e]));
#pragma unroll 1
      for (int i = sub + DEC_QX_LANES * DEC_QX_CACHE; i < kmax;
           i += DEC_QX_LANES)
        mx = fmaxf(mx, fabsf(load_x(x, x_bf16, base + i)));
#pragma unroll
      for (int o = 1; o < DEC_QX_LANES; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float sc = x_scale(mx);
      const float ss = sc == 0.0f ? 1.0f : sc;
      const float rs = __frcp_rn(ss);
      const bool rs_ok = ss >= 0x1p-100f && ss <= 0x1p100f;
      if (live) {
        int8_t* row = xs + m * Kp + t * n;
        uint32_t redo = 0;          // elements whose code needs the division
#pragma unroll
        for (int e = 0; e < DEC_QX_CACHE; ++e) {
          const int i = sub + DEC_QX_LANES * e;
          int8_t code;
          if (!x_code_rcp(v[e], rs, rs_ok, lx, code)) redo |= 1u << e;
          if (i < n) row[i] = code;
        }
#pragma unroll 1
        for (; redo; redo &= redo - 1) {
          const int i = sub + DEC_QX_LANES * (__ffs(redo) - 1);
          if (i < n)
            row[i] = x_code(i < kmax ? load_x(x, x_bf16, base + i) : 0.0f,
                            ss, lx);
        }
#pragma unroll 1
        for (int i = sub + DEC_QX_LANES * DEC_QX_CACHE; i < n;
             i += DEC_QX_LANES)
          row[i] = x_code(i < kmax ? load_x(x, x_bf16, base + i) : 0.0f, ss,
                          lx);
        if (sub == 0) sxs[m * T + t] = sc;
      }
      for (t += STRIDE; t >= T; t -= T) ++m;
    }
  }
  __syncthreads();

  const int32_t* xw = (const int32_t*)xs;
  const int fm = tid / DEC_COLS, fc = tid % DEC_COLS;
  const int kb0 = warp / tk, tt0 = warp % tk;  // K block of tile `warp`
  const int rounds = (T + DEC_WARPS - 1) / DEC_WARPS;
  int k = 0, parity = 0;
#pragma unroll 1
  for (int si = 0; si < my_slices; ++si) {
    const int c0 = ((int)blockIdx.x + si * (int)gridDim.x) * DEC_COLS;
    int s, j_local;
    segment_of(seg, c0 / BN, s, j_local);
    const uint32_t seed = seed_of(seg, adc, s);
    // The salt of row block 0 and K block 0 (bm = 8 >= M: every row is in
    // row block 0, hash row tt * 8 + m), at the slice's global block.
    const uint32_t salt0 = (uint32_t)(seg.off[s] + j_local) * (uint32_t)nk;
    const int cb = c0 % BN + 4 * ch;           // hash column of column 0
    float bsum = -0.0f, acc = 0.0f;            // the fold thread's sums
    int kb = kb0, tt = tt0;                    // warp's tile t = kb tk + tt
    int f_tt = 0;                              // fold: tile within K block
#pragma unroll 1
    for (int r = 0; r < rounds; ++r, parity ^= 1) {
      const int t = r * DEC_WARPS + warp;
      float* tb = terms + parity * (DEC_WARPS * M * DEC_COLS);
      if (t < T) {
        int dot[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[m][j] = 0;
        uint2 sw = make_uint2(0, 0);
        float g = 1.0f;
#pragma unroll 1
        for (int b = 0; b < batches; ++b, ++k) {
          cp_async_wait<1>();                  // stage k has landed
          const int buf = k & 1;
          if (b == 0) {
            sw = sb[buf * DEC_THREADS + tid];
            if (adc.has_gains) g = gb[buf * DEC_THREADS + tid];
          }
#pragma unroll
          for (int i = 0; i < DEC_LOADS; ++i) {
            const int q = gq + 4 * (b * DEC_LOADS + i);
            if (q < nq) {
              const uint4 wv = wb[(buf * DEC_LOADS + i) * DEC_THREADS + tid];
#pragma unroll
              for (int m = 0; m < M; ++m) {
                const int a = xw[m * kq + t * nq + q];
                dot[m][0] = __dp4a(a, (int)wv.x, dot[m][0]);
                dot[m][1] = __dp4a(a, (int)wv.y, dot[m][1]);
                dot[m][2] = __dp4a(a, (int)wv.z, dot[m][2]);
                dot[m][3] = __dp4a(a, (int)wv.w, dot[m][3]);
              }
            }
          }
          issue();            // stage k + 2, into the buffer just read
        }
        // Sum over the four row groups; row group gq keeps rows gq, gq + 4.
        int mine[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int d = dot[m][j];
            d += __shfl_xor_sync(0xffffffffu, d, 8);
            d += __shfl_xor_sync(0xffffffffu, d, 16);
            if ((m & 3) == gq) mine[m >> 2][j] = d;
          }

        // The ADC epilogue of rows gq and gq + 4 (abfp_tile_terms' order;
        // / g is * (1 / g) where that is exact).
        const bool g_exact = exact_reciprocal(__float_as_uint(g));
        const float g_inv = g_exact ? 1.0f / g : 1.0f;
        const float swf[4] = {bf16_bits(sw.x), bf16_bits(sw.x >> 16),
                              bf16_bits(sw.y), bf16_bits(sw.y >> 16)};
#pragma unroll 1
        for (int h = 0; h < 2; ++h) {
          const int m = gq + 4 * h;
          if (m >= M) break;
          const uint32_t salt = salt0 + (uint32_t)kb;
          const uint32_t hr = (uint32_t)tt * (uint32_t)bm + (uint32_t)m;
          const float sxm = sxs[m * T + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int dj = h ? mine[1][j] : mine[0][j];
            float v = __fmul_rn((float)dj, adc.scale);
            if (adc.has_gains) v = __fmul_rn(v, g);
            if (adc.noisy)
              v = __fadd_rn(v, __fmul_rn(hash_u05(hr, (uint32_t)(cb + j),
                                                  seed, salt),
                                         adc.noise2));
            const float yq = __fmul_rn(fminf(fmaxf(rintf(v), -adc.ly), adc.ly),
                                       adc.bin_y);
            float term = __fmul_rn(__fmul_rn(yq, sxm), swf[j]);
            if (adc.has_gains)
              term = g_exact ? __fmul_rn(term, g_inv) : __fdiv_rn(term, g);
            tb[(warp * M + m) * DEC_COLS + 4 * ch + j] = term;
          }
        }
      }
      for (tt += DEC_WARPS; tt >= tk; tt -= tk) ++kb;
      __syncthreads();
      // Fold this round's tiles into the sums, in tile order.
      if (fm < M) {
#pragma unroll 1
        for (int wi = 0; wi < DEC_WARPS; ++wi) {
          const int tf = r * DEC_WARPS + wi;
          if (tf >= T) break;
          bsum = __fadd_rn(bsum, tb[(wi * M + fm) * DEC_COLS + fc]);
          if (++f_tt == tk || tf == T - 1) {
            f_tt = 0;
            if (!adc.has_gains)
              bsum = adc.gain_pow2 ? __fmul_rn(bsum, adc.inv_gain)
                                   : __fdiv_rn(bsum, adc.gain);
            acc = __fadd_rn(acc, bsum);
            bsum = -0.0f;
          }
        }
      }
    }
    if (fm < M) out[(long)fm * Ntot + c0 + fc] = __float2bfloat16_rn(acc);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// The fused route (M > 8): int8 tensor-core tile dots, ADC in registers
// ---------------------------------------------------------------------------

constexpr int MAGIC_BITS = 0x4B400000;   // 1.5 * 2^23 as f32 bits
constexpr float MAGIC = 12582912.0f;     // 1.5 * 2^23
constexpr int FUSED_STAGES = 2;          // K-tiles in flight
constexpr int FUSED_BROW = BN * 4 + 32;  // padded code-word row (bytes)

// d = a . b + c on one m16n8k32 tile, s8 x s8 -> s32 (exact).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1,
                                       const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

// The ADC on one K-tile's fragment (dot[j][e]: subtile j, element e; rows
// h = e / 2, columns col0 + 8 j + (e & 1)) in the reference's f32 order,
// into the block sums.  A block sum starts at -0, so its first addition
// returns the first term exactly, as the reference's sum that starts from
// the first term.  GDIV: a per-tile gain that is not a power of two, so the
// rescale divides.
template <bool NOISY, bool GAINS, bool GDIV>
__device__ __forceinline__ void adc_tile(
    const int (&dot)[4][4], float (&bsum)[4][4], const Adc& adc, float gt,
    float gt_inv, const float (&sxr)[2], const float2 (&sw)[4],
    const uint32_t (&hrow)[2], uint32_t col0) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float v = __fmul_rn(__fsub_rn(__int_as_float(dot[j][e]), MAGIC),
                          adc.scale);
      if (GAINS) v = __fmul_rn(v, gt);
      if (NOISY) {
        uint32_t x = hrow[h] + (col0 + 8 * j + (e & 1)) * 0x85EBCA6Bu;
        x ^= x >> 16;
        x *= 0x85EBCA6Bu;
        x ^= x >> 13;
        x *= 0xC2B2AE35u;
        x ^= x >> 16;
        const float u05 = __fmaf_rn((float)(x >> 8), 0x1p-24f, -0.5f);
        v = __fadd_rn(v, __fmul_rn(u05, adc.noise2));
      }
      const float c = fminf(fmaxf(v, -adc.ly), adc.ly);
      const float yq = __fmul_rn(__fsub_rn(__fadd_rn(c, MAGIC), MAGIC),
                                 adc.bin_y);
      float term =
          __fmul_rn(__fmul_rn(yq, sxr[h]), (e & 1) ? sw[j].y : sw[j].x);
      if (GAINS) term = GDIV ? __fdiv_rn(term, gt) : __fmul_rn(term, gt_inv);
      bsum[j][e] = __fadd_rn(bsum[j][e], term);
    }
}

// Shared memory of one block: the staged K-tiles, then the block's s_x
// (BM rows x T tiles), s_w (T tiles x 128 columns, bf16) and per-tile gains
// (T).  Rows are padded so that the lanes of a fragment quad read distinct
// banks.
struct FusedSmem {
  int a_row, a_stage, b_stage, stage, sx, sw, gains, total;
  __host__ __device__ FusedSmem(int bm_rows, int n, int T) {
    a_row = n + 16;                       // padded activation row (bytes)
    a_stage = bm_rows * a_row;
    b_stage = (n / 4) * FUSED_BROW;
    stage = a_stage + b_stage;
    sx = FUSED_STAGES * stage;
    sw = sx + bm_rows * T * 4;
    gains = sw + T * BN * 2;
    total = gains + T * 4;
  }
};

// One block per (BM-row block, 128-column block jj); warps (wr, wc) own
// rows wr * 16 .. + 15 and columns wc * 32 .. + 31 of it.  A thread holds,
// per 8-column subtile j, the fragment elements e = 0..3: row g (e < 2) or
// g + 8, column 2 * tig + (e & 1).  The K-tiles are staged with cp.async,
// FUSED_STAGES - 1 tiles ahead; a thread copies the same 16-byte chunks of
// every tile.  xq has at least ceil(M / BM) * BM rows (the rows past M are
// never stored).  n is a power of two from 32 to 256.
template <int WR, bool NOISY, bool GAINS>
__global__ void __launch_bounds__(128 * WR)
abfp_fused(const int8_t* __restrict__ xq, const float* __restrict__ sx,
           const int32_t* __restrict__ kcodes,
           const __nv_bfloat16* __restrict__ scales,
           const float* __restrict__ gains, int M, int Kp, int T, int n,
           int Ntot, int bm, int tk, int nk, Segments seg, Adc adc,
           __nv_bfloat16* __restrict__ out) {
  constexpr int BM = 16 * WR;
  constexpr int THREADS = 128 * WR;
  extern __shared__ __align__(128) unsigned char smem[];
  const FusedSmem L(BM, n, T);
  const int nq = n >> 2;                 // code words per tile row
  const int jj = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = (warp >> 2) * 16;       // warp's first row in the block
  const int cw = (warp & 3) * 32;        // warp's first column in the block
  const bool warp_live = m0 + r0 < M;    // rows past M need no epilogue

  int s, j_local;
  segment_of(seg, jj, s, j_local);

  // This thread's 16-byte chunks of every tile: activation rows ar,
  // ar + ar_step, ..., chunk ac; code-word rows warp, warp + THREADS / 32,
  // ..., chunk `lane`.
  const int ach = n >> 4;
  const int ar = threadIdx.x / ach, ac = threadIdx.x % ach;
  const int ar_step = THREADS / ach;
  const int8_t* a_src = xq + (long)(m0 + ar) * Kp + ac * 16;
  const int32_t* b_src = kcodes + (long)warp * Ntot + jj * BN + lane * 4;
  auto load = [&](int buf, int t) {
    unsigned char* st = smem + buf * L.stage;
    for (int r = ar; r < BM; r += ar_step)
      cp_async16(st + r * L.a_row + ac * 16,
                 a_src + (long)(r - ar) * Kp + t * n);
    for (int q = warp; q < nq; q += THREADS / 32)
      cp_async16(st + L.a_stage + q * FUSED_BROW + lane * 16,
                 b_src + (long)(t * nq + q - warp) * Ntot);
  };

  for (int p = 0; p < FUSED_STAGES - 1; ++p) {
    if (p < T) load(p, p);
    cp_async_commit();
  }

  // The block's s_x, s_w and gains for every K-tile, once.
  float* sxs = (float*)(smem + L.sx);
  __nv_bfloat16* sws = (__nv_bfloat16*)(smem + L.sw);
  float* gs = (float*)(smem + L.gains);
  for (int i = threadIdx.x; i < BM * T; i += THREADS) {
    const long k = (long)m0 * T + i;
    sxs[i] = k < (long)M * T ? sx[k] : 0.0f;
  }
  for (int i = threadIdx.x; i < T * (BN / 2); i += THREADS) {
    const int t = i / (BN / 2), c2 = i % (BN / 2);
    ((__nv_bfloat162*)sws)[i] =
        ((const __nv_bfloat162*)(scales + (long)t * Ntot + jj * BN))[c2];
  }
  if (GAINS)
    for (int t = threadIdx.x; t < T; t += THREADS)
      gs[t] = gains[t * seg.nseg + s];

  // Per-row parts of the reference hash (row, seed and salt terms) that do
  // not change with the K-tile: hash row tt * bm + rr, salt
  // (i * nj + off + j_local) * nk + kb.
  const int m_row[2] = {m0 + r0 + g, m0 + r0 + g + 8};
  const uint32_t seed = seed_of(seg, adc, s);
  uint32_t hbase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t i = (uint32_t)(m_row[h] / bm);
    const uint32_t rr = (uint32_t)(m_row[h] % bm);
    hbase[h] = rr * 0x9E3779B9u + seed * 0xC2B2AE35u +
               (i * (uint32_t)seg.nj[s] + (uint32_t)(seg.off[s] + j_local)) *
                   (uint32_t)nk *
                   0x27D4EB2Fu;
  }
  int magic[4] = {MAGIC_BITS, MAGIC_BITS, MAGIC_BITS, MAGIC_BITS};

  float bsum[4][4], acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bsum[j][e] = -0.0f;
      acc[j][e] = 0.0f;
    }

  int kb = 0, tt = 0;                    // reference K block, tile in it
  for (int t = 0; t < T; ++t) {
    const int buf = t % FUSED_STAGES;
    cp_async_wait<FUSED_STAGES - 2>();
    // Tile t has landed for every thread, every warp is done with the
    // buffer that tile t + STAGES - 1 refills, and the s_x / s_w / gain
    // loads above are visible.
    __syncthreads();
    if (t + FUSED_STAGES - 1 < T)
      load((t + FUSED_STAGES - 1) % FUSED_STAGES, t + FUSED_STAGES - 1);
    cp_async_commit();

    if (warp_live) {
      const unsigned char* st = smem + buf * L.stage;
      const uint32_t* as_ = (const uint32_t*)st;
      const uint32_t* bs_ = (const uint32_t*)(st + L.a_stage);
      const int as = L.a_row / 4, bstr = FUSED_BROW / 4;
      // k step kk (8 code words): the first one starts every accumulator
      // at the bits of 1.5 * 2^23.
      int dot[4][4];
      auto k_step = [&](int kk, bool first) {
        uint32_t a[4];
        a[0] = as_[(r0 + g) * as + kk + tig];
        a[1] = as_[(r0 + g + 8) * as + kk + tig];
        a[2] = as_[(r0 + g) * as + kk + 4 + tig];
        a[3] = as_[(r0 + g + 8) * as + kk + 4 + tig];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = cw + j * 8 + g;
          mma_s8(dot[j], a, bs_[(kk + tig) * bstr + col],
                 bs_[(kk + 4 + tig) * bstr + col], first ? magic : dot[j]);
        }
      };
      k_step(0, true);
      for (int kk = 8; kk < nq; kk += 8) k_step(kk, false);

      const float sxr[2] = {sxs[(r0 + g) * T + t],
                            sxs[(r0 + g + 8) * T + t]};
      float2 sw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sw[j] = __bfloat1622float2(
            ((const __nv_bfloat162*)(sws + t * BN))[(cw + j * 8) / 2 + tig]);
      uint32_t hrow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hrow[h] = hbase[h] + (uint32_t)(tt * bm) * 0x9E3779B9u +
                  (uint32_t)kb * 0x27D4EB2Fu;
      const uint32_t col0 = (uint32_t)(cw + 2 * tig);
      if (GAINS) {
        const float gt = gs[t];
        if (exact_reciprocal(__float_as_uint(gt)))
          adc_tile<NOISY, true, false>(dot, bsum, adc, gt, 1.0f / gt, sxr,
                                       sw, hrow, col0);
        else
          adc_tile<NOISY, true, true>(dot, bsum, adc, gt, 1.0f, sxr, sw,
                                      hrow, col0);
      } else {
        adc_tile<NOISY, false, false>(dot, bsum, adc, 1.0f, 1.0f, sxr, sw,
                                      hrow, col0);
      }
      if (tt == tk - 1 || t == T - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float b = bsum[j][e];
            if (!GAINS)
              b = adc.gain_pow2 ? __fmul_rn(b, adc.inv_gain)
                                : __fdiv_rn(b, adc.gain);
            acc[j][e] = __fadd_rn(acc[j][e], b);
            bsum[j][e] = -0.0f;
          }
      }
    }
    if (++tt == tk) {
      tt = 0;
      ++kb;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (m_row[h] >= M) continue;
    __nv_bfloat16* o = out + (long)m_row[h] * Ntot + jj * BN + cw + 2 * tig;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *(__nv_bfloat162*)(o + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

// The H100's opt-in shared memory per block.
constexpr int MAX_SMEM = 227 * 1024;

// cudaFuncSetAttribute applies to the current device only: raise a kernel's
// dynamic shared-memory cap to `bytes` once on each device (`done` holds a
// bit per device; two threads may both set it, which is harmless).
template <typename Kernel>
cudaError_t raise_smem_cap(Kernel kernel, int bytes,
                           std::atomic<uint64_t>& done) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <int WR, bool NOISY, bool GAINS>
cudaError_t launch_fused(const int8_t* xq, const float* sx,
                         const int32_t* kcodes, const __nv_bfloat16* scales,
                         const float* gains, int M, int Kp, int T, int n,
                         int Ntot, int bm, int tk, int nk, const Segments& seg,
                         const Adc& adc, __nv_bfloat16* out, cudaStream_t st) {
  const size_t smem = (size_t)FusedSmem(16 * WR, n, T).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // The cap covers every size a launch may ask, so it is set once on each
  // device (never again once warm, e.g. under CUDA graph capture).
  static std::atomic<uint64_t> cap_set{0};
  cudaError_t err =
      raise_smem_cap(abfp_fused<WR, NOISY, GAINS>, MAX_SMEM, cap_set);
  if (err != cudaSuccess) return err;
  dim3 grid(Ntot / BN, (M + 16 * WR - 1) / (16 * WR));
  abfp_fused<WR, NOISY, GAINS><<<grid, 128 * WR, smem, st>>>(
      xq, sx, kcodes, scales, gains, M, Kp, T, n, Ntot, bm, tk, nk, seg, adc,
      out);
  return cudaGetLastError();
}

template <int WR>
cudaError_t launch_fused_wr(const int8_t* xq, const float* sx,
                            const int32_t* kcodes,
                            const __nv_bfloat16* scales, const float* gains,
                            int M, int Kp, int T, int n, int Ntot, int bm,
                            int tk, int nk, const Segments& seg,
                            const Adc& adc, __nv_bfloat16* out,
                            cudaStream_t st) {
  if (adc.noisy && adc.has_gains)
    return launch_fused<WR, true, true>(xq, sx, kcodes, scales, gains, M, Kp,
                                        T, n, Ntot, bm, tk, nk, seg, adc, out,
                                        st);
  if (adc.noisy)
    return launch_fused<WR, true, false>(xq, sx, kcodes, scales, gains, M,
                                         Kp, T, n, Ntot, bm, tk, nk, seg, adc,
                                         out, st);
  if (adc.has_gains)
    return launch_fused<WR, false, true>(xq, sx, kcodes, scales, gains, M,
                                         Kp, T, n, Ntot, bm, tk, nk, seg, adc,
                                         out, st);
  return launch_fused<WR, false, false>(xq, sx, kcodes, scales, gains, M, Kp,
                                        T, n, Ntot, bm, tk, nk, seg, adc, out,
                                        st);
}

template <int MR>
cudaError_t launch_decode(const void* x, int x_bf16, int K, int Kp, int T,
                          int n, float lx, const int32_t* kcodes,
                          const __nv_bfloat16* scales, const float* gains,
                          int Ntot, int bm, int tk, int nk,
                          const Segments& seg, const Adc& adc,
                          __nv_bfloat16* out, cudaStream_t st) {
  const size_t smem = (size_t)DecodeSmem(MR, Kp, T).total;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<uint64_t> cap_set{0};
  cudaError_t err = raise_smem_cap(abfp_decode<MR>, MAX_SMEM, cap_set);
  if (err != cudaSuccess) return err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int slices = Ntot / DEC_COLS;
  const int blocks =
      slices < DEC_BLOCKS_PER_SM * sms ? slices : DEC_BLOCKS_PER_SM * sms;
  abfp_decode<MR><<<blocks, DEC_THREADS, smem, st>>>(
      x, x_bf16, K, Kp, T, n, lx, kcodes, scales, gains, Ntot, bm, tk, nk,
      seg, adc, out);
  return cudaGetLastError();
}

bool host_pow2(float v) {
  uint32_t bits;
  memcpy(&bits, &v, sizeof bits);
  return exact_reciprocal(bits);
}

}  // namespace

// nj0..nj2: each segment's global column-block count, off0..off2 the
// global index of its first block: a column shard of a weight draws the
// noise the whole weight's grid draws for the same columns (salt
// (i * nj + off + j_local) * nk + k).  A whole weight passes its own block
// count and offset 0.
// seeds: device pointer to the nseg segment seeds (null without noise).
// rows: the route.  16, 32 or 64: the fused route's row block (M > 8);
// 8: the decode route (M <= 8, one launch; xq, sx and terms unused); 0: the
// tile-terms + reduce route (terms: (T, M, Ntot) f32 scratch).
extern "C" int abfp_matmul_packed_launch(
    const void* x, int x_bf16, int M, int K, const void* kcodes,
    const void* scales, const void* gains, int Kp, int T, int n, int Ntot,
    int nseg, int start1, int start2, int nj0, int nj1, int nj2, int off0,
    int off1, int off2, const void* seeds, int bm, int tk, int nk, float adc_scale,
    float noise2, int noisy, float ly, float bin_y, float gain, float lx,
    int rows, void* xq, void* sx, void* terms, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 != 0 || Ntot % BN != 0 || nseg < 1 || nseg > 3 || M < 1 ||
      (noisy && seeds == nullptr) || off0 < 0 || off1 < 0 || off2 < 0)
    return (int)cudaErrorInvalidValue;
  // The fused route's conditions: whole 32-deep k steps (n a power of two
  // from 32), s_x and s_w of every K-tile in shared memory (T <= 128), and
  // a tile dot and an ADC level below 2^22 (the 1.5 * 2^23 conversions).
  const bool fused = rows == 16 || rows == 32 || rows == 64;
  if (fused && (n < 32 || (n & (n - 1)) != 0 || T > 128 ||
                (double)n * lx * 127.0 >= 4194304.0 || ly >= 4194304.0f))
    return (int)cudaErrorInvalidValue;
  // The decode route's noise keeps every row in row block 0 (bm >= M).
  if ((rows == DEC_ROWS && (M > DEC_ROWS || bm < M)) ||
      (rows != 0 && rows != DEC_ROWS && !fused))
    return (int)cudaErrorInvalidValue;

  Segments seg;
  seg.start1 = start1;
  seg.start2 = start2;
  seg.nj[0] = nj0; seg.nj[1] = nj1; seg.nj[2] = nj2;
  seg.off[0] = off0; seg.off[1] = off1; seg.off[2] = off2;
  seg.seeds = (const int*)seeds;
  seg.nseg = nseg;
  Adc adc;
  adc.scale = adc_scale;
  adc.noise2 = noise2;
  adc.ly = ly;
  adc.bin_y = bin_y;
  adc.gain = gain;
  adc.gain_pow2 = host_pow2(gain);
  adc.inv_gain = adc.gain_pow2 ? 1.0f / gain : 0.0f;
  adc.noisy = noisy;
  adc.has_gains = gains != nullptr;
  const int32_t* w = (const int32_t*)kcodes;
  const __nv_bfloat16* sc = (const __nv_bfloat16*)scales;
  const float* gn = (const float*)gains;
  __nv_bfloat16* o = (__nv_bfloat16*)out;

  if (rows == DEC_ROWS) {
    switch (M) {
#define DECODE_CASE(R)                                                     \
  case R:                                                                  \
    return (int)launch_decode<R>(x, x_bf16, K, Kp, T, n, lx, w, sc, gn,    \
                                 Ntot, bm, tk, nk, seg, adc, o, st);
      DECODE_CASE(1) DECODE_CASE(2) DECODE_CASE(3) DECODE_CASE(4)
      DECODE_CASE(5) DECODE_CASE(6) DECODE_CASE(7) DECODE_CASE(8)
#undef DECODE_CASE
    }
  }

  {
    long warps = (long)M * T;
    int threads = 128;
    long blocks = (warps * 32 + threads - 1) / threads;
    abfp_quantize_x<<<(unsigned)blocks, threads, 0, st>>>(
        x, x_bf16, M, K, Kp, T, n, lx, (int8_t*)xq, (float*)sx);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (fused) {
    const int8_t* a = (const int8_t*)xq;
    const float* s = (const float*)sx;
    if (rows == 16)
      err = launch_fused_wr<1>(a, s, w, sc, gn, M, Kp, T, n, Ntot, bm, tk,
                               nk, seg, adc, o, st);
    else if (rows == 32)
      err = launch_fused_wr<2>(a, s, w, sc, gn, M, Kp, T, n, Ntot, bm, tk,
                               nk, seg, adc, o, st);
    else
      err = launch_fused_wr<4>(a, s, w, sc, gn, M, Kp, T, n, Ntot, bm, tk,
                               nk, seg, adc, o, st);
    return (int)err;
  }

  const int rb = M <= 8 ? 8 : 32;
  dim3 grid(Ntot / BN, T, (M + rb - 1) / rb);
  size_t smem = (size_t)rb * n;
  if (rb == 8)
    abfp_tile_terms<8><<<grid, BN, smem, st>>>(
        (const int8_t*)xq, (const float*)sx, w, sc, gn, M, Kp, T, n, Ntot,
        bm, tk, nk, seg, adc, (float*)terms);
  else
    abfp_tile_terms<32><<<grid, BN, smem, st>>>(
        (const int8_t*)xq, (const float*)sx, w, sc, gn, M, Kp, T, n, Ntot,
        bm, tk, nk, seg, adc, (float*)terms);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  long outs = (long)M * Ntot;
  abfp_reduce<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
      (const float*)terms, M, T, Ntot, tk, nk, gains != nullptr, gain, o);
  return (int)cudaGetLastError();
}

extern "C" int abfp_quantize_w_launch(const void* w, int w_bf16, int K, int N,
                                      int Np, int T, int n, float lw,
                                      void* kcodes, void* scales,
                                      void* stream) {
  if (n % 4 != 0 || Np % BN != 0 || N > Np || (long)T * n < K)
    return (int)cudaErrorInvalidValue;
  dim3 grid(Np / QW_COLS, T);
  dim3 block(QW_COLS, QW_GROUPS);
  abfp_quantize_w<<<grid, block, 0, (cudaStream_t)stream>>>(
      w, w_bf16, K, N, Np, n, lw, (int32_t*)kcodes, (__nv_bfloat16*)scales);
  return (int)cudaGetLastError();
}
