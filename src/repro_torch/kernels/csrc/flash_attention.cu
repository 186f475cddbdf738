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
// What bounds it: one forward of smollm-360m (4 x 512 tokens, causal) does
// about 2 GFLOP of dot products per layer against 10 MB of q/k/v/out, so
// the operations bound it, not the bytes.  On bf16 inputs they run on the
// bf16 tensor cores: a bf16 x bf16 product is exact in f32, so q . k on the
// tensor cores with f32 accumulation differs from an f32 FMA loop only in
// summation order.  On f32 inputs that argument does not hold, and the f32
// FMA kernel below is the route.
//
// Design, by dtype:
//   * bf16 (flash_fwd_tc, FlashAttention-2's shape): one block of 4 warps
//     per (64-query block, batch x head); a warp owns 16 query rows.  K/V
//     tiles of 64 positions are staged in shared memory as bf16 with
//     cp.async, double-buffered, rows padded by 16 bytes, and read with
//     ldmatrix (.trans for V).  S = (q * D^-0.5) . k runs on mma.sync
//     m16n8k16 bf16 -> f32.  q * scale is exact in bf16 when the scale is a
//     power of two (D = 64); otherwise it is split into bf16 hi + lo and
//     takes two passes.  The online softmax runs on the accumulator
//     fragments in registers (row max over the four lanes of a quad; the
//     denominator as per-lane partial sums, added across the quad at the
//     end).  P . V runs on p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
//     MMAs into the f32 accumulator: about 16 bits of p, against 8 for bf16
//     alone.  Masks only on tiles that hold a masked (key, query) pair of
//     the block.
//   * f32 (flash_fwd, f32 FMAs): one block per (64-query block, batch x
//     head); 4 threads per query row, each holding the scaled query and the
//     f32 accumulator of every 4th dimension; K/V tiles of 4,096 / D
//     positions (rounded down to whole 16s: 32 at D = 96, 16 at D = 256)
//     staged in shared memory as f32; 16 keys per online-softmax update.
// Head dims 32, 64, 96 (phi-3-vision: six 16-deep k-steps on the tensor
// cores), 128 and 256 (recurrentgemma-2b, gemma-7b).
// At D = 256 the bf16 kernel's registers are the limit: a warp's 16 x 256
// f32 accumulator alone is 128 registers per thread, and the scaled query's
// 16 k-chunks of A fragments would add 64 more (plus 32 for a 64-key score
// tile), past the 255 cap.  So at D > 128 the scaled query lives in shared
// memory (64 rows x 264 bf16, hi and lo tiles when the scale is not a power
// of two) and is read with ldmatrix per k-chunk, and the K/V tiles shrink
// to 32 keys (16 score registers): 101,376 B of dynamic shared memory per
// block (135,168 B with the lo tile), two blocks per SM.  Compiled for
// sm_90a (CUDA 12.8), flash_fwd_tc<256> then takes 255 registers and no
// spill, with and without the lo tile, and flash_fwd<256> 255 and no
// spill; at D <= 128 the query stays in registers (216 at D = 128 without
// the lo tile; with it, 255 and a 12-byte spill).  chip_smoke.py's build
// phase reports every instantiation's registers and spill bytes.
// Both walk only the KV range some query of the block can see (causal: up
// to the block's last query; window: from its first query's window start),
// so they skip every block the TPU kernel skips, at a finer grain.  The
// sum order differs from the plain version's (bq = bk = 512 blocks), so
// results agree to a tolerance, not bit for bit.
// A query row that sees no key (a window, qpos >= Skv + window - 1; only
// when Sq > Skv) gets the reference's result, not its own tiles': every
// score of the TPU kernel's live blocks for that row is -1e30, so the row
// is the mean of v over all bk entries of those blocks (no_key_blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;                // query rows per block
constexpr int TPR = 4;                // threads per query row
constexpr int THREADS = BQ * TPR;     // 256
constexpr int TILE_ELEMS = 4096;      // BK x D floats of one staged tile
constexpr int SUB = 16;               // keys per online-softmax update
constexpr float NEG = -1e30f;

// True when no key is visible to query row qpos: with a window, the keys
// qpos - window + 1 .. qpos all lie past Skv.
__device__ __forceinline__ bool sees_no_key(int qpos, int Skv, int window) {
  return window > 0 && qpos >= Skv + window - 1;
}

// The reference's blocks (bq = min(512, ceil128(Sq)), bk = min(512,
// ceil128(Skv))) that the TPU kernel does not skip for the query block of
// qpos: every entry of them, the zero padding past Skv included, gets p =
// exp(0) = 1 on a row that sees no key, so that row is the sum of v over
// keys [lo, hi) divided by den = bk x their count (0 when none is live: the
// guarded division then gives 0).
struct NoKeyBlocks {
  int lo, hi;
  float den;
};

__device__ NoKeyBlocks no_key_blocks(int qpos, int Sq, int Skv, int causal,
                                     int window) {
  const int bq = min(512, (Sq + 127) / 128 * 128);
  const int bk = min(512, (Skv + 127) / 128 * 128);
  const int q_start = qpos / bq * bq;
  const int nkb = (Skv + bk - 1) / bk;
  int lo = nkb, hi = 0;              // the live blocks are contiguous
  for (int kb = 0; kb < nkb; ++kb) {
    const int k_start = kb * bk;
    bool live = !causal || k_start <= q_start + bq - 1;
    live = live && k_start + bk - 1 > q_start - window;
    if (live) {
      lo = min(lo, kb);
      hi = kb + 1;
    }
  }
  if (hi <= lo) return {0, 0, 0.0f};
  return {lo * bk, min(hi * bk, Skv), (float)((hi - lo) * bk)};
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int H, int KH,
          int Sq, int Skv, float scale, int causal, int window) {
  // 128, 64, 32, 32, 16 positions at D = 32, 64, 96, 128, 256: whole SUB
  // steps.
  constexpr int BK = TILE_ELEMS / D / SUB * SUB;
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
    qr[t] = active ? __fmul_rn(q[q_off + TPR * t], scale) : 0.0f;
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
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D;
      const int kp = k0 + j;
      float kk = 0.0f, vv = 0.0f;
      if (kp < Skv) {
        const long off = kv_base + kp * kv_step + d;
        kk = k[off];
        vv = v[off];
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
  float den = fmaxf(l, 1e-30f);
  if (sees_no_key(qi, Skv, window)) {
    const NoKeyBlocks nk = no_key_blocks(qi, Sq, Skv, causal, window);
#pragma unroll
    for (int t = 0; t < DP; ++t) acc[t] = 0.0f;
    for (int kp = nk.lo; kp < nk.hi; ++kp)
#pragma unroll
      for (int t = 0; t < DP; ++t)
        acc[t] = __fadd_rn(acc[t], v[kv_base + kp * kv_step + sub + TPR * t]);
    den = fmaxf(nk.den, 1e-30f);
  }
  float* o = out + q_off;
#pragma unroll
  for (int t = 0; t < DP; ++t) o[TPR * t] = __fdiv_rn(acc[t], den);
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores (mma.sync m16n8k16 bf16 -> f32)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;       // query rows per block (4 warps x 16)
constexpr int TC_THREADS = 128;

// Key positions per staged tile, and whether the scaled query is kept in
// shared memory (not in registers): both by head dim (see the header).
template <int D>
struct TcShape {
  static constexpr bool QS = D > 128;
  static constexpr int BK = QS ? 32 : 64;
};

// Dynamic shared memory of one flash_fwd_tc block: double-buffered K and V
// tiles, then the scaled query's hi (and lo) tiles when QS.
template <int D, bool QLO>
constexpr int tc_smem_bytes() {
  return (2 * 2 * TcShape<D>::BK +
          (TcShape<D>::QS ? TC_BQ * (QLO ? 2 : 1) : 0)) *
         (D + 8) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a . b on one m16n8k16 tile, bf16 x bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 hi words and the bf16 rounding of their remainders.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(
      __fsub_rn(a, __low2float(h)), __fsub_rn(b, __high2float(h))));
}

// A thread (lane = 4 g + tig) of warp w holds query rows qa = q0 + 16 w + g
// and qb = qa + 8; in each 8-wide fragment tile, columns 2 tig and
// 2 tig + 1 (elements 0, 1 of row qa, 2, 3 of row qb).
template <int D, bool QLO>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ out, int H, int KH, int Sq, int Skv,
             float scale, int causal, int window) {
  constexpr int LD = D + 8;        // padded shared-memory row (bf16)
  constexpr int KC = D / 16;       // 16-deep chunks of the score dot
  constexpr int TC_BK = TcShape<D>::BK;
  constexpr bool QS = TcShape<D>::QS;
  constexpr int NT = TC_BK / 8;    // key tiles of a score row
  constexpr int DT = D / 8;        // dimension tiles of the output
  constexpr int CH = D / 8;        // 16-byte chunks of a K/V row
  // [2][K|V][BK][LD], then (QS) the query's [hi|lo][TC_BQ][LD].
  extern __shared__ __align__(16) __nv_bfloat16 kv_smem[];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KH);
  const int q0 = blockIdx.x * TC_BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // The scaled query as A fragments, bf16 hi (+ lo when the scale is not a
  // power of two): in registers, or (QS) in shared memory, read per
  // k-chunk with ldmatrix (lane l: row l % 8 + 8 ((l / 8) % 2), column
  // 8 (l / 16) of the 16 x 16 chunk).
  uint32_t qh[QS ? 1 : KC][4], ql[QLO && !QS ? KC : 1][4];
  __nv_bfloat16* qs_hi = kv_smem + 2 * 2 * TC_BK * LD;
  __nv_bfloat16* qs_lo = qs_hi + TC_BQ * LD;
  if (QS) {
    for (int e = threadIdx.x; e < TC_BQ * D / 2; e += TC_THREADS) {
      const int row = e / (D / 2), col = 2 * (e % (D / 2));
      const int qi = q0 + row;
      float2 f = make_float2(0.0f, 0.0f);
      if (qi < Sq)
        f = __bfloat1622float2(*(const __nv_bfloat162*)(
            q + (((long)b * Sq + qi) * H + h) * D + col));
      const float a0 = __fmul_rn(f.x, scale), a1 = __fmul_rn(f.y, scale);
      uint32_t hi, lo = 0;
      if (QLO)
        split_bf16(a0, a1, hi, lo);
      else
        hi = bf16x2_bits(__floats2bfloat162_rn(a0, a1));
      *(uint32_t*)(qs_hi + row * LD + col) = hi;
      if (QLO) *(uint32_t*)(qs_lo + row * LD + col) = lo;
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qi = qrow[r & 1];
        float2 f = make_float2(0.0f, 0.0f);
        if (qi < Sq)
          f = __bfloat1622float2(*(const __nv_bfloat162*)(
              q + (((long)b * Sq + qi) * H + h) * D + kc * 16 + (r >> 1) * 8 +
              2 * tig));
        const float a0 = __fmul_rn(f.x, scale), a1 = __fmul_rn(f.y, scale);
        if (QLO)
          split_bf16(a0, a1, qh[QS ? 0 : kc][r], ql[QLO && !QS ? kc : 0][r]);
        else
          qh[QS ? 0 : kc][r] = bf16x2_bits(__floats2bfloat162_rn(a0, a1));
      }
  }
  const int q_ld = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   (lane >> 4) * 8;

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.0f, 0.0f};

  // The KV positions some query of this block can see.
  const int k_hi = causal ? min(Skv, q0 + TC_BQ) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / TC_BK * TC_BK : 0;
  const long kv_base = (long)b * Skv * KH * D + (long)kvh * D;
  const long kv_step = (long)KH * D;

  auto load = [&](int buf, int k0) {
    __nv_bfloat16* ks = kv_smem + buf * 2 * TC_BK * LD;
    __nv_bfloat16* vs = ks + TC_BK * LD;
    for (int e = threadIdx.x; e < TC_BK * CH; e += TC_THREADS) {
      const int j = e / CH, ch = e % CH;
      const int kp = k0 + j;
      const long off = kv_base + (long)min(kp, Skv - 1) * kv_step + ch * 8;
      const int bytes = kp < Skv ? 16 : 0;  // key padding reads as 0
      cp_async16(ks + j * LD + ch * 8, k + off, bytes);
      cp_async16(vs + j * LD + ch * 8, v + off, bytes);
    }
  };

  int buf = 0;
  if (k_lo < k_hi) load(0, k_lo);
  cp_async_commit();
  for (int k0 = k_lo; k0 < k_hi; k0 += TC_BK) {
    if (k0 + TC_BK < k_hi) load(buf ^ 1, k0 + TC_BK);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const __nv_bfloat16* ks = kv_smem + buf * 2 * TC_BK * LD;
    const __nv_bfloat16* vs = ks + TC_BK * LD;

    // S = (q * scale) . k
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a_hi[4], a_lo[4];
      if (QS) {
        ldsm_x4(a_hi, qs_hi + q_ld + kc * 16);
        if (QLO) ldsm_x4(a_lo, qs_lo + q_ld + kc * 16);
      }
      const uint32_t(&qa)[4] = QS ? a_hi : qh[QS ? 0 : kc];
      const uint32_t(&qb)[4] = QS ? a_lo : ql[QLO && !QS ? kc : 0];
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, ks + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                       kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * jp], qa, r[0], r[1]);
        mma_bf16(sc[2 * jp + 1], qa, r[2], r[3]);
        if (QLO) {
          mma_bf16(sc[2 * jp], qb, r[0], r[1]);
          mma_bf16(sc[2 * jp + 1], qb, r[2], r[3]);
        }
      }
    }

    // Masks, only where some (key, query) pair of the block is masked.
    const bool full = k0 + TC_BK <= Skv &&
                      (!causal || k0 + TC_BK - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + TC_BQ - 1 - window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * tig + (e & 1);
          const int qi = qrow[e >> 1];
          bool valid = kp < Skv;
          if (causal) valid = valid && kp <= qi;
          if (window > 0) valid = valid && kp > qi - window;
          if (!valid) sc[j][e] = NEG;
        }
    }

    // Online softmax on the fragments.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = expf(m_run[r] - mx);
      m_run[r] = mx;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[j][e] = expf(sc[j][e] - mx);
          ps += sc[j][e];
        }
      l_run[r] = l_run[r] * corr + ps;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
    }

    // O += p_hi . V + p_lo . V
#pragma unroll
    for (int kc = 0; kc < TC_BK / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
      split_bf16(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
      split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t r[4];
        ldsm_x4_trans(r, vs + (kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, r[0], r[1]);
        mma_bf16(o[2 * dp], pl, r[0], r[1]);
        mma_bf16(o[2 * dp + 1], ph, r[2], r[3]);
        mma_bf16(o[2 * dp + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    if (qrow[r] >= Sq) continue;
    __nv_bfloat16* op = out + (((long)b * Sq + qrow[r]) * H + h) * D + 2 * tig;
    if (sees_no_key(qrow[r], Skv, window)) {
      const NoKeyBlocks nk = no_key_blocks(qrow[r], Sq, Skv, causal, window);
      const float dn = fmaxf(nk.den, 1e-30f);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        float sx = 0.0f, sy = 0.0f;
        for (int kp = nk.lo; kp < nk.hi; ++kp) {
          const float2 f = __bfloat1622float2(*(const __nv_bfloat162*)(
              v + kv_base + kp * kv_step + d * 8 + 2 * tig));
          sx = __fadd_rn(sx, f.x);
          sy = __fadd_rn(sy, f.y);
        }
        *(__nv_bfloat162*)(op + d * 8) =
            __floats2bfloat162_rn(__fdiv_rn(sx, dn), __fdiv_rn(sy, dn));
      }
      continue;
    }
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *(__nv_bfloat162*)(op + d * 8) = __floats2bfloat162_rn(
          __fdiv_rn(o[d][2 * r], den), __fdiv_rn(o[d][2 * r + 1], den));
  }
}

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

template <int D, bool QLO>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int H, int KH, int Sq, int Skv, float scale, int causal,
              int window, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<D, QLO>();
  // The block's shared memory depends only on D: set once on each device.
  static std::atomic<uint64_t> cap_set{0};
  if (smem > 48 * 1024) {
    cudaError_t err = raise_smem_cap(flash_fwd_tc<D, QLO>, smem, cap_set);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((Sq + TC_BQ - 1) / TC_BQ, B * H);
  flash_fwd_tc<D, QLO><<<grid, TC_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, KH, Sq, Skv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <bool QLO>
int launch_tc_d(const void* q, const void* k, const void* v, void* out, int B,
                int H, int KH, int Sq, int Skv, int D, float scale,
                int causal, int window, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_tc<32, QLO>(q, k, v, out, B, H, KH, Sq, Skv, scale,
                                causal, window, st);
    case 64:
      return launch_tc<64, QLO>(q, k, v, out, B, H, KH, Sq, Skv, scale,
                                causal, window, st);
    case 96:
      return launch_tc<96, QLO>(q, k, v, out, B, H, KH, Sq, Skv, scale,
                                causal, window, st);
    case 128:
      return launch_tc<128, QLO>(q, k, v, out, B, H, KH, Sq, Skv, scale,
                                 causal, window, st);
    case 256:
      return launch_tc<256, QLO>(q, k, v, out, B, H, KH, Sq, Skv, scale,
                                 causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int H, int KH, int Sq, int Skv, int D, float scale,
               int causal, int window, cudaStream_t st) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const float* qq = (const float*)q;
  const float* kk = (const float*)k;
  const float* vv = (const float*)v;
  float* oo = (float*)out;
  switch (D) {
    case 32:
      flash_fwd<32><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq, Skv,
                                              scale, causal, window);
      break;
    case 64:
      flash_fwd<64><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq, Skv,
                                              scale, causal, window);
      break;
    case 96:
      flash_fwd<96><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq, Skv,
                                              scale, causal, window);
      break;
    case 128:
      flash_fwd<128><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq, Skv,
                                               scale, causal, window);
      break;
    case 256:
      flash_fwd<256><<<grid, THREADS, 0, st>>>(qq, kk, vv, oo, H, KH, Sq, Skv,
                                               scale, causal, window);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 inputs run on the tensor cores, f32 inputs on the FMA kernel.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int B, int H, int KH, int Sq, int Skv,
                                      int D, float scale, int causal,
                                      int window, void* stream) {
  if (B < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    // q * scale is exact in bf16 when the scale is a power of two.
    int e;
    const bool pow2 = frexpf(scale, &e) == 0.5f;
    return pow2 ? launch_tc_d<false>(q, k, v, out, B, H, KH, Sq, Skv, D,
                                     scale, causal, window, st)
                : launch_tc_d<true>(q, k, v, out, B, H, KH, Sq, Skv, D,
                                    scale, causal, window, st);
  }
  return launch_f32(q, k, v, out, B, H, KH, Sq, Skv, D, scale, causal,
                    window, st);
}
