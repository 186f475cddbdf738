// Single-query GQA decode attention over the int8 KV cache (kernel 3) for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel
//   repro/kernels/abfp_decode_fused.py  fused_quantized_decode_attention
// scores = (q * d^-1/2) . k_codes * (k_scale / 127) per cached position,
// positions >= length masked (-1e30), an f32 softmax over the key axis,
// then PV with the value codes weighted by p * (v_scale / 127).
//
// What bounds it: the int8 cache read (2 * length * KH * (D + 2) bytes per
// batch row) from device memory; the arithmetic is a few f32 operations per
// byte.  At serving sizes (4 rows of about 80 positions, 5 KV heads of 64)
// that is about 0.2 MB per layer, 0.06 us at the memory rate, so a launch
// is bound by its latency: the dependent round trips to memory and the
// number of positions a warp walks in turn.
//
// Design (flash-decoding): a block of 8 warps per (batch row, KV head,
// group of up to four of its query heads, position split).  A warp step
// takes PPW = 32 / (D / 16) positions: lane (pl, ch) reads the 16-byte
// chunk ch of position pl's K codes and of its V codes (one load each) and
// the two scales, so each code is read once for every query head of the
// group; the chunk dots are summed over the D / 16 lanes of a position
// with shuffles.  When D / 16 does not divide 32 (D = 96: 6 chunks, 5
// positions a step) the last 32 mod (D / 16) lanes idle, and the sums over
// a position's lanes and over the positions of a chunk read their lanes by
// index instead of by butterfly.
// The warps take the block's positions in interleaved steps (the next
// step's codes requested before this step's arithmetic), each keeping
// an online softmax per query head in f32 (running max, per-lane partial
// denominator and PV accumulator, rescaled when the max moves).  The block
// combines its warps in shared memory (8 x heads x (D + 2) floats,
// whatever S).  With one split (the wrapper's choice up to S = 1,024) the
// block writes the output; otherwise each split writes its max,
// denominator and accumulator, and a second launch combines the splits.
// Only the first `length` positions are read; a row with length 0 keeps the
// reference's uniform softmax over all S positions (every score -1e30, so
// every weight exp(0)) and reads no K code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_HEADS = 4;         // query heads per block
constexpr float MASKED = -1e30f;
// scale / 127 as a multiplication (within an f32 ULP of the division; the
// kernel is held to a tolerance, not to bits).
constexpr float INV127 = 1.0f / 127.0f;
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float load_q(const void* q, int q_bf16, long i) {
  return q_bf16 ? __bfloat162float(((const __nv_bfloat16*)q)[i])
                : ((const float*)q)[i];
}

__device__ __forceinline__ void store_out(void* out, int bf16, long i,
                                          float v) {
  if (bf16)
    ((__nv_bfloat16*)out)[i] = __float2bfloat16_rn(v);
  else
    ((float*)out)[i] = v;
}

// The 16 signed codes of a 16-byte chunk, as floats.
__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[16]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)(int8_t)(v[i >> 2] >> (8 * (i & 3)));
}

// The block's place: blockIdx = (head group, KV head g, row b x splits +
// split), read without an integer division on the way to the first load
// when there is one split; `part` is the index of its (b, g, head group).
struct Place {
  int rep, b, g, r0, z, part;
  __device__ Place(int H, int KH, int RG, int nsplit) {
    rep = H / KH;
    g = blockIdx.y;
    r0 = blockIdx.x * RG;
    b = nsplit == 1 ? (int)blockIdx.z : (int)blockIdx.z / nsplit;
    z = (int)blockIdx.z - b * nsplit;
    part = (b * KH + g) * (int)gridDim.x + (int)blockIdx.x;
  }
  __device__ long out_index(int H, int D, int r, int d) const {
    return ((long)b * H + g * rep + r0 + r) * D + d;
  }
};

// Sum over the CH lanes of this lane's position (lanes pl * CH ..
// pl * CH + CH - 1): a butterfly when CH divides 32, else lane by lane.
template <int CH>
__device__ __forceinline__ float position_sum(float v, int lane) {
  if constexpr (32 % CH == 0) {
#pragma unroll
    for (int o = 1; o < CH; o <<= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  } else {
    const int first = lane - lane % CH;
    float s = __shfl_sync(0xffffffffu, v, first);
#pragma unroll
    for (int c = 1; c < CH; ++c)
      s = __fadd_rn(s, __shfl_sync(0xffffffffu, v, first + c));
    return s;
  }
}

// Sum over the PPW positions of this lane's chunk (lanes ch, ch + CH, ..).
template <int CH, int PPW>
__device__ __forceinline__ float chunk_sum(float v, int lane) {
  if constexpr (32 % CH == 0) {
#pragma unroll
    for (int o = CH; o < 32; o <<= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  } else {
    const int ch = lane % CH;
    float s = __shfl_sync(0xffffffffu, v, ch);
#pragma unroll
    for (int p = 1; p < PPW; ++p)
      s = __fadd_rn(s, __shfl_sync(0xffffffffu, v, p * CH + ch));
    return s;
  }
}

// Max over the warp's positions: over the lanes of one chunk when CH
// divides 32, else over all 32 lanes (a position's lanes hold one score,
// idle lanes -inf).
template <int CH>
__device__ __forceinline__ float positions_max(float v) {
#pragma unroll
  for (int o = 32 % CH == 0 ? CH : 1; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Merges (max, denominator, accumulator) parts i < n, at strides sm (max
// and denominator) and sa (accumulator): max m, sum of e_i * den_i and of
// e_i * acc_i with e_i = exp(m_i - m).  A part with no position (m_i =
// -inf) weighs 0; with no position at all the sums are 0.
struct Merged {
  float m, den, acc;
};

__device__ __forceinline__ Merged merge(const float* m, const float* den,
                                        int sm, const float* acc, int sa,
                                        int n) {
  Merged r{-INFINITY, 0.0f, 0.0f};
  for (int i = 0; i < n; ++i) r.m = fmaxf(r.m, m[i * sm]);
  if (r.m == -INFINITY) return r;
  for (int i = 0; i < n; ++i) {
    const float e = expf(m[i * sm] - r.m);
    r.acc = fmaf(acc[i * sa], e, r.acc);
    r.den = fmaf(den[i * sm], e, r.den);
  }
  return r;
}

template <int D, int RG>
__global__ void __launch_bounds__(THREADS)
decode_attention(const void* __restrict__ q, int q_bf16,
                 const int8_t* __restrict__ kc,
                 const __nv_bfloat16* __restrict__ ks,
                 const int8_t* __restrict__ vc,
                 const __nv_bfloat16* __restrict__ vs,
                 const int32_t* __restrict__ lengths, void* __restrict__ out,
                 float* __restrict__ part, int S, int H, int KH, int nsplit,
                 float qscale) {
  constexpr int CH = D / 16;          // 16-byte chunks of a position's codes
  constexpr int PPW = 32 / CH;        // positions per warp step
  constexpr int STEP = PPW * WARPS;   // positions per block step
  __shared__ float wm[WARPS][RG], wl[WARPS][RG], wacc[WARPS][RG][D];

  const Place at(H, KH, RG, nsplit);
  const int z = at.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch = lane % CH, pl = lane / CH;
  const bool lane_live = pl < PPW;    // false on the idle lanes (D = 96)

  const int len = lengths[at.b];
  float qv[RG][16];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const bool live = at.r0 + r < at.rep;
    const long qi = at.out_index(H, D, r, ch * 16);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      qv[r][i] = live ? __fmul_rn(load_q(q, q_bf16, qi + i), qscale) : 0.0f;
  }
  const bool all_masked = len <= 0;
  const int L = all_masked ? S : min(len, S);
  // This split's positions, whole block steps.
  int p_lo = 0, p_hi = L;
  if (nsplit > 1) {
    const int per = ((L + nsplit - 1) / nsplit + STEP - 1) / STEP * STEP;
    p_lo = min(L, z * per);
    p_hi = min(L, p_lo + per);
  }

  float m_run[RG], l_run[RG], acc[RG][16];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[r][i] = 0.0f;
  }

  // Position s of head g of row b: (b * S + s) * KH + g.  A lane's codes
  // and scales of the step at position p (zeros past the split's end); the
  // next step's are requested before this step's arithmetic.
  const long pos0 = (long)at.b * S * KH + at.g;
  struct Chunk {
    uint4 k, v;
    float kscale, vscale;
  };
  auto fetch = [&](int p) {
    Chunk c{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0), 0.0f, 0.0f};
    const int s = p + pl;
    if (lane_live && s < p_hi) {
      const long pos = pos0 + (long)s * KH;
      if (!all_masked) {
        c.k = __ldg((const uint4*)(kc + pos * D) + ch);
        c.kscale = __fmul_rn(__bfloat162float(ks[pos]), INV127);
      }
      c.v = __ldg((const uint4*)(vc + pos * D) + ch);
      c.vscale = __fmul_rn(__bfloat162float(vs[pos]), INV127);
    }
    return c;
  };
  int p = p_lo + warp * PPW;
  Chunk cur = fetch(p);
  for (; p < p_hi; p += STEP) {
    const Chunk nxt = fetch(p + STEP);
    const bool valid = lane_live && p + pl < p_hi;  // lane 0 always is
    const float kscale = cur.kscale, vscale = cur.vscale;
    float kf[16], vf[16];
    unpack16(cur.k, kf);
    unpack16(cur.v, vf);
    cur = nxt;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      // The chunk's dot as four interleaved partial sums (a short chain).
      float d4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 16; ++i) d4[i & 3] = fmaf(qv[r][i], kf[i], d4[i & 3]);
      const float dot = position_sum<CH>(
          __fadd_rn(__fadd_rn(d4[0], d4[1]), __fadd_rn(d4[2], d4[3])), lane);
      const float sc = !valid ? -INFINITY
                              : (all_masked ? MASKED : __fmul_rn(dot, kscale));
      const float m_new = fmaxf(m_run[r], positions_max<CH>(sc));
      const float corr = expf(m_run[r] - m_new);
      const float pr = valid ? expf(sc - m_new) : 0.0f;
      l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr), pr);
      const float pv = __fmul_rn(pr, vscale);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[r][i] = fmaf(pv, vf[i], __fmul_rn(acc[r][i], corr));
      m_run[r] = m_new;
    }
  }

  // The warp's sums over its positions (the lanes of one chunk), then the
  // block's over its warps.
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    l_run[r] = chunk_sum<CH, PPW>(l_run[r], lane);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[r][i] = chunk_sum<CH, PPW>(acc[r][i], lane);
  }
  if (pl == 0) {
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int i = 0; i < 16; ++i) wacc[warp][r][ch * 16 + i] = acc[r][i];
      if (ch == 0) {
        wm[warp][r] = m_run[r];
        wl[warp][r] = l_run[r];
      }
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < RG * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    if (at.r0 + r >= at.rep) continue;
    const Merged mg =
        merge(&wm[0][r], &wl[0][r], RG, &wacc[0][r][d], RG * D, WARPS);
    if (nsplit == 1) {
      store_out(out, q_bf16, at.out_index(H, D, r, d),
                __fdiv_rn(mg.acc, mg.den));
      continue;
    }
    // This split's part: its max, denominator and accumulator.
    float* pp = part + (((long)at.part * nsplit + z) * RG + r) * (D + 2);
    if (d == 0) {
      pp[0] = mg.m;
      pp[1] = mg.den;
    }
    pp[2 + d] = mg.acc;
  }
}

// The second launch of a split call: one block per (head group, KV head,
// batch row), a thread per (query head, d), over the nsplit parts.
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_attention_combine(const float* __restrict__ part,
                         void* __restrict__ out, int q_bf16, int H, int KH,
                         int D, int RG, int nsplit) {
  const Place at(H, KH, RG, 1);
  const int stride = RG * (D + 2);
  for (int idx = threadIdx.x; idx < RG * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    if (at.r0 + r >= at.rep) continue;
    const float* pp = part + ((long)at.part * nsplit * RG + r) * (D + 2);
    const Merged mg = merge(pp, pp + 1, stride, pp + 2 + d, stride, nsplit);
    store_out(out, q_bf16, at.out_index(H, D, r, d),
              __fdiv_rn(mg.acc, mg.den));
  }
}

template <int D, int RG>
cudaError_t launch(const void* q, int q_bf16, const void* kc, const void* ks,
                   const void* vc, const void* vs, const void* lengths,
                   void* out, float* part, int B, int S, int H, int KH,
                   int nsplit, float qscale, cudaStream_t st) {
  const int groups = (H / KH + RG - 1) / RG;
  dim3 grid(groups, KH, B * nsplit);
  decode_attention<D, RG><<<grid, THREADS, 0, st>>>(
      q, q_bf16, (const int8_t*)kc, (const __nv_bfloat16*)ks,
      (const int8_t*)vc, (const __nv_bfloat16*)vs, (const int32_t*)lengths,
      out, part, S, H, KH, nsplit, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  decode_attention_combine<<<dim3(groups, KH, B), COMBINE_THREADS, 0, st>>>(
      part, out, q_bf16, H, KH, D, RG, nsplit);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int RG, const void* q, int q_bf16, const void* kc,
                     const void* ks, const void* vc, const void* vs,
                     const void* lengths, void* out, float* part, int B,
                     int S, int H, int KH, int nsplit, float qscale,
                     cudaStream_t st) {
  switch (RG) {
#define HEADS_CASE(R)                                                      \
  case R:                                                                  \
    return launch<D, R>(q, q_bf16, kc, ks, vc, vs, lengths, out, part, B,  \
                        S, H, KH, nsplit, qscale, st);
    HEADS_CASE(1) HEADS_CASE(2) HEADS_CASE(3) HEADS_CASE(4)
#undef HEADS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// part: nsplit > 1 only, f32 scratch of B * KH * groups * nsplit * RG *
// (D + 2) floats, RG = min(H / KH, 4) query heads per block and groups =
// ceil((H / KH) / RG).  D is 32, 64, 96, 128 or 256.
extern "C" int decode_attention_launch(const void* q, int q_bf16,
                                       const void* kc, const void* ks,
                                       const void* vc, const void* vs,
                                       const void* lengths, void* out,
                                       void* part, int B, int S, int H,
                                       int KH, int D, int nsplit,
                                       float qscale, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || KH > 65535 || H % KH != 0 ||
      nsplit < 1 || (long)B * nsplit > 65535 ||
      (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rep = H / KH;
  const int RG = rep < MAX_HEADS ? rep : MAX_HEADS;
  cudaStream_t st = (cudaStream_t)stream;
  float* pt = (float*)part;
  switch (D) {
    case 32:
      return (int)launch_d<32>(RG, q, q_bf16, kc, ks, vc, vs, lengths, out,
                               pt, B, S, H, KH, nsplit, qscale, st);
    case 64:
      return (int)launch_d<64>(RG, q, q_bf16, kc, ks, vc, vs, lengths, out,
                               pt, B, S, H, KH, nsplit, qscale, st);
    case 96:
      return (int)launch_d<96>(RG, q, q_bf16, kc, ks, vc, vs, lengths, out,
                               pt, B, S, H, KH, nsplit, qscale, st);
    case 128:
      return (int)launch_d<128>(RG, q, q_bf16, kc, ks, vc, vs, lengths, out,
                                pt, B, S, H, KH, nsplit, qscale, st);
    case 256:
      return (int)launch_d<256>(RG, q, q_bf16, kc, ks, vc, vs, lengths, out,
                                pt, B, S, H, KH, nsplit, qscale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
