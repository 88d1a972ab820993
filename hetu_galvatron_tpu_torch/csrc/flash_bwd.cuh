// Shared pieces of the flash backward kernels K2 (flash_bwd.cu) and K3
// (flash_bwd_dq.cu); the design note is at the top of flash_bwd.cu.
#pragma once

#include <climits>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace galv {

// ---------------------------------------------------------------------------
// fp32: FMA kernels on fp32 shared-memory tiles
// ---------------------------------------------------------------------------

// s, p, dp and ds of one (q-tile, k-tile) pair; thread (ty, tx) owns
// q rows ty + 16 i and k columns tx + 16 j. Writes the dropped p (for dv)
// to Pd and ds to DS when they are given.
__device__ __forceinline__ void bwd_tile(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* delta_s, const int* qseg,
    const int* kseg, float* Pd, float* DS, int LD, int D, int q0, int k0,
    const Dims& dm, int causal, float scale, const DropoutArgs& dr,
    uint32_t key, bool has_seg) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, LP = BK + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + d];
      ov[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, kpos = k0 + c;
      bool ok = qpos < dm.S && kpos < dm.Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (has_seg) ok = ok && qseg[r] == kseg[c];
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      float dpv = dp[i][j], pd = p;
      if (dr.on) {
        const bool kp = keep(key, qpos, kpos, dr.threshold);
        pd = kp ? p / dr.keep_prob : 0.f;
        dpv = kp ? dpv / dr.keep_prob : 0.f;
      }
      // delta = rowsum(dropout(P) . dP') = dO . O, so the delta trick
      // survives dropout unchanged
      if (Pd != nullptr) Pd[r * LP + c] = pd;
      DS[r * LP + c] = p * (dpv - delta_s[r]) * scale;
    }
  }
}

__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          int* qseg, const float* lse,
                                          const float* delta, const int* seg,
                                          long long row0, int b, int q0,
                                          const Dims& dm) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = q0 + r < dm.S;
    lse_s[r] = in ? lse[row0 + q0 + r] : 0.f;
    delta_s[r] = in ? delta[row0 + q0 + r] : 0.f;
    if (seg != nullptr)
      qseg[r] = in ? seg[(long long)b * dm.S + q0 + r] : -1;
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int TC_NT = 128;  // four warps
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int DP>
struct Tc {
  static constexpr int LDS = DP + 8;  // shared-memory row, elements
  // tiles (rows of the fixed and of the streamed operand) and blocks of 4
  // warps an SM: the register caps of 3 and 4 blocks (168 and 128 a
  // thread) and of 2 and 3 above D=64 are the ones that fit without spills
  static constexpr int K2_BK = 64;
  static constexpr int K2_BQ = 32;
  static constexpr int K3_BQ = 64;
  static constexpr int K3_BK = 32;
  static constexpr int K2_MINB = DP > 64 ? 2 : 3;
  static constexpr int K3_MINB = DP > 64 ? 3 : 4;
  // bf16 carries P and dS as hi + lo (see the note in flash_bwd.cu)
  static constexpr bool SPLIT = std::is_same<T, __nv_bfloat16>::value;
  // bytes: K2 holds k, v, the k rows' segment ids and two stages of q,
  // dO, lse, delta, segment ids; K3 holds q, dO, the q rows' lse, delta and
  // segment ids and two stages of k, v, segment ids; the tile flags
  // (flag_bytes) follow. Row values live here rather than in registers,
  // which the fp32 accumulators fill.
  static constexpr int K2_SMEM = (2 * K2_BK + 4 * K2_BQ) * LDS *
                                     (int)sizeof(T) +
                                 (6 * K2_BQ + K2_BK) * 4;
  static constexpr int K3_SMEM = (2 * K3_BQ + 4 * K3_BK) * LDS *
                                     (int)sizeof(T) +
                                 (2 * K3_BK + 3 * K3_BQ) * 4;
};

// rows [pos0, pos0 + ROWS) of a strided [*, D] operand into a [ROWS][DP + 8]
// tile. AL: 16-byte cp.async (rows past `limit` zero-filled; the columns
// past D are never written and stay zero); else element-wise loads.
template <typename T, int DP, int ROWS, bool AL>
__device__ __forceinline__ void load_tile_tc(T* dst, const T* base,
                                             long long stride, int pos0,
                                             int limit, int D) {
  constexpr int LDS = DP + 8;
  if constexpr (AL) {
    constexpr int CH = DP / 8;
    const int dch = D / 8;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += TC_NT) {
      const int r = idx / CH, c = idx - r * CH;
      if (c >= dch) continue;
      const int pos = pos0 + r;
      const bool in = pos < limit;
      const T* src = in ? base + (long long)pos * stride + c * 8 : base;
      mma::cp_async16(mma::smem_u32(dst + r * LDS + c * 8), src,
                      in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += TC_NT) {
      const int r = idx / DP, c = idx - r * DP;
      const int pos = pos0 + r;
      dst[r * LDS + c] = (pos < limit && c < D)
                             ? base[(long long)pos * stride + c]
                             : from_float<T>(0.f);
    }
  }
}

// `rows` 4-byte values from src (the first n_valid real, the rest 0)
template <typename V>
__device__ __forceinline__ void load_vec_tc(V* dst, const V* src,
                                            int n_valid, int rows) {
  for (int r = threadIdx.x; r < rows; r += TC_NT) {
    const bool in = r < n_valid;
    mma::cp_async4(mma::smem_u32(dst + r), in ? src + r : src, in ? 4 : 0);
  }
}

// [min, max] segment id over positions [p0, min(p0 + rows, limit)) of one
// batch row's ids `sb` (the rule of ops/flash_attention.py::
// tile_segment_ranges). Every warp computes it whole, so the result is the
// same in every thread; call it from the whole block.
__device__ __forceinline__ int2 tile_range(const int* sb, int p0, int rows,
                                           int limit) {
  const int end = min(p0 + rows, limit);
  int lo = INT_MAX, hi = INT_MIN;
  for (int p = p0 + (threadIdx.x & 31); p < end; p += 32) {
    const int id = sb[p];
    lo = min(lo, id);
    hi = max(hi, id);
  }
  return make_int2(__reduce_min_sync(0xffffffffu, lo),
                   __reduce_max_sync(0xffffffffu, hi));
}

// Flags of the streamed tiles t in [t0, t1) (rows t * trows, up to tlimit)
// against the block's fixed tile (rows [f0, f0 + frows), up to flimit), by
// their segment-id ranges: 0 when the ranges do not overlap (the pair is
// skipped), 2 when both tiles hold one and the same id (no segment mask),
// else 1. Warps take the tiles in turn; sync the block before reading.
// Kept in shared memory, so the tile loop carries no ranges in registers.
__device__ __forceinline__ void tile_flags(unsigned char* flags,
                                           const int* sb, int f0, int frows,
                                           int flimit, int t0, int t1,
                                           int trows, int tlimit) {
  const int2 fr = tile_range(sb, f0, frows, flimit);
  for (int t = t0 + (int)(threadIdx.x >> 5); t < t1; t += TC_NT / 32) {
    const int2 r = tile_range(sb, t * trows, trows, tlimit);
    if ((threadIdx.x & 31) == 0)
      flags[t] = !(r.x <= fr.y && fr.x <= r.y)
                     ? 0
                     : (r.x == r.y && fr.x == fr.y && r.x == fr.x) ? 2 : 1;
  }
}

// bytes of the flags of n streamed tiles
static inline int flag_bytes(const int* seg, int n) {
  return seg != nullptr ? (n + 15) / 16 * 16 : 0;
}

// p (after dropout, for dv) and ds of one accumulator element. DROP is a
// compile-time copy of dr.on, so the loops over a tile's elements stay free
// of branches; inv_keep = 1 / keep_prob.
template <bool DROP>
__device__ __forceinline__ void p_ds(float& s, float& dp, bool ok,
                                     float lse2, float dlt, float scale,
                                     float scale2, uint32_t key,
                                     uint32_t threshold, float inv_keep,
                                     int qpos, int kpos) {
  const float p = ok ? exp2f(s * scale2 - lse2) : 0.f;
  float dpv = dp, pd = p;
  if constexpr (DROP) {
    const bool kp = keep(key, qpos, kpos, threshold);
    pd = kp ? p * inv_keep : 0.f;
    dpv = kp ? dpv * inv_keep : 0.f;
  }
  // delta = rowsum(dropout(P) . dP') = dO . O, so the delta trick survives
  // dropout unchanged
  s = pd;
  dp = p * (dpv - dlt) * scale;
}

// calls f(edge, drop) with both as std::integral_constant, so that a tile's
// element loop is compiled once per case and branches only once per tile
template <typename F>
__device__ __forceinline__ void with_cases(bool edge, bool drop, F&& f) {
  using T_ = std::true_type;
  using F_ = std::false_type;
  if (edge) {
    if (drop) f(T_{}, T_{}); else f(T_{}, F_{});
  } else {
    if (drop) f(F_{}, T_{}); else f(F_{}, F_{});
  }
}

// ---------------------------------------------------------------------------
// launch plumbing
// ---------------------------------------------------------------------------

static inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// 16-byte copies: base 16-byte aligned, strides and D multiples of 8
static inline bool rows_16b(const void* p, Strides s, int D) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0 && D % 8 == 0;
}

struct BwdCall {
  const void *q, *k, *v, *dO;
  const float *lse, *delta;
  const int* seg;
  void *out0, *out1;  // dk, dv (K2) or dq (K3)
  Dims dm;
  const long long* st;
  int causal;
  float scale;
  DropoutArgs dr;
  cudaStream_t stream;
  bool aligned() const {
    return rows_16b(q, strides_at(st, 0), dm.D) &&
           rows_16b(k, strides_at(st, 1), dm.D) &&
           rows_16b(v, strides_at(st, 2), dm.D) &&
           rows_16b(dO, strides_at(st, 3), dm.D);
  }
};

// L<T, DP, AL>::run(c) launches one instantiation: DP = 32, 64 or 128, the
// least that holds D (zero-padded), AL = 16-byte copies. Three buckets keep
// the build at 24 tensor-core kernels; a D between buckets (D=40 in the
// checks) costs padded work on cases no main path runs.
template <template <typename, int, bool> class L, typename T, int DP>
static int launch_tc_dp(const BwdCall& c) {
  return c.aligned() ? L<T, DP, true>::run(c) : L<T, DP, false>::run(c);
}

template <template <typename, int, bool> class L, typename T>
static int launch_tc(const BwdCall& c) {
  if (c.dm.D <= 32) return launch_tc_dp<L, T, 32>(c);
  if (c.dm.D <= 64) return launch_tc_dp<L, T, 64>(c);
  if (c.dm.D <= 128) return launch_tc_dp<L, T, 128>(c);
  return (int)cudaErrorInvalidValue;
}

// the instantiation by dtype: fp32 FMA, bf16 / fp16 tensor cores
template <template <typename, int, bool> class L>
static int launch_bwd(int dtype, const BwdCall& c,
                      int (*launch_f32)(const BwdCall&)) {
  switch (dtype) {
    case kF32:
      return launch_f32(c);
    case kBF16:
      return launch_tc<L, __nv_bfloat16>(c);
    case kF16:
      return launch_tc<L, __half>(c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

static inline BwdCall bwd_call(const void* q, const void* k, const void* v,
                               const void* dO, const float* lse,
                               const float* delta, const int* seg,
                               void* out0, void* out1,
                               const long long* dims,
                               const long long* strides, int causal,
                               float scale, int dropout, uint32_t seed,
                               uint32_t threshold, float keep_prob,
                               void* stream) {
  return BwdCall{q, k, v, dO, lse, delta, seg, out0, out1,
                 Dims{(int)dims[0], (int)dims[1], (int)dims[2],
                      (int)dims[3], (int)dims[4], (int)dims[5]},
                 strides, causal, scale,
                 DropoutArgs{dropout, seed, threshold, keep_prob},
                 static_cast<cudaStream_t>(stream)};
}

}  // namespace galv
