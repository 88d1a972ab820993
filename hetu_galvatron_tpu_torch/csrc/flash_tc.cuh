// Shared pieces of the 16-bit tensor-core flash kernels: K1 (flash_fwd.cu),
// K2 (flash_bwd.cu) and K3 (flash_bwd_dq.cu). Their tile sizes, the
// 16-bit tile copies into shared memory, the tile rule across packed
// documents, and the launch by head-size bucket and alignment.
#pragma once

#include <climits>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace galv {

constexpr int TC_NT = 128;  // four warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int DP>
struct Tc {
  static constexpr int LDS = DP + 8;  // shared-memory row, elements
  // tiles (rows of the fixed and of the streamed operand) and blocks of 4
  // warps an SM: the register caps of 3 and 4 blocks (168 and 128 a
  // thread) and of 2 and 3 above D=64 are the ones that fit without spills
  static constexpr int K1_BQ = 64;
  static constexpr int K1_BK = 64;
  static constexpr int K2_BK = 64;
  static constexpr int K2_BQ = 32;
  static constexpr int K3_BQ = 64;
  static constexpr int K3_BK = 32;
  static constexpr int K1_MINB = DP > 64 ? 2 : 4;
  static constexpr int K2_MINB = DP > 64 ? 2 : 3;
  static constexpr int K3_MINB = DP > 64 ? 3 : 4;
  // bf16 carries P (K1) and P and dS (K2/K3) as hi + lo (see the notes in
  // flash_fwd.cu and flash_bwd.cu); fp16 rounds them once
  static constexpr bool SPLIT = std::is_same<T, __nv_bfloat16>::value;
  // bytes: K1 holds q, the q rows' segment ids and two stages of k, v and
  // their segment ids; K2 holds k, v, the k rows' segment ids and two
  // stages of q, dO, lse, delta, segment ids; K3 holds q, dO, the q rows'
  // lse, delta and segment ids and two stages of k, v, segment ids; the
  // tile flags (flag_bytes) follow. Row values live here rather than in
  // registers, which the fp32 accumulators fill.
  static constexpr int K1_SMEM = (K1_BQ + 4 * K1_BK) * LDS * (int)sizeof(T) +
                                 (2 * K1_BK + K1_BQ) * 4;
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

// L<T, DP, AL>::run(c) launches one instantiation: DP = 32, 64 or 128, the
// least that holds D (zero-padded), AL = 16-byte copies (c.aligned()).
// Three buckets keep the build at 12 tensor-core kernels a kernel; a D
// between buckets (D=40 in the checks) costs padded work on cases no main
// path runs.
template <template <typename, int, bool> class L, typename T, int DP,
          typename Call>
static int launch_tc_dp(const Call& c) {
  return c.aligned() ? L<T, DP, true>::run(c) : L<T, DP, false>::run(c);
}

template <template <typename, int, bool> class L, typename T, typename Call>
static int launch_tc(const Call& c) {
  if (c.dm.D <= 32) return launch_tc_dp<L, T, 32>(c);
  if (c.dm.D <= 64) return launch_tc_dp<L, T, 64>(c);
  if (c.dm.D <= 128) return launch_tc_dp<L, T, 128>(c);
  return (int)cudaErrorInvalidValue;
}

}  // namespace galv
