// Shared pieces of the flash backward kernels K2 (flash_bwd.cu) and K3
// (flash_bwd_dq.cu); the design note is at the top of flash_bwd.cu.
#pragma once

#include "flash_tc.cuh"

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
// bf16 / fp16: tensor-core kernels (tiles and helpers in flash_tc.cuh)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// launch plumbing
// ---------------------------------------------------------------------------

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
