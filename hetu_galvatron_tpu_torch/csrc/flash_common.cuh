// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_dq.cu).
//
// Layout contract (checked by ops/flash_attention.py before any launch):
//   q, o, dO, dq  logical [B, N, S, D];  k, v, dk, dv  logical [B, K, Sk, D]
//   Each is addressed through three element strides (batch, head, position)
//   with a unit stride along D, so the wrapper can hand over views of the
//   fused qkv projection without copying. lse and delta are [B, N, S] fp32,
//   contiguous; segment ids are [B, S] int32, contiguous (S == Sk).
//
// The fp32 FMA kernels of K1-K3 (the bf16/fp16 kernels run on the tensor
// cores, with their tiles in flash_tc.cuh) use BQ x BK = 64 x 64 tiles;
// 256 threads form a 16 x 16 grid and thread (ty, tx) owns rows ty + 16 i
// and columns tx + 16 j (i, j < 4) of a score tile, and the same rows x
// columns tx + 16 jd of a [64, D] tile. Their arithmetic is fp32 FMA on
// shared-memory tiles (padded by one column so the strided row reads fall
// in distinct banks).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace galv {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int MAXD = 128;
constexpr int NDS = MAXD / 16;  // D columns a thread owns, at most
// the JAX kernels mask with finfo(float32).min, not -inf
constexpr float NEG_INF = -3.4028234663852886e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// splitmix32 finalizer: the exact integer chain of keep_mask in
// hetu_galvatron_tpu/ops/pallas/flash_attention.py (uint32 wrap-around).
__device__ __forceinline__ uint32_t fin32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t head_key(uint32_t seed, uint32_t bn) {
  return fin32(seed * 0x9E3779B9u + bn);
}

__device__ __forceinline__ bool keep(uint32_t key, int qpos, int kpos,
                                     uint32_t threshold) {
  return fin32(fin32((uint32_t)qpos ^ key) ^ (uint32_t)kpos) < threshold;
}

struct Dims {
  int B, N, K, S, Sk, D;
};

// per-operand (batch, head, position) element strides
struct Strides {
  long long b, h, s;
};

struct DropoutArgs {
  int on;
  uint32_t seed;
  uint32_t threshold;
  float keep_prob;
};

// [rows, D] tile of a strided operand -> fp32 shared memory (row stride ld),
// zero-filled past `limit` positions; optionally scaled
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          Strides st, int pos0, int limit,
                                          int D, float mul) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    int r = idx / D;
    int c = idx - r * D;
    int pos = pos0 + r;
    dst[r * ld + c] =
        pos < limit ? to_float(base[(long long)pos * st.s + c]) * mul : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, 16));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, 16);
  return v;
}

// dtype codes shared with ops/_build.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// the kernel a K1 / K2 launch runs, chosen by ops/flash_attention.py::
// kernel_route before the launch: the fp32 FMA kernel, the mma.sync
// tensor-core kernel, or the warp-specialised wgmma + TMA kernel
enum Route { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

}  // namespace galv
