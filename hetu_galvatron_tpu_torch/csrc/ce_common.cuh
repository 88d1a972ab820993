// Shared pieces of the fused cross-entropy kernels (ce_fwd.cu, ce_bwd.cu).
//
// Layout contract (checked by ops/cross_entropy.py before any launch):
//   logits  logical [T, V], unit stride along V, row stride ld >= V
//   labels  [T] int64, contiguous; a label outside [0, V) gathers 0 and
//           puts no one-hot into the backward (vocab shards feed them so)
//   lse, gold, a, b  [T] fp32, contiguous
//   dlogits [T, V] in the logits dtype, row stride ldo
// A row is read with 16-byte vector loads when its start is 16-byte aligned
// for every row (base pointer aligned, ld a multiple of the vector width);
// the launcher checks that and picks the scalar instantiation otherwise.
#pragma once

#include "flash_common.cuh"

namespace galv {

constexpr int CE_NT = 256;  // threads per block of both kernels

// elements of T in one 16-byte vector
template <typename T> struct VecWidth {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p,
                                         float (&out)[VecWidth<T>::N]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VecWidth<T>::N; ++i) out[i] = to_float(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p,
                                          const float (&v)[VecWidth<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VecWidth<T>::N; ++i) e[i] = from_float<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
inline bool rows_aligned(const void* base, long long ld) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         ld % VecWidth<T>::N == 0;
}

}  // namespace galv
