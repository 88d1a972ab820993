// K5: fused cross-entropy backward, dlogits = exp(x - lse) * a - onehot * b.
//
// Replaces hetu_galvatron_tpu/ops/pallas/cross_entropy.py::_ce_bwd_kernel
// (launched by _ce_bwd_call, pallas_call at :126). The autograd Function
// passes a = d_lse and b = -d_gold per row, so a z-loss on lse arrives
// folded into a. The TPU grid (T-block, V-block) was parallel on both axes,
// and so is this one: a 2-D grid of (row, vocab chunk) blocks, each thread
// computing 16-byte vectors of the chunk from the row's lse, a, b and label,
// which every thread of the block reads once.
//
// Bound on an H100: one read of the logits and one write of dlogits in the
// logits dtype. At T = 8192, V = 152064 in fp32 that is 9.96 GB, about
// 2.97 ms at 3.35 TB/s (1.49 ms in bf16); the exponentials are well under
// that. So it is bound by bytes, and the design is a single streaming
// pass: each element is loaded once, written once, and nothing else moves.
#include "ce_common.cuh"

namespace galv {

constexpr int CE_BWD_ITERS = 4;  // vectors per thread per block

template <typename T, bool VEC>
__global__ void __launch_bounds__(CE_NT)
    ce_bwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ a,
                  const float* __restrict__ b, T* __restrict__ dx, int V,
                  long long ld, long long ldo) {
  constexpr int N = VEC ? VecWidth<T>::N : 1;
  constexpr int CHUNK = CE_NT * N * CE_BWD_ITERS;
  const long long row = blockIdx.x;
  const float rl = lse[row], ra = a[row], rb = b[row];
  const long long lab = labels[row];
  const T* xr = x + row * ld;
  T* dr = dx + row * ldo;
  const int start = blockIdx.y * CHUNK;
  const int stop = min(start + CHUNK, V);
  if constexpr (VEC) {
    const int vstop = start + (stop - start) / N * N;
#pragma unroll
    for (int it = 0; it < CE_BWD_ITERS; ++it) {
      const int e = start + (it * CE_NT + threadIdx.x) * N;
      if (e < vstop) {
        float v[N];
        load_vec<T>(xr + e, v);
#pragma unroll
        for (int j = 0; j < N; ++j)
          v[j] = __expf(v[j] - rl) * ra - (e + j == lab ? rb : 0.f);
        store_vec<T>(dr + e, v);
      }
    }
    // the row's tail past the last whole vector (only in the last chunk)
    for (int e = vstop + threadIdx.x; e < stop; e += CE_NT) {
      dr[e] = from_float<T>(__expf(to_float(xr[e]) - rl) * ra -
                            (e == lab ? rb : 0.f));
    }
  } else {
    for (int e = start + threadIdx.x; e < stop; e += CE_NT) {
      dr[e] = from_float<T>(__expf(to_float(xr[e]) - rl) * ra -
                            (e == lab ? rb : 0.f));
    }
  }
}

template <typename T, bool VEC>
static void launch_ce_bwd_as(const void* x, const long long* labels,
                             const float* lse, const float* a, const float* b,
                             void* dx, long long T_, long long V, long long ld,
                             long long ldo, cudaStream_t stream) {
  constexpr int N = VEC ? VecWidth<T>::N : 1;
  constexpr long long CHUNK = (long long)CE_NT * N * CE_BWD_ITERS;
  dim3 grid((unsigned)T_, (unsigned)((V + CHUNK - 1) / CHUNK));
  ce_bwd_kernel<T, VEC><<<grid, CE_NT, 0, stream>>>(
      static_cast<const T*>(x), labels, lse, a, b, static_cast<T*>(dx),
      (int)V, ld, ldo);
}

template <typename T>
static int launch_ce_bwd(const void* x, const long long* labels,
                         const float* lse, const float* a, const float* b,
                         void* dx, long long T_, long long V, long long ld,
                         long long ldo, cudaStream_t stream) {
  if (rows_aligned<T>(x, ld) && rows_aligned<T>(dx, ldo))
    launch_ce_bwd_as<T, true>(x, labels, lse, a, b, dx, T_, V, ld, ldo,
                              stream);
  else
    launch_ce_bwd_as<T, false>(x, labels, lse, a, b, dx, T_, V, ld, ldo,
                               stream);
  return (int)cudaGetLastError();
}

}  // namespace galv

// logits [T, V] (row stride ld), labels [T] int64, lse/a/b [T] fp32;
// writes dlogits [T, V] (row stride ldo) in the logits dtype. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int galv_ce_bwd(int dtype, const void* logits,
                           const long long* labels, const float* lse,
                           const float* a, const float* b, void* dlogits,
                           long long T, long long V, long long ld,
                           long long ldo, void* stream) {
  using namespace galv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_ce_bwd<float>(logits, labels, lse, a, b, dlogits, T, V, ld,
                                  ldo, s);
    case kBF16:
      return launch_ce_bwd<__nv_bfloat16>(logits, labels, lse, a, b, dlogits,
                                          T, V, ld, ldo, s);
    case kF16:
      return launch_ce_bwd<__half>(logits, labels, lse, a, b, dlogits, T, V,
                                   ld, ldo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
