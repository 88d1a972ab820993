// K4: fused cross-entropy forward, online logsumexp over the vocabulary plus
// the gold-logit gather.
//
// Replaces hetu_galvatron_tpu/ops/pallas/cross_entropy.py::_ce_fwd_kernel
// (launched by _ce_fwd_call, pallas_call at :95). The TPU grid (T-block,
// V-block) ran the vocab axis in order and carried the running max,
// normaliser and gold accumulator in VMEM scratch; here one CUDA block owns
// one row and its threads stride over the whole vocabulary, each keeping a
// running (max, sum) in fp32 registers with online rescaling; a warp-shuffle
// and shared-memory merge of the (m, l) pairs ends the row. The gold logit
// is read directly when 0 <= label < V, else it is 0.
//
// Bound on an H100: the kernel reads each logit once and writes 8 bytes a
// row. At T = 8192, V = 152064 in fp32 (the training path's logits) that is
// 4.98 GB, about 1.49 ms at 3.35 TB/s (0.74 ms for bf16 logits); the T*V =
// 1.25 G exponentials are well under that. So it is bound by bytes, and the
// design reads every logit exactly once with 16-byte vector loads, several
// in flight per thread, and keeps everything else in registers.
#include "ce_common.cuh"

namespace galv {

constexpr int CE_FWD_UNROLL = 4;  // vector loads in flight per thread

__device__ __forceinline__ void merge_ml(float& m, float& l, float om,
                                         float ol) {
  const float nm = fmaxf(m, om);
  l = l * __expf(m - nm) + ol * __expf(om - nm);
  m = nm;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(CE_NT)
    ce_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
                  float* __restrict__ lse, float* __restrict__ gold, int V,
                  long long ld) {
  const long long row = blockIdx.x;
  const T* xr = x + row * ld;
  // the JAX kernel starts the running max at finfo(float32).min, so an
  // empty share of the row merges as exp(very negative) = 0
  float m = NEG_INF, l = 0.f;
  int done = 0;
  if constexpr (VEC) {
    constexpr int N = VecWidth<T>::N;
    const int nvec = V / N;
    for (int i0 = threadIdx.x; i0 < nvec; i0 += CE_NT * CE_FWD_UNROLL) {
      float v[CE_FWD_UNROLL][N];
#pragma unroll
      for (int u = 0; u < CE_FWD_UNROLL; ++u) {
        const int i = i0 + u * CE_NT;
        if (i < nvec) {
          load_vec<T>(xr + (long long)i * N, v[u]);
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) v[u][j] = NEG_INF;
        }
      }
#pragma unroll
      for (int u = 0; u < CE_FWD_UNROLL; ++u) {
        float cm = v[u][0];
#pragma unroll
        for (int j = 1; j < N; ++j) cm = fmaxf(cm, v[u][j]);
        const float nm = fmaxf(m, cm);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < N; ++j) s += __expf(v[u][j] - nm);
        // a padded vector (all NEG_INF) adds exp(0) = 1 per element only
        // when the row so far is empty too; skip it instead
        if (i0 + u * CE_NT < nvec) {
          l = l * __expf(m - nm) + s;
          m = nm;
        }
      }
    }
    done = nvec * N;
  }
  for (int i = done + threadIdx.x; i < V; i += CE_NT) {
    const float xv = to_float(xr[i]);
    const float nm = fmaxf(m, xv);
    l = l * __expf(m - nm) + __expf(xv - nm);
    m = nm;
  }

  // merge the threads' (m, l): within each warp, then across warps
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float ol = __shfl_xor_sync(0xffffffffu, l, off);
    merge_ml(m, l, om, ol);
  }
  __shared__ float sm[CE_NT / 32], sl[CE_NT / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < CE_NT / 32 ? sm[lane] : NEG_INF;
    l = lane < CE_NT / 32 ? sl[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const float ol = __shfl_xor_sync(0xffffffffu, l, off);
      merge_ml(m, l, om, ol);
    }
    if (lane == 0) {
      // lse = m + log(max(l, 1e-30)), as the JAX kernel's _fin
      lse[row] = m + logf(fmaxf(l, 1e-30f));
      const long long lab = labels[row];
      gold[row] = (lab >= 0 && lab < V) ? to_float(xr[lab]) : 0.f;
    }
  }
}

template <typename T>
static int launch_ce_fwd(const void* x, const long long* labels, float* lse,
                         float* gold, long long T_, long long V, long long ld,
                         cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  dim3 grid((unsigned)T_);
  if (rows_aligned<T>(x, ld))
    ce_fwd_kernel<T, true><<<grid, CE_NT, 0, stream>>>(xp, labels, lse, gold,
                                                        (int)V, ld);
  else
    ce_fwd_kernel<T, false><<<grid, CE_NT, 0, stream>>>(xp, labels, lse, gold,
                                                         (int)V, ld);
  return (int)cudaGetLastError();
}

}  // namespace galv

// logits [T, V] (row stride ld, unit stride along V), labels [T] int64;
// writes lse and gold [T] fp32. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int galv_ce_fwd(int dtype, const void* logits,
                           const long long* labels, float* lse, float* gold,
                           long long T, long long V, long long ld,
                           void* stream) {
  using namespace galv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_ce_fwd<float>(logits, labels, lse, gold, T, V, ld, s);
    case kBF16:
      return launch_ce_fwd<__nv_bfloat16>(logits, labels, lse, gold, T, V, ld,
                                          s);
    case kF16:
      return launch_ce_fwd<__half>(logits, labels, lse, gold, T, V, ld, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
