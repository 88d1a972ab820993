// K1: flash-attention forward.
//
// Replaces hetu_galvatron_tpu/ops/pallas/flash_attention.py::_flash_kernel
// (launched by flash_attention_hmajor, pallas_call at :220). The TPU grid
// (B, N, q-block, k-block) ran the k-block axis in order and carried the
// online-softmax state in VMEM scratch; here one CUDA block owns one
// (q-tile, head, batch) and walks the k-tiles in a loop, keeping the running
// max, normaliser and the [64, D] accumulator in registers.
//
// Bound on an H100: at B=8, N=12, S=1024, D=64 causal the work is about
// 12.9 GFLOP (two products over the S(S+1)/2 kept pairs) against 50.7 MB of
// q/k/v/o/lse traffic, i.e. about 13 us of bf16 tensor-core time and 15 us of
// HBM time: bound by bytes. This first version computes in fp32 FMA on
// shared-memory tiles (no tensor cores, no TMA), so it sits far above that
// bound; what the design does get right is the memory side: the [S, Sk]
// score matrix never leaves the SM, each q tile reads k/v once per k-tile,
// and tiles past the causal diagonal are skipped. A ragged tail (S or Sk not a multiple of 64) is
// masked in-kernel, so any length runs.
#include "flash_common.cuh"

namespace galv {

template <typename T>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ seg,
                     Dims dm, Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, float scale, DropoutArgs dr) {
  extern __shared__ float smem[];
  const int D = dm.D, LD = D + 1, LP = BK + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  int* qseg = reinterpret_cast<int*>(Ps + BQ * LP);
  int* kseg = qseg + BQ;

  const int qt = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (dm.N / dm.K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * BQ;
  const T* qb = q + b * qs.b + n * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  const uint32_t key = head_key(dr.seed, (uint32_t)(b * dm.N + n));

  // the JAX kernel scales q before the q.k product
  load_tile(Qs, LD, qb, qs, q0, dm.S, D, scale);
  if (seg != nullptr)
    for (int r = tid; r < BQ; r += NT)
      qseg[r] = q0 + r < dm.S ? seg[(long long)b * dm.S + q0 + r] : -1;

  float m[4], l[4], acc[4][NDS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) acc[i][jd] = 0.f;
  }

  const int num_k = (dm.Sk + BK - 1) / BK;
  const int last = causal ? min(num_k - 1, (q0 + BQ - 1) / BK) : num_k - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P.V is done with Ks/Vs/Ps
    load_tile(Ks, LD, kb, ks, k0, dm.Sk, D, 1.f);
    load_tile(Vs, LD, vb, vs, k0, dm.Sk, D, 1.f);
    if (seg != nullptr)
      for (int c = tid; c < BK; c += NT)
        kseg[c] = k0 + c < dm.Sk ? seg[(long long)b * dm.S + k0 + c] : -2;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
      bool ok[4];
      float bm = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        ok[j] = qpos < dm.S && kpos < dm.Sk;
        if (causal) ok[j] = ok[j] && qpos >= kpos;
        if (seg != nullptr) ok[j] = ok[j] && qseg[r] == kseg[c];
        if (!ok[j]) s[i][j] = NEG_INF;
        bm = fmaxf(bm, s[i][j]);
      }
      bm = half_warp_max(bm);
      const float new_m = fmaxf(m[i], bm);
      const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - new_m);
      float p[4], ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = ok[j] ? expf(s[i][j] - new_m) : 0.f;
        ps += p[j];
      }
      ps = half_warp_sum(ps);
      // the normaliser uses the undropped p: out = dropout(softmax(s)) @ v
      l[i] = l[i] * corr + ps;
      m[i] = new_m;
#pragma unroll
      for (int jd = 0; jd < NDS; ++jd) acc[i][jd] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pj = p[j];
        if (dr.on)
          pj = keep(key, qpos, k0 + tx + 16 * j, dr.threshold)
                   ? pj / dr.keep_prob
                   : 0.f;
        Ps[r * LP + tx + 16 * j] = pj;
      }
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int jd = 0; jd < NDS; ++jd) {
        const int col = tx + 16 * jd;
        if (col < D) {
          const float vv = Vs[c * LD + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
        }
      }
    }
  }

  T* ob = o + b * os.b + n * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= dm.S) continue;
    const float lf = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) ob[(long long)qpos * os.s + col] = from_float<T>(acc[i][jd] / lf);
    }
    if (tx == 0)
      lse[((long long)b * dm.N + n) * dm.S + qpos] = m[i] + logf(lf);
  }
}

template <typename T>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      float* lse, const int* seg, Dims dm, const long long* st,
                      int causal, float scale, DropoutArgs dr,
                      cudaStream_t stream) {
  const int LD = dm.D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * (BK + 1)) +
      sizeof(int) * (BQ + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((dm.S + BQ - 1) / BQ, dm.N, dm.B);
  flash_fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, seg, dm,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, causal,
      scale, dr);
  return (int)cudaGetLastError();
}

}  // namespace galv

// Operands: inputs, segment ids (or null), outputs. dims: B, N, K, S, Sk,
// D; strides: (batch, head, position) of q, k, v, o. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int galv_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, const int* seg, void* o,
                              float* lse, const long long* dims,
                              const long long* strides, int causal,
                              float scale, int dropout, uint32_t seed,
                              uint32_t threshold, float keep_prob,
                              void* stream) {
  using namespace galv;
  Dims dm{(int)dims[0], (int)dims[1], (int)dims[2],
          (int)dims[3], (int)dims[4], (int)dims[5]};
  DropoutArgs dr{dropout, seed, threshold, keep_prob};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fwd<float>(q, k, v, o, lse, seg, dm, strides, causal,
                               scale, dr, s);
    case kBF16:
      return launch_fwd<__nv_bfloat16>(q, k, v, o, lse, seg, dm, strides,
                                       causal, scale, dr, s);
    case kF16:
      return launch_fwd<__half>(q, k, v, o, lse, seg, dm, strides, causal,
                                scale, dr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
