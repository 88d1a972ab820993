// K2 and K3: flash-attention backward.
//
// K2 replaces hetu_galvatron_tpu/ops/pallas/flash_attention.py::
// _flash_bwd_dkdv_kernel (pallas_call at :449) and K3 replaces
// _flash_bwd_dq_kernel (pallas_call at :501), both launched by
// flash_attention_bwd_hmajor (:388). Like the TPU kernels they take o's
// logsumexp (and delta = rowsum(dO * O), computed outside) from the caller
// and recompute p = exp(s - lse) per tile, so no [S, Sk] array is stored.
//
// The TPU grid carried dk/dv across its sequential (G, q-block) axes and dq
// across its k-block axis in VMEM scratch. Blocks on Hopper run in no order,
// so each becomes a loop inside one CUDA block:
//   K2: one block per (k-tile, kv-head, batch) loops over the G query heads
//       of its kv head and the q-tiles from the causal diagonal down,
//       accumulating dk and dv in registers and writing them once (no
//       atomics, GQA groups reduce on chip);
//   K3: one block per (q-tile, head, batch) loops over the k-tiles up to
//       the diagonal, accumulating dq in registers.
//
// Bound on an H100 at B=8, N=12, S=1024, D=64 causal: four tile products in
// K2 and three in K3, each about 6.4 GFLOP over the kept pairs, about 26 us
// and 20 us of bf16 tensor-core time; their HBM traffic (each input read
// once, each output written once: about 76 MB and 64 MB) is 23 us and 19 us,
// so both are bound by operations. Like K1, this first version runs fp32
// FMA on shared-memory tiles and is far from that bound; it keeps the score,
// probability and ds tiles on chip and skips tiles past the diagonal.
#include "flash_common.cuh"

namespace galv {

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

template <typename T>
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

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, Dims dm, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dks, Strides dvs, int causal,
    float scale, DropoutArgs dr) {
  extern __shared__ float smem[];
  const int D = dm.D, LD = D + 1, LP = BK + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Pd = dOs + BQ * LD;
  float* DS = Pd + BQ * LP;
  float* lse_s = DS + BQ * LP;
  float* delta_s = lse_s + BQ;
  int* qseg = reinterpret_cast<int*>(delta_s + BQ);
  int* kseg = qseg + BQ;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = dm.N / dm.K;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * BK;
  load_tile(Ks, LD, k + b * ks.b + kh * ks.h, ks, k0, dm.Sk, D, 1.f);
  load_tile(Vs, LD, v + b * vs.b + kh * vs.h, vs, k0, dm.Sk, D, 1.f);
  if (seg != nullptr)
    for (int c = tid; c < BK; c += NT)
      kseg[c] = k0 + c < dm.Sk ? seg[(long long)b * dm.S + k0 + c] : -2;

  float dka[4][NDS], dva[4][NDS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) dka[i][jd] = dva[i][jd] = 0.f;

  const int num_q = (dm.S + BQ - 1) / BQ;
  // q tiles entirely above the causal diagonal contribute nothing
  const int first_q = causal ? k0 / BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int n = kh * G + g;
    const long long row0 = ((long long)b * dm.N + n) * dm.S;
    const uint32_t key = head_key(dr.seed, (uint32_t)(b * dm.N + n));
    const T* qb = q + b * qs.b + n * qs.h;
    const T* ob = dO + b * dos.b + n * dos.h;
    for (int qt = first_q; qt < num_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's accumulation is done
      load_tile(Qs, LD, qb, qs, q0, dm.S, D, 1.f);
      load_tile(dOs, LD, ob, dos, q0, dm.S, D, 1.f);
      load_rows<T>(lse_s, delta_s, qseg, lse, delta, seg, row0, b, q0, dm);
      __syncthreads();
      bwd_tile(Qs, dOs, Ks, Vs, lse_s, delta_s, qseg, kseg, Pd, DS, LD, D,
               q0, k0, dm, causal, scale, dr, key, seg != nullptr);
      __syncthreads();
      // dv += Pd^T dO, dk += dS^T Q over this tile's q rows
      for (int r = 0; r < BQ; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pd[r * LP + ty + 16 * i];
          sv[i] = DS[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int jd = 0; jd < NDS; ++jd) {
          const int col = tx + 16 * jd;
          if (col < D) {
            const float ov = dOs[r * LD + col], qv = Qs[r * LD + col];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dva[i][jd] = fmaf(pv[i], ov, dva[i][jd]);
              dka[i][jd] = fmaf(sv[i], qv, dka[i][jd]);
            }
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + kh * dks.h;
  T* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= dm.Sk) continue;
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) {
        dkb[(long long)kpos * dks.s + col] = from_float<T>(dka[i][jd]);
        dvb[(long long)kpos * dvs.s + col] = from_float<T>(dva[i][jd]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dq, Dims dm, Strides qs, Strides ks, Strides vs,
    Strides dos, Strides dqs, int causal, float scale, DropoutArgs dr) {
  extern __shared__ float smem[];
  const int D = dm.D, LD = D + 1, LP = BK + 1;
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* DS = Vs + BK * LD;
  float* lse_s = DS + BQ * LP;
  float* delta_s = lse_s + BQ;
  int* qseg = reinterpret_cast<int*>(delta_s + BQ);
  int* kseg = qseg + BQ;

  const int qt = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (dm.N / dm.K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * BQ;
  const long long row0 = ((long long)b * dm.N + n) * dm.S;
  const uint32_t key = head_key(dr.seed, (uint32_t)(b * dm.N + n));
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  load_tile(Qs, LD, q + b * qs.b + n * qs.h, qs, q0, dm.S, D, 1.f);
  load_tile(dOs, LD, dO + b * dos.b + n * dos.h, dos, q0, dm.S, D, 1.f);
  load_rows<T>(lse_s, delta_s, qseg, lse, delta, seg, row0, b, q0, dm);

  float acc[4][NDS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) acc[i][jd] = 0.f;

  const int num_k = (dm.Sk + BK - 1) / BK;
  const int last = causal ? min(num_k - 1, (q0 + BQ - 1) / BK) : num_k - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(Ks, LD, kb, ks, k0, dm.Sk, D, 1.f);
    load_tile(Vs, LD, vb, vs, k0, dm.Sk, D, 1.f);
    if (seg != nullptr)
      for (int c = tid; c < BK; c += NT)
        kseg[c] = k0 + c < dm.Sk ? seg[(long long)b * dm.S + k0 + c] : -2;
    __syncthreads();
    bwd_tile(Qs, dOs, Ks, Vs, lse_s, delta_s, qseg, kseg, nullptr, DS, LD,
             D, q0, k0, dm, causal, scale, dr, key, seg != nullptr);
    __syncthreads();
    // dq += dS K
    for (int c = 0; c < BK; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = DS[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int jd = 0; jd < NDS; ++jd) {
        const int col = tx + 16 * jd;
        if (col < D) {
          const float kv = Ks[c * LD + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(sv[i], kv, acc[i][jd]);
        }
      }
    }
  }

  T* dqb = dq + b * dqs.b + n * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= dm.S) continue;
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) dqb[(long long)qpos * dqs.s + col] = from_float<T>(acc[i][jd]);
    }
  }
}

static Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename T>
static int launch_dkdv(const void* q, const void* k, const void* v,
                       const void* dO, const float* lse, const float* delta,
                       const int* seg, void* dk, void* dv, Dims dm,
                       const long long* st, int causal, float scale,
                       DropoutArgs dr, cudaStream_t stream) {
  const int LD = dm.D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * LD +
                       2 * (size_t)BQ * (BK + 1) + 2 * BQ) +
      sizeof(int) * (BQ + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((dm.Sk + BK - 1) / BK, dm.K, dm.B);
  flash_bwd_dkdv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta, seg,
      static_cast<T*>(dk), static_cast<T*>(dv), dm, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), causal, scale, dr);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dO, const float* lse, const float* delta,
                     const int* seg, void* dq, Dims dm, const long long* st,
                     int causal, float scale, DropoutArgs dr,
                     cudaStream_t stream) {
  const int LD = dm.D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * LD +
                       (size_t)BQ * (BK + 1) + 2 * BQ) +
      sizeof(int) * (BQ + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((dm.S + BQ - 1) / BQ, dm.N, dm.B);
  flash_bwd_dq_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), lse, delta, seg,
      static_cast<T*>(dq), dm, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), causal, scale,
      dr);
  return (int)cudaGetLastError();
}

}  // namespace galv

// Operands: inputs, segment ids (or null), outputs. dims: B, N, K, S, Sk,
// D; strides: (batch, head, position) of q, k, v, dO, dk, dv. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int galv_flash_bwd_dkdv(int dtype, const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse, const float* delta,
                                   const int* seg, void* dk, void* dv,
                                   const long long* dims,
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
      return launch_dkdv<float>(q, k, v, dO, lse, delta, seg, dk, dv, dm,
                                strides, causal, scale, dr, s);
    case kBF16:
      return launch_dkdv<__nv_bfloat16>(q, k, v, dO, lse, delta, seg, dk, dv,
                                        dm, strides, causal, scale, dr, s);
    case kF16:
      return launch_dkdv<__half>(q, k, v, dO, lse, delta, seg, dk, dv, dm,
                                 strides, causal, scale, dr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// strides: (batch, head, position) of q, k, v, dO, dq.
extern "C" int galv_flash_bwd_dq(int dtype, const void* q, const void* k,
                                 const void* v, const void* dO,
                                 const float* lse, const float* delta,
                                 const int* seg, void* dq,
                                 const long long* dims,
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
      return launch_dq<float>(q, k, v, dO, lse, delta, seg, dq, dm, strides,
                              causal, scale, dr, s);
    case kBF16:
      return launch_dq<__nv_bfloat16>(q, k, v, dO, lse, delta, seg, dq, dm,
                                      strides, causal, scale, dr, s);
    case kF16:
      return launch_dq<__half>(q, k, v, dO, lse, delta, seg, dq, dm, strides,
                               causal, scale, dr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
