// K3: flash-attention backward, dq. The design note of K2 and K3 is at the
// top of flash_bwd.cu; this file holds K3 so that nvcc builds the two
// kernels' instantiations in parallel.
#include "flash_bwd.cuh"

namespace galv {

__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, float* __restrict__ dq, Dims dm,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, int causal,
    float scale, DropoutArgs dr) {
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
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  load_tile(Qs, LD, q + b * qs.b + n * qs.h, qs, q0, dm.S, D, 1.f);
  load_tile(dOs, LD, dO + b * dos.b + n * dos.h, dos, q0, dm.S, D, 1.f);
  load_rows(lse_s, delta_s, qseg, lse, delta, seg, row0, b, q0, dm);

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

  float* dqb = dq + b * dqs.b + n * dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= dm.S) continue;
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) dqb[(long long)qpos * dqs.s + col] = acc[i][jd];
    }
  }
}

static int launch_dq_f32(const BwdCall& c) {
  const int LD = c.dm.D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * LD +
                       (size_t)BQ * (BK + 1) + 2 * BQ) +
      sizeof(int) * (BQ + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c.dm.S + BQ - 1) / BQ, c.dm.N, c.dm.B);
  flash_bwd_dq_kernel<<<grid, NT, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.dO),
      c.lse, c.delta, c.seg, static_cast<float*>(c.out0), c.dm,
      strides_at(c.st, 0), strides_at(c.st, 1), strides_at(c.st, 2),
      strides_at(c.st, 3), strides_at(c.st, 4), c.causal, c.scale, c.dr);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool AL>
__global__ void __launch_bounds__(TC_NT, Tc<T, DP>::K3_MINB)
    flash_bwd_dq_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dq, Dims dm, Strides qs,
    Strides ks, Strides vs, Strides dos, Strides dqs, int causal,
    float scale, DropoutArgs dr) {
  using C = Tc<T, DP>;
  constexpr int LDS = C::LDS, BQT = C::K3_BQ, BKT = C::K3_BK;
  constexpr int NK8 = BKT / 8, ND8 = DP / 8, KD = DP / 16, KK = BKT / 16;
  constexpr int SMEM = C::K3_SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQT * LDS;
  T* Ks = dOs + BQT * LDS;       // two stages
  T* Vs = Ks + 2 * BKT * LDS;    // two stages
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * BKT * LDS);  // two stages
  float* lse_s = reinterpret_cast<float*>(kseg_s + 2 * BKT);  // * log2(e)
  float* delta_s = lse_s + BQT;
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQT);

  // the q-tile index varies slowest, from the last: under causality the
  // high q-tiles loop over the most k-tiles, and they are issued first
  const int nqt = (dm.S + BQT - 1) / BQT;
  const int NB = dm.N * dm.B;
  const int qr_ = blockIdx.x / NB, rem = blockIdx.x - qr_ * NB;
  const int qt = nqt - 1 - qr_, n = rem % dm.N, b = rem / dm.N;
  const int kh = n / (dm.N / dm.K), q0 = qt * BQT;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = w * 16 + gq;  // this thread's q rows: r0, r0 + 8
  const float scale2 = scale * LOG2E, inv_keep = 1.f / dr.keep_prob;
  const bool has_seg = seg != nullptr;

  const int nkt = (dm.Sk + BKT - 1) / BKT;
  const int last = causal ? min(nkt - 1, (q0 + BQT - 1) / BKT) : nkt - 1;
  unsigned char* tflag = smem_raw + SMEM;
  for (int i = threadIdx.x; i < SMEM / 16; i += TC_NT)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  if (has_seg)
    tile_flags(tflag, seg + (long long)b * dm.S, q0, BQT, dm.S, 0, last + 1,
               BKT, dm.Sk);
  __syncthreads();
  load_tile_tc<T, DP, BQT, AL>(Qs, q + b * qs.b + n * qs.h, qs.s, q0, dm.S,
                               dm.D);
  load_tile_tc<T, DP, BQT, AL>(dOs, dO + b * dos.b + n * dos.h, dos.s, q0,
                               dm.S, dm.D);
  const long long row0 = ((long long)b * dm.N + n) * dm.S;
  for (int r = threadIdx.x; r < BQT; r += TC_NT) {
    const int qpos = q0 + r;
    const bool in = qpos < dm.S;
    lse_s[r] = in ? lse[row0 + qpos] * LOG2E : 0.f;
    delta_s[r] = in ? delta[row0 + qpos] : 0.f;
    qseg_s[r] = in && has_seg ? seg[(long long)b * dm.S + qpos] : -1;
  }
  // the k-tiles that pair with this q-tile: up to the causal diagonal, with
  // overlapping segment ranges
  auto next_k = [&](int kt) {
    if (has_seg)
      while (kt <= last && tflag[kt] == 0) ++kt;
    return kt;
  };
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  auto issue = [&](int kt, int st) {
    const int k0 = kt * BKT;
    load_tile_tc<T, DP, BKT, AL>(Ks + st * BKT * LDS, kb, ks.s, k0, dm.Sk,
                                 dm.D);
    load_tile_tc<T, DP, BKT, AL>(Vs + st * BKT * LDS, vb, vs.s, k0, dm.Sk,
                                 dm.D);
    if (has_seg)
      load_vec_tc(kseg_s + st * BKT, seg + (long long)b * dm.S + k0,
                  dm.Sk - k0, BKT);
  };
  const uint32_t key =
      dr.on ? head_key(dr.seed, (uint32_t)(b * dm.N + n)) : 0u;

  float dqa[ND8][4];
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  int kt = next_k(0), st = 0;
  if (kt <= last) issue(kt, 0);
  mma::cp_commit();  // q, dO and the first k-tile
  while (kt <= last) {
    const int nk = next_k(kt + 1);
    const bool more = nk <= last;
    if (more) issue(nk, st ^ 1);
    mma::cp_commit();
    mma::cp_wait<1>();
    __syncthreads();

    const int k0 = kt * BKT;
    const T* Kt = Ks + st * BKT * LDS;
    const T* Vt = Vs + st * BKT * LDS;
    const int* ksg = kseg_s + st * BKT;
    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x BKT k columns
    float s[NK8][4], dp[NK8][4];
#pragma unroll
    for (int j = 0; j < NK8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t aq[4], ao[4];
      const int aofs = (w * 16 + mma::a_row(lane)) * LDS + kd * 16 +
                       mma::a_col(lane);
      mma::ldsm_x4(aq, mma::smem_u32(Qs + aofs));
      mma::ldsm_x4(ao, mma::smem_u32(dOs + aofs));
#pragma unroll
      for (int j = 0; j < NK8 / 2; ++j) {
        uint32_t bk[4], bv[4];
        const int bofs = (j * 16 + mma::b_row(lane)) * LDS + kd * 16 +
                         mma::b_col(lane);
        mma::ldsm_x4(bk, mma::smem_u32(Kt + bofs));
        mma::ldsm_x4(bv, mma::smem_u32(Vt + bofs));
        mma::mma16816<T>(s[2 * j], aq, bk[0], bk[1]);
        mma::mma16816<T>(s[2 * j + 1], aq, bk[2], bk[3]);
        mma::mma16816<T>(dp[2 * j], ao, bv[0], bv[1]);
        mma::mma16816<T>(dp[2 * j + 1], ao, bv[2], bv[3]);
      }
    }
    // an edge tile needs the mask; elsewhere every pair is attended
    bool edge = q0 + BQT > dm.S || k0 + BKT > dm.Sk ||
                (causal && q0 < k0 + BKT - 1);
    if (has_seg) edge = edge || tflag[kt] != 2;
    with_cases(edge, dr.on, [&](auto edge_c, auto drop_c) {
#pragma unroll
      for (int j = 0; j < NK8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int c = j * 8 + 2 * tq + (e & 1);
          const int qpos = q0 + r0 + 8 * h, kpos = k0 + c;
          bool ok = true;
          if constexpr (decltype(edge_c)::value) {
            ok = qpos < dm.S && kpos < dm.Sk;
            if (causal) ok = ok && qpos >= kpos;
            if (has_seg) ok = ok && qseg_s[qpos - q0] == ksg[c];
          }
          p_ds<decltype(drop_c)::value>(s[j][e], dp[j][e], ok,
                                        lse_s[qpos - q0], delta_s[qpos - q0],
                                        scale, scale2, key,
                                        dr.threshold, inv_keep, qpos, kpos);
        }
    });
    // dQ += dS K; dS is the A operand, rounded to T in registers (in bf16
    // as hi + lo, two products)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t as[4], asl[4];
      if constexpr (C::SPLIT)
        mma::pack_a_split<T>(as, asl, dp[2 * kk], dp[2 * kk + 1]);
      else
        mma::pack_a<T>(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < ND8 / 2; ++jd) {
        uint32_t bk[4];
        const int bofs = (kk * 16 + mma::bt_row(lane)) * LDS + jd * 16 +
                         mma::bt_col(lane);
        mma::ldsm_x4_trans(bk, mma::smem_u32(Kt + bofs));
        mma::mma16816<T>(dqa[2 * jd], as, bk[0], bk[1]);
        mma::mma16816<T>(dqa[2 * jd + 1], as, bk[2], bk[3]);
        if constexpr (C::SPLIT) {
          mma::mma16816<T>(dqa[2 * jd], asl, bk[0], bk[1]);
          mma::mma16816<T>(dqa[2 * jd + 1], asl, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the prefetch after next
    if (!more) break;
    kt = nk;
    st ^= 1;
  }
  mma::cp_wait<0>();

  T* dqb = dq + b * dqs.b + n * dqs.h;
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = q0 + r0 + ((e >> 1) << 3);
      const int c = j * 8 + 2 * tq + (e & 1);
      if (qpos < dm.S && c < dm.D)
        dqb[(long long)qpos * dqs.s + c] = from_float<T>(dqa[j][e]);
    }
}

template <typename T, int DP, bool AL>
struct DqTc {
  static int run(const BwdCall& c) {
    using C = Tc<T, DP>;
    const int smem = C::K3_SMEM +
                     flag_bytes(c.seg, (c.dm.Sk + C::K3_BK - 1) / C::K3_BK);
    auto kern = flash_bwd_dq_kernel_tc<T, DP, AL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int nqt = (c.dm.S + C::K3_BQ - 1) / C::K3_BQ;
    kern<<<nqt * c.dm.N * c.dm.B, TC_NT, smem, c.stream>>>(
        static_cast<const T*>(c.q), static_cast<const T*>(c.k),
        static_cast<const T*>(c.v), static_cast<const T*>(c.dO), c.lse,
        c.delta, c.seg, static_cast<T*>(c.out0), c.dm,
        strides_at(c.st, 0), strides_at(c.st, 1), strides_at(c.st, 2),
        strides_at(c.st, 3), strides_at(c.st, 4), c.causal, c.scale, c.dr);
    return (int)cudaGetLastError();
  }
};

}  // namespace galv

// Operands as galv_flash_bwd_dkdv; strides: (batch, head, position) of q,
// k, v, dO, dq.
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
  return launch_bwd<DqTc>(
      dtype,
      bwd_call(q, k, v, dO, lse, delta, seg, dq, nullptr, dims,
               strides, causal, scale, dropout, seed, threshold, keep_prob,
               stream),
      launch_dq_f32);
}
