// K1: flash-attention forward.
//
// Replaces hetu_galvatron_tpu/ops/pallas/flash_attention.py::_flash_kernel
// (:86, launched by flash_attention_hmajor :163, pallas_call at :220). The
// TPU grid (B, N, q-block, k-block) ran the k-block axis in order and
// carried the online-softmax state (m, l and the [block_q, D] accumulator)
// in VMEM scratch. Blocks on Hopper run in no order, so one CUDA block owns
// one (q-tile, head, batch) and walks the k-tiles in a loop, keeping that
// state in registers; the [S, Sk] scores never leave the SM.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): two tile products
// (S = Q K^T, O += P V) over the kept (q, k) pairs, against q, k, v read
// once and o, lse written once. GPT-2 small's shape (B=8, N=K=12, S=1024,
// D=64, causal): 0.0151 ms, bound by bytes. The Qwen2.5-7B path's (B=2,
// N=28, K=4, S=4096, D=128, causal, three packed documents, 39% of the
// causal pairs kept): 0.0946 ms, bound by operations
// (chip_smoke.py::bounds).
//
// Two instantiations, chosen by dtype (never after a failure):
//
// * bf16 / fp16: the tensor-core kernel (flash_fwd_kernel_tc). The first
//   version (fp32 FMA, 80-220x its bound at the two shapes) widened every
//   tile to fp32 in shared memory, multiplied in scalar FMA loops, copied
//   synchronously with a barrier between every step, and computed every
//   causal tile. What this one does instead:
//   - Tensor cores. S = Q K^T and O += P V are warp-level
//     mma.sync.m16n8k16 products with fp32 accumulation, fed by ldmatrix
//     (flash_mma.cuh). Four warps each own 16 rows of a 64-row q tile. The
//     accumulators of two neighbouring n8 tiles of S are the A fragment of
//     one k16 step of P V, so P goes from accumulator to operand in
//     registers. V is read [k][n] by ldmatrix.trans.
//   - Rounding of P. The JAX kernel keeps P in fp32. fp16 rounds it once
//     to the input dtype, as FlashAttention-2 does. In bf16 one rounding
//     kept O within its own check but moved O by enough that the backward
//     fed with it (delta = rowsum(dO * O)) put single dq elements past the
//     16-bit limit of chip_smoke.py's autograd check (3.9x) at GPT-2's
//     shape; so bf16 carries P as hi + lo, as K2/K3 carry P and dS, and
//     runs P V twice (3 products a tile instead of 2).
//   - 16-bit tiles. q, k and v stay in their dtype in [rows][DP + 8]
//     shared-memory tiles (DP = 32, 64 or 128, zero padded; the 16-byte row
//     pad keeps ldmatrix free of bank conflicts): q once, k and v through a
//     two-stage cp.async ring, so the next kept k-tile is in flight while
//     the current one's products run.
//   - The scale. 1/sqrt(D) multiplies the fp32 accumulators (folded with
//     log2(e) into exp2f). q is never pre-scaled into a 16-bit buffer: a
//     rounded q / sqrt(128) would be another function.
//   - Online softmax per row on the fp32 C layout (rows g, g + 8; columns
//     2t, 2t + 1): masks with the JAX kernel's finfo-min NEG_INF, the row
//     max reduced over the quad of lanes that share a row, m and l in fp32
//     registers (l summed per lane and over the quad at the end), O
//     rescaled by corr, which is 0 while m is still NEG_INF. l sums the
//     undropped p; the counter-based dropout then applies to p at each
//     element's global (q, k) position before P V.
//   - Tile skipping. A (q-tile, k-tile) pair is computed only where
//     causality allows some pair in it and the two tiles' segment-id ranges
//     overlap; each block reduces the ranges from the ids it reads
//     (tile_flags, flash_tc.cuh), the rule of K2/K3 and of
//     ops/flash_attention.py::computed_tiles. Computing a skipped tile
//     would leave O, m and l bitwise as they are (corr exactly 1, or 0 on
//     a row still at NEG_INF whose O and l are 0; every p 0).
//   - Branches. Each tile takes one of four branch-free copies of its
//     element loop (edge tile or not, dropout or not); a tile off the
//     causal diagonal, inside S and Sk and inside one document skips the
//     mask.
//   - Load balance: under causality the high q-tiles loop longest, so
//     blockIdx maps the q-tile index slowest and issues them first.
//   Operands whose bases or strides are not multiples of 8 elements take
//   the instantiation with element-wise loads and stores (AL = false): 12
//   tensor-core instantiations (bf16 and fp16, three DP, AL or not).
//
// * fp32: the first version's FMA kernel, unchanged: 64 x 64 tiles of fp32
//   in shared memory, 256 threads as a 16 x 16 grid, tiles past the
//   diagonal skipped. TF32 tensor cores would miss the 1e-4 fp32 checks of
//   chip_smoke.py and its fp32 reference runs.
//
// Both mask a ragged tail (S or Sk not a multiple of 64) in-kernel, so any
// length runs.
#include "flash_tc.cuh"

namespace galv {

__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
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
  const float* qb = q + b * qs.b + n * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
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

  float* ob = o + b * os.b + n * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= dm.S) continue;
    const float lf = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) ob[(long long)qpos * os.s + col] = acc[i][jd] / lf;
    }
    if (tx == 0)
      lse[((long long)b * dm.N + n) * dm.S + qpos] = m[i] + logf(lf);
  }
}

struct FwdCall {
  const void *q, *k, *v;
  const int* seg;
  void* o;
  float* lse;
  Dims dm;
  const long long* st;  // (batch, head, position) strides of q, k, v, o
  int causal;
  float scale;
  DropoutArgs dr;
  cudaStream_t stream;
  bool aligned() const {
    return rows_16b(q, strides_at(st, 0), dm.D) &&
           rows_16b(k, strides_at(st, 1), dm.D) &&
           rows_16b(v, strides_at(st, 2), dm.D) &&
           rows_16b(o, strides_at(st, 3), dm.D);
  }
};

static int launch_fwd_f32(const FwdCall& c) {
  const int LD = c.dm.D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + 2 * BK) * LD + (size_t)BQ * (BK + 1)) +
      sizeof(int) * (BQ + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c.dm.S + BQ - 1) / BQ, c.dm.N, c.dm.B);
  flash_fwd_kernel<<<grid, NT, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<float*>(c.o), c.lse, c.seg,
      c.dm, strides_at(c.st, 0), strides_at(c.st, 1), strides_at(c.st, 2),
      strides_at(c.st, 3), c.causal, c.scale, c.dr);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool AL>
__global__ void __launch_bounds__(TC_NT, Tc<T, DP>::K1_MINB)
    flash_fwd_kernel_tc(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, const int* __restrict__ seg,
                        Dims dm, Strides qs, Strides ks, Strides vs,
                        Strides os, int causal, float scale,
                        DropoutArgs dr) {
  using C = Tc<T, DP>;
  constexpr int LDS = C::LDS, BQT = C::K1_BQ, BKT = C::K1_BK;
  constexpr int NK8 = BKT / 8, ND8 = DP / 8, KD = DP / 16, KK = BKT / 16;
  constexpr int SMEM = C::K1_SMEM;
  static_assert(4 * NK8 <= 32, "one mask bit a score element");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQT * LDS;      // two stages
  T* Vs = Ks + 2 * BKT * LDS;  // two stages
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * BKT * LDS);  // two stages
  int* qseg_s = kseg_s + 2 * BKT;
  unsigned char* tflag = smem_raw + SMEM;

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
  const int* sb = has_seg ? seg + (long long)b * dm.S : nullptr;

  const int nkt = (dm.Sk + BKT - 1) / BKT;
  const int last = causal ? min(nkt - 1, (q0 + BQT - 1) / BKT) : nkt - 1;
  for (int i = threadIdx.x; i < SMEM / 16; i += TC_NT)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  if (has_seg) tile_flags(tflag, sb, q0, BQT, dm.S, 0, last + 1, BKT, dm.Sk);
  __syncthreads();
  load_tile_tc<T, DP, BQT, AL>(Qs, q + b * qs.b + n * qs.h, qs.s, q0, dm.S,
                               dm.D);
  if (has_seg)
    for (int r = threadIdx.x; r < BQT; r += TC_NT)
      qseg_s[r] = q0 + r < dm.S ? sb[q0 + r] : -1;
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
    if (has_seg) load_vec_tc(kseg_s + st * BKT, sb + k0, dm.Sk - k0, BKT);
  };
  const uint32_t key =
      dr.on ? head_key(dr.seed, (uint32_t)(b * dm.N + n)) : 0u;

  // O, and the running max (in units of log2, scaled) and per-lane partial
  // normaliser of rows r0 and r0 + 8
  float oa[ND8][4];
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int kt = next_k(0), st = 0;
  if (kt <= last) issue(kt, 0);
  mma::cp_commit();  // q and the first k-tile
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
    // S = Q K^T: this warp's 16 q rows x BKT k columns
    float s[NK8][4];
#pragma unroll
    for (int j = 0; j < NK8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t aq[4];
      mma::ldsm_x4(aq, mma::smem_u32(Qs + (w * 16 + mma::a_row(lane)) * LDS +
                                     kd * 16 + mma::a_col(lane)));
#pragma unroll
      for (int j = 0; j < NK8 / 2; ++j) {
        uint32_t bk[4];
        mma::ldsm_x4(bk, mma::smem_u32(Kt + (j * 16 + mma::b_row(lane)) * LDS +
                                       kd * 16 + mma::b_col(lane)));
        mma::mma16816<T>(s[2 * j], aq, bk[0], bk[1]);
        mma::mma16816<T>(s[2 * j + 1], aq, bk[2], bk[3]);
      }
    }
    // an edge tile needs the mask; elsewhere every pair is attended
    bool edge = q0 + BQT > dm.S || k0 + BKT > dm.Sk ||
                (causal && q0 < k0 + BKT - 1);
    if (has_seg) edge = edge || tflag[kt] != 2;
    with_cases(edge, dr.on, [&](auto edge_c, auto drop_c) {
      // bit 4 j + e set: element e of n8 tile j (row r0 + 8 (e / 2),
      // column 8 j + 2 tq + e % 2) is attended
      uint32_t okb = 0xffffffffu;
      if constexpr (decltype(edge_c)::value) {
#pragma unroll
        for (int j = 0; j < NK8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = q0 + r0 + 8 * (e >> 1);
            const int c = j * 8 + 2 * tq + (e & 1), kpos = k0 + c;
            bool ok = qpos < dm.S && kpos < dm.Sk;
            if (causal) ok = ok && qpos >= kpos;
            if (has_seg) ok = ok && qseg_s[qpos - q0] == ksg[c];
            if (!ok) okb &= ~(1u << (4 * j + e));
          }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NK8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (okb >> (4 * j + e)) & 1u ? s[j][e] * scale2 : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float new_m = fmaxf(m[h], mx[h]);
        corr[h] = m[h] == NEG_INF ? 0.f : exp2f(m[h] - new_m);
        m[h] = new_m;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < ND8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oa[j][e] *= corr[e >> 1];
#pragma unroll
      for (int j = 0; j < NK8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (okb >> (4 * j + e)) & 1u
                              ? exp2f(s[j][e] - m[e >> 1])
                              : 0.f;
          // the normaliser uses the undropped p: out = dropout(softmax) @ v
          l[e >> 1] += p;
          if constexpr (decltype(drop_c)::value) {
            const int qpos = q0 + r0 + 8 * (e >> 1);
            const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
            s[j][e] = keep(key, qpos, kpos, dr.threshold) ? p * inv_keep
                                                          : 0.f;
          } else {
            s[j][e] = p;
          }
        }
    });
    // O += P V; P is the A operand, rounded to T in registers (in bf16 as
    // hi + lo, two products)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ap[4], apl[4];
      if constexpr (C::SPLIT)
        mma::pack_a_split<T>(ap, apl, s[2 * kk], s[2 * kk + 1]);
      else
        mma::pack_a<T>(ap, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < ND8 / 2; ++jd) {
        uint32_t bv[4];
        mma::ldsm_x4_trans(bv, mma::smem_u32(
                                   Vt + (kk * 16 + mma::bt_row(lane)) * LDS +
                                   jd * 16 + mma::bt_col(lane)));
        mma::mma16816<T>(oa[2 * jd], ap, bv[0], bv[1]);
        mma::mma16816<T>(oa[2 * jd + 1], ap, bv[2], bv[3]);
        if constexpr (C::SPLIT) {
          mma::mma16816<T>(oa[2 * jd], apl, bv[0], bv[1]);
          mma::mma16816<T>(oa[2 * jd + 1], apl, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the prefetch after next
    if (!more) break;
    kt = nk;
    st ^= 1;
  }
  mma::cp_wait<0>();

  T* ob = o + b * os.b + n * os.h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int qpos = q0 + r0 + 8 * h;
    if (qpos >= dm.S) continue;
    const float lf = fmaxf(l[h], 1e-20f);
    T* orow = ob + (long long)qpos * os.s;
#pragma unroll
    for (int j = 0; j < ND8; ++j) {
      const int c = j * 8 + 2 * tq;
      const float x0 = oa[j][2 * h] / lf, x1 = oa[j][2 * h + 1] / lf;
      if constexpr (AL) {  // D is a multiple of 8: c + 1 < D
        if (c < dm.D)
          *reinterpret_cast<uint32_t*>(orow + c) = mma::pack2<T>(x0, x1);
      } else {
        if (c < dm.D) orow[c] = from_float<T>(x0);
        if (c + 1 < dm.D) orow[c + 1] = from_float<T>(x1);
      }
    }
    // natural-log logsumexp, as the JAX kernel's m + log(l)
    if (tq == 0)
      lse[((long long)b * dm.N + n) * dm.S + qpos] =
          (m[h] == NEG_INF ? NEG_INF : m[h] * LN2) + logf(lf);
  }
}

template <typename T, int DP, bool AL>
struct FwdTc {
  static int run(const FwdCall& c) {
    using C = Tc<T, DP>;
    const int smem = C::K1_SMEM +
                     flag_bytes(c.seg, (c.dm.Sk + C::K1_BK - 1) / C::K1_BK);
    auto kern = flash_fwd_kernel_tc<T, DP, AL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int nqt = (c.dm.S + C::K1_BQ - 1) / C::K1_BQ;
    kern<<<nqt * c.dm.N * c.dm.B, TC_NT, smem, c.stream>>>(
        static_cast<const T*>(c.q), static_cast<const T*>(c.k),
        static_cast<const T*>(c.v), static_cast<T*>(c.o), c.lse, c.seg,
        c.dm, strides_at(c.st, 0), strides_at(c.st, 1), strides_at(c.st, 2),
        strides_at(c.st, 3), c.causal, c.scale, c.dr);
    return (int)cudaGetLastError();
  }
};

}  // namespace galv

// Operands: inputs, segment ids (or null), outputs. dims: B, N, K, S, Sk,
// D; strides: (batch, head, position) of q, k, v, o. Returns
// cudaGetLastError() after the launch (0 = launched). fp32 runs the FMA
// kernel, bf16 / fp16 the tensor-core kernel.
extern "C" int galv_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, const int* seg, void* o,
                              float* lse, const long long* dims,
                              const long long* strides, int causal,
                              float scale, int dropout, uint32_t seed,
                              uint32_t threshold, float keep_prob,
                              void* stream) {
  using namespace galv;
  const FwdCall c{q, k, v, seg, o, lse,
                  Dims{(int)dims[0], (int)dims[1], (int)dims[2],
                       (int)dims[3], (int)dims[4], (int)dims[5]},
                  strides, causal, scale,
                  DropoutArgs{dropout, seed, threshold, keep_prob},
                  static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kF32:
      return launch_fwd_f32(c);
    case kBF16:
      return launch_tc<FwdTc, __nv_bfloat16>(c);
    case kF16:
      return launch_tc<FwdTc, __half>(c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
