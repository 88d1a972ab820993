// K2 and K3: flash-attention backward.
//
// K2 (dk, dv) replaces hetu_galvatron_tpu/ops/pallas/flash_attention.py::
// _flash_bwd_dkdv_kernel (:248, pallas_call at :449) and K3 (dq) replaces
// _flash_bwd_dq_kernel (:324, pallas_call at :501), both launched by
// flash_attention_bwd_hmajor (:388). Like the TPU kernels they take o's
// logsumexp and delta = rowsum(dO * O) (fp32 [B, N, S], computed outside)
// and recompute p = exp(s - lse) per tile, so no [S, Sk] array is stored.
// The TPU grid carried dk/dv across its sequential (G, q-block) axes and dq
// across its k-block axis in VMEM; blocks on Hopper run in no order, so
// each becomes a loop inside one CUDA block:
//   K2: one block per (k-tile, kv-head, batch) loops over the G query heads
//       of its kv head and the q-tiles, accumulating dk and dv in fp32
//       registers and writing them once (no atomics: GQA groups reduce on
//       chip);
//   K3: one block per (q-tile, head, batch) loops over the k-tiles,
//       accumulating dq in fp32 registers.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): four tile products
// over the kept (q, k) pairs in K2, three in K3, against each input read
// once and each output written once. GPT-2 small's shape (B=8, N=K=12,
// S=1024, D=64, causal): K2 0.0261 ms, K3 0.0196 ms. The Qwen2.5-7B path's
// (B=2, N=28, K=4, S=4096, D=128, causal, three packed documents, 39% of
// the causal pairs kept): K2 0.1893 ms, K3 0.1419 ms. Both kernels are
// bound by operations at both shapes (chip_smoke.py::bounds).
//
// Routes, chosen before the launch by ops/flash_attention.py::kernel_route
// (never after a failure): K2 takes the warp-specialised wgmma + TMA
// kernel of flash_bwd_sm90.cu in bf16 / fp16 at D = 64 or 128 on operands
// TMA can describe (every main path); the kernels below serve every other
// case, K3 always, and K2's mma.sync kernel is the yardstick chip_smoke.py
// times the wgmma kernel against.
//
// * bf16 / fp16: the tensor-core kernels (*_tc). What held the first
//   version (fp32 FMA, 170-250x its bound) back, and what this one does:
//   - No tensor cores. Every product (S = Q K^T and dP = dO V^T in both
//     kernels, dV += P^T dO and dK += dS^T Q in K2, dQ += dS K in K3) is a
//     warp-level mma.sync.m16n8k16 with fp32 accumulation, fed by ldmatrix
//     (flash_mma.cuh). Four warps each own 16 rows of the block's fixed
//     tile: K2 computes S^T = K Q^T and dP^T = V dO^T, so each warp's
//     accumulator fragments are already the A operand (P^T, dS^T, rows =
//     its k rows) of dV and dK; K3 computes S and dP with rows = its q
//     rows, the A operand of dQ. P and dS go from accumulator to operand in
//     registers, and nothing is staged through shared memory.
//   - 16-bit operands were widened to fp32 in shared memory, one scalar
//     load per element. Tiles now stay in their dtype, copied with 16-byte
//     cp.async into [rows][DP + 8] tiles (DP = 32, 64 or 128, the least
//     that holds D, zero padded; the 16-byte row pad makes every ldmatrix,
//     plain or .trans, free of bank conflicts). Three DP buckets rather
//     than every multiple of 16 keep the build at 24 tensor-core kernels.
//   - No overlap of copy and compute. The streamed operand goes through two
//     shared-memory stages: K2 prefetches the q, dO, lse, delta and segment
//     rows of its next (head, q-tile), K3 the k, v and segment rows of its
//     next k-tile, while the current tile's products run (cp.async groups,
//     wait_group 1).
//   - Work the bound does not count. A (q-tile, k-tile) pair is computed
//     only if causality allows some pair in it and the tiles' segment-id
//     ranges [min, max] overlap (exact for ids in any order: disjoint
//     ranges share no id). Each block takes the ranges from the segment
//     ids themselves before its tile loop, one coalesced row of ids and a
//     warp reduction per tile (tile_range, tile_flags in flash_tc.cuh),
//     and keeps one flag a streamed tile in shared memory: skip, compute
//     with the mask, or compute one document's tile without it.
//     ops/flash_attention.py::computed_tiles is the same rule in torch,
//     which the CPU tests hold to the dense mask. A skipped tile would add
//     exactly zero, so results do not change.
//   - Load balance: under causality K2's low k-tiles and K3's high q-tiles
//     loop longest, so blockIdx maps the tile index slowest and issues
//     those blocks first.
//   - Branches in the element loop. Masks, dropout and the exp run per
//     element of a tile; each tile takes one of four branch-free copies of
//     that loop (edge tile or not, dropout or not), and a tile off the
//     causal diagonal, inside S and inside one document skips the mask.
//   Tiles: K2 holds a 64-row k-tile (4 warps x 16 rows) and streams 32-row
//   q-tiles; K3 holds a 64-row q-tile and streams 32-row k-tiles. The
//   kernels are bound by latency and instruction issue, not by the tensor
//   cores' rate (they run at 9-14% of the bound, chip_smoke.py phase 3),
//   so the tiles are chosen for warps on an SM: K2's fp32 dk and dv
//   fragments take D registers a thread, and with the 16 x 32 S^T and dP^T
//   beside them K2 fits 168 registers (3 blocks, 12 warps an SM) at
//   D <= 64; above, it runs a q-tile in two passes of 16 columns (the K
//   and V fragments are read twice) and fits 229-236 (2 blocks). K3 fits
//   128 (4 blocks) and 168 (3 blocks); it keeps its q rows' lse, delta and
//   segment ids in shared memory rather than registers. These ran faster
//   than 64-row streamed tiles at 2 blocks an SM at both main shapes.
//   Under causality K2 has 512 blocks at the Qwen shape, about two waves
//   of its 264 slots.
//   Rounding: P (after dropout) and dS are rounded to the input dtype in
//   registers before the products that consume them, as FlashAttention-2
//   does; the JAX kernels keep them in fp32 (flash_attention.py:280-316).
//   In fp16 (11 bits) that keeps every element within a third of the
//   16-bit tolerance of chip_smoke.py phase 3. In bf16 (8 bits) one
//   rounding put single dk elements past that tolerance at both main
//   shapes (dS terms of large magnitude cancel in dk's sum over q), so
//   bf16 carries P and dS as hi + lo, two bf16 numbers whose sum holds
//   about 16 bits, and runs the three products that consume them twice
//   (K2 6 products a tile instead of 4, K3 4 instead of 3).
//   16-byte copies need every operand's base and (batch, head, position)
//   strides to be multiples of 8 elements (and D a multiple of 8); the
//   fused qkv views of the main paths meet this at D=64 and D=128. Other
//   operands take the instantiation with element-wise loads (AL = false),
//   which keeps the same pipeline but copies synchronously.
//
// * fp32: the first version's FMA kernels, unchanged: 64 x 64 tiles of fp32
//   in shared memory, 256 threads as a 16 x 16 grid, tiles past the
//   diagonal skipped. TF32 tensor cores would miss the 1e-4 fp32 checks of
//   chip_smoke.py and its fp32 reference runs.
//
// Not taken: one fused backward with an atomic fp32 dq (FlashAttention-2's
// layout) would drop K3's recompute of S and dP (7 tile products to 5) but
// changes K3's launch count and the kernel table, and atomics would make
// dq's bits depend on the schedule. K2's wgmma + TMA form is
// flash_bwd_sm90.cu; K3's is later work on the same header.
#include "flash_sm90.cuh"

namespace galv {

__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, float* __restrict__ dk,
    float* __restrict__ dv, Dims dm, Strides qs, Strides ks, Strides vs,
    Strides dos, Strides dks, Strides dvs, int causal, float scale,
    DropoutArgs dr) {
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
    const float* qb = q + b * qs.b + n * qs.h;
    const float* ob = dO + b * dos.b + n * dos.h;
    for (int qt = first_q; qt < num_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's accumulation is done
      load_tile(Qs, LD, qb, qs, q0, dm.S, D, 1.f);
      load_tile(dOs, LD, ob, dos, q0, dm.S, D, 1.f);
      load_rows(lse_s, delta_s, qseg, lse, delta, seg, row0, b, q0, dm);
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

  float* dkb = dk + b * dks.b + kh * dks.h;
  float* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= dm.Sk) continue;
#pragma unroll
    for (int jd = 0; jd < NDS; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) {
        dkb[(long long)kpos * dks.s + col] = dka[i][jd];
        dvb[(long long)kpos * dvs.s + col] = dva[i][jd];
      }
    }
  }
}

static int launch_dkdv_f32(const BwdCall& c) {
  const int LD = c.dm.D + 1;
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BK + 2 * BQ) * LD +
                       2 * (size_t)BQ * (BK + 1) + 2 * BQ) +
      sizeof(int) * (BQ + BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((c.dm.Sk + BK - 1) / BK, c.dm.K, c.dm.B);
  flash_bwd_dkdv_kernel<<<grid, NT, smem, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), static_cast<const float*>(c.dO),
      c.lse, c.delta, c.seg, static_cast<float*>(c.out0),
      static_cast<float*>(c.out1), c.dm, strides_at(c.st, 0),
      strides_at(c.st, 1), strides_at(c.st, 2), strides_at(c.st, 3),
      strides_at(c.st, 4), strides_at(c.st, 5), c.causal, c.scale, c.dr);
  return (int)cudaGetLastError();
}

template <typename T, int DP, bool AL>
__global__ void __launch_bounds__(TC_NT, Tc<T, DP>::K2_MINB)
    flash_bwd_dkdv_kernel_tc(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv,
    Dims dm, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
    Strides dvs, int causal, float scale, DropoutArgs dr) {
  using C = Tc<T, DP>;
  constexpr int LDS = C::LDS, BKT = C::K2_BK, BQT = C::K2_BQ;
  // QH passes over a q-tile's columns: at D=128 the fp32 dk and dv
  // fragments take 128 registers a thread, and half the S^T and dP^T
  // fragments at a time keep the kernel under 255 without spills
  constexpr int QH = DP > 64 ? 2 : 1, CQ = BQT / QH;
  constexpr int NQP = CQ / 8, ND8 = DP / 8, KD = DP / 16;
  constexpr int SMEM = C::K2_SMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BKT * LDS;
  T* Qs = Vs + BKT * LDS;        // two stages
  T* dOs = Qs + 2 * BQT * LDS;   // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQT * LDS);
  float* delta_s = lse_s + 2 * BQT;
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * BQT);
  int* kseg_s = qseg_s + 2 * BQT;

  // the k-tile index varies slowest: under causality the low k-tiles loop
  // over the most q-tiles, and they are issued first
  const int KB = dm.K * dm.B;
  const int kt = blockIdx.x / KB, rem = blockIdx.x - kt * KB;
  const int kh = rem % dm.K, b = rem / dm.K;
  const int G = dm.N / dm.K, k0 = kt * BKT;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = w * 16 + gq;  // this thread's k rows: r0, r0 + 8
  const float scale2 = scale * LOG2E, inv_keep = 1.f / dr.keep_prob;
  const bool has_seg = seg != nullptr;

  const int nqt = (dm.S + BQT - 1) / BQT;
  const int q_first = causal ? k0 / BQT : 0;
  unsigned char* tflag = smem_raw + SMEM;
  for (int i = threadIdx.x; i < SMEM / 16; i += TC_NT)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  const int* sb = seg + (long long)b * dm.S;
  if (has_seg) tile_flags(tflag, sb, k0, BKT, dm.Sk, q_first, nqt, BQT, dm.S);
  __syncthreads();
  load_tile_tc<T, DP, BKT, AL>(Ks, k + b * ks.b + kh * ks.h, ks.s, k0,
                               dm.Sk, dm.D);
  load_tile_tc<T, DP, BKT, AL>(Vs, v + b * vs.b + kh * vs.h, vs.s, k0,
                               dm.Sk, dm.D);
  if (has_seg)
    for (int r = threadIdx.x; r < BKT; r += TC_NT)
      kseg_s[r] = k0 + r < dm.Sk ? sb[k0 + r] : -2;
  // the q-tiles that pair with this k-tile: on or below the causal
  // diagonal, with overlapping segment ranges (the same for every head)
  auto next_q = [&](int qt) {
    if (has_seg)
      while (qt < nqt && tflag[qt] == 0) ++qt;
    return qt;
  };
  const int q_begin = next_q(q_first);

  auto issue = [&](int g, int qt, int st) {
    const int n = kh * G + g, q0 = qt * BQT;
    load_tile_tc<T, DP, BQT, AL>(Qs + st * BQT * LDS, q + b * qs.b + n * qs.h,
                                 qs.s, q0, dm.S, dm.D);
    load_tile_tc<T, DP, BQT, AL>(dOs + st * BQT * LDS,
                                 dO + b * dos.b + n * dos.h, dos.s, q0, dm.S,
                                 dm.D);
    const long long row0 = ((long long)b * dm.N + n) * dm.S + q0;
    load_vec_tc(lse_s + st * BQT, lse + row0, dm.S - q0, BQT);
    load_vec_tc(delta_s + st * BQT, delta + row0, dm.S - q0, BQT);
    if (has_seg)
      load_vec_tc(qseg_s + st * BQT, seg + (long long)b * dm.S + q0,
                  dm.S - q0, BQT);
  };

  float dka[ND8][4], dva[ND8][4];
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int g = 0, qt = q_begin, st = 0;
  if (qt < nqt) issue(0, qt, 0);
  mma::cp_commit();  // k, v and the first q-tile
  while (qt < nqt) {
    int ng = g, nq = next_q(qt + 1);
    if (nq >= nqt) {
      ng = g + 1;
      nq = q_begin;
    }
    const bool more = ng < G;
    if (more) issue(ng, nq, st ^ 1);
    mma::cp_commit();
    mma::cp_wait<1>();  // everything but the prefetch has landed
    __syncthreads();

    const int n = kh * G + g, q0 = qt * BQT;
    const T* Qt = Qs + st * BQT * LDS;
    const T* dOt = dOs + st * BQT * LDS;
    const float* ls = lse_s + st * BQT;
    const float* dl = delta_s + st * BQT;
    const int* qsg = qseg_s + st * BQT;
    const uint32_t key =
        dr.on ? head_key(dr.seed, (uint32_t)(b * dm.N + n)) : 0u;
    // an edge tile needs the mask; elsewhere every pair is attended
    bool edge = q0 + BQT > dm.S || k0 + BKT > dm.Sk ||
                (causal && q0 < k0 + BKT - 1);
    if (has_seg) edge = edge || tflag[qt] != 2;
    // QH passes over the tile's q columns, CQ at a time
#pragma unroll 1
    for (int cq = 0; cq < BQT; cq += CQ) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 k rows x CQ q columns
      float s[NQP][4], dp[NQP][4];
#pragma unroll
      for (int j = 0; j < NQP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ak[4], av[4];
        const int ao = (w * 16 + mma::a_row(lane)) * LDS + kd * 16 +
                       mma::a_col(lane);
        mma::ldsm_x4(ak, mma::smem_u32(Ks + ao));
        mma::ldsm_x4(av, mma::smem_u32(Vs + ao));
#pragma unroll
        for (int j = 0; j < NQP / 2; ++j) {
          uint32_t bq[4], bo[4];
          const int bofs = (cq + j * 16 + mma::b_row(lane)) * LDS +
                           kd * 16 + mma::b_col(lane);
          mma::ldsm_x4(bq, mma::smem_u32(Qt + bofs));
          mma::ldsm_x4(bo, mma::smem_u32(dOt + bofs));
          mma::mma16816<T>(s[2 * j], ak, bq[0], bq[1]);
          mma::mma16816<T>(s[2 * j + 1], ak, bq[2], bq[3]);
          mma::mma16816<T>(dp[2 * j], av, bo[0], bo[1]);
          mma::mma16816<T>(dp[2 * j + 1], av, bo[2], bo[3]);
        }
      }
      with_cases(edge, dr.on, [&](auto edge_c, auto drop_c) {
#pragma unroll
        for (int j = 0; j < NQP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cq + j * 8 + 2 * tq + (e & 1);
            const int kpos = k0 + r0 + ((e >> 1) << 3), qpos = q0 + c;
            bool ok = true;
            if constexpr (decltype(edge_c)::value) {
              ok = qpos < dm.S && kpos < dm.Sk;
              if (causal) ok = ok && qpos >= kpos;
              if (has_seg) ok = ok && qsg[c] == kseg_s[kpos - k0];
            }
            p_ds<decltype(drop_c)::value>(s[j][e], dp[j][e], ok,
                                          ls[c] * LOG2E, dl[c], scale,
                                          scale2, key, dr.threshold,
                                          inv_keep, qpos, kpos);
          }
      });
      // dV += P^T dO and dK += dS^T Q; P^T and dS^T are the A operands,
      // rounded to T in registers (in bf16 as hi + lo, two products each)
#pragma unroll
      for (int kq = 0; kq < NQP / 2; ++kq) {
        uint32_t ap[4], as[4], apl[4], asl[4];
        if constexpr (C::SPLIT) {
          mma::pack_a_split<T>(ap, apl, s[2 * kq], s[2 * kq + 1]);
          mma::pack_a_split<T>(as, asl, dp[2 * kq], dp[2 * kq + 1]);
        } else {
          mma::pack_a<T>(ap, s[2 * kq], s[2 * kq + 1]);
          mma::pack_a<T>(as, dp[2 * kq], dp[2 * kq + 1]);
        }
#pragma unroll
        for (int jd = 0; jd < ND8 / 2; ++jd) {
          uint32_t bo[4], bq[4];
          const int bofs = (cq + kq * 16 + mma::bt_row(lane)) * LDS +
                           jd * 16 + mma::bt_col(lane);
          mma::ldsm_x4_trans(bo, mma::smem_u32(dOt + bofs));
          mma::ldsm_x4_trans(bq, mma::smem_u32(Qt + bofs));
          mma::mma16816<T>(dva[2 * jd], ap, bo[0], bo[1]);
          mma::mma16816<T>(dva[2 * jd + 1], ap, bo[2], bo[3]);
          mma::mma16816<T>(dka[2 * jd], as, bq[0], bq[1]);
          mma::mma16816<T>(dka[2 * jd + 1], as, bq[2], bq[3]);
          if constexpr (C::SPLIT) {
            mma::mma16816<T>(dva[2 * jd], apl, bo[0], bo[1]);
            mma::mma16816<T>(dva[2 * jd + 1], apl, bo[2], bo[3]);
            mma::mma16816<T>(dka[2 * jd], asl, bq[0], bq[1]);
            mma::mma16816<T>(dka[2 * jd + 1], asl, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the prefetch after next
    if (!more) break;
    g = ng;
    qt = nq;
    st ^= 1;
  }
  mma::cp_wait<0>();

  T* dkb = dk + b * dks.b + kh * dks.h;
  T* dvb = dv + b * dvs.b + kh * dvs.h;
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + r0 + ((e >> 1) << 3);
      const int c = j * 8 + 2 * tq + (e & 1);
      if (kpos < dm.Sk && c < dm.D) {
        dkb[(long long)kpos * dks.s + c] = from_float<T>(dka[j][e]);
        dvb[(long long)kpos * dvs.s + c] = from_float<T>(dva[j][e]);
      }
    }
}

template <typename T, int DP, bool AL>
struct DkdvTc {
  static int run(const BwdCall& c) {
    using C = Tc<T, DP>;
    const int smem = C::K2_SMEM +
                     flag_bytes(c.seg, (c.dm.S + C::K2_BQ - 1) / C::K2_BQ);
    auto kern = flash_bwd_dkdv_kernel_tc<T, DP, AL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int nkt = (c.dm.Sk + C::K2_BK - 1) / C::K2_BK;
    kern<<<nkt * c.dm.K * c.dm.B, TC_NT, smem, c.stream>>>(
        static_cast<const T*>(c.q), static_cast<const T*>(c.k),
        static_cast<const T*>(c.v), static_cast<const T*>(c.dO), c.lse,
        c.delta, c.seg, static_cast<T*>(c.out0),
        static_cast<T*>(c.out1), c.dm, strides_at(c.st, 0),
        strides_at(c.st, 1), strides_at(c.st, 2), strides_at(c.st, 3),
        strides_at(c.st, 4), strides_at(c.st, 5), c.causal, c.scale, c.dr);
    return (int)cudaGetLastError();
  }
};

}  // namespace galv

// Operands: inputs, segment ids [B, S] (null without segments), outputs.
// dims: B, N, K, S, Sk, D; strides: (batch, head, position) of q, k, v,
// dO, dk, dv. `route` as galv_flash_fwd's: the fp32 FMA kernel, the
// mma.sync kernel or the wgmma kernel (flash_bwd_sm90.cu). Returns
// cudaGetLastError() after the launch (0 = launched),
// cudaErrorNotSupported for a route the operands cannot take.
extern "C" int galv_flash_bwd_dkdv(int dtype, const void* q, const void* k,
                                   const void* v, const void* dO,
                                   const float* lse, const float* delta,
                                   const int* seg, void* dk, void* dv,
                                   const long long* dims,
                                   const long long* strides, int causal,
                                   float scale, int dropout, uint32_t seed,
                                   uint32_t threshold, float keep_prob,
                                   int route, void* stream) {
  using namespace galv;
  const BwdCall c = bwd_call(q, k, v, dO, lse, delta, seg, dk, dv, dims,
                             strides, causal, scale, dropout, seed,
                             threshold, keep_prob, stream);
  if (route == kRouteWgmma) return launch_dkdv_sm90(dtype, c);
  if ((route == kRouteFma) != (dtype == kF32) ||
      (route != kRouteFma && route != kRouteMma))
    return (int)cudaErrorNotSupported;
  return launch_bwd<DkdvTc>(dtype, c, launch_dkdv_f32);
}
