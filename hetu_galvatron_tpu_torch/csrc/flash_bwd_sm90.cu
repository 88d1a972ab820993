// K2 on the wgmma route: dK and dV of flash attention redesigned for Hopper.
//
// Replaces, with flash_bwd.cu's mma.sync kernel on the operands this route
// does not take, hetu_galvatron_tpu/ops/pallas/flash_attention.py::
// _flash_bwd_dkdv_kernel (:248, pallas_call at :449, launched by
// flash_attention_bwd_hmajor :388). The route rule is K1's (flash_fwd_sm90.cu,
// ops/flash_attention.py::kernel_route): bf16 / fp16, D = 64 or 128, q, k,
// v, dO, dk and dv on 16 bytes with strides in multiples of 8 elements.
// K3 (dq) keeps its mma.sync kernel.
//
// What held flash_bwd.cu's flash_bwd_dkdv_kernel_tc (:232; note :1-102) at
// 5-16% of its bound:
//   - The same mma.sync instruction and the same lack of a producer /
//     consumer split as K1's old kernel: four warps re-reading the streamed
//     q and dO tiles through ldmatrix, a block-wide barrier a tile.
//   - At D=128 each 32-row q tile ran in two column passes (QH,
//     flash_bwd.cu:242-246) to fit the fp32 dk and dv, re-reading the k and
//     v fragments.
//   - The grid was B K ceil(Sk / 64) blocks (flash_bwd.cu:258-262), each
//     looping over its G query heads: with one row and 4 kv heads (phase
//     16) 256 blocks against 132 SMs x 3 slots, and under causality the
//     low k tiles loop longest, so the SMs were both underfilled and
//     unbalanced (5.1% of the bound).
//
// The design here:
//   - Warps: K1's skeleton. Warpgroup 0 produces (warp 0), warpgroups 1
//     and 2 consume, each owning 64 rows of a held 128-row k tile; 384
//     threads, one block an SM.
//   - Loads. A unit is a (k tile, kv head, batch). TMA brings its k and v
//     tiles into a slot (two slots at D=64, so the next unit's load while
//     this one's last q tiles run; one at D=128); q and dO tiles of 64 rows
//     stream through a ring of 3 stages with full / empty mbarriers. The
//     producer warp decides the tile rule for the unit (warp reductions of
//     the tiles' segment ids, the same for every head), and copies each
//     tile's head, q-tile index, flag, lse, delta and segment ids into its
//     stage before arming it; a stage without a tile ends a pass.
//   - Products. S^T = K Q^T and dP^T = V dO^T are SS wgmma.m64n64k16 (k,
//     v, q and dO K-major in shared memory); their accumulators have rows
//     = k, so P^T and dS^T go straight into A-operand registers for dV +=
//     P^T dO and dK += dS^T Q, RS wgmma.m64nDk16 with dO and q read
//     MN-major from the same tiles. dK and dV stay in fp32 registers and
//     are written once. At D=128 both would take 128 registers a thread
//     and spilled beside S^T and dP^T, so the unit runs in two passes over
//     its items: dV (S^T only), then dK (S^T recomputed, and dP^T): 7
//     products a tile in bf16 where one pass runs 6.
//   - The GQA loop over the G query heads stays on chip. Where a k tile's
//     items can reach WG_K2_SPLIT_ITEMS (G ceil(S / 64) >= 32: the Qwen,
//     Mixtral and Llama paths) a thread-block cluster of 2 takes each
//     unit: its two blocks take every other (head, q tile) item of the same
//     ordered list, so the causal work of a low k tile is halved and
//     balanced between two SMs, and one row with 4 kv heads (phase 16)
//     launches 256 blocks rather than 128. The two fp32 partials
//     meet in distributed shared memory: block r writes the rows of
//     consumer r as its own partial plus its peer's, one fp32 addition,
//     which is commutative, so the result is the same bits whichever block
//     adds. No atomics; one launch a call. Shorter units (GPT-2, BERT, T5)
//     run unsplit on a persistent grid, a block an SM taking its units in
//     a snake order, so set-up is paid once a block and the next unit's k
//     and v load while this one runs.
//
// Kept bit for bit in function from the mma.sync kernel: p = exp2(s
// log2(e) / sqrt(D) - lse log2(e)) on fp32 scores; NEG_INF masks; the
// counter-based dropout at each element's global (q, k), on p for dV and
// on dP, with delta = rowsum(dO . O) unchanged by it; the tile rule at these
// tiles. bf16 carries P^T and dS^T as hi + lo (dS terms of large magnitude
// cancel in dk's sum over q, flash_bwd.cu:84-94); fp16 rounds them once.
// So in bf16 the kernel runs 6 products a tile where the bound counts 4:
// at the full tensor-core rate bf16 reaches at most 2/3 of its bound.
//
// Each output element's sum order depends only on its own (b, kv head, k
// tile): the items in order (heads, then q tiles), split by parity between
// a cluster's two blocks where G and S call for a split, then one
// addition. Nothing depends on B, N or the grid.
//
// Bound on an H100 SXM: four tile products over the kept pairs against each
// input read once and dk, dv written once (chip_smoke.py::bounds).
#include "flash_sm90.cuh"

namespace galv {

template <typename T, int D>
struct Dkdv90 {
  static constexpr int BK = WG_K2_BK;
  static constexpr int BQ = WG_K2_BQ;
  static constexpr int ST = 3;  // stages of the q / dO ring
  // k / v slots: at D=64 the next unit's k and v load while this one's
  // last q tiles run; at D=128 one slot (two would not fit)
  static constexpr int KVS = D == 64 ? 2 : 1;
  static constexpr int KV_BYTES = BK * D * 2;  // the k or the v tile
  static constexpr int QT_BYTES = BQ * D * 2;  // a q or a dO tile
  static constexpr int PLD = D + 8;  // a row of the fp32 partial, floats
  static constexpr int OFF_V = KVS * KV_BYTES;
  static constexpr int OFF_Q = 2 * KVS * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + ST * QT_BYTES;
  static constexpr int OFF_PART = OFF_DO + ST * QT_BYTES;  // one output
  static constexpr int OFF_LSE = OFF_PART + 64 * PLD * 4;
  static constexpr int OFF_DELTA = OFF_LSE + ST * BQ * 4;
  static constexpr int OFF_QSEG = OFF_DELTA + ST * BQ * 4;
  static constexpr int OFF_META = OFF_QSEG + ST * BQ * 4;  // head, q tile, flag
  static constexpr int OFF_KSEG = OFF_META + ST * 16;
  static constexpr int OFF_BAR = OFF_KSEG + KVS * BK * 4;
  static constexpr int OFF_FLAG = OFF_BAR + (2 * KVS + 2 * ST) * 8;
  static_assert(KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0,
                "tiles start on the swizzle's 1024-byte period");
};

template <typename T, int D>
__global__ void __launch_bounds__(WG_NT, 1)
    flash_bwd_dkdv_kernel_wg(__grid_constant__ const CUtensorMap tq,
                             __grid_constant__ const CUtensorMap tk,
                             __grid_constant__ const CUtensorMap tv,
                             __grid_constant__ const CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ seg, T* __restrict__ dk,
                             T* __restrict__ dv, Dims dm, Strides dks,
                             Strides dvs, int causal, float scale,
                             DropoutArgs dr, int split) {
  using L = Dkdv90<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, KVS = L::KVS;
  constexpr int NQ8 = BQ / 8, KQ = BQ / 16, KD = D / 16, PLD = L::PLD;
  constexpr bool SPLIT = std::is_same<T, __nv_bfloat16>::value;
  // D=128: dV over the items, then dK over them again, so one fp32 output
  // is in registers at a time (both at once spilled even at 232 registers)
  constexpr int PASSES = D == 64 ? 1 : 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = sm90::smem_1024(smem_raw);
  float* part = reinterpret_cast<float*>(sm + L::OFF_PART);
  float* lse_s = reinterpret_cast<float*>(sm + L::OFF_LSE);
  float* delta_s = reinterpret_cast<float*>(sm + L::OFF_DELTA);
  int* qseg_s = reinterpret_cast<int*>(sm + L::OFF_QSEG);
  int* meta = reinterpret_cast<int*>(sm + L::OFF_META);  // [ST][4]
  int* kseg_s = reinterpret_cast<int*>(sm + L::OFF_KSEG);  // [KVS][BK]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* kv_empty = kv_full + KVS;
  uint64_t* full = kv_empty + KVS;
  uint64_t* empty = full + ST;
  unsigned char* qflag = sm + L::OFF_FLAG;

  // The units (k tile, kv head, batch), the k-tile index slowest (under
  // causality the low k-tiles loop over the most q-tiles, and they come
  // first), go round the blocks (snake_unit), or with split = 2 round the
  // clusters of two blocks, both of which take the unit: one each when the
  // grid covers them, several in a persistent grid
  const uint32_t rank = split == 2 ? sm90::cluster_rank() : 0u;
  const int KB = dm.K * dm.B, G = dm.N / dm.K;
  const int nkt = (dm.Sk + BK - 1) / BK, units = nkt * KB;
  const int nqt = (dm.S + BQ - 1) / BQ;
  const int cl = blockIdx.x / split, ncl = gridDim.x / split;
  const bool has_seg = seg != nullptr;
  struct Unit {
    int kh, b, k0, q_first;
  };
  auto unit = [&](int u) {
    Unit x;
    const int kt = u / KB, rem = u - kt * KB;
    x.kh = rem % dm.K;
    x.b = rem / dm.K;
    x.k0 = kt * BK;
    x.q_first = causal ? x.k0 / BQ : 0;
    return x;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < KVS; ++i) {
      sm90::mbar_init(kv_full + i, 1);
      sm90::mbar_init(kv_empty + i, 8);  // the consumers' warps
    }
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: warp 0 keeps the ring full, warps 1-3 only join
    // the cluster's barriers
    sm90::reg_dealloc<WG_PRODUCER_REGS>();
    const int lane = threadIdx.x;
    int it = 0, ui = 0;  // q tiles through the ring, units of this block
    for (int u; (u = snake_unit(ui, cl, ncl, units)) >= 0; ++ui) {
      const Unit x = unit(u);
      const int kslot = ui % KVS;
      const int* sb = has_seg ? seg + (long long)x.b * dm.S : nullptr;
      if (threadIdx.x < 32) {
        sm90::mbar_wait(kv_empty + kslot, ((ui / KVS) & 1) ^ 1);
        if (has_seg) {
          for (int r = lane; r < BK; r += 32)
            kseg_s[kslot * BK + r] = x.k0 + r < dm.Sk ? sb[x.k0 + r] : -2;
          // the q-tiles that pair with this k-tile (the same for every
          // head): on or below the causal diagonal, with overlapping
          // segment ranges (the tile rule)
          const int2 fr = tile_range(sb, x.k0, BK, dm.Sk);
          for (int qt = x.q_first; qt < nqt; ++qt) {
            const int f = pair_flag(fr, tile_range(sb, qt * BQ, BQ, dm.S));
            if (lane == 0) qflag[qt] = (unsigned char)f;
          }
        }
        __syncwarp();
        if (lane == 0) {
          sm90::mbar_expect_tx(kv_full + kslot, 2 * L::KV_BYTES);
          sm90::tma_tile<D, BK>(sm + kslot * L::KV_BYTES, &tk,
                                kv_full + kslot, x.k0, x.kh, x.b);
          sm90::tma_tile<D, BK>(sm + L::OFF_V + kslot * L::KV_BYTES, &tv,
                                kv_full + kslot, x.k0, x.kh, x.b);
        }
      }
      for (int pass = 0; pass < PASSES; ++pass) {
        if (threadIdx.x < 32) {
          // the (head g, q-tile) items in order; with split = 2 this block
          // takes every other one, starting at its rank
          int i = 0;
          for (int g = 0; g < G; ++g)
            for (int qt = x.q_first; qt < nqt; ++qt) {
              const int flag = has_seg ? qflag[qt] : 2;
              if (flag == 0 || (i++ % split) != (int)rank) continue;
              const int s = it % ST;
              sm90::mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
              const int n = x.kh * G + g, q0 = qt * BQ;
              const float* lrow = lse + ((long long)x.b * dm.N + n) * dm.S;
              const float* drow = delta + ((long long)x.b * dm.N + n) * dm.S;
              for (int r = lane; r < BQ; r += 32) {
                const bool in = q0 + r < dm.S;
                lse_s[s * BQ + r] = in ? lrow[q0 + r] : 0.f;
                delta_s[s * BQ + r] = in ? drow[q0 + r] : 0.f;
                if (has_seg) qseg_s[s * BQ + r] = in ? sb[q0 + r] : -1;
              }
              __syncwarp();
              if (lane == 0) {
                meta[4 * s] = g;
                meta[4 * s + 1] = qt;
                meta[4 * s + 2] = flag;
                sm90::mbar_expect_tx(full + s, 2 * L::QT_BYTES);
                sm90::tma_tile<D, BQ>(sm + L::OFF_Q + s * L::QT_BYTES, &tq,
                                      full + s, q0, n, x.b);
                sm90::tma_tile<D, BQ>(sm + L::OFF_DO + s * L::QT_BYTES,
                                      &tdo, full + s, q0, n, x.b);
              }
              ++it;
            }
          // the pass's end: a stage without a tile
          const int s = it % ST;
          sm90::mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
          if (lane == 0) {
            meta[4 * s] = -1;
            sm90::mbar_arrive(full + s);
          }
          ++it;
        }
        __syncwarp();
        // the consumers' sums of this pass's outputs, two barriers each
        if (split == 2)
          for (int i = 0; i < 4 / PASSES; ++i) sm90::cluster_sync();
      }
    }
  } else {
    sm90::reg_alloc<WG_CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1;  // consumer 0 or 1
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int gq = lane >> 2, tq4 = lane & 3;
    const int pr = w * 16 + gq;  // rows pr, pr + 8 of this consumer's 64
    const int r0 = cw * 64 + pr;  // the same rows in the k tile
    const float scale2 = scale * LOG2E, inv_keep = 1.f / dr.keep_prob;
    using T_ = std::true_type;
    using F_ = std::false_type;
    int it = 0, ui = 0;
    for (int u; (u = snake_unit(ui, cl, ncl, units)) >= 0; ++ui) {
      const Unit x = unit(u);
      const int kh = x.kh, b = x.b, k0 = x.k0, kslot = ui % KVS;
      const int* ksg = kseg_s + kslot * BK;

      // one pass over this block's items of the unit, accumulating dV
      // into va when DV and dK into ka when DK
      auto items = [&](auto dv_c, auto dk_c, float(&va)[D / 2],
                       float(&ka)[D / 2]) {
        constexpr bool DV = decltype(dv_c)::value;
        constexpr bool DK = decltype(dk_c)::value;
        while (true) {
          const int s = it % ST;
          sm90::mbar_wait(full + s, (it / ST) & 1);
          ++it;
          const int g = meta[4 * s];
          if (g < 0) {  // the pass's end
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(empty + s);
            break;
          }
          const int qt = meta[4 * s + 1], flag = meta[4 * s + 2];
          const int n = kh * G + g, q0 = qt * BQ;
          const uint32_t base = sm90::opaque(sm90::smem_u32(sm));
          const uint32_t ka_ = base + kslot * L::KV_BYTES;
          const uint32_t va_ = base + L::OFF_V + kslot * L::KV_BYTES;
          const uint32_t qa = base + L::OFF_Q + s * L::QT_BYTES;
          const uint32_t oa = base + L::OFF_DO + s * L::QT_BYTES;
          const float* ls = lse_s + s * BQ;
          const float* dl = delta_s + s * BQ;
          const int* qsg = qseg_s + s * BQ;
          const uint32_t key =
              dr.on ? head_key(dr.seed, (uint32_t)(b * dm.N + n)) : 0u;

          // S^T = K Q^T (and dP^T = V dO^T for dK): this consumer's 64 k
          // rows x BQ q columns
          float sa[BQ / 2], pa[BQ / 2];
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) sa[i] = pa[i] = 0.f;
          sm90::wg_fence();
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            sm90::Wgmma<T, BQ>::template ss<0>(
                sa, sm90::desc_k<BK>(ka_, cw * 64, kk),
                sm90::desc_k<BQ>(qa, 0, kk));
          if constexpr (DK) {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
              sm90::Wgmma<T, BQ>::template ss<0>(
                  pa, sm90::desc_k<BK>(va_, cw * 64, kk),
                  sm90::desc_k<BQ>(oa, 0, kk));
          }
          sm90::wg_commit();
          sm90::wg_wait<0>();
          sm90::fence_regs(sa);
          if constexpr (DK) sm90::fence_regs(pa);

          // an edge tile needs the mask; elsewhere every pair is attended
          bool edge = q0 + BQ > dm.S || k0 + BK > dm.Sk ||
                      (causal && q0 < k0 + BK - 1);
          if (has_seg) edge = edge || flag != 2;
          with_cases(edge, dr.on, [&](auto edge_c, auto drop_c) {
            constexpr bool DROP = decltype(drop_c)::value;
#pragma unroll
            for (int j = 0; j < NQ8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = j * 8 + 2 * tq4 + (e & 1);
                const int kr = r0 + 8 * (e >> 1);
                const int kpos = k0 + kr, qpos = q0 + c;
                bool ok = true;
                if constexpr (decltype(edge_c)::value) {
                  ok = qpos < dm.S && kpos < dm.Sk;
                  if (causal) ok = ok && qpos >= kpos;
                  if (has_seg) ok = ok && qsg[c] == ksg[kr];
                }
                float& v = sa[4 * j + e];
                if constexpr (DK) {
                  p_ds<DROP>(v, pa[4 * j + e], ok, ls[c] * LOG2E, dl[c],
                             scale, scale2, key, dr.threshold, inv_keep,
                             qpos, kpos);
                } else {  // p_ds's p after dropout, alone
                  const float p =
                      ok ? exp2f(v * scale2 - ls[c] * LOG2E) : 0.f;
                  if constexpr (DROP)
                    v = keep(key, qpos, kpos, dr.threshold) ? p * inv_keep
                                                            : 0.f;
                  else
                    v = p;
                }
              }
          });

          // dV += P^T dO and dK += dS^T Q; P^T and dS^T are the A
          // operands, rounded to T in registers (bf16 as hi + lo, two
          // products each)
          uint32_t ph[KQ][4], sh[KQ][4];
          [[maybe_unused]] uint32_t pl[KQ][4], sl[KQ][4];
#pragma unroll
          for (int kk = 0; kk < KQ; ++kk) {
            if constexpr (DV) {
              if constexpr (SPLIT)
                mma::pack_a_split<T>(ph[kk], pl[kk], &sa[8 * kk],
                                     &sa[8 * kk + 4]);
              else
                mma::pack_a<T>(ph[kk], &sa[8 * kk], &sa[8 * kk + 4]);
            }
            if constexpr (DK) {
              if constexpr (SPLIT)
                mma::pack_a_split<T>(sh[kk], sl[kk], &pa[8 * kk],
                                     &pa[8 * kk + 4]);
              else
                mma::pack_a<T>(sh[kk], &pa[8 * kk], &pa[8 * kk + 4]);
            }
          }
          if constexpr (DV) sm90::fence_regs(va);
          if constexpr (DK) sm90::fence_regs(ka);
          sm90::wg_fence();
          if constexpr (DV) {
#pragma unroll
            for (int kk = 0; kk < KQ; ++kk) {
              const uint64_t ddo = sm90::desc_mn<BQ>(oa, kk);
              sm90::Wgmma<T, D>::template rs<1>(va, ph[kk], ddo);
              if constexpr (SPLIT)
                sm90::Wgmma<T, D>::template rs<1>(va, pl[kk], ddo);
            }
          }
          if constexpr (DK) {
#pragma unroll
            for (int kk = 0; kk < KQ; ++kk) {
              const uint64_t dqd = sm90::desc_mn<BQ>(qa, kk);
              sm90::Wgmma<T, D>::template rs<1>(ka, sh[kk], dqd);
              if constexpr (SPLIT)
                sm90::Wgmma<T, D>::template rs<1>(ka, sl[kk], dqd);
            }
          }
          sm90::wg_commit();
          sm90::wg_wait<0>();
          if constexpr (DV) sm90::fence_regs(va);
          if constexpr (DK) sm90::fence_regs(ka);
          // this warp is done with the stage
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty + s);
        }
      };

      // one output: with split = 2 block `rank` writes the rows of
      // consumer `rank`, its own partial plus its peer's (one fp32
      // addition, commutative), and the other consumer hands its partial
      // to the peer through this block's shared memory; else each consumer
      // writes its rows
      auto write = [&](float(&a)[D / 2], T* out, Strides os) {
        T* ob = out + b * os.b + kh * os.h;
        auto put = [&](int h, int j, float x0, float x1) {
          const int kpos = k0 + r0 + 8 * h;
          if (kpos < dm.Sk)
            *reinterpret_cast<uint32_t*>(ob + (long long)kpos * os.s + j * 8 +
                                         2 * tq4) = mma::pack2<T>(x0, x1);
        };
        if (split == 1) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              put(h, j, a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
          return;
        }
        if (cw != (int)rank) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(part + (pr + 8 * h) * PLD + j * 8 +
                                         2 * tq4) =
                  make_float2(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
        }
        __syncwarp();
        sm90::cluster_sync();
        if (cw == (int)rank) {
          const uint32_t peer = rank ^ 1u;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
              const float2 pv = sm90::ld_peer2(
                  part + (pr + 8 * h) * PLD + j * 8 + 2 * tq4, peer);
              put(h, j, a[4 * j + 2 * h] + pv.x, a[4 * j + 2 * h + 1] + pv.y);
            }
        }
        __syncwarp();
        sm90::cluster_sync();  // the peer is done reading this partial
      };

      sm90::mbar_wait(kv_full + kslot, (ui / KVS) & 1);
      auto release_kv = [&]() {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(kv_empty + kslot);
      };
      if constexpr (PASSES == 1) {
        float dka[D / 2], dva[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
        items(T_{}, T_{}, dva, dka);
        release_kv();
        write(dva, dv, dvs);
        write(dka, dk, dks);
      } else {
        // one fp32 output at a time: dV over the items, then dK over them
        // again (S^T recomputed)
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        items(T_{}, F_{}, acc, acc);
        write(acc, dv, dvs);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        items(F_{}, T_{}, acc, acc);
        release_kv();
        write(acc, dk, dks);
      }
    }
  }
}

template <typename T, int D>
static int run_dkdv_sm90(const BwdCall& c) {
  using L = Dkdv90<T, D>;
  const Dims& dm = c.dm;
  CUtensorMap mq, mk, mv, mdo;
  if (!tensor_map<T>(&mq, c.q, dm.B, dm.N, dm.S, D, strides_at(c.st, 0),
                     L::BQ) ||
      !tensor_map<T>(&mk, c.k, dm.B, dm.K, dm.Sk, D, strides_at(c.st, 1),
                     L::BK) ||
      !tensor_map<T>(&mv, c.v, dm.B, dm.K, dm.Sk, D, strides_at(c.st, 2),
                     L::BK) ||
      !tensor_map<T>(&mdo, c.dO, dm.B, dm.N, dm.S, D, strides_at(c.st, 3),
                     L::BQ))
    return (int)cudaErrorNotSupported;
  const int nqt = (dm.S + L::BQ - 1) / L::BQ;
  const int smem = L::OFF_FLAG + (nqt + 15) / 16 * 16 + 1024;
  auto kern = flash_bwd_dkdv_kernel_wg<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // a cluster of two blocks a unit where a k tile's items can reach
  // WG_K2_SPLIT_ITEMS: a rule of the (batch row, kv head) problem, S and
  // G, so each output's sum order never depends on B, N or the grid
  const int G = dm.N / dm.K;
  const int split = G * nqt >= WG_K2_SPLIT_ITEMS ? 2 : 1;
  // persistent (a block an SM walking the units) where a unit is short,
  // which is where no cluster splits it; else a block (or cluster) a unit
  const int units = (dm.Sk + L::BK - 1) / L::BK * dm.K * dm.B;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split == 2 ? 2 * units : min(units, sm_count()), 1, 1);
  cfg.blockDim = dim3(WG_NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split == 2 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, mq, mk, mv, mdo, c.lse, c.delta, c.seg,
                           static_cast<T*>(c.out0), static_cast<T*>(c.out1),
                           dm, strides_at(c.st, 4), strides_at(c.st, 5),
                           c.causal, c.scale, c.dr, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_dkdv_sm90(int dtype, const BwdCall& c) {
  const void* ops[6] = {c.q, c.k, c.v, c.dO, c.out0, c.out1};
  for (int i = 0; i < 6; ++i)
    if (!tma_ok(ops[i], strides_at(c.st, i), c.dm.D))
      return (int)cudaErrorNotSupported;
  if (dtype == kBF16)
    return c.dm.D == 64 ? run_dkdv_sm90<__nv_bfloat16, 64>(c)
                        : run_dkdv_sm90<__nv_bfloat16, 128>(c);
  if (dtype == kF16)
    return c.dm.D == 64 ? run_dkdv_sm90<__half, 64>(c)
                        : run_dkdv_sm90<__half, 128>(c);
  return (int)cudaErrorNotSupported;
}

}  // namespace galv
