// K1 on the wgmma route: the flash-attention forward redesigned for Hopper.
//
// Replaces, with flash_fwd.cu's mma.sync kernel on the operands this route
// does not take, hetu_galvatron_tpu/ops/pallas/flash_attention.py::
// _flash_kernel (:86, launched by flash_attention_hmajor :163, pallas_call
// at :220). ops/flash_attention.py::kernel_route sends bf16 and fp16 at
// D = 64 or 128 on operands TMA can describe (a base on 16 bytes, strides in
// multiples of 8 elements: the fused-qkv views of every main path) here,
// before the launch; the C side refuses anything else with
// cudaErrorNotSupported, and the wrapper raises.
//
// What held flash_fwd.cu's flash_fwd_kernel_tc (:261; design note :19-74,
// tiles in flash_tc.cuh:24-34) at 14-32% of its bound:
//   - mma.sync tiles and no wgmma. Four warps each owned 16 rows of a
//     64-row q tile and each read the whole k and v tile from shared memory
//     through ldmatrix: the same bytes crossed shared memory four times a
//     tile, and the warp-level instruction never reaches the card's
//     tensor-core rate.
//   - No producer / consumer split: a two-stage cp.async ring issued by
//     all 128 threads with a __syncthreads a tile, so the softmax of tile j
//     ran serially between tile j's Q K^T and tile j+1's.
//   - The register cap: K1_MINB gave 2 blocks of 4 warps an SM at D=128,
//     8 warps resident.
//
// The design here (hopper-kernels guide section 1):
//   - Warps. 384 threads: warpgroup 0 is the producer (setmaxnreg down to
//     56 registers; its warp 0 issues every load), warpgroups 1 and 2 are
//     consumers (setmaxnreg up to 224), each owning 64 rows of a 128-row q
//     tile. One block an SM.
//   - Loads. TMA brings each unit's q tile into one of two q buffers and
//     streams k and v through a ring of three shared-memory stages in the
//     128-byte swizzle, each stage completing on an mbarrier with an
//     expected transaction count (full); the consumers' eight warps
//     release a stage on a second mbarrier (empty). The producer warp
//     decides the tile rule itself (a warp reduction of each tile's
//     segment ids), and writes the tile's index, flag and k rows' segment
//     ids into the stage before it arms it; a stage without a tile ends a
//     unit. A ragged S or Sk reads zeros past the end (TMA's out-of-bounds
//     fill) and is masked in-kernel.
//   - Units. A unit is a (q tile, head, batch). Where a q tile meets at
//     most WG_SHORT_TILES k tiles (T5, BERT) the grid is persistent, a
//     block an SM taking its units in a snake order, so one unit's loads
//     overlap the previous one's tiles and set-up is paid once a block;
//     otherwise a block a unit, heaviest first, which the card balances.
//   - Products. S = Q K^T is an SS wgmma.m64nBKk16 (q and k K-major in
//     shared memory), fp32 accumulators; O += P V is an RS wgmma.m64nDk16:
//     P goes from the S accumulators into A-operand registers, V is the B
//     operand in its natural [k][d] layout, read MN-major by the
//     descriptor. Each consumer issues its products, commits and waits
//     before its softmax; the two consumers run out of step, so one's
//     softmax overlaps the other's products, and the producer's loads
//     overlap both.
//   - Tiles: 128 x 128 at D=64 (S and P take 64 + 64 registers, O 32),
//     128 x 64 at D=128 (O takes 64; the S, P and O of a 128-column tile
//     would leave no headroom under 224 registers for bf16's hi + lo).
//
// Kept bit for bit in function from the mma.sync kernel: fp32
// accumulators; 1/sqrt(D) on the fp32 scores, folded with log2(e) into
// exp2f, q never pre-scaled in 16 bits; masks with the JAX kernel's
// finfo-min NEG_INF; corr 0 while m is NEG_INF; l over the undropped p;
// the counter-based dropout at each element's global (q, k), from the
// accumulator layout (flash_sm90.cuh); lse as m ln 2 + log l; the tile rule
// (tile_flags, ops/flash_attention.py::computed_tiles) at these tiles.
// bf16 keeps P as hi + lo (two RS products, flash_fwd.cu:32-38: one
// rounding put single dq elements 3.9x past phase 3's 16-bit limit); fp16
// rounds P once. So in bf16 the kernel runs 3 products a tile where the
// bound counts 2: at the full tensor-core rate bf16 reaches at most 2/3 of
// its bound (SDPA sits at 59% at the unpacked Qwen shape).
//
// Each output element's sum order depends only on its own (b, n, q tile):
// the k tiles in order, each one product chain. Nothing depends on B, N or
// the grid, so the compiled pipeline's lanes folded into the batch and
// DDP's replicas stay bit-identical to their references.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): two tile products
// over the kept (q, k) pairs against q, k, v read once and o, lse written
// once (chip_smoke.py::bounds).
#include "flash_sm90.cuh"

namespace galv {

template <typename T, int D>
struct Fwd90 {
  static constexpr int BQ = WG_K1_BQ;
  static constexpr int BK = D == 64 ? WG_K1_BK64 : WG_K1_BK128;
  static constexpr int ST = 3;  // stages of the k / v ring
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one of k, v
  static constexpr int OFF_K = 2 * Q_BYTES;    // q is double-buffered
  static constexpr int OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr int OFF_KSEG = OFF_V + ST * KV_BYTES;
  static constexpr int OFF_META = OFF_KSEG + ST * BK * 4;  // tile, flag
  static constexpr int OFF_QSEG = OFF_META + ST * 8;
  static constexpr int OFF_BAR = OFF_QSEG + 2 * BQ * 4;
  static constexpr int SMEM = OFF_BAR + (4 + 2 * ST) * 8;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "tiles start on the swizzle's 1024-byte period");
};

template <typename T, int D>
__global__ void __launch_bounds__(WG_NT, 1)
    flash_fwd_kernel_wg(__grid_constant__ const CUtensorMap tq,
                        __grid_constant__ const CUtensorMap tk,
                        __grid_constant__ const CUtensorMap tv,
                        T* __restrict__ o, float* __restrict__ lse,
                        const int* __restrict__ seg, Dims dm, Strides os,
                        int causal, float scale, DropoutArgs dr) {
  using L = Fwd90<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST;
  constexpr int NK8 = BK / 8, KK = BK / 16, KD = D / 16;
  constexpr bool SPLIT = std::is_same<T, __nv_bfloat16>::value;
  static_assert(4 * NK8 <= 64, "one mask bit a score element");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = sm90::smem_1024(smem_raw);
  int* kseg_s = reinterpret_cast<int*>(sm + L::OFF_KSEG);
  int* meta = reinterpret_cast<int*>(sm + L::OFF_META);  // [ST][2]
  int* qseg_s = reinterpret_cast<int*>(sm + L::OFF_QSEG);  // [2][BQ]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);  // [2]
  uint64_t* q_empty = q_full + 2;                                    // [2]
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + ST;

  // The units (q-tile, head, batch) go round the blocks (snake_unit): one
  // each when the grid covers them, several in a persistent grid. The
  // q-tile index varies slowest, from the last, so under causality the
  // units that loop over the most k-tiles come first
  const int nqt = (dm.S + BQ - 1) / BQ;
  const int NB = dm.N * dm.B, units = nqt * NB;
  const int nkt = (dm.Sk + BK - 1) / BK;
  const bool has_seg = seg != nullptr;
  struct Unit {
    int qt, n, b, q0, last;
  };
  auto unit = [&](int u) {
    Unit x;
    const int qr_ = u / NB, rem = u - qr_ * NB;
    x.qt = nqt - 1 - qr_;
    x.n = rem % dm.N;
    x.b = rem / dm.N;
    x.q0 = x.qt * BQ;
    x.last = causal ? min(nkt - 1, (x.q0 + BQ - 1) / BK) : nkt - 1;
    return x;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(q_full + i, 1);
      sm90::mbar_init(q_empty + i, 8);  // the consumers' warps
    }
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: warp 0 keeps the ring full, warps 1-3 idle
    sm90::reg_dealloc<WG_PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int it = 0, ui = 0;  // tiles through the ring, units of this block
      for (int u; (u = snake_unit(ui, blockIdx.x, gridDim.x, units)) >= 0;
           ++ui) {
        const Unit x = unit(u);
        const int kh = x.n / (dm.N / dm.K), qs = ui & 1;
        const int* sb = has_seg ? seg + (long long)x.b * dm.S : nullptr;
        sm90::mbar_wait(q_empty + qs, ((ui >> 1) & 1) ^ 1);
        int2 fr = make_int2(0, 0);
        if (has_seg) {
          for (int r = lane; r < BQ; r += 32)
            qseg_s[qs * BQ + r] = x.q0 + r < dm.S ? sb[x.q0 + r] : -1;
          fr = tile_range(sb, x.q0, BQ, dm.S);
        }
        __syncwarp();
        if (lane == 0) {
          sm90::mbar_expect_tx(q_full + qs, L::Q_BYTES);
          sm90::tma_tile<D, BQ>(sm + qs * L::Q_BYTES, &tq, q_full + qs,
                                x.q0, x.n, x.b);
        }
        // the k-tiles that pair with this q-tile: up to the causal
        // diagonal, with overlapping segment ranges (the tile rule)
        for (int kt = 0; kt <= x.last; ++kt) {
          const int k0 = kt * BK;
          int flag = 2;
          if (has_seg) {
            flag = pair_flag(fr, tile_range(sb, k0, BK, dm.Sk));
            if (flag == 0) continue;
          }
          const int s = it % ST;
          sm90::mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
          if (has_seg)
            for (int r = lane; r < BK; r += 32)
              kseg_s[s * BK + r] = k0 + r < dm.Sk ? sb[k0 + r] : -2;
          __syncwarp();
          if (lane == 0) {
            meta[2 * s] = kt;
            meta[2 * s + 1] = flag;
            sm90::mbar_expect_tx(full + s, 2 * L::KV_BYTES);
            sm90::tma_tile<D, BK>(sm + L::OFF_K + s * L::KV_BYTES, &tk,
                                  full + s, k0, kh, x.b);
            sm90::tma_tile<D, BK>(sm + L::OFF_V + s * L::KV_BYTES, &tv,
                                  full + s, k0, kh, x.b);
          }
          ++it;
        }
        // the unit's end: a stage without a tile
        const int s = it % ST;
        sm90::mbar_wait(empty + s, ((it / ST) & 1) ^ 1);
        if (lane == 0) {
          meta[2 * s] = -1;
          sm90::mbar_arrive(full + s);
        }
        ++it;
      }
    }
  } else {
    sm90::reg_alloc<WG_CONSUMER_REGS>();
    const int cw = (threadIdx.x >> 7) - 1;  // consumer 0 or 1
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    const int gq = lane >> 2, tq4 = lane & 3;
    const int r0 = cw * 64 + w * 16 + gq;  // this thread's q rows: r0, r0 + 8
    const float scale2 = scale * LOG2E, inv_keep = 1.f / dr.keep_prob;
    int it = 0, ui = 0;
    for (int u; (u = snake_unit(ui, blockIdx.x, gridDim.x, units)) >= 0;
         ++ui) {
      const Unit x = unit(u);
      const int n = x.n, b = x.b, q0 = x.q0, qs = ui & 1;
      const int* qsg = qseg_s + qs * BQ;
      const uint32_t key =
          dr.on ? head_key(dr.seed, (uint32_t)(b * dm.N + n)) : 0u;

      // O, and the running max (in units of log2, scaled) and per-lane
      // partial normaliser of rows r0 and r0 + 8
      float oa[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oa[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

      sm90::mbar_wait(q_full + qs, (ui >> 1) & 1);
      while (true) {
        const int s = it % ST;
        sm90::mbar_wait(full + s, (it / ST) & 1);
        ++it;
        const int kt = meta[2 * s];
        if (kt < 0) {  // the unit's end
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(empty + s);
          break;
        }
        const int flag = meta[2 * s + 1];
        const uint32_t qa =
            sm90::opaque(sm90::smem_u32(sm)) + qs * L::Q_BYTES;
        const uint32_t ka = sm90::opaque(sm90::smem_u32(sm)) + L::OFF_K +
                            s * L::KV_BYTES;
        const uint32_t va = ka + (L::OFF_V - L::OFF_K);
        const int* ksg = kseg_s + s * BK;
        const int k0 = kt * BK;

        // S = Q K^T: this consumer's 64 q rows x BK k columns
        float sa[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sa[i] = 0.f;
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          sm90::Wgmma<T, BK>::template ss<0>(
              sa, sm90::desc_k<BQ>(qa, cw * 64, kk),
              sm90::desc_k<BK>(ka, 0, kk));
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs(sa);

        // an edge tile needs the mask; elsewhere every pair is attended
        bool edge = q0 + BQ > dm.S || k0 + BK > dm.Sk ||
                    (causal && q0 < k0 + BK - 1);
        if (has_seg) edge = edge || flag != 2;
        with_cases(edge, dr.on, [&](auto edge_c, auto drop_c) {
          // bit 4 j + e set: element 4 j + e (row r0 + 8 (e / 2), column
          // 8 j + 2 tq4 + e % 2) is attended. Row h attends the columns
          // below lim[h] (past Sk, and with causality past its own
          // position, nothing), then within its document.
          uint64_t okb = ~0ull;
          if constexpr (decltype(edge_c)::value) {
            int lim[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int qpos = q0 + r0 + 8 * h;
              lim[h] = qpos < dm.S ? dm.Sk - k0 : 0;
              if (causal) lim[h] = min(lim[h], qpos - k0 + 1);
            }
#pragma unroll
            for (int j = 0; j < NK8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = j * 8 + 2 * tq4 + (e & 1);
                bool ok = c < lim[e >> 1];
                if (has_seg) ok = ok && qsg[r0 + 8 * (e >> 1)] == ksg[c];
                if (!ok) okb &= ~(1ull << (4 * j + e));
              }
          }
          float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int j = 0; j < NK8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& v = sa[4 * j + e];
              v = (okb >> (4 * j + e)) & 1ull ? v * scale2 : NEG_INF;
              mx[e >> 1] = fmaxf(mx[e >> 1], v);
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
          for (int i = 0; i < D / 2; ++i) oa[i] *= corr[(i & 3) >> 1];
#pragma unroll
          for (int j = 0; j < NK8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& v = sa[4 * j + e];
              const float p =
                  (okb >> (4 * j + e)) & 1ull ? exp2f(v - m[e >> 1]) : 0.f;
              // the normaliser uses the undropped p: out = dropout(P) V
              l[e >> 1] += p;
              if constexpr (decltype(drop_c)::value) {
                const int qpos = q0 + r0 + 8 * (e >> 1);
                const int kpos = k0 + j * 8 + 2 * tq4 + (e & 1);
                v = keep(key, qpos, kpos, dr.threshold) ? p * inv_keep : 0.f;
              } else {
                v = p;
              }
            }
        });

        // O += P V: P is the A operand, rounded to T in registers (bf16 as
        // hi + lo, two products a k16 step)
        uint32_t ph[KK][4];
        [[maybe_unused]] uint32_t pl[KK][4];
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          if constexpr (SPLIT)
            mma::pack_a_split<T>(ph[kk], pl[kk], &sa[8 * kk],
                                 &sa[8 * kk + 4]);
          else
            mma::pack_a<T>(ph[kk], &sa[8 * kk], &sa[8 * kk + 4]);
        }
        sm90::fence_regs(oa);
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const uint64_t dv = sm90::desc_mn<BK>(va, kk);
          sm90::Wgmma<T, D>::template rs<1>(oa, ph[kk], dv);
          if constexpr (SPLIT)
            sm90::Wgmma<T, D>::template rs<1>(oa, pl[kk], dv);
        }
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs(oa);
        // this warp is done with the stage
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + s);
      }
      // this warp is done with the q tile and its segment ids
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(q_empty + qs);

      T* ob = o + b * os.b + n * os.h;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int qpos = q0 + r0 + 8 * h;
        if (qpos >= dm.S) continue;
        const float lf = fmaxf(l[h], 1e-20f), inv = 1.f / lf;
        T* orow = ob + (long long)qpos * os.s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * tq4) =
              mma::pack2<T>(oa[4 * j + 2 * h] * inv,
                            oa[4 * j + 2 * h + 1] * inv);
        // natural-log logsumexp, as the JAX kernel's m + log(l)
        if (tq4 == 0)
          lse[((long long)b * dm.N + n) * dm.S + qpos] =
              (m[h] == NEG_INF ? NEG_INF : m[h] * LN2) + logf(lf);
      }
    }
  }
}

template <typename T, int D>
static int run_fwd_sm90(const FwdCall& c) {
  using L = Fwd90<T, D>;
  const Dims& dm = c.dm;
  CUtensorMap mq, mk, mv;
  if (!tensor_map<T>(&mq, c.q, dm.B, dm.N, dm.S, D, strides_at(c.st, 0),
                     L::BQ) ||
      !tensor_map<T>(&mk, c.k, dm.B, dm.K, dm.Sk, D, strides_at(c.st, 1),
                     L::BK) ||
      !tensor_map<T>(&mv, c.v, dm.B, dm.K, dm.Sk, D, strides_at(c.st, 2),
                     L::BK))
    return (int)cudaErrorNotSupported;
  const int smem = L::SMEM + 1024;
  auto kern = flash_fwd_kernel_wg<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent (a block an SM walking the units) where a unit is short:
  // there a block's set-up would cost about what its tiles do; else a
  // block a unit, which the card schedules as blocks finish
  const int units = (dm.S + L::BQ - 1) / L::BQ * dm.N * dm.B;
  const bool persistent = (dm.Sk + L::BK - 1) / L::BK <= WG_SHORT_TILES;
  kern<<<persistent ? min(units, sm_count()) : units, WG_NT, smem,
         c.stream>>>(
      mq, mk, mv, static_cast<T*>(c.o), c.lse, c.seg, dm,
      strides_at(c.st, 3), c.causal, c.scale, c.dr);
  return (int)cudaGetLastError();
}

int launch_fwd_sm90(int dtype, const FwdCall& c) {
  const void* ops[4] = {c.q, c.k, c.v, c.o};
  for (int i = 0; i < 4; ++i)
    if (!tma_ok(ops[i], strides_at(c.st, i), c.dm.D))
      return (int)cudaErrorNotSupported;
  if (dtype == kBF16)
    return c.dm.D == 64 ? run_fwd_sm90<__nv_bfloat16, 64>(c)
                        : run_fwd_sm90<__nv_bfloat16, 128>(c);
  if (dtype == kF16)
    return c.dm.D == 64 ? run_fwd_sm90<__half, 64>(c)
                        : run_fwd_sm90<__half, 128>(c);
  return (int)cudaErrorNotSupported;
}

}  // namespace galv
