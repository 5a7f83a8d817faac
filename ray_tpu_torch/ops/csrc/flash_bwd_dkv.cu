// Flash-attention backward, dK and dV, for Hopper (sm_90a), bound to
// PyTorch through a plain C entry point (`flash_bwd_dkv`) that
// ray_tpu_torch/ops/attention.py loads with ctypes.
//
// Replaces: ray_tpu/ops/attention.py:_bwd_dkv_kernel (Pallas, TPU),
// launched by _flash_bwd. Same function: for each key row, over every
// query row the mask lets see it, p = exp(s - lse), dV += p^T . dO with p
// rounded to the input dtype, dp = dO . V^T, ds = p * (dp - delta) and
// dK += scale * ds^T . Q with ds rounded to the input dtype; both
// accumulate in fp32 and are written once in the input dtype. Under the
// causal (top-left) mask the q tiles start at the first one that reaches
// the diagonal, as in the Pallas kernel.
//
// GQA: one block serves one KV head and loops over the G = H / Hkv query
// heads that share it, summing their contributions into one fp32
// accumulator. That is the sum JAX gets from AD through jnp.repeat (there
// as G per-head results in the input dtype); here it is one fp32 sum, with
// no atomics and no repeated K/V, so the result does not depend on the
// order blocks run in.
//
// Layout: q, dO [B, Lq, H, D], k/v/dK/dV [B, Lk, Hkv, D] through their
// strides (last dim contiguous); lse and delta [B, H, Lq] fp32. D is 64 or
// 128.
//
// Two paths, chosen by dtype in the C entry:
//
// bf16: tensor cores (wgmma) fed by TMA. The Pallas kernel's four products
// are jnp.dot(bf16, bf16, preferred_element_type=f32), exactly bf16 wgmma
// with fp32 accumulators. Bound on an H100 SXM at the tpu-3b training
// shape (B=4, L=1024, H=24, Hkv=8, D=128, causal): four products of 2 D
// FLOPs per kept (query, key) pair, 51.6 GFLOP, against ~93 MB of
// compulsory traffic, so by operations at ~0.05 ms.
//   Block: one per (KV head, batch, 128-key tile), 256 threads in two
// warpgroups of 64 key rows each, which hold dK and dV for their rows in
// registers (2 x 64 fp32 a thread at D=128). Warp 0 does the loads: its
// lane 0 brings the block's K and V tiles once by TMA, then, for each
// query head of the group and each 64-row q tile from the diagonal on,
// the Q and dO tiles into a 3-stage ring, and the warp's lanes copy the
// tile's 64 lse and delta values beside them with plain loads (rows of
// [B, H, Lq] fp32 do not meet TMA's 16-byte stride rule for every Lq), each
// side one arrival on the stage's full barrier; step it + 3 is issued as
// soon as both warpgroups have released step it. Per q tile, all bf16 ->
// fp32 on wgmma: S^T = K . Q^T and dP^T = V . dO^T (A = K or V, B = Q or
// dO, all K-major), issued together; p^T = exp2(s^T scale log2 e - lse
// log2 e) on the S^T fragments while dP^T runs; dV += bf16(P^T) . dO and
// dK += bf16(dS^T) . Q with P^T and dS^T packed in registers as the A
// operand and dO and Q read MN-major from the same tiles. A warpgroup
// whose 64 keys all lie after a causal q tile skips it. The epilogue
// writes dK (times scale) and dV through the warpgroup's own K and V rows
// in shared memory with TMA stores, which clip rows past Lk.
//   Why no producer warpgroup: with one (384 threads, setmaxnreg moving
// registers to the consumers) ptxas (CUDA 12.9) still allocates every
// thread's code within 168 registers, and the D=128 consumer spilled
// heavily; at 256 threads it gets 255 and spills 68 bytes, and measured
// faster (PERF.md).
//   Order: blockIdx.z is the key tile, so under the causal mask the tiles
// with the most q tiles (key tile 0 has 8x the work of the last at
// L=1024) start first, and the light ones fill in behind them (heaviest
// first, not persistent).
//   Budget (ptxas, CUDA 12.9): D=128 255 registers with a 72-byte stack
// (68 bytes of spill stores), 161.5 KB of shared memory (K and V 64 KB,
// three stages of Q, dO, lse and delta at 32.5 KB), one block per SM;
// D=64 207 registers, no spill, 81 KB.
//
// fp32: the FMA kernel of the first port of this kernel, unchanged: tensor
// cores would compute fp32 products in TF32 and break the 2e-3 fp32 parity
// this kernel is held to, and fp32 runs on no main path. One block of 128
// threads per (batch, KV head, 64-row k tile); K and V stay in shared
// memory as fp32 for the whole block, each q tile brings Q, dO, lse and
// delta; each thread owns 4 key rows x 8 query columns of the transposed
// score tile and 4 key rows x D/8 columns of dK and dV. There is no switch
// between the two paths: bf16 launches the tensor-core kernel or fails.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = TILE;   // query rows per q tile
constexpr int BK = TILE;   // key rows per block

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int G, int Lq, int Lk,
    int64_t sqb, int64_t sql, int64_t sqh,
    int64_t skb, int64_t skl, int64_t skh,
    int64_t svb, int64_t svl, int64_t svh,
    int64_t sdb, int64_t sdl, int64_t sdh,
    int64_t skgb, int64_t skgl, int64_t skgh,
    int64_t svgb, int64_t svgl, int64_t svgh,
    float scale, int causal) {
  constexpr int LD = D + 1;   // padded fp32 row of a K/V/Q/dO tile
  constexpr int LP = BQ + 1;  // padded fp32 row of the P and dS tiles
  constexpr int CO = D / 8;   // dK/dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;             // [BK][LD]
  float* sV = sK + BK * LD;     // [BK][LD]
  float* sQ = sV + BK * LD;     // [BQ][LD]
  float* sdO = sQ + BQ * LD;    // [BQ][LD]
  float* sP = sdO + BQ * LD;    // [BK][LP]: p^T, key rows x query columns
  float* sDS = sP + BK * LP;    // [BK][LP]: dp^T, then ds^T
  float* sLse = sDS + BK * LP;  // [BQ]
  float* sDelta = sLse + BQ;    // [BQ]

  const int kt = blockIdx.x;    // k tile 0 has the most causal q tiles
  const int hk = blockIdx.y, b = blockIdx.z;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int k0 = kt * BK;
  const int r0 = rg * RM;       // first of this thread's key rows

  load_tile<T, D>(sK, k + b * skb + hk * skh, skl, k0, Lk);
  load_tile<T, D>(sV, v + b * svb + hk * svh, svl, k0, Lk);

  float acc_k[RM][CO], acc_v[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nq = (Lq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;   // earlier q tiles see no key here
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's products are done with
                         // sQ, sdO, sP, sDS, sLse and sDelta
      load_tile<T, D>(sQ, q + b * sqb + h * sqh, sql, q0, Lq);
      load_tile<T, D>(sdO, dout + b * sdb + h * sdh, sdl, q0, Lq);
      {
        const int r = threadIdx.x & (BQ - 1);
        const int qpos = q0 + r;
        const float* src = threadIdx.x < BQ ? lse : delta;
        float* dst = threadIdx.x < BQ ? sLse : sDelta;
        dst[r] = qpos < Lq ? src[((int64_t)b * H + h) * Lq + qpos] : 0.f;
      }
      __syncthreads();

      {  // dp^T = V . dO^T, parked in the dS tile
        float dp[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) dp[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float vv[RM], ov[CN];
#pragma unroll
          for (int i = 0; i < RM; ++i) vv[i] = sV[(r0 + i) * LD + d];
#pragma unroll
          for (int j = 0; j < CN; ++j) ov[j] = sdO[(cg + 8 * j) * LD + d];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j)
              dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j)
            sDS[(r0 + i) * LP + cg + 8 * j] = dp[i][j];
      }

      {  // s^T = K . Q^T, then p^T and ds^T
        float s[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float kv[RM], qv[CN];
#pragma unroll
          for (int i = 0; i < RM; ++i) kv[i] = sK[(r0 + i) * LD + d];
#pragma unroll
          for (int j = 0; j < CN; ++j) qv[j] = sQ[(cg + 8 * j) * LD + d];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j)
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int kpos = k0 + r0 + i;
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            const int col = cg + 8 * j;
            const int qpos = q0 + col;
            const bool keep =
                kpos < Lk && qpos < Lq && (!causal || qpos >= kpos);
            // a masked score is -1e30 in the Pallas kernel:
            // exp(-1e30 - lse) = 0
            const float p = keep ? expf(s[i][j] * scale - sLse[col]) : 0.f;
            const int at = (r0 + i) * LP + col;
            sP[at] = round_to<T>(p);
            sDS[at] = round_to<T>(p * (sDS[at] - sDelta[col]));
          }
        }
      }
      __syncthreads();   // P and dS are complete

#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RM], dsv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = sP[(r0 + i) * LP + qq];
          dsv[i] = sDS[(r0 + i) * LP + qq];
        }
#pragma unroll
        for (int c = 0; c < CO; ++c) {
          const float ov = sdO[qq * LD + cg + 8 * c];
          const float qv = sQ[qq * LD + cg + 8 * c];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kpos = k0 + r0 + i;
    if (kpos >= Lk) continue;
    T* krow = dk + b * skgb + kpos * skgl + hk * skgh;
    T* vrow = dv + b * svgb + kpos * svgl + hk * svgh;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      krow[cg + 8 * c] = from_f<T>(acc_k[i][c] * scale);
      vrow[cg + 8 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int H, int Hkv, int Lq, int Lk, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      (size_t)(4 * BK * LD + 2 * BK * (BQ + 1) + 2 * BQ) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lk + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, H / Hkv, Lq, Lk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], st[15], st[16], st[17], scale, causal);
  return (int)cudaGetLastError();
}


// ---------------------------------------------- bf16: wgmma + TMA (sm_90a)
namespace tc {

using namespace sm90;

constexpr int BK = 128;          // key rows per block: two warpgroups
constexpr int WK = 64;           // key rows per warpgroup
constexpr int BQ = 64;           // q rows per q tile
constexpr int STAGES = 3;        // Q/dO ring depth
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte aligned base
template <int D>
struct Smem {
  static constexpr int KV_BYTES = BK * D * 2;  // [D/64][BK][128 B]
  static constexpr int Q_BYTES = BQ * D * 2;   // [D/64][BQ][128 B]
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;       // STAGES Q tiles
  static constexpr int DO = Q + STAGES * Q_BYTES;
  static constexpr int LSE = DO + STAGES * Q_BYTES;   // STAGES x BQ fp32
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  static constexpr int BARS = DELTA + STAGES * BQ * 4;
  // bar_kv, full[STAGES], empty[STAGES]
  static constexpr int TOTAL = BARS + (1 + 2 * STAGES) * 8;
  static constexpr int LAUNCH = TOTAL + 1024;  // room to align the base
};

// The loads of step `it` (query head it / nqt, q tile it % nqt from qt0)
// into its stage, issued by warp 0 once both warpgroups have released the
// stage: Q and dO by TMA from lane 0, the tile's lse (in log2 units) and
// delta by the warp's lanes with plain loads, each side one arrival on the
// stage's full barrier.
template <int D>
__device__ __forceinline__ void load_step(
    uint8_t* sm, const CUtensorMap* mq, const CUtensorMap* mdo,
    const float* lse, const float* delta, uint64_t* full, uint64_t* empty,
    int it, int nqt, int qt0, int hk, int G, int H, int b, int Lq, int lane) {
  using S = Smem<D>;
  const int st = it % STAGES;
  const int h = hk * G + it / nqt;
  const int q0 = (qt0 + it % nqt) * BQ;
  mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
  if (lane == 0) {
    mbar_expect_tx(&full[st], 2 * S::Q_BYTES);
    for (int s = 0; s < D / 64; ++s) {
      tma_load_4d(sm + S::Q + st * S::Q_BYTES + s * BQ * 128, mq, &full[st],
                  64 * s, q0, h, b);
      tma_load_4d(sm + S::DO + st * S::Q_BYTES + s * BQ * 128, mdo,
                  &full[st], 64 * s, q0, h, b);
    }
  }
  float* sLse = reinterpret_cast<float*>(sm + S::LSE) + st * BQ;
  float* sDelta = reinterpret_cast<float*>(sm + S::DELTA) + st * BQ;
  const int64_t row = ((int64_t)b * H + h) * Lq;
  for (int i = lane; i < BQ; i += 32) {
    const bool in = q0 + i < Lq;
    sLse[i] = in ? lse[row + q0 + i] * LOG2E : 0.f;
    sDelta[i] = in ? delta[row + q0 + i] : 0.f;
  }
  __syncwarp();
  if (lane == 0) mbar_arrive(&full[st]);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_tc_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mdk,
    const __grid_constant__ CUtensorMap mdv, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int G, int Lq, int Lk,
    float scale, int causal) {
  using S = Smem<D>;
  constexpr int SLICES = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const float* sLse = reinterpret_cast<const float*>(sm + S::LSE);
  const float* sDelta = reinterpret_cast<const float*>(sm + S::DELTA);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + STAGES;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;   // key tile 0 (the heaviest) first
  const int nq = (Lq + BQ - 1) / BQ;
  const int qt0 = causal ? min(k0 / BQ, nq) : 0;
  const int nqt = nq - qt0;         // q tiles per query head
  const int n_it = G * nqt;         // (query head, q tile) steps

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 2);   // the TMA bytes' arrival + the lse copy's
      mbar_init(&empty[s], THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int cw = threadIdx.x / 128;     // warpgroup: 64 key rows each
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const bool loader = threadIdx.x < 32;  // warp 0 issues every load
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * S::KV_BYTES);
      for (int s = 0; s < SLICES; ++s) {
        tma_load_4d(sm + S::K + s * BK * 128, &mk, bar_kv, 64 * s, k0, hk, b);
        tma_load_4d(sm + S::V + s * BK * 128, &mv, bar_kv, 64 * s, k0, hk, b);
      }
    }
    for (int it = 0; it < min(STAGES, n_it); ++it)
      load_step<D>(sm, &mq, &mdo, lse, delta, full, empty, it, nqt, qt0, hk,
                   G, H, b, Lq, lane);
  }

  const int r_in = 16 * w + lane / 4;   // this thread's first key row
  const int kw0 = k0 + WK * cw;         // the warpgroup's first key
  uint8_t* sK = sm + S::K + cw * WK * 128;
  uint8_t* sV = sm + S::V + cw * WK * 128;
  const float scale_log2 = scale * LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    const int q0 = (qt0 + it % nqt) * BQ;
    mbar_wait(&full[st], (it / STAGES) & 1);
    // under the causal mask a warpgroup whose keys all come after this q
    // tile's rows has nothing to add
    if (!causal || q0 + BQ - 1 >= kw0) {
      const uint8_t* sQ = sm + S::Q + st * S::Q_BYTES;
      const uint8_t* sdO = sm + S::DO + st * S::Q_BYTES;
      const float* lse2 = sLse + st * BQ;
      const float* dlt = sDelta + st * BQ;

      float s[BQ / 2], dp[BQ / 2];   // S^T and dP^T, 64 keys x 64 queries
      const uint64_t k_desc = desc_kmajor(sK), v_desc = desc_kmajor(sV);
      const uint64_t q_desc = desc_kmajor(sQ), do_desc = desc_kmajor(sdO);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(s, kstep_kmajor(k_desc, BK, kk),
                        kstep_kmajor(q_desc, BQ, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BQ, 0>(dp, kstep_kmajor(v_desc, BK, kk),
                        kstep_kmajor(do_desc, BQ, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      reg_fence(s);

      // p^T on the S^T fragments; masked pairs are 0 (exp(-1e30 - lse))
      const bool edge = q0 + BQ > Lq || kw0 + WK > Lk ||
                        (causal && kw0 + WK - 1 > q0);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = 8 * j + 2 * (lane % 4) + c;
            float p =
                exp2f(fmaf(s[4 * j + 2 * i + c], scale_log2, -lse2[qc]));
            if (edge) {
              const int kpos = kw0 + r_in + 8 * i, qpos = q0 + qc;
              if (kpos >= Lk || qpos >= Lq || (causal && qpos < kpos))
                p = 0.f;
            }
            s[4 * j + 2 * i + c] = p;
          }
      uint32_t pa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(s, kk, pa[kk]);
      const uint64_t do_mn = desc_mnmajor(sdO, BQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dv, pa[kk], kstep_mnmajor(do_mn, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();   // dP^T is done; dV's product runs on
      reg_fence(dp);

#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qc = 8 * j + 2 * (lane % 4) + c;
            dp[4 * j + 2 * i + c] =
                s[4 * j + 2 * i + c] * (dp[4 * j + 2 * i + c] - dlt[qc]);
          }
      uint32_t dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(dp, kk, dsa[kk]);
      const uint64_t q_mn = desc_mnmajor(sQ, BQ);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<D, 1>(dk, dsa[kk], kstep_mnmajor(q_mn, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      reg_fence(pa);
      reg_fence(dsa);
    }
    mbar_arrive(&empty[st]);
    if (loader && it + STAGES < n_it)
      load_step<D>(sm, &mq, &mdo, lse, delta, full, empty, it + STAGES, nqt,
                   qt0, hk, G, H, b, Lq, lane);
  }

  // epilogue: dK * scale and dV in bf16 through this warpgroup's own K and
  // V rows (its last product is done), one TMA store per 64-column slice
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 8 * j + 2 * (lane % 4);
      const uint32_t at =
          (col / 64) * BK * 128 + swz128(r_in + 8 * i, col % 64);
      *reinterpret_cast<uint32_t*>(sK + at) =
          pack_bf16(dk[4 * j + 2 * i] * scale, dk[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(sV + at) =
          pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (t == 0) {
    for (int s = 0; s < SLICES; ++s) {
      tma_store_4d(&mdk, sK + s * BK * 128, 64 * s, kw0, hk, b);
      tma_store_4d(&mdv, sV + s * BK * 128, 64 * s, kw0, hk, b);
    }
    tma_store_commit_and_wait();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int H, int Hkv, int Lq, int Lk, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!map_bf16_4d(&mq, q, B, Lq, H, D, st[0], st[1], st[2], BQ) ||
      !map_bf16_4d(&mk, k, B, Lk, Hkv, D, st[3], st[4], st[5], BK) ||
      !map_bf16_4d(&mv, v, B, Lk, Hkv, D, st[6], st[7], st[8], BK) ||
      !map_bf16_4d(&mdo, dout, B, Lq, H, D, st[9], st[10], st[11], BQ) ||
      !map_bf16_4d(&mdk, dk, B, Lk, Hkv, D, st[12], st[13], st[14], WK) ||
      !map_bf16_4d(&mdv, dv, B, Lk, Hkv, D, st[15], st[16], st[17], WK))
    return (int)cudaErrorInvalidValue;
  const int smem = Smem<D>::LAUNCH;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B, (Lk + BK - 1) / BK);
  flash_bwd_dkv_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, lse, delta, H, H / Hkv, Lq, Lk, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma + TMA kernel).
// strides (in elements): q, k, v, dO, dK, dV, each as (batch, seq, head).
// Returns a cudaError_t; 0 means launched. Shapes and strides (for bf16
// also TMA's 16-byte rules) are checked by the Python wrapper before the
// call.
int flash_bwd_dkv(int dtype, int D, const void* q, const void* k,
                  const void* v, const void* dout, const float* lse,
                  const float* delta, void* dk, void* dv, int B, int H,
                  int Hkv, int Lq, int Lk, const int64_t* strides,
                  float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                             Lq, Lk, strides, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                              Lq, Lk, strides, scale, causal, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Lq,
                          Lk, strides, scale, causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Lq,
                           Lk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
