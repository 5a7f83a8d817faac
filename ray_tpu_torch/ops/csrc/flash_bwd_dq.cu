// Flash-attention backward, dQ, for Hopper (sm_90a), bound to PyTorch
// through a plain C entry point (`flash_bwd_dq`) that
// ray_tpu_torch/ops/attention.py loads with ctypes.
//
// Replaces: ray_tpu/ops/attention.py:_bwd_dq_kernel (Pallas, TPU), launched
// by _flash_bwd. Same function: for each query row it recomputes the
// scores against every key the mask keeps, p = exp(s - lse) with the lse
// the forward wrote, dp = dO . V^T, ds = p * (dp - delta) with
// delta = rowsum(dO * O) (computed by the wrapper, as JAX computes it
// outside its kernels), and dQ = scale * ds . K, with ds rounded to the
// input dtype before that product and dQ accumulated in fp32 and written
// once in the input dtype. Causal masking is top-left aligned (query i sees
// key j iff i >= j, both from 0) and key tiles past the diagonal are
// skipped, as in the Pallas kernel.
//
// Layout: q, dO, dQ [B, Lq, H, D] and k/v [B, Lk, Hkv, D] through their
// strides (last dim contiguous); lse and delta [B, H, Lq] fp32, the layout
// flash_fwd writes. GQA reads kv head h / (H / Hkv) directly. Ragged Lq/Lk
// are masked here, so every length is taken. D is 64 or 128.
//
// Two paths, chosen by dtype in the C entry:
//
// bf16: tensor cores (wgmma) fed by TMA. The Pallas kernel's three
// products are jnp.dot(bf16, bf16, preferred_element_type=f32), exactly
// bf16 wgmma with fp32 accumulators. Bound on an H100 SXM at the tpu-3b
// training shape (B=4, L=1024, H=24, Hkv=8, D=128, causal): three products
// of 2 D FLOPs per kept (query, key) pair, 38.7 GFLOP, against ~93 MB of
// compulsory traffic, so by operations at ~0.04 ms.
//   Block: one per (query head, batch, 128-row q tile), 256 threads in two
// warpgroups of 64 q rows each, which hold dQ for their rows in registers
// (64 fp32 a thread at D=128). Warp 0's lane 0 brings the block's Q and dO
// tiles once by TMA, then streams 64-key K and V tiles through a 3-stage
// ring (full barriers count the bytes, the empty barrier the 256 threads'
// release). Each thread reads the lse (in log2 units) and delta of its two
// accumulator rows once, with plain loads: rows of [B, H, Lq] fp32 do not
// meet TMA's 16-byte stride rule for every Lq. Per key tile, all bf16 ->
// fp32 on wgmma: S = Q . K^T and dP = dO . V^T (m64n64k16, both operands
// K-major in shared memory), issued together; p = exp2(s scale log2 e -
// lse log2 e) on the S fragments while dP runs; ds = p (dp - delta) packed
// to bf16 in registers as the A operand of dQ += dS . K (m64nDk16), K read
// MN-major from the same tile the scores read K-major; the warpgroup waits
// for that product and releases the stage, and thread 0 refills it with
// tile kt + 3 once both warpgroups have. The two warpgroups overlap each
// other's CUDA-core work with their tensor-core work. (Leaving dS . K in
// flight behind the next tile's S and dP was slower, and ptxas serialized
// its wgmmas: PERF.md, PR 4.) A warpgroup whose rows see none of a tile's
// keys (under the causal mask the tile after its diagonal, or all rows
// past Lq) skips the tile's products but still waits for the tile and
// releases its stage: an empty barrier counts arrivals, so a warpgroup
// that ran ahead would complete a stage's phase by itself.
// The epilogue writes dQ (times scale) in bf16 through the warpgroup's own
// Q rows in shared memory with TMA stores, which clip rows past Lq; rows
// past Lq or Lk read as zeros through the 4-D tensor maps (D, L, H, B),
// and the mask sets their p to 0.
//   Why no producer warpgroup: with one (384 threads, setmaxnreg moving
// registers to the consumers) ptxas (CUDA 12.9) still allocates every
// thread's code within 168 registers, and the D=128 consumers of B1 and
// B3 spilled; 256 threads give the consumers up to 255 (PERF.md, PR 3).
//   Order: blockIdx.z runs the q tiles from the last (the longest causal
// rows) to the first, so the heaviest blocks start first; blockIdx.x is
// the query head, so the G heads of a KV group run side by side and share
// their K/V tiles through L2.
//   Budget (ptxas, CUDA 12.9): D=128 168 registers, no spill, 160 KB of
// shared memory (Q and dO 2 x 32 KB, three stages of K and V at 32 KB),
// one block per SM; D=64 138 registers, no spill, 80 KB.
//
// fp32: the FMA kernel of the first port, unchanged: tensor cores would
// compute fp32 products in TF32 and break the 2e-3 fp32 parity this kernel
// is held to, and fp32 runs on no main path. One block of 128 threads per
// (batch, query head, 64-row q tile). Q and dO of the tile stay in shared
// memory as fp32; each 64-key tile is brought in twice through one buffer,
// V first (for dp), then K (for s and for the dQ product), so a block holds
// Q, dO, one K-or-V tile and the 64x64 dS tile: 113 KB at D=128. Each
// thread owns 4 query rows x 8 key columns of the tile and 4 rows x D/8
// columns of dQ. dp stays in registers until s is ready; ds goes to shared
// memory, rounded, for the dQ product. There is no switch between the two
// paths: bf16 launches the tensor-core kernel or fails.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = TILE;   // query rows per block
constexpr int BK = TILE;   // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int G, int Lq, int Lk,
    int64_t sqb, int64_t sql, int64_t sqh,
    int64_t skb, int64_t skl, int64_t skh,
    int64_t svb, int64_t svl, int64_t svh,
    int64_t sdb, int64_t sdl, int64_t sdh,
    int64_t sgb, int64_t sgl, int64_t sgh,
    float scale, int causal) {
  constexpr int LD = D + 1;   // padded fp32 row of a Q/dO/K/V tile
  constexpr int LP = BK + 1;  // padded fp32 row of the dS tile
  constexpr int CO = D / 8;   // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][LD]
  float* sdO = sQ + BQ * LD;    // [BQ][LD]
  float* sKV = sdO + BQ * LD;   // [BK][LD]: the V tile, then the K tile
  float* sDS = sKV + BK * LD;   // [BQ][LP]

  const int nq = (Lq + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int q0 = qt * BQ;
  const int r0 = rg * RM;       // first of this thread's rows in the tile

  load_tile<T, D>(sQ, q + b * sqb + h * sqh, sql, q0, Lq);
  load_tile<T, D>(sdO, dout + b * sdb + h * sdh, sdl, q0, Lq);
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  float row_lse[RM], row_delta[RM], acc[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + r0 + i;
    const int64_t row = ((int64_t)b * H + h) * Lq + qpos;
    row_lse[i] = qpos < Lq ? lse[row] : 0.f;
    row_delta[i] = qpos < Lq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  int nk = (Lk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's dQ product is done with sKV, sDS
    load_tile<T, D>(sKV, vb, svl, k0, Lk);
    __syncthreads();

    float dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ov[RM], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) ov[i] = sdO[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) vv[j] = sKV[(cg + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }

    __syncthreads();   // every thread is done reading the V tile
    load_tile<T, D>(sKV, kb, skl, k0, Lk);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = sQ[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = sKV[(cg + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool keep = qpos < Lq && kpos < Lk && (!causal || qpos >= kpos);
        // a masked score is -1e30 in the Pallas kernel: exp(-1e30 - lse) = 0
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sDS[(r0 + i) * LP + cg + 8 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    }
    __syncthreads();   // dS is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = sDS[(r0 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float kv = sKV[kk * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= Lq) continue;
    T* grow = dq + b * sgb + qpos * sgl + h * sgh;
#pragma unroll
    for (int c = 0; c < CO; ++c)
      grow[cg + 8 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hkv, int Lq, int Lk, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = (size_t)(3 * BQ * LD + BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, H / Hkv, Lq, Lk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], scale, causal);
  return (int)cudaGetLastError();
}



// ---------------------------------------------- bf16: wgmma + TMA (sm_90a)
namespace tc {

using namespace sm90;

constexpr int BQ = 128;          // q rows per block: two warpgroups
constexpr int WQ = 64;           // q rows per warpgroup
constexpr int BK = 64;           // keys per K/V tile
constexpr int STAGES = 3;        // K/V ring depth
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

// shared memory, in bytes from a 1024-byte aligned base
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;   // [2 wg][D/64][64][128 B]
  static constexpr int KV_BYTES = BK * D * 2;  // [D/64][BK][128 B]
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_BYTES;
  static constexpr int K = DO + Q_BYTES;       // STAGES K tiles
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BARS = V + STAGES * KV_BYTES;
  // bar_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int TOTAL = BARS + (1 + 3 * STAGES) * 8;
  static constexpr int LAUNCH = TOTAL + 1024;  // room to align the base
};

// TMA loads of K/V tile kt into its stage, once both warpgroups have
// released the stage (one thread)
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* sm, const CUtensorMap* mk,
                                        const CUtensorMap* mv,
                                        uint64_t* full_k, uint64_t* full_v,
                                        uint64_t* empty, int kt, int hk,
                                        int b) {
  using S = Smem<D>;
  const int st = kt % STAGES;
  mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
  mbar_expect_tx(&full_k[st], S::KV_BYTES);
  for (int s = 0; s < D / 64; ++s)
    tma_load_4d(sm + S::K + st * S::KV_BYTES + s * BK * 128, mk, &full_k[st],
                64 * s, kt * BK, hk, b);
  mbar_expect_tx(&full_v[st], S::KV_BYTES);
  for (int s = 0; s < D / 64; ++s)
    tma_load_4d(sm + S::V + st * S::KV_BYTES + s * BK * 128, mv, &full_v[st],
                64 * s, kt * BK, hk, b);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo,
    const __grid_constant__ CUtensorMap mdq, const float* __restrict__ lse,
    const float* __restrict__ delta, int H, int G, int Lq, int Lk,
    float scale, int causal) {
  using S = Smem<D>;
  constexpr int SLICES = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int nq = (Lq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.z) * BQ;   // longest rows first
  const int nk_all = (Lk + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (min(q0 + BQ, Lq) - 1) / BK + 1)
                        : nk_all;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // the loader: Q and dO once, the first stages
    mbar_expect_tx(bar_q, 2 * S::Q_BYTES);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < SLICES; ++s) {
        tma_load_4d(sm + S::Q + (w * SLICES + s) * WQ * 128, &mq, bar_q,
                    64 * s, q0 + WQ * w, h, b);
        tma_load_4d(sm + S::DO + (w * SLICES + s) * WQ * 128, &mdo, bar_q,
                    64 * s, q0 + WQ * w, h, b);
      }
    for (int kt = 0; kt < min(STAGES, nk); ++kt)
      load_kv<D>(sm, &mk, &mv, full_k, full_v, empty, kt, hk, b);
  }

  const int cw = threadIdx.x / 128;   // warpgroup: 64 q rows each
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int r_in = 16 * w + lane / 4;          // this thread's first row
  const int wq0 = q0 + WQ * cw;                // the warpgroup's first row
  uint8_t* sQ = sm + S::Q + cw * SLICES * WQ * 128;
  const uint8_t* sdO = sm + S::DO + cw * SLICES * WQ * 128;
  // key tiles this warpgroup's rows see: none if all of them lie past Lq;
  // under the causal mask, none after the tile of its last row
  const int nkw = wq0 >= Lq ? 0
                  : causal ? min(nk, (min(wq0 + WQ, Lq) - 1) / BK + 1)
                           : nk;
  const float scale_log2 = scale * LOG2E;

  float lse2[2], dlt[2];   // this thread's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = wq0 + r_in + 8 * i;
    const int64_t row = ((int64_t)b * H + h) * Lq + qpos;
    lse2[i] = qpos < Lq ? lse[row] * LOG2E : 0.f;
    dlt[i] = qpos < Lq ? delta[row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    const uint32_t ph = (kt / STAGES) & 1;
    const uint8_t* sK = sm + S::K + st * S::KV_BYTES;
    const uint8_t* sV = sm + S::V + st * S::KV_BYTES;
    // an idle warpgroup waits too: its release of this stage must not
    // count towards the phase that frees the stage's previous tile
    mbar_wait(&full_k[st], ph);
    if (kt < nkw) {   // else no row of this warpgroup sees the tile
      float s[BK / 2], dp[BK / 2];   // S and dP, 64 q rows x 64 keys
      const uint64_t q_desc = desc_kmajor(sQ), k_desc = desc_kmajor(sK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK, 0>(s, kstep_kmajor(q_desc, WQ, kk),
                        kstep_kmajor(k_desc, BK, kk), kk > 0);
      wgmma_commit();
      mbar_wait(&full_v[st], ph);
      const uint64_t do_desc = desc_kmajor(sdO), v_desc = desc_kmajor(sV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK, 0>(dp, kstep_kmajor(do_desc, WQ, kk),
                        kstep_kmajor(v_desc, BK, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // S is done; dP runs on
      reg_fence(s);

      // p on the S fragments; masked pairs are 0 (exp(-1e30 - lse))
      const int k0 = kt * BK;
      const bool edge = k0 + BK > Lk || wq0 + WQ > Lq ||
                        (causal && k0 + BK - 1 > wq0);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float p =
                exp2f(fmaf(s[4 * j + 2 * i + c], scale_log2, -lse2[i]));
            if (edge) {
              const int qpos = wq0 + r_in + 8 * i;
              const int kpos = k0 + 8 * j + 2 * (lane % 4) + c;
              if (kpos >= Lk || qpos >= Lq || (causal && kpos > qpos))
                p = 0.f;
            }
            s[4 * j + 2 * i + c] = p;
          }
      wgmma_wait<0>();   // dP is done
      reg_fence(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            dp[4 * j + 2 * i + c] =
                s[4 * j + 2 * i + c] * (dp[4 * j + 2 * i + c] - dlt[i]);
      uint32_t dsa[BK / 16][4];   // bf16(dS) as the A operand of dS . K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(dp, kk, dsa[kk]);
      const uint64_t k_mn = desc_mnmajor(sK, BK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D, 1>(acc, dsa[kk], kstep_mnmajor(k_mn, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(dsa);
    }
    mbar_arrive(&empty[st]);   // both warpgroups release every stage
    if (threadIdx.x == 0 && kt + STAGES < nk)
      load_kv<D>(sm, &mk, &mv, full_k, full_v, empty, kt + STAGES, hk, b);
  }

  // epilogue: dQ * scale in bf16 through this warpgroup's Q rows (every
  // product that read them is done), one TMA store per 64-column slice
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(sQ + (col / 64) * WQ * 128 +
                                   swz128(r_in + 8 * i, col % 64)) =
          pack_bf16(acc[4 * j + 2 * i] * scale,
                    acc[4 * j + 2 * i + 1] * scale);
    }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (t == 0 && wq0 < Lq) {
    for (int s = 0; s < SLICES; ++s)
      tma_store_4d(&mdq, sQ + s * WQ * 128, 64 * s, wq0, h, b);
    tma_store_commit_and_wait();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hkv, int Lq, int Lk, const int64_t* st, float scale,
           int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!map_bf16_4d(&mq, q, B, Lq, H, D, st[0], st[1], st[2], WQ) ||
      !map_bf16_4d(&mk, k, B, Lk, Hkv, D, st[3], st[4], st[5], BK) ||
      !map_bf16_4d(&mv, v, B, Lk, Hkv, D, st[6], st[7], st[8], BK) ||
      !map_bf16_4d(&mdo, dout, B, Lq, H, D, st[9], st[10], st[11], WQ) ||
      !map_bf16_4d(&mdq, dq, B, Lq, H, D, st[12], st[13], st[14], WQ))
    return (int)cudaErrorInvalidValue;
  const int smem = Smem<D>::LAUNCH;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Lq + BQ - 1) / BQ);
  flash_bwd_dq_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mdo, mdq, lse, delta, H, H / Hkv, Lq, Lk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma + TMA kernel).
// strides (in elements): q, k, v, dO, dQ, each as (batch, seq, head).
// Returns a cudaError_t; 0 means launched. Shapes and strides (for bf16
// also TMA's 16-byte rules) are checked by the Python wrapper before the
// call.
int flash_bwd_dq(int dtype, int D, const void* q, const void* k,
                 const void* v, const void* dout, const float* lse,
                 const float* delta, void* dq, int B, int H, int Hkv, int Lq,
                 int Lk, const int64_t* strides, float scale, int causal,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Lq,
                             Lk, strides, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Lq,
                              Lk, strides, scale, causal, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Lq, Lk,
                          strides, scale, causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Lq, Lk,
                           strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
