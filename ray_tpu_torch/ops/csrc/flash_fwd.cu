// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point (`flash_fwd`) that ray_tpu_torch/ops/attention.py
// loads with ctypes.
//
// Replaces: ray_tpu/ops/attention.py:_fwd_kernel (Pallas, TPU), launched by
// _flash_fwd. Same function: per query row an online softmax over the key
// tiles (running max m, running sum l, fp32 accumulator), scores in fp32,
// p rounded to the input dtype before the PV product, o written in the
// input dtype and lse = m + log(max(l, 1e-30)) in fp32, [B, H, Lq]. Causal
// masking is top-left aligned (query i sees key j iff i >= j, both counted
// from 0), masked scores are -1e30, and key tiles past the diagonal are
// skipped, as in the Pallas kernel.
//
// Layout: q [B, Lq, H, D], k/v [B, Lk, Hkv, D] read through their strides
// (last dim contiguous); o [B, Lq, H, D]; lse [B, H, Lq]. GQA reads kv head
// h / (H / Hkv) directly instead of repeating K/V. D is 64 or 128.
//
// Two paths, chosen by dtype in the C entry:
//
// bf16: tensor cores (wgmma) fed by TMA. The Pallas kernel's products are
// jnp.dot(bf16, bf16, preferred_element_type=f32), which is exactly a bf16
// wgmma with an fp32 accumulator, so this computes the same function with
// the same rounding points. Bound on an H100 SXM at the serving prefill
// shape (B=8, L=512, H=32, Hkv=8, D=128, causal): 2 products x 2 D FLOPs
// over 33.6 M kept pairs = 17.2 GFLOP against ~84 MB of compulsory
// traffic, ~200 FLOP/B, under the bf16 ridge (~295 FLOP/B), so by bytes at
// ~0.025 ms; in practice the softmax between the two products, which runs
// on the CUDA cores while this warpgroup's tensor-core work waits, and the
// causal tiles' imbalance keep the kernel at a few times that.
//   Block: one per (head, batch, 128-row q tile), 256 threads in two
// warpgroups of 64 q rows each. Thread 0 loads the Q tile once and each
// 128-key K and V tile by TMA into a 2-stage ring (full barriers count the
// bytes, the empty barrier the 256 threads' release), issuing tile kt + 2
// as soon as both warpgroups are done with tile kt. Per tile: S = Q.K^T by
// wgmma m64n128k16 with both operands K-major in shared memory; the online
// softmax on the accumulator fragments in registers (scores in log2
// units, exp2); p packed to bf16 in registers as the A operand of
// O += P.V (wgmma m64nDk16, V the MN-major B operand), so P never touches
// shared memory. The epilogue writes o through the warpgroup's Q tile
// (swizzled as TMA wrote it) with one TMA store per 64 columns, which
// clips rows past Lq; lse goes out with plain stores. Rows past Lq or Lk
// read as zeros through the 4-D tensor maps (D, L, H, B), and the mask
// decides p.
//   Why no producer warpgroup: a 384-thread block (producer warpgroup
// handing registers to two consumer warpgroups with setmaxnreg) leaves
// ptxas (CUDA 12.9) 168 registers a thread for all of its code, setmaxnreg
// or not, and the D=128 consumer spilled; 256 threads give it 192 with no
// spill, and measured faster (PERF.md).
//   Order: blockIdx.z runs the q tiles from the last (the longest causal
// rows) to the first, so the heaviest blocks start first; blockIdx.x is
// the head, so the G query heads of a KV group run side by side and share
// their K/V tiles through L2 rather than inside one block (which would
// multiply the accumulators a block holds).
//   Budget (ptxas, CUDA 12.9): D=128 192 registers, 160 KB of shared
// memory (Q 32 KB, K and V 2 x 64 KB), one block per SM; D=64 158
// registers, 80 KB.
//
// fp32: the FMA kernel of the first port, unchanged: tensor cores would
// compute fp32 products in TF32 and break the 2e-3 fp32 parity this kernel
// is held to, and fp32 runs on no main path (serving and training compute
// in bf16). One block of 128 threads per (batch, head, 64-row q tile); Q,
// then each K and V tile, converted to fp32 in shared memory; each thread
// owns 4 rows x 8 key columns of the score tile and 4 rows x D/8 columns of
// the output. There is no switch between the two paths: bf16 launches the
// tensor-core kernel or fails.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

constexpr int BQ = TILE;   // query rows per block
constexpr int BK = TILE;   // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int H, int G, int Lq, int Lk,
    int64_t sqb, int64_t sql, int64_t sqh,
    int64_t skb, int64_t skl, int64_t skh,
    int64_t svb, int64_t svl, int64_t svh,
    int64_t sob, int64_t sol, int64_t soh,
    float scale, int causal) {
  constexpr int LD = D + 1;   // padded fp32 row of a Q/K/V tile
  constexpr int LP = BK + 1;  // padded fp32 row of the P tile
  constexpr int CO = D / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][LD]
  float* sKV = sQ + BQ * LD;    // [BK][LD]: the K tile, then the V tile
  float* sP = sKV + BK * LD;    // [BQ][LP]

  const int nq = (Lq + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int q0 = qt * BQ;
  const int r0 = rg * RM;       // first of this thread's rows in the tile

  load_tile<T, D>(sQ, q + b * sqb + h * sqh, sql, q0, Lq);
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  float m[RM], l[RM], acc[RM][CO];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  int nk = (Lk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's PV is done with sKV and sP
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
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool keep = kpos < Lk && (!causal || qpos >= kpos);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(r0 + i) * LP + cg + 8 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();   // all scores read from the K tile; P is complete
    load_tile<T, D>(sKV, vb, svl, k0, Lk);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = sP[(r0 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float vv = sKV[kk * LD + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + r0 + i;
    if (qpos >= Lq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + b * sob + qpos * sol + h * soh;
#pragma unroll
    for (int c = 0; c < CO; ++c) orow[cg + 8 * c] = from_f<T>(acc[i][c] / li);
    if (cg == 0) lse[((int64_t)b * H + h) * Lq + qpos] = m[i] + logf(li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Lq, int Lk, const int64_t* st,
           float scale, int causal, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = (size_t)(2 * BQ * LD + BQ * (BK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, Lq, Lk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return (int)cudaGetLastError();
}


// ---------------------------------------------- bf16: wgmma + TMA (sm_90a)
namespace tc {

using namespace sm90;

constexpr int BQ = 128;          // q rows per block: two warpgroups
constexpr int WQ = 64;           // q rows per warpgroup
constexpr int BK = 128;          // keys per K/V tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory, in bytes from a 1024-byte aligned base
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;   // [2 wg][D/64][64][128 B]
  static constexpr int KV_BYTES = BK * D * 2;  // [D/64][BK][128 B]
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;        // STAGES K tiles
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
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mo, float* __restrict__ lse, int H,
    int G, int Lq, int Lk, float scale_log2, int causal) {
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
  int nk = (Lk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + BQ, Lq) - 1) / BK + 1);

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
  if (threadIdx.x == 0) {   // the loader: Q once, the first K/V stages
    mbar_expect_tx(bar_q, S::Q_BYTES);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < SLICES; ++s)
        tma_load_4d(sm + S::Q + (w * SLICES + s) * WQ * 128, &mq, bar_q,
                    64 * s, q0 + WQ * w, h, b);
    for (int kt = 0; kt < min(STAGES, nk); ++kt)
      load_kv<D>(sm, &mk, &mv, full_k, full_v, empty, kt, hk, b);
  }

  const int cw = threadIdx.x / 128;   // warpgroup: 64 q rows each
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int r_in = 16 * w + lane / 4;          // this thread's first row
  const int wq0 = q0 + WQ * cw;                // the warpgroup's first row
  uint8_t* sQ = sm + S::Q + cw * SLICES * WQ * 128;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    const uint32_t ph = (kt / STAGES) & 1;
    const uint8_t* sK = sm + S::K + st * S::KV_BYTES;
    const uint8_t* sV = sm + S::V + st * S::KV_BYTES;

    float s[BK / 2];   // S = Q . K^T, 64 x 128
    mbar_wait(&full_k[st], ph);
    const uint64_t q_desc = desc_kmajor(sQ), k_desc = desc_kmajor(sK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK, 0>(s, kstep_kmajor(q_desc, WQ, kk),
                      kstep_kmajor(k_desc, BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    // online softmax on the fragments, scores in log2 units
    const int k0 = kt * BK;
    const bool edge = k0 + BK > Lk || (causal && k0 + BK - 1 > wq0);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = wq0 + r_in + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + c;
            if (kpos >= Lk || (causal && kpos > qpos)) x = NEG_INF;
          }
          s[4 * j + 2 * i + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[4 * j + 2 * i + c] - mx);
          s[4 * j + 2 * i + c] = p;
          sum += p;
        }
      l[i] = alpha[i] * l[i] + sum;   // this thread's part of the row sum
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }
    uint32_t pa[BK / 16][4];   // bf16(p) as the A operand of P . V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, pa[kk]);

    mbar_wait(&full_v[st], ph);
    const uint64_t v_desc = desc_mnmajor(sV, BK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D, 1>(acc, pa[kk], kstep_mnmajor(v_desc, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    mbar_arrive(&empty[st]);
    if (threadIdx.x == 0 && kt + STAGES < nk)
      load_kv<D>(sm, &mk, &mv, full_k, full_v, empty, kt + STAGES, hk, b);
  }

  // epilogue: o = acc / l in bf16 through this warpgroup's Q tile (its
  // last product is done), one TMA store; lse with plain stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(sQ + (col / 64) * WQ * 128 +
                                   swz128(r_in + 8 * i, col % 64)) =
          pack_bf16(acc[4 * j + 2 * i] / l[i], acc[4 * j + 2 * i + 1] / l[i]);
    }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (t == 0) {
    for (int s = 0; s < SLICES; ++s)
      tma_store_4d(&mo, sQ + s * WQ * 128, 64 * s, wq0, h, b);
    tma_store_commit_and_wait();
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = wq0 + r_in + 8 * i;
      if (qpos < Lq)
        lse[((int64_t)b * H + h) * Lq + qpos] = m[i] * LN2 + logf(l[i]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Lq, int Lk, const int64_t* st,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!map_bf16_4d(&mq, q, B, Lq, H, D, st[0], st[1], st[2], WQ) ||
      !map_bf16_4d(&mk, k, B, Lk, Hkv, D, st[3], st[4], st[5], BK) ||
      !map_bf16_4d(&mv, v, B, Lk, Hkv, D, st[6], st[7], st[8], BK) ||
      !map_bf16_4d(&mo, o, B, Lq, H, D, st[9], st[10], st[11], WQ))
    return (int)cudaErrorInvalidValue;
  const int smem = Smem<D>::LAUNCH;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (Lq + BQ - 1) / BQ);
  flash_fwd_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mo, lse, H, H / Hkv, Lq, Lk, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma + TMA kernel).
// strides (in elements): q, k, v, o, each as (batch, seq, head). Returns a
// cudaError_t; 0 means launched. Shapes and strides (for bf16 also TMA's
// 16-byte rules) are checked by the Python wrapper before the call.
int flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
              void* o, float* lse, int B, int H, int Hkv, int Lq, int Lk,
              const int64_t* strides, float scale, int causal,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, strides,
                             scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, strides,
                              scale, causal, s);
  if (dtype == 1 && D == 64)
    return tc::launch<64>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, strides, scale,
                          causal, s);
  if (dtype == 1 && D == 128)
    return tc::launch<128>(q, k, v, o, lse, B, H, Hkv, Lq, Lk, strides, scale,
                           causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
