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
// are masked here, so every length is taken. D is 64 or 128, dtype bf16 or
// fp32.
//
// Bound on an H100 SXM: at the tpu-3b training shape (B=4, L=1024, H=24,
// Hkv=8, D=128, bf16, causal) the kernel does three products of 2*D FLOPs
// per kept (query, key) pair, 38.7 GFLOP, against ~93 MB of compulsory
// traffic: with tensor cores it would be bound by operations at ~0.04 ms.
// This kernel does its products with fp32 FMAs (67 TFLOP/s peak), so it is
// bound by operations at ~0.6 ms at best.
//
// Design, kept simple (as flash_fwd.cu): one block of 128 threads per
// (batch, query head, 64-row q tile). Q and dO of the tile stay in shared
// memory as fp32; each 64-key tile is brought in twice through one buffer,
// V first (for dp), then K (for s and for the dQ product), so a block holds
// Q, dO, one K-or-V tile and the 64x64 dS tile: 113 KB at D=128. Each
// thread owns 4 query rows x 8 key columns of the tile and 4 rows x D/8
// columns of dQ. dp stays in registers until s is ready; ds goes to shared
// memory, rounded, for the dQ product. Only dQ goes back to device memory.

#include "flash_common.cuh"

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q, k, v, dO, dQ,
// each as (batch, seq, head). Returns a cudaError_t; 0 means launched.
// Shapes and strides are checked by the Python wrapper before the call.
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
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, B, H,
                                     Hkv, Lq, Lk, strides, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, B, H,
                                      Hkv, Lq, Lk, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
