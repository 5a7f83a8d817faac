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
// strides (last dim contiguous); lse and delta [B, H, Lq] fp32. Ragged
// Lq/Lk are masked here. D is 64 or 128, dtype bf16 or fp32.
//
// Bound on an H100 SXM: at the tpu-3b training shape (B=4, L=1024, H=24,
// Hkv=8, D=128, bf16, causal) the kernel does four products of 2*D FLOPs
// per kept (query, key) pair, 51.6 GFLOP, against ~93 MB of compulsory
// traffic: with tensor cores it would be bound by operations at ~0.05 ms.
// This kernel does its products with fp32 FMAs (67 TFLOP/s peak), so it is
// bound by operations at ~0.8 ms at best.
//
// Design, kept simple (as flash_fwd.cu): one block of 128 threads per
// (batch, KV head, 64-row k tile). K and V of the tile stay in shared
// memory as fp32 for the whole block; each q tile brings Q, dO, and its
// rows' lse and delta. Each thread owns 4 key rows x 8 query columns of the
// transposed 64x64 score tile and 4 key rows x D/8 columns of both dK and
// dV (128 fp32 registers at D=128, the block's largest cost). dp is parked
// in the dS tile (each thread reads back only its own entries) so that it
// and s are never live together; p and ds then go to shared memory,
// rounded, for the two accumulating products. A block holds K, V, Q, dO,
// P and dS: 162 KB at D=128.

#include "flash_common.cuh"

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q, k, v, dO, dK,
// dV, each as (batch, seq, head). Returns a cudaError_t; 0 means launched.
// Shapes and strides are checked by the Python wrapper before the call.
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
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, B,
                                     H, Hkv, Lq, Lk, strides, scale, causal,
                                     s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, B,
                                      H, Hkv, Lq, Lk, strides, scale, causal,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
