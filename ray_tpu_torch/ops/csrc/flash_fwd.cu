// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C entry point (`flash_fwd`) that ray_tpu_torch/ops/attention.py
// loads with ctypes.
//
// Replaces: ray_tpu/ops/attention.py:_fwd_kernel (Pallas, TPU), launched by
// _flash_fwd. Same function: per query row an online softmax over the key
// tiles (running max m, running sum l, fp32 accumulator), scores in fp32,
// p rounded to the input dtype before the PV product, o written in the
// input dtype and lse = m + log(l) in fp32. Causal masking is top-left
// aligned (query i sees key j iff i >= j, both counted from 0), and key
// tiles past the diagonal are skipped, as in the Pallas kernel.
//
// Layout: q [B, Lq, H, D], k/v [B, Lk, Hkv, D] read through their strides
// (last dim contiguous); o [B, Lq, H, D]; lse [B, H, Lq]. GQA reads kv head
// h / (H / Hkv) directly instead of repeating K/V. Ragged Lq/Lk are masked
// in the kernel, so every length is taken. D is 64 or 128, dtype bf16 or
// fp32.
//
// Bound on an H100 SXM: at the serving prefill shape (B=8, L=512, H=32,
// Hkv=8, D=128, bf16, causal) the work is 2*B*H*L^2*D = 17.2 GFLOP against
// ~84 MB of compulsory traffic, i.e. ~200 FLOP per byte. That is under the
// card's bf16 ridge of ~295 FLOP/B, so with tensor cores the bound would be
// memory (~0.025 ms); this kernel does its products with fp32 FMAs instead
// (67 TFLOP/s peak), which makes it bound by operations: ~0.26 ms at best.
//
// Design, kept simple: one block of 128 threads per (batch, head, 64-row q
// tile). Q, then each K tile and V tile in turn, are converted to fp32 in
// shared memory (rows padded by one float so that the column-strided reads
// below hit distinct banks). Each thread owns 4 query rows x 8 key columns
// of the 64x64 score tile and 4 rows x D/8 columns of the output; the 8
// threads that share a row are neighbouring lanes, so row max and row sum
// are three warp shuffles. Only the score tile, not the full score matrix,
// ever exists, and nothing but o and lse goes back to device memory.
// Tensor cores (wgmma) and TMA pipelining are later work.

#include "flash_common.cuh"

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides (in elements): q, k, v, o, each
// as (batch, seq, head). Returns a cudaError_t; 0 means launched. Shapes
// and strides are checked by the Python wrapper before the call.
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
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, H, Hkv, Lq, Lk,
                                     strides, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, H, Hkv, Lq, Lk,
                                      strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
