// Flash-attention backward for Hopper (sm_90a), float32: dq, and dk/dv.
//
// Replaces: mxnet_tpu_flash_attention_dq (mxnet_tpu/ops/pallas/attention.py:208)
// and mxnet_tpu_flash_attention_dkv (attention.py:243), the backward of
// every transformer training step with the attention kernels on.
//
// Both recompute the probabilities from the forward's log-sum-exp, as
// _p_block (attention.py:195) does, in the JAX order of operations:
//   s  = (q . k) * scale, masked keys (k >= length, or k > q if causal)
//        give p = 0
//   p  = 0 if masked or lse == -inf, else exp(s - lse)
//   dp = do . v;  delta = rowsum(do * o)
//   ds = p * (dp - delta) * scale
//   dq = sum_k ds k;  dk = sum_q ds q;  dv = sum_q p do
// A row with no visible key (length 0) has lse == -inf and gives dq == 0
// and nothing to dk/dv; no NaN is formed.
//
// What bounds them on the H100: at BERT-base training shapes (B*H 1152,
// S 128, D 64) dq does 3 and dk/dv 4 products of 2*S*S*D flops per
// (batch, head): 7.2 and 9.7 GFLOP against ~0.23-0.26 GB of q, k, v, o,
// do in and gradients out, so the float32 CUDA-core rate (67 TFLOP/s, no
// tensor cores in this version) bounds both.
//
// Design. Each output tile is owned by one block, so no sum crosses
// blocks and there is no atomicAdd (results are deterministic); the TPU
// grid's sequential walk becomes a loop inside the block. Tiles are 64
// rows; a block has 256 threads (16 x 16), and each thread owns a 4 x 4
// patch of every 64 x 64 product, accumulated in registers from 16-byte
// shared-memory loads (register tiling, as a SIMT GEMM does):
//   * dq: grid (B*H, ceil(Sq/64)). The block stages its Q and dO tiles
//     once, then walks the key tiles: S = Q K^T and dP = dO V^T (thread:
//     query rows 4*ty + r, keys tx + 16*c), dS into shared memory, then
//     dQ += dS K (thread: query rows 4*ty + r, dims 4*tx + c). Key tiles
//     past the block's last visible key are skipped.
//   * dk/dv: grid (B*H, ceil(Sk/64)). The block stages its K and V tiles
//     once, then walks the query tiles: S and dP as above, P and dS into
//     shared memory, then dV += P^T dO and dK += dS^T Q (thread: keys
//     4*ty + r, dims 4*tx + c). A causal block starts at the first query
//     tile that can see its keys; a block wholly past the length sees no
//     query at all.
//   * Staged tiles have rows of 68 floats: with the strided key ownership
//     (tx + 16*c) every 16-byte load of a quarter-warp hits distinct banks.
//   * delta is recomputed by each kernel from do and o, as the TPU kernels
//     do, so the two launches stay independent.
// wgmma/TMA and bf16 are later work.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int D = 64;         // head dim: the instance the slice needs
constexpr int T = 64;         // rows of every tile (queries or keys)
constexpr int LD = D + 4;     // padded row stride of a staged tile, floats
constexpr int THREADS = 256;  // 16 x 16, each owning 4 x 4 outputs
constexpr int TILE = T * LD;  // floats of one staged tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [base, base + T) of src (n rows of D floats) into dst (T rows of
// LD floats), zeros past row n; coalesced 16-byte loads
__device__ __forceinline__ void stage(float* dst, const float* src, int base,
                                      int n) {
  for (int idx = threadIdx.x; idx < T * D / 4; idx += THREADS) {
    const int r = idx / (D / 4);
    const int c = idx % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (base + r < n)
      x = reinterpret_cast<const float4*>(src + (size_t)(base + r) * D)[c];
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = x;
  }
}

// lse and delta = rowsum(do * o) of query rows [base, base + T), from the
// staged dO tile and o in device memory; four threads per row
__device__ __forceinline__ void row_stats(float* lse_s, float* delta_s,
                                          const float* lse, const float* o,
                                          const float* dos, int base, int n) {
  const int r = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const bool ok = base + r < n;
  float acc = 0.f;
  if (ok) {
    const float* orow = o + (size_t)(base + r) * D + part * (D / 4);
    const float* drow = dos + r * LD + part * (D / 4);
#pragma unroll
    for (int k = 0; k < D / 4; k += 4) {
      const float4 a = ld4(drow + k);
      const float4 w = ld4(orow + k);
      acc = fmaf(a.x, w.x, acc);
      acc = fmaf(a.y, w.y, acc);
      acc = fmaf(a.z, w.z, acc);
      acc = fmaf(a.w, w.w, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    delta_s[r] = acc;
    lse_s[r] = ok ? lse[base + r] : -CUDART_INF_F;
  }
}

// one product of two staged tiles over D: out[r][c] = a[4 ty + r] .
// b[tx + 16 c]
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float out[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = ld4(a + (4 * ty + r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = ld4(b + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s = out[r][c];
        s = fmaf(av[r].x, bv[c].x, s);
        s = fmaf(av[r].y, bv[c].y, s);
        s = fmaf(av[r].z, bv[c].z, s);
        s = fmaf(av[r].w, bv[c].w, s);
        out[r][c] = s;
      }
  }
}

// p and ds of the thread's 4 x 4 (query 4 ty + r, key tx + 16 c) from the
// staged Q, dO (query tile at qbase) and K, V (key tile at kbase), into
// ps (if given) and dss, both [query][key]
__device__ __forceinline__ void probs(const float* qs, const float* dos,
                                      const float* ks, const float* vs,
                                      const float* lse_s,
                                      const float* delta_s, float* ps,
                                      float* dss, int qbase, int kbase,
                                      int sq, int len, float scale,
                                      int causal, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_dot(qs, ks, ty, tx, s);
  tile_dot(dos, vs, ty, tx, dp);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
    const int qi = qbase + i;
    const float lse_i = lse_s[i];
    const float delta_i = delta_s[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c;
      const int kj = kbase + j;
      const bool vis = qi < sq && kj < len && (!causal || kj <= qi);
      const float p = (vis && lse_i != -CUDART_INF_F)
                          ? expf(s[r][c] * scale - lse_i)
                          : 0.f;
      if (ps != nullptr) ps[i * LD + j] = p;
      dss[i * LD + j] = p * (dp[r][c] - delta_i) * scale;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attention_dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ o,
                          const float* __restrict__ lse,
                          const float* __restrict__ dout,
                          const int* __restrict__ lengths,
                          float* __restrict__ dq, int heads, int sq, int sk,
                          float scale, int causal) {
  extern __shared__ float smem[];
  float* qs = smem;             // [T][LD] query tile
  float* dos = qs + TILE;       // [T][LD] dO of the query tile
  float* ks = dos + TILE;       // [T][LD] key tile
  float* vs = ks + TILE;        // [T][LD] value tile
  float* dss = vs + TILE;       // [T][LD] dS, [query][key]
  float* lse_s = dss + TILE;    // [T]
  float* delta_s = lse_s + T;   // [T]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int q0 = blockIdx.y * T;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* kb = k + (size_t)bh * sk * D;
  const float* vb = v + (size_t)bh * sk * D;

  stage(qs, q + (size_t)bh * sq * D, q0, sq);
  stage(dos, dout + (size_t)bh * sq * D, q0, sq);
  __syncthreads();
  row_stats(lse_s, delta_s, lse + (size_t)bh * sq, o + (size_t)bh * sq * D,
            dos, q0, sq);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const int len = max(0, min(lengths[b], sk));
  int kend = len;  // one past the last key any row of the block sees
  if (causal) kend = min(kend, min(q0 + T, sq));
  for (int kbase = 0; kbase < kend; kbase += T) {
    __syncthreads();  // the previous tile is consumed, row stats written
    stage(ks, kb, kbase, sk);
    stage(vs, vb, kbase, sk);
    __syncthreads();
    probs(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, kbase, sq, len,
          scale, causal, ty, tx);
    __syncthreads();
    // dQ[4 ty + r][4 tx + c] += sum_j dS[4 ty + r][j] K[j][4 tx + c]
#pragma unroll 2
    for (int j = 0; j < T; j += 4) {
      float4 a[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(dss + (4 * ty + r) * LD + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) kv[e] = ld4(ks + (j + e) * LD + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = comp(a[r], e);
          acc[r][0] = fmaf(w, kv[e].x, acc[r][0]);
          acc[r][1] = fmaf(w, kv[e].y, acc[r][1]);
          acc[r][2] = fmaf(w, kv[e].z, acc[r][2]);
          acc[r][3] = fmaf(w, kv[e].w, acc[r][3]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi < sq)
      *reinterpret_cast<float4*>(dq + ((size_t)bh * sq + qi) * D + 4 * tx) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attention_dkv_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ o,
                           const float* __restrict__ lse,
                           const float* __restrict__ dout,
                           const int* __restrict__ lengths,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int heads, int sq, int sk, float scale,
                           int causal) {
  extern __shared__ float smem[];
  float* ks = smem;             // [T][LD] key tile
  float* vs = ks + TILE;        // [T][LD] value tile
  float* qs = vs + TILE;        // [T][LD] query tile
  float* dos = qs + TILE;       // [T][LD] dO of the query tile
  float* ps = dos + TILE;       // [T][LD] P, [query][key]
  float* dss = ps + TILE;       // [T][LD] dS, [query][key]
  float* lse_s = dss + TILE;    // [T]
  float* delta_s = lse_s + T;   // [T]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int k0 = blockIdx.y * T;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* qb = q + (size_t)bh * sq * D;
  const float* dob = dout + (size_t)bh * sq * D;
  const float* ob = o + (size_t)bh * sq * D;
  const float* lseb = lse + (size_t)bh * sq;

  stage(ks, k + (size_t)bh * sk * D, k0, sk);
  stage(vs, v + (size_t)bh * sk * D, k0, sk);

  float dka[4][4], dva[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[r][c] = dva[r][c] = 0.f;

  const int len = max(0, min(lengths[b], sk));
  // no query sees a key at or past the length; a causal key k is seen
  // only by queries q >= k
  const int qbegin = causal ? k0 : 0;
  const int qend = k0 < len ? sq : 0;
  for (int i0 = qbegin; i0 < qend; i0 += T) {
    __syncthreads();  // the previous tile is consumed (and ks/vs staged)
    stage(qs, qb, i0, sq);
    stage(dos, dob, i0, sq);
    __syncthreads();
    row_stats(lse_s, delta_s, lseb, ob, dos, i0, sq);
    __syncthreads();
    probs(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, k0, sq, len, scale,
          causal, ty, tx);
    __syncthreads();
    // dV[4 ty + r][4 tx + c] += sum_i P[i][4 ty + r] dO[i][4 tx + c]
    // dK[4 ty + r][4 tx + c] += sum_i dS[i][4 ty + r] Q[i][4 tx + c]
#pragma unroll 2
    for (int i = 0; i < T; ++i) {
      const float4 p4 = ld4(ps + i * LD + 4 * ty);
      const float4 s4 = ld4(dss + i * LD + 4 * ty);
      const float4 g4 = ld4(dos + i * LD + 4 * tx);
      const float4 q4 = ld4(qs + i * LD + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = comp(p4, r);
        const float sr = comp(s4, r);
        dva[r][0] = fmaf(pr, g4.x, dva[r][0]);
        dva[r][1] = fmaf(pr, g4.y, dva[r][1]);
        dva[r][2] = fmaf(pr, g4.z, dva[r][2]);
        dva[r][3] = fmaf(pr, g4.w, dva[r][3]);
        dka[r][0] = fmaf(sr, q4.x, dka[r][0]);
        dka[r][1] = fmaf(sr, q4.y, dka[r][1]);
        dka[r][2] = fmaf(sr, q4.z, dka[r][2]);
        dka[r][3] = fmaf(sr, q4.w, dka[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + 4 * ty + r;
    if (kj < sk) {
      const size_t at = ((size_t)bh * sk + kj) * D + 4 * tx;
      *reinterpret_cast<float4*>(dk + at) =
          make_float4(dka[r][0], dka[r][1], dka[r][2], dka[r][3]);
      *reinterpret_cast<float4*>(dv + at) =
          make_float4(dva[r][0], dva[r][1], dva[r][2], dva[r][3]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// ---- host entry points ----
// q, o, do (B*H, Sq, D); k, v (B*H, Sk, D); lse (B*H, Sq); lengths (B,)
// int32; outputs dq (B*H, Sq, D) or dk, dv (B*H, Sk, D). All contiguous
// float32 on the device, 16-byte aligned. Each returns the cudaError_t of
// its launch.
extern "C" int mx_flash_attention_dq(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* lse, const void* dout,
                                     const void* lengths, void* dq,
                                     int batch, int heads, int sq, int sk,
                                     int d, float scale, int causal,
                                     void* stream) {
  if (d != D) return cudaErrorInvalidValue;
  const size_t smem = (5 * TILE + 2 * T) * sizeof(float);
  cudaError_t err = set_smem(flash_attention_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (sq + T - 1) / T);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  flash_attention_dq_kernel<<<grid, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(lengths), static_cast<float*>(dq), heads, sq,
      sk, scale, causal);
  return cudaGetLastError();
}

extern "C" int mx_flash_attention_dkv(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      const void* lengths, void* dk,
                                      void* dv, int batch, int heads, int sq,
                                      int sk, int d, float scale, int causal,
                                      void* stream) {
  if (d != D) return cudaErrorInvalidValue;
  const size_t smem = (6 * TILE + 2 * T) * sizeof(float);
  cudaError_t err = set_smem(flash_attention_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (sk + T - 1) / T);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  flash_attention_dkv_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(lengths), static_cast<float*>(dk),
      static_cast<float*>(dv), heads, sq, sk, scale, causal);
  return cudaGetLastError();
}
