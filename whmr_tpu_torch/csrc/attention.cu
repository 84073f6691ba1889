// K1 and K3: fused softmax self-attention for short sequences, forward only.
//
// K3 (`attention_batch_kernel`, below K1) replaces the TPU kernel
// `fused_attention` of whmr_tpu/ops/attention_pallas.py:108 (body `_kernel`
// :43, pallas_call :123): the same function with one program per batch row
// that loops over all H heads. Its notes follow K1's launch code.
//
// K1 (`attention_kernel`) replaces the TPU kernel `fused_attention_heads` of
// whmr_tpu/ops/attention_pallas.py:79 (body `_kernel_heads` :61, pallas_call
// :98): o = softmax((q * s) k^T) v with s = 1/sqrt(D), per (batch, head), no
// mask, no dropout, q/k/v/o (B, H, N, D) in one dtype (fp32 or bf16).
// Numerics follow the TPU kernel step for step: q is widened to fp32 and
// scaled before the product, scores and softmax are fp32 with the row max
// subtracted, P is divided by its row sum and then ROUNDED TO THE INPUT DTYPE
// before P.V, P.V accumulates in fp32, and the output is rounded once.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the ViT-B shape
// (B=48, H=12, N=192, D=64, bf16) the kernel must move 4 x 48*12*192*64 x 2 B
// = 56.6 MB (16.9 us) and do 4*B*H*N*N*D = 5.44 GFLOP (5.5 us), so it is
// bound by bytes. What the design does about it: q, k, v and o each cross
// device memory once per block, K and V of the head are staged once in
// shared memory and reused by every query row of the block, and the N x N
// scores never leave shared memory. It is the simple first design: one warp
// per query row on CUDA cores (no wgmma, no TMA yet), so it is expected to sit
// well above that bound; PERF.md records by how much.
//
// Layout: grid (ceil(N / kRowsPerBlock), H, B); kWarps warps per block. The
// block copies K (rows padded so that lanes reading 32 different rows hit 32
// different banks) and V of its head into shared memory. Each warp then takes
// one query row at a time: lanes split the N keys for the scores, reduce max
// and sum with shuffles, and split the D output columns for P.V.
//
// Built by whmr_tpu_torch/ops/cuda_build.py (nvcc, sm_90a) into a shared
// library with a plain C interface, loaded with ctypes by ops/attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 64;
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
// K3: one block per batch row has only B blocks, so it takes more warps.
constexpr int kBatchWarps = 16;
constexpr int kBatchThreads = kBatchWarps * 32;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  __device__ static float to_f(float x) { return x; }
  __device__ static float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};

// Row stride of K in shared memory, in elements: an odd number of 32-bit
// words per row, so the 32 lanes of a warp (one key row each) hit 32 banks.
__host__ __device__ inline int k_stride(int d, int esize) {
  if (esize == 4) return (d & 1) ? d : d + 1;
  const int even = d + (d & 1);
  return ((even / 2) & 1) ? even : even + 2;
}

__host__ __device__ inline size_t kv_bytes(int n, int d, int esize) {
  size_t b = (size_t)n * (size_t)(k_stride(d, esize) + d) * (size_t)esize;
  return (b + 15) & ~(size_t)15;
}

// K (N x k_stride) and V (N x D) in the input dtype, then per warp one fp32
// score row (N) and one fp32 scaled query row (D).
__host__ __device__ inline size_t smem_bytes(int n, int d, int esize, int warps) {
  return kv_bytes(n, d, esize) + (size_t)warps * (size_t)(n + d) * sizeof(float);
}

// Stages K (rows padded to k_stride) and V of one head in shared memory.
template <typename T, int Threads>
__device__ inline void stage_kv(const T* __restrict__ kh, const T* __restrict__ vh,
                                T* k_s, T* v_s, int ks, int N, int D) {
  for (int i = threadIdx.x; i < N * D; i += Threads) {
    const int j = i / D;
    const int c = i - j * D;
    k_s[(size_t)j * ks + c] = kh[i];
    v_s[i] = vh[i];
  }
}

// One warp computes the query rows row0, row0 + row_step, ... < row_end of
// one head whose K and V are staged in shared memory. p (N floats) and qr
// (D floats) are the warp's own scratch rows.
template <typename T>
__device__ inline void attend_rows(const T* __restrict__ qh, const T* k_s,
                                   const T* v_s, T* __restrict__ oh, int ks,
                                   int N, int D, float scale, float* p,
                                   float* qr, int row0, int row_step,
                                   int row_end) {
  const int lane = threadIdx.x % 32;
  for (int r = row0; r < row_end; r += row_step) {
    for (int c = lane; c < D; c += 32) {
      qr[c] = Cvt<T>::to_f(qh[(size_t)r * D + c]) * scale;
    }
    __syncwarp();

    // Scores: lane owns keys lane, lane + 32, ...
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const T* kr = k_s + (size_t)j * ks;
      float acc = 0.f;
      for (int c = 0; c < D; ++c) acc = fmaf(qr[c], Cvt<T>::to_f(kr[c]), acc);
      p[j] = acc;
      m = fmaxf(m, acc);
    }
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    // Divide (not multiply by a reciprocal), then round P to the input dtype.
    for (int j = lane; j < N; j += 32) {
      p[j] = Cvt<T>::to_f(Cvt<T>::from_f(p[j] / sum));
    }
    __syncwarp();

    // P.V: lane owns output columns lane, lane + 32, ...
    float acc[kDPerLane];
#pragma unroll
    for (int t = 0; t < kDPerLane; ++t) acc[t] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float pj = p[j];
      const T* vr = v_s + (size_t)j * D;
#pragma unroll
      for (int t = 0; t < kDPerLane; ++t) {
        const int c = lane + 32 * t;
        if (c < D) acc[t] = fmaf(pj, Cvt<T>::to_f(vr[c]), acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kDPerLane; ++t) {
      const int c = lane + 32 * t;
      if (c < D) oh[(size_t)r * D + c] = Cvt<T>::from_f(acc[t]);
    }
    __syncwarp();  // p and qr are rewritten by the next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int N,
                 int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = k_stride(D, (int)sizeof(T));
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)N * ks;
  float* p_all = reinterpret_cast<float*>(smem + kv_bytes(N, D, (int)sizeof(T)));
  float* q_all = p_all + (size_t)kWarps * N;

  const int warp = threadIdx.x / 32;
  const size_t head = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)N * D;
  stage_kv<T, kThreads>(k + head, v + head, k_s, v_s, ks, N, D);
  __syncthreads();

  const int row_end = min(N, (int)(blockIdx.x + 1) * kRowsPerBlock);
  attend_rows<T>(q + head, k_s, v_s, o + head, ks, N, D, scale,
                 p_all + (size_t)warp * N, q_all + (size_t)warp * D,
                 blockIdx.x * kRowsPerBlock + warp, kWarps, row_end);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int N, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D, (int)sizeof(T), kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, D, scale);
  return (int)cudaGetLastError();
}

// K3: one block per batch row loops over the H heads, as the TPU kernel's
// one program per batch row does (attention_pallas.py:43-58). The heads are
// staged one at a time into the same shared-memory buffer: K and V of head
// h (at (192, 64): 49.9 KB in bf16, 99.1 KB in fp32, above the 48 KB
// default, so the launch raises the block's limit), a barrier, the block's
// kBatchWarps warps take the N query rows of the head in turn, and a barrier
// before head h + 1 overwrites the buffer. Numerics are K1's, step for step
// (attend_rows). It launches only B blocks (48 at the ViT-B batch, on 132
// SMs) and does not overlap staging with compute, so it is expected to be
// slower than K1; its bound is K1's, since it does the same work.
template <typename T>
__global__ void __launch_bounds__(kBatchThreads)
attention_batch_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int N, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ks = k_stride(D, (int)sizeof(T));
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)N * ks;
  float* p_all = reinterpret_cast<float*>(smem + kv_bytes(N, D, (int)sizeof(T)));
  float* q_all = p_all + (size_t)kBatchWarps * N;

  const int warp = threadIdx.x / 32;
  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)blockIdx.x * H + h) * (size_t)N * D;
    if (h > 0) __syncthreads();  // every warp is done with head h - 1
    stage_kv<T, kBatchThreads>(k + head, v + head, k_s, v_s, ks, N, D);
    __syncthreads();
    attend_rows<T>(q + head, k_s, v_s, o + head, ks, N, D, scale,
                   p_all + (size_t)warp * N, q_all + (size_t)warp * D, warp,
                   kBatchWarps, N);
  }
}

template <typename T>
int launch_batch(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int N, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, D, (int)sizeof(T), kBatchWarps);
  cudaError_t err = cudaFuncSetAttribute(
      attention_batch_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_batch_kernel<T><<<B, kBatchThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit before it launches.
// per_batch selects K3's block (one per batch row), else K1's.
size_t whmr_attention_smem_bytes(int n, int d, int esize, int per_batch) {
  return smem_bytes(n, d, esize, per_batch ? kBatchWarps : kWarps);
}

// q, k, v, o: contiguous (B, H, N, D); is_bf16 selects bf16, else fp32.
// Returns cudaGetLastError() after the launch (0 on success).
int whmr_attention_fwd(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int N, int D, float scale, int is_bf16,
                       void* stream) {
  if (D < 1 || D > kMaxD || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, o, B, H, N, D, scale, s);
  return launch<float>(q, k, v, o, B, H, N, D, scale, s);
}

// K3: the same contract as whmr_attention_fwd, one block per batch row.
int whmr_attention_batch_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int N, int D, float scale,
                             int is_bf16, void* stream) {
  if (D < 1 || D > kMaxD || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_batch<__nv_bfloat16>(q, k, v, o, B, H, N, D, scale, s);
  return launch_batch<float>(q, k, v, o, B, H, N, D, scale, s);
}

}  // extern "C"
