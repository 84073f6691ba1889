// K1 and K3: fused softmax self-attention for short sequences, forward only.
//
// K1 replaces the TPU kernel `fused_attention_heads` of
// whmr_tpu/ops/attention_pallas.py:79 (body `_kernel_heads` :61, pallas_call
// :98): o = softmax((q * s) k^T) v with s = 1/sqrt(D), per (batch, head), no
// mask, no dropout, q/k/v/o (B, H, N, D) in one dtype (fp32 or bf16).
// K3 replaces `fused_attention` of attention_pallas.py:108 (body `_kernel`
// :43, pallas_call :123): the same function, with the TPU's launch shape of
// one program per batch row looping over all H heads.
// Numerics follow the TPU kernel step for step: scores and softmax are fp32
// with the row max subtracted, P is divided by its row sum and then ROUNDED
// TO THE INPUT DTYPE before P.V, P.V accumulates in fp32, and the output is
// rounded once.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16, 495 TFLOP/s TF32): at
// the ViT-B shape (B=48, H=12, N=192, D=64, bf16) the kernel must move 4 x
// 48*12*192*64 x 2 B = 56.6 MB (16.9 us) and do 4*B*H*N*N*D = 5.44 GFLOP
// (5.5 us), so it is bound by bytes. In fp32 at whmr-eval's (32, 12, 192, 64)
// it moves 75.5 MB (22.5 us) and does three TF32 products of 3.62 GFLOP each
// (22.0 us; see "mma" in fp32 below): bound by bytes, barely. What the
// designs do about it: q, k, v and o cross device memory once (K3, and K1
// in fp32 at D <= 64), or K and V once per 64 query rows (K1 otherwise, the
// re-reads hit L2), copies run asynchronously beside the compute in bf16,
// and the N x N scores never leave registers. What holds them above that bound (PERF.md): the softmax's
// exact expf and division, about 15 CUDA-core instructions a score, and in
// fp32 the operand splits, which the warps of an SM run between their
// tensor-core products.
//
// Two variants of each kernel, chosen by the wrapper (ops/attention.py) by
// dtype and shape only:
//
// * "mma" in bf16, with N <= 256 and D % 8 == 0 (every ViT of the repo has
//   N = 192 and D = 64 or 80): the
//   warpgroup routine `attend_tile_mma`, 64 query rows a warpgroup.
//   - Staging: one thread loads Q, K and V of the head by TMA (tensor maps
//     from cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint)
//     into 128-byte-swizzled shared memory, 64 columns a block; Q and K
//     complete one mbarrier and V another, so the scores and the softmax
//     run while V lands. The maps' bounds zero the rows past N and columns
//     past D. TMA needs D % 8 == 0 (16-byte rows) and 16-byte aligned
//     pointers: the wrapper sends other D to "rows" and copies misaligned
//     inputs.
//   - Packed staging: every map is 4-D, (D, N, H, B) over its tensor's own
//     strides, and the loads and stores take (col, row, head, batch). Over
//     contiguous (B, H, N, D) operands (K1, K3) that is the plain layout;
//     for K1 over the ViT block's fused projection (`whmr_attention_qkv_fwd`),
//     (B, N, 3, H, D), q, k and v are one map's strides (N: 3 H D elements,
//     H: D, B: N 3 H D) at offsets 0, H D and 2 H D, and O goes through a
//     map over a (B, N, H, D) buffer, token-major, where `proj` reads it.
//     TMA takes any 16-byte-multiple stride, so the same 128-byte rows land
//     in shared memory as from contiguous copies, and the output bits are
//     the same, and no layout copy is needed around the block's attention. N
//     and D stay dimensions of their own, so the bounds still zero the
//     rows past N and columns past D, which in the projection hold the next
//     sample's tokens and the next head's columns.
//   - S = QK^T by wgmma.m64n64k16 (bf16 in, fp32 out, both operands read by
//     descriptor from shared memory); each warp holds its 16 rows' whole
//     score row in fp32 registers (the kernels are instantiated for 64, 128,
//     192 and 256 padded keys, so the register arrays have compile-time
//     extents; ptxas reports no spills at 256).
//   - Softmax: the scale applied in fp32 to the accumulated scores (q *
//     scale rounded to bf16 would be exact only for D a power of 4; for a
//     power-of-two scale one FMA gives the product-then-difference's bits),
//     pad keys masked to -inf, the row max and sum by quad shuffles, P = e / sum
//     correctly rounded (`div_rn`: the same bits as a division, not a
//     multiply by the reciprocal) and rounded to bf16 straight into the
//     register A operand of O = P.V, so P never touches shared memory.
//   - O = P.V by wgmma with V read MN-major from shared memory, accumulated
//     in fp32 and rounded once into the (now free) Q tile, which one thread
//     stores by TMA (the map clips rows past N).
//   Every softmax step is an _rn intrinsic, so the compiler contracts
//   nothing and K1 and K3, which inline the same routine on the same staged
//   values, agree bit for bit.
//   K1's launch: one warpgroup per (b, h, 64 query rows); at (192, 64) it
//   stages 64 + 2 x 192 rows of 128 B (57 KB), so 3 blocks (12 warps, at
//   most 168 registers a thread) are resident per SM. At N = 192 that is
//   1,728 blocks at B = 48 (4.4 waves of 396) and 576 at B = 16 (1.5 waves);
//   K and V are read once per 64 rows, the re-reads from L2.
//   K3's launch: persistent, one block of 3 warpgroups (2 at 256 padded
//   keys) per SM, each block walking the (b, h) items b * H + h, + grid,
//   ...; thread 0 loads the next item into a second buffer while the
//   current item computes (2 x 72 KB at (192, 64); one buffer when two do
//   not fit, e.g. D > 64 at N > 128).
// * "mma" in fp32, with N <= 192 and D % 4 == 0 (16-byte rows): 3xTF32 on
//   tensor cores. One TF32 product keeps 10 of fp32's 23 mantissa bits,
//   outside the 2e-5 contract (a numpy model of it misses by 18-40x,
//   tests/test_torch_attention.py); so each operand x is split into big =
//   RNA_tf32(x) and small = RNA_tf32(x - big) (`cvt.rna.tf32.f32`: raw fp32
//   bits would be truncated) and a b is taken as a_small b_big + a_big
//   b_small + a_big b_big, accumulated in fp32: about 21-22 bits, the one
//   dropped term a_small b_small below 2^-22 |ab|. q is widened and scaled
//   in fp32 before its split, as the plain version scales before its
//   product; the softmax is the bf16 routine's in fp32 (`softmax_f32`:
//   exact expf, `div_rn`), and P stays fp32 (the plain version's rounding
//   of P to the input dtype is a no-op there). The bound counts the three
//   products at the TF32 peak. Two routines, by D:
//   - D <= 64 (every ViT-B head), `attend_tile_wg`, wgmma, a warpgroup per
//     64 query rows. wgmma in tf32 reads its shared-memory operands K-major
//     only and truncates them, so the block first writes K and V^T of the
//     head, each split into big and small parts (`stage_wg`: float4 loads,
//     the split, 16-byte stores into the 128-byte swizzle; V transposed, a
//     warp's stores 32 keys of one row), 192 KB at 192 keys. S = (q
//     scale) K^T by m64n64k8, q's split A fragments from registers; P.V by
//     m64n64k8 with P's fragments straight from the score registers: the S
//     accumulator holds keys 2t and 2t + 1 of each n8 tile where the A
//     fragment wants keys t and t + 4, and V^T stores each 8-key group in
//     the order 0, 2, 4, 6, 1, 3, 5, 7 to match. The A registers of a k8
//     step stay untouched until the wgmma.wait_group that retires it.
//     K1's launch: grid (H, B), one block of N / 64 (padded) warpgroups a
//     head, 1 block an SM (at 164 registers a thread); the staging is not
//     overlapped with compute. K3's: persistent, one block of at most 2
//     warpgroups an SM taking the 64-row tiles of an item in turn (3 would
//     spill with the item loop's registers).
//   - 64 < D <= 128 (ViT-H's 80), `attend_tile_f32`, mma.sync.m16n8k8, a
//     warp per 16 query rows, each thread loading and splitting its own
//     fragments (the split K and V^T of 128 columns would not fit a block).
//     K and V of the head staged in fp32 by cp.async into rows of 132
//     floats (a B fragment's 8 rows x 4 columns hit 32 banks), zero past N
//     and D so that the unrolled loops need no run-time guard (a guard
//     cuts them into blocks the compiler cannot interleave); the same key
//     permutation feeds P to P.V. K1: a block of 4 warps per (b, h, 64 rows), K and V on two copy
//     groups so that the scores run while V lands; K3: persistent, 8 warps
//     taking 16-row tiles, the next item copied into a second buffer when
//     two fit.
//   Each kernel pair inlines one routine on the same staged values, so K3's
//   output equals K1's bit for bit. What holds them above the bound
//   (PERF.md): the operand splits and the exact softmax on CUDA cores, the
//   staging's split and transpose, which no warp overlaps with the products
//   at one block an SM, and for D > 64 mma.sync's rate (about 12 cycles a
//   TF32 m16n8k8 a sub-partition, read on the H100).
// * "rows", fp32 above N = 192 or with D % 4 != 0, and bf16 above N = 256
//   or with D % 8 != 0: the first design on CUDA cores. One
//   warp per query row; lanes split the N keys for the scores, reduce max
//   and sum with shuffles, and split the D output columns for P.V. K1 is a
//   block of 8 warps per (b, h, 64 rows) with K (rows padded so that lanes
//   reading 32 different rows hit 32 different banks) and V of its head in
//   shared memory; K3 is a block of 16 warps per batch row staging one
//   head at a time. q is widened to fp32 and scaled before the product.
//
// Built by whmr_tpu_torch/ops/cuda_build.py (nvcc, sm_90a) into a shared
// library with a plain C interface, loaded with ctypes by ops/attention.py.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared-memory limit on the current device to
// `smem`, remembering in `allowed` (the call site's own table) what it set:
// the attribute call would otherwise cost microseconds on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
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
  static size_t allowed[kMaxDevices];
  cudaError_t err = allow_smem(attention_kernel<T>, smem, allowed);
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
  static size_t allowed[kMaxDevices];
  cudaError_t err = allow_smem(attention_batch_kernel<T>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  attention_batch_kernel<T><<<B, kBatchThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, D, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The "mma" variant: bf16 on tensor cores (see the notes at the top).

constexpr int kMmaMaxN = 256;
// K1: one warpgroup (4 warps) per (b, h, 64 query rows).
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory an H100 block may use
constexpr int kSmemAlign = 1024;     // the 128-byte swizzle repeats every 1024 bytes

// K3: 3 warpgroups (one 64-row tile each at N = 192) within 168 registers a
// thread; at 256 padded keys the score row needs more, so 2 warpgroups.
template <int NKP>
struct BatchMma {
  static constexpr int kWarpgroups = NKP <= 192 ? 3 : 2;
  static constexpr int kThreads = kWarpgroups * 128;
};

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// The padded key count the kernels are instantiated for; K and V are
// staged with this many rows (zero beyond N), and Q in 64-row tiles.
__host__ __device__ inline int padded_keys(int n) {
  return n <= 64 ? 64 : n <= 128 ? 128 : n <= 192 ? 192 : 256;
}

// Shared-memory layout of the tensor-core variant: a (rows, D) matrix as
// ceil(D / 64) column blocks of 64 bf16 values; a block is `rows` rows of
// 128 bytes whose 16-byte chunk c lies at chunk c ^ (row % 8): the 128-byte
// swizzle, which TMA writes and wgmma reads through a B128 descriptor, and
// under which a column chunk's 8 rows fall in 8 different bank groups.
// Columns past D are zero.
__host__ __device__ inline int col_blocks(int d) { return (d + 63) / 64; }

__device__ inline uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// K1's block: its 64 query rows, K and V (padded_keys rows each).
__host__ __device__ inline size_t mma_tile_bytes(int n, int d) {
  return (size_t)(kMmaRows + 2 * padded_keys(n)) * 128 * col_blocks(d) + kSmemAlign;
}

// One stage of K3's block: Q, K and V of one (b, h) item, padded_keys rows each.
__host__ __device__ inline size_t mma_head_bytes(int n, int d) {
  return (size_t)3 * padded_keys(n) * 128 * col_blocks(d);
}

// K3 double-buffers the items when two fit in a block.
__host__ __device__ inline int batch_mma_stages(int n, int d) {
  return 2 * mma_head_bytes(n, d) + kSmemAlign <= kMaxSmem ? 2 : 1;
}

__host__ __device__ inline size_t batch_mma_smem_bytes(int n, int d) {
  return batch_mma_stages(n, d) * mma_head_bytes(n, d) + kSmemAlign;
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Makes this thread's shared-memory accesses ordered with the asynchronous
// proxy (TMA writes, wgmma reads).
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Arrives on `bar` and tells it `bytes` of TMA writes will complete its phase.
__device__ inline void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// A (64 x rows) box of the (D, N, H, B) tensor map at (col, row, head,
// batch), out-of-bounds elements zero, to dst; completes `bar`'s
// transaction bytes.
__device__ inline void tma_load(void* dst, const CUtensorMap* map, int col, int row, int head,
                                int batch, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// The (64 x 64) box at src to (col, row, head, batch) of the tensor map,
// clipped to its bounds; the calling thread commits it to its bulk group.
__device__ inline void tma_store(const CUtensorMap* map, const void* src, int col, int row, int head,
                                 int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row), "r"(head), "r"(batch), "r"(smem_u32(src))
      : "memory");
}

// Waits until the thread's bulk stores have read their shared memory.
__device__ inline void tma_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The four tensor maps of a launch: q, k, v (boxes of 64 columns x the
// kernel's rows) and o (64 x 64), each (D, N, H, B) over its tensor's own
// strides (`Layout`).
struct Maps {
  CUtensorMap q, k, v, o;
};

// A wgmma shared-memory descriptor of the 128-byte swizzled layout: start
// address, leading and stride byte offsets in 16-byte units, B128.
__device__ inline uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float& x) { asm volatile("" : "+f"(x)::"memory"); }

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(i) WG_F4(i), WG_F4(i + 4)
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)

// d[0, 32) += A (64 x 16, K-major in shared memory) B (16 x 64, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(0)
      : "l"(da), "l"(db), "r"(1));
}

// d[0, 32) += A (64 x 16 in registers) B (16 x 64, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_F32
#undef WG_F8
#undef WG_F4

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// x / l correctly rounded, given r = RN(1 / l): q = RN(x r) is within an
// ulp of x / l, the FMA gives the remainder x - q l exactly, and RN(q + rem
// r) is then the correctly rounded quotient (Markstein's theorem, for
// quotients in fp32's normal range; tests/test_torch_attention.py holds the
// formula to exact division). One reciprocal a row replaces a division an
// element: the same bits as x / l, at 3 instructions an element.
__device__ inline float div_rn(float x, float l, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, l, x), r, q);
}

// Where a block stages one (b, h) head: Q (q_rows rows), K and V
// (padded_keys rows each), each as col_blocks(D) swizzled column blocks.
struct HeadTiles {
  unsigned char* q;
  unsigned char* k;
  unsigned char* v;
  int q_rows, kv_rows, cb;
  __device__ HeadTiles(unsigned char* base, int q_rows_, int kv_rows_, int d)
      : q_rows(q_rows_), kv_rows(kv_rows_), cb(col_blocks(d)) {
    q = base;
    k = q + (size_t)q_rows * 128 * cb;
    v = k + (size_t)kv_rows * 128 * cb;
  }
};

// The head's TMA loads (one thread): each tensor's column blocks, with rows
// past N and columns past D zero-filled by the tensor maps' bounds. Q and K
// complete `qk`, V completes `vb`, so the scores can start before V lands.
__device__ inline void load_head(const HeadTiles& t, const Maps& m, int q_row0, int head, int batch,
                                 uint64_t* qk, uint64_t* vb) {
  mbar_expect(qk, (uint32_t)(t.q_rows + t.kv_rows) * 128 * t.cb);
  for (int b = 0; b < t.cb; ++b) {
    tma_load(t.q + (size_t)b * t.q_rows * 128, &m.q, 64 * b, q_row0, head, batch, qk);
    tma_load(t.k + (size_t)b * t.kv_rows * 128, &m.k, 64 * b, 0, head, batch, qk);
  }
  mbar_expect(vb, (uint32_t)t.kv_rows * 128 * t.cb);
  for (int b = 0; b < t.cb; ++b) {
    tma_load(t.v + (size_t)b * t.kv_rows * 128, &m.v, 64 * b, 0, head, batch, vb);
  }
}

// One warpgroup: the 64 query rows of the tile at q_t (row 0 of the tile at
// byte 0 of each of its column blocks, blocks q_stride bytes apart) of a
// head whose K and V (NKP rows, zero beyond N) are staged at k_t and v_t
// (blocks kv_stride bytes apart). Each warp owns 16 rows of the tile and
// ends with its 16 bf16 output rows over its rows of q_t. NKP is the
// compile-time extent of the score row: NKP / 2 fp32 registers a thread.
// v_bar completes, at parity v_parity, when V has landed.
template <int NKP>
__device__ inline void attend_tile_mma(unsigned char* q_t, int q_stride, const unsigned char* k_t,
                                       const unsigned char* v_t, int kv_stride, int n, int d,
                                       float scale, uint64_t* v_bar, uint32_t v_parity) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of the warp's 16
  const int t = lane % 4;  // accumulator columns 2t and 2t + 1 of each n8 tile
  const int w = (threadIdx.x / 32) % 4;  // the warp's 16 rows in the tile
  const int cb = col_blocks(d);
  const uint32_t q_a = smem_u32(q_t);
  const uint32_t k_a = smem_u32(k_t);
  const uint32_t v_a = smem_u32(v_t);

  // S = Q K^T, 64 x NKP unscaled fp32 sums: per k16 step one m64n64k16 per
  // 64 keys. A (Q) and B (K) are K-major: 8-row groups 1024 B apart, a k16
  // step 32 B into the swizzled 128-byte rows.
  float s[NKP / 8][4];
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 0.f;
      reg_fence(s[j][e]);
    }
  }
  wgmma_fence();
  for (int kk = 0; kk < round16(d) / 16; ++kk) {
    const uint32_t k_off = 32u * (kk % 4);
    const uint64_t da = gmma_desc(q_a + (uint32_t)((kk / 4) * q_stride) + k_off, 16, 1024);
#pragma unroll
    for (int nb = 0; nb < NKP / 64; ++nb) {
      wgmma_ss_n64(&s[8 * nb][0], da,
                   gmma_desc(k_a + (uint32_t)((kk / 4) * kv_stride + nb * 64 * 128) + k_off, 16, 1024));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(s[j][e]);
  }

  // Pad keys (n < NKP) take -inf, then the row max. The scale is positive
  // and rounding is monotonic, so the max of the scaled scores RN(s * scale)
  // is RN(max(s) * scale).
  if (n < NKP) {
#pragma unroll
    for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * t + e >= n) s[j][e] = s[j][2 + e] = -INFINITY;
      }
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  m0 = __fmul_rn(m0, scale);
  m1 = __fmul_rn(m1, scale);

  // e = exp(RN(s * scale) - m), 0 at the pads, and the row sums. When the
  // scale is a power of two (D = 4, 16, 64, ...), s * scale is exact and one
  // FMA gives the same bits as the product and the difference.
  float l0 = 0.f, l1 = 0.f;
  if ((__float_as_uint(scale) & 0x7FFFFF) == 0) {
#pragma unroll
    for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(__fmaf_rn(s[j][e], scale, -m0));
        s[j][2 + e] = expf(__fmaf_rn(s[j][2 + e], scale, -m1));
        l0 = __fadd_rn(l0, s[j][e]);
        l1 = __fadd_rn(l1, s[j][2 + e]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(__fsub_rn(__fmul_rn(s[j][e], scale), m0));
        s[j][2 + e] = expf(__fsub_rn(__fmul_rn(s[j][2 + e], scale), m1));
        l0 = __fadd_rn(l0, s[j][e]);
        l1 = __fadd_rn(l1, s[j][2 + e]);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, off));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, off));
  }

  // P = e / sum, divided and rounded to bf16 straight into the register A
  // operand of P.V: the accumulator tiles of keys 16c..16c+7 and
  // 16c+8..16c+15 are A fragment c.
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
  uint32_t p[NKP / 16][4];
#pragma unroll
  for (int c = 0; c < NKP / 16; ++c) {
    p[c][0] = pack_bf16(div_rn(s[2 * c][0], l0, r0), div_rn(s[2 * c][1], l0, r0));
    p[c][1] = pack_bf16(div_rn(s[2 * c][2], l1, r1), div_rn(s[2 * c][3], l1, r1));
    p[c][2] = pack_bf16(div_rn(s[2 * c + 1][0], l0, r0), div_rn(s[2 * c + 1][1], l0, r0));
    p[c][3] = pack_bf16(div_rn(s[2 * c + 1][2], l1, r1), div_rn(s[2 * c + 1][3], l1, r1));
  }

  // O = P V, 64 x (64 per column block) in fp32: per k16 step of keys one
  // m64n64k16 per column block. B (V) is MN-major: 8-key groups 1024 B
  // apart (a k16 step is 2048 B), column blocks kv_stride apart.
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    o[i] = 0.f;
    reg_fence(o[i]);
  }
  mbar_wait(v_bar, v_parity);
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if (b < cb) {
#pragma unroll
      for (int c = 0; c < NKP / 16; ++c) {
        if (16 * c < n) {
          wgmma_rs_n64(&o[32 * b], p[c],
                       gmma_desc(v_a + (uint32_t)(b * kv_stride + c * 2048), (uint32_t)kv_stride, 1024));
        }
      }
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 64; ++i) reg_fence(o[i]);

  // Rounded once to bf16, over the warp's own rows of q_t.
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j / 8 < cb) {
      unsigned char* blk = q_t + (size_t)(j / 8) * q_stride;
      const int row = 16 * w + g;
      *reinterpret_cast<__nv_bfloat162*>(blk + swz(row, j % 8) + 4 * t) =
          __floats2bfloat162_rn(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(blk + swz(row + 8, j % 8) + 4 * t) =
          __floats2bfloat162_rn(o[4 * j + 2], o[4 * j + 3]);
    }
  }
  __syncwarp();
}

// A warpgroup's tile: attend, then one thread stores the whole tile by TMA
// (the map clips rows past N) once the four warps have written it. The
// tile's shared memory is free on return.
template <int NKP>
__device__ inline void attend_and_store(unsigned char* q_t, int q_stride, const unsigned char* k_t,
                                        const unsigned char* v_t, int kv_stride, int n, int d,
                                        float scale, const Maps& m, uint64_t* v_bar,
                                        uint32_t v_parity, int o_row0, int head, int batch) {
  attend_tile_mma<NKP>(q_t, q_stride, k_t, v_t, kv_stride, n, d, scale, v_bar, v_parity);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)threadIdx.x / 128) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int b = 0; b < col_blocks(d); ++b) {
      tma_store(&m.o, q_t + (size_t)b * q_stride, 64 * b, o_row0, head, batch);
    }
    tma_store_commit_and_wait_read();
  }
}

__device__ inline unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + kSmemAlign - 1) & ~(uintptr_t)(kSmemAlign - 1));
}

// K1, "mma": grid (ceil(N / 64), H, B), one warpgroup per 64 query rows.
// m's q boxes are 64 rows, k's and v's NKP rows.
template <int NKP>
__global__ void __launch_bounds__(kMmaThreads, NKP <= 192 ? 3 : 1)
attention_mma_kernel(const __grid_constant__ Maps m, int N, int D, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qk_bar, v_bar;
  const HeadTiles t(aligned_smem(smem_raw), kMmaRows, NKP, D);
  const int row0 = blockIdx.x * kMmaRows;
  if (threadIdx.x == 0) {
    mbar_init(&qk_bar, 1);
    mbar_init(&v_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_head(t, m, row0, blockIdx.y, blockIdx.z, &qk_bar, &v_bar);
  }
  __syncthreads();
  mbar_wait(&qk_bar, 0);
  attend_and_store<NKP>(t.q, kMmaRows * 128, t.k, t.v, NKP * 128, N, D, scale, m, &v_bar, 0, row0,
                        blockIdx.y, blockIdx.z);
}

// K3, "mma": a persistent grid; each block walks the items b * H + h
// (a batch row's heads in turn) from blockIdx.x in steps of gridDim.x, its
// warpgroups taking the 64-row tiles of an item in turn. Thread 0 loads the
// next item by TMA into the other buffer while the current one computes
// (stages == 2), or after it (stages == 1).
template <int NKP>
__global__ void __launch_bounds__(BatchMma<NKP>::kThreads, 1)
attention_batch_mma_kernel(const __grid_constant__ Maps m, int items, int H, int N, int D,
                           float scale, int stages) {
  constexpr int kWarpgroups = BatchMma<NKP>::kWarpgroups;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qk_bar[2], v_bar[2];
  unsigned char* base = aligned_smem(smem_raw);
  const size_t stage_bytes = (size_t)3 * NKP * 128 * col_blocks(D);
  int item = blockIdx.x;
  if (item >= items) return;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qk_bar[b], 1);
      mbar_init(&v_bar[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_head(HeadTiles(base, NKP, NKP, D), m, 0, item % H, item / H, &qk_bar[0], &v_bar[0]);
  }
  __syncthreads();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int next = item + gridDim.x;
    const int buf = stages == 2 ? it % 2 : 0;
    const uint32_t parity = stages == 2 ? (it / 2) % 2 : it % 2;
    const HeadTiles t(base + buf * stage_bytes, NKP, NKP, D);
    // The other buffer was freed by the barrier that ended the last item.
    if (stages == 2 && next < items && threadIdx.x == 0) {
      load_head(HeadTiles(base + (1 - buf) * stage_bytes, NKP, NKP, D), m, 0, next % H, next / H,
                &qk_bar[1 - buf], &v_bar[1 - buf]);
    }
    mbar_wait(&qk_bar[buf], parity);
    for (int r = 64 * (threadIdx.x / 128); r < N; r += 64 * kWarpgroups) {
      attend_and_store<NKP>(t.q + (size_t)r * 128, NKP * 128, t.k, t.v, NKP * 128, N, D, scale, m,
                            &v_bar[buf], parity, r, item % H, item / H);
    }
    __syncthreads();  // every warp is done with this buffer
    if (stages == 1 && next < items && threadIdx.x == 0) {
      load_head(t, m, 0, next % H, next / H, &qk_bar[0], &v_bar[0]);
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The blocks of a persistent kernel that fit on the card at once (SMs x
// blocks an SM), cached per device and shared-memory size in the call
// site's `cache` (the queries cost microseconds).
struct SlotCache {
  size_t smem[kMaxDevices];
  int slots[kMaxDevices];
};

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, SlotCache& cache, int* slots) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache.smem[dev] == smem) {
    *slots = cache.slots[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  *slots = sms * (per_sm > 1 ? per_sm : 1);
  if (dev < kMaxDevices) {
    cache.slots[dev] = *slots;
    cache.smem[dev] = smem;
  }
  return cudaSuccess;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// Element strides of the N, H and B dimensions of a bf16 operand whose D
// elements are contiguous: (B, H, N, D) contiguous, or the (B, N, 3, H, D)
// qkv projection and the (B, N, H, D) output that K1 reads and writes in
// place (`whmr_attention_qkv_fwd`).
struct Layout {
  int64_t n, h, b;
};

inline Layout bhnd_layout(int H, int N, int D) {
  return {(int64_t)D, (int64_t)N * D, (int64_t)H * N * D};
}

// The (D, N, H, B) bf16 tensor at ptr with strides s, in boxes of 64
// columns x box_rows rows of one (b, h), 128-byte swizzled, out-of-bounds
// elements zero. D and N are dimensions of their own, so the bounds zero
// the columns past D and the rows past N even where the memory beyond them
// holds the next head's columns or the next sample's tokens.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int D, int N, int H, int B, Layout s,
                       int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.n * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                  box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q, k and v share the layout `in`; o has `out`.
template <int NKP>
int launch_mma_nkp(const void* q, const void* k, const void* v, void* o, Layout in, Layout out,
                   int B, int H, int N, int D, float scale, int per_batch, cudaStream_t stream) {
  if (D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return (int)cudaErrorInvalidValue;  // TMA reads 16-byte aligned rows
  }
  const int items = B * H;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t err;
  if ((err = tensor_map(&maps.q, q, D, N, H, B, in, per_batch ? NKP : kMmaRows)) != cudaSuccess ||
      (err = tensor_map(&maps.k, k, D, N, H, B, in, NKP)) != cudaSuccess ||
      (err = tensor_map(&maps.v, v, D, N, H, B, in, NKP)) != cudaSuccess ||
      (err = tensor_map(&maps.o, o, D, N, H, B, out, kMmaRows)) != cudaSuccess) {
    return (int)err;
  }
  if (!per_batch) {
    const size_t smem = mma_tile_bytes(N, D);
    static size_t allowed[kMaxDevices];
    if ((err = allow_smem(attention_mma_kernel<NKP>, smem, allowed)) != cudaSuccess) return (int)err;
    const dim3 grid((N + kMmaRows - 1) / kMmaRows, H, B);
    attention_mma_kernel<NKP><<<grid, kMmaThreads, smem, stream>>>(maps, N, D, scale);
    return (int)cudaGetLastError();
  }
  const int stages = batch_mma_stages(N, D);
  const size_t smem = batch_mma_smem_bytes(N, D);
  static size_t allowed[kMaxDevices];
  if ((err = allow_smem(attention_batch_mma_kernel<NKP>, smem, allowed)) != cudaSuccess) return (int)err;
  static SlotCache cache;
  int slots = 0;
  err = resident_blocks(attention_batch_mma_kernel<NKP>, BatchMma<NKP>::kThreads, smem, cache, &slots);
  if (err != cudaSuccess) return (int)err;
  const int grid = items < slots ? items : slots;
  attention_batch_mma_kernel<NKP><<<grid, BatchMma<NKP>::kThreads, smem, stream>>>(
      maps, items, H, N, D, scale, stages);
  return (int)cudaGetLastError();
}

int launch_mma(const void* q, const void* k, const void* v, void* o, Layout in, Layout out, int B,
               int H, int N, int D, float scale, int per_batch, cudaStream_t s) {
  switch (padded_keys(N)) {
    case 64: return launch_mma_nkp<64>(q, k, v, o, in, out, B, H, N, D, scale, per_batch, s);
    case 128: return launch_mma_nkp<128>(q, k, v, o, in, out, B, H, N, D, scale, per_batch, s);
    case 192: return launch_mma_nkp<192>(q, k, v, o, in, out, B, H, N, D, scale, per_batch, s);
    default: return launch_mma_nkp<256>(q, k, v, o, in, out, B, H, N, D, scale, per_batch, s);
  }
}

// ---------------------------------------------------------------------------
// The "mma" variant in fp32: 3xTF32 on tensor cores (see the notes at the top).

constexpr int kF32MaxN = 192;          // fp32 on tensor cores: N <= 192, D % 4 == 0
constexpr int kF32Rows = 64;           // K1, 64 < D <= 128: 4 warps of 16 query rows a block
constexpr int kF32Threads = 128;
constexpr int kF32BatchThreads = 256;  // K3, 64 < D <= 128: 8 warps taking an item's 16-row tiles in turn

// Row stride of K and V in shared memory, in floats: 128 columns (the S
// products and the 16 n8 tiles of O read zeros past D), plus 4, so that a B
// fragment's 8 rows x 4 columns fall in 32 different banks.
constexpr int kF32Ld = 128 + 4;

// K and V of one head, padded_keys(N) rows each (zero past N): K1's block,
// and one stage of K3's; 202,752 bytes at 192 keys.
__host__ __device__ inline size_t f32_head_bytes(int n) {
  return (size_t)2 * padded_keys(n) * kF32Ld * sizeof(float);
}

// K3 double-buffers the items when two fit in a block.
__host__ __device__ inline int batch_f32_stages(int n) { return 2 * f32_head_bytes(n) <= kMaxSmem ? 2 : 1; }

__host__ __device__ inline size_t batch_f32_smem_bytes(int n) { return batch_f32_stages(n) * f32_head_bytes(n); }

// 16 bytes from device memory at src to shared memory at dst, asynchronously;
// src_bytes = 0 writes 16 zero bytes and reads nothing.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `Pending` of the thread's committed copy groups are in flight.
template <int Pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Starts the copy of one head's (n, d) fp32 matrix at src into shared memory
// at dst: padded_keys(n) rows of kF32Ld floats, zero past n rows and past d
// columns (up to 128). The block's Threads threads share the 16-byte chunks.
template <int Threads>
__device__ inline void stage_f32_async(const float* src, float* dst, int n, int d) {
  const int ld = kF32Ld, chunks = 32, in_row = d / 4;
  const int total = padded_keys(n) * chunks;
  for (int i = threadIdx.x; i < total; i += Threads) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const bool in = r < n && c < in_row;
    cp_async16(dst + (size_t)r * ld + 4 * c, in ? src + (size_t)r * d + 4 * c : src, in ? 16 : 0);
  }
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 21 bits, both parts TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// d += a b: m16n8k8, A row-major (16 x 8), B column-major (8 x 8), TF32 in,
// fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small cross terms first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// The softmax of 16 rows' fp32 scores in the accumulator layout of
// m16n8k8 and of wgmma (s[j][0..1]: keys 8j + 2t and 8j + 2t + 1 of row g,
// s[j][2..3] of row g + 8; the 4 lanes of a quad hold a row): pad keys (>=
// n) take -inf; then the row max, e = exp(s - m), the row sums by quad
// shuffles, and P = e / sum correctly rounded, in place.
template <int NKP>
__device__ __forceinline__ void softmax_f32(float (&s)[NKP / 8][4], int n, int t) {
  if (n < NKP) {
#pragma unroll
    for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + 2 * t + e >= n) s[j][e] = s[j][2 + e] = -INFINITY;
      }
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(__fsub_rn(s[j][e], m0));
      s[j][2 + e] = expf(__fsub_rn(s[j][2 + e], m1));
      l0 = __fadd_rn(l0, s[j][e]);
      l1 = __fadd_rn(l1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, off));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, off));
  }
  const float r0 = __frcp_rn(l0), r1 = __frcp_rn(l1);
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = div_rn(s[j][e], l0, r0);
      s[j][2 + e] = div_rn(s[j][2 + e], l1, r1);
    }
  }
}

// One warp, for 64 < d <= 128: the 16 query rows row0 .. row0 + 15 of one
// head, q at qh and o at oh ((n, d) each, row-major), K and V staged at k_s
// and v_s (`stage_f32_async`). NKP = padded_keys(n) is the compile-time
// extent of the score row, NKP / 2 floats a thread, and O takes 64 floats a
// thread; the score registers die as P.V consumes them. The unrolled loops
// carry no run-time guard (a guard would cut them into blocks the compiler
// cannot interleave): every key tile and every column tile of O is
// computed, on the staged zeros past n and d. Rows past n compute on a copy
// of row n - 1 and are not stored. With kWaitV the warp waits for the
// thread's last copy group and the block's barrier before P.V (K1, whose 4
// warps all call this once: V lands while the scores compute).
template <int NKP, bool kWaitV>
__device__ inline void attend_tile_f32(const float* __restrict__ qh, const float* k_s, const float* v_s,
                                       float* __restrict__ oh, int row0, int n, int d, float scale) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // A rows g and g + 8; B column (key or output column) g
  const int t = lane % 4;  // A columns t and t + 4; accumulator columns 2t and 2t + 1
  const int ld = kF32Ld;
  const int ra = row0 + g, rb = ra + 8;
  const float* qa = qh + (size_t)min(ra, n - 1) * d;
  const float* qb = qh + (size_t)min(rb, n - 1) * d;

  // S = (q * scale) K^T, unrounded fp32 sums: per k8 step over D, the A
  // fragment (q at columns t and t + 4 of rows g and g + 8, read one step
  // ahead), then per n8 tile of keys the B fragment (K at key g, columns t
  // and t + 4).
  float s[NKP / 8][4];
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  float next[4];
  auto load_q = [&](int kk, float (&x)[4]) {
    const int c = 8 * kk + t;  // < d, since d % 4 == 0
    const bool hi = c + 4 < d;
    x[0] = qa[c];
    x[1] = qb[c];
    x[2] = hi ? qa[c + 4] : 0.f;
    x[3] = hi ? qb[c + 4] : 0.f;
  };
  const int steps = (d + 7) / 8;
  load_q(0, next);
  for (int kk = 0; kk < steps; ++kk) {
    uint32_t a_big[4], a_small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__fmul_rn(next[e], scale), a_big[e], a_small[e]);
    if (kk + 1 < steps) load_q(kk + 1, next);
    const float* kc = k_s + (size_t)g * ld + 8 * kk + t;
#pragma unroll
    for (int j = 0; j < NKP / 8; ++j) {
      uint32_t b_big[2], b_small[2];
      split_tf32(kc[8 * j * ld], b_big[0], b_small[0]);
      split_tf32(kc[8 * j * ld + 4], b_big[1], b_small[1]);
      mma_3xtf32(s[j], a_big, a_small, b_big, b_small);
    }
  }

  softmax_f32<NKP>(s, n, t);

  if (kWaitV) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // O = P V over 128 columns: per n8 tile j of keys, P's A fragment
  // straight from s[j] (slot t holds key 8j + 2t, slot t + 4 key 8j + 2t +
  // 1), and per n8 tile of output columns V's B fragment read with the same
  // permutation.
  float o[16][4];
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  }
  const float* vc = v_s + (size_t)(2 * t) * ld + g;
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
    uint32_t a_big[4], a_small[4];
    split_tf32(s[j][0], a_big[0], a_small[0]);  // (row g, key 2t)
    split_tf32(s[j][2], a_big[1], a_small[1]);  // (row g + 8, key 2t)
    split_tf32(s[j][1], a_big[2], a_small[2]);  // (row g, key 2t + 1)
    split_tf32(s[j][3], a_big[3], a_small[3]);  // (row g + 8, key 2t + 1)
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      uint32_t b_big[2], b_small[2];
      split_tf32(vc[8 * j * ld + 8 * nb], b_big[0], b_small[0]);
      split_tf32(vc[(8 * j + 1) * ld + 8 * nb], b_big[1], b_small[1]);
      mma_3xtf32(o[nb], a_big, a_small, b_big, b_small);
    }
  }

  // Written once: columns 2t and 2t + 1 of each n8 tile (both < d or both
  // past it, since d % 4 == 0), rows g and g + 8.
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    const int c = 8 * nb + 2 * t;
    if (c < d) {
      if (ra < n) *reinterpret_cast<float2*>(oh + (size_t)ra * d + c) = make_float2(o[nb][0], o[nb][1]);
      if (rb < n) *reinterpret_cast<float2*>(oh + (size_t)rb * d + c) = make_float2(o[nb][2], o[nb][3]);
    }
  }
}

// K1, "mma" in fp32 at 64 < D <= 128: grid (ceil(N / 64), H, B), 4 warps
// of 16 query rows. K and V are copied in two groups, so the scores run
// while V lands.
template <int NKP>
__global__ void __launch_bounds__(kF32Threads)
attention_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int H, int N, int D,
                         float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + (size_t)padded_keys(N) * kF32Ld;
  const size_t head = ((size_t)blockIdx.z * H + blockIdx.y) * (size_t)N * D;
  stage_f32_async<kF32Threads>(k + head, k_s, N, D);
  cp_async_commit();
  stage_f32_async<kF32Threads>(v + head, v_s, N, D);
  cp_async_commit();
  cp_async_wait<1>();  // K has landed
  __syncthreads();
  attend_tile_f32<NKP, true>(q + head, k_s, v_s, o + head, blockIdx.x * kF32Rows + 16 * (threadIdx.x / 32), N,
                             D, scale);
}

// K3, "mma" in fp32 at 64 < D <= 128: a persistent grid walking the items b * H + h from
// blockIdx.x in steps of gridDim.x; the block's 8 warps take the 16-row
// tiles of an item in turn. The next item's K and V are copied into the
// other buffer while the current one computes (stages == 2), or after it.
template <int NKP>
__global__ void __launch_bounds__(kF32BatchThreads, 1)
attention_batch_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, int items, int N,
                               int D, float scale, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* base = reinterpret_cast<float*>(smem);
  const size_t rows = (size_t)padded_keys(N) * kF32Ld;  // floats of K (and of V) in a stage
  const size_t head = (size_t)N * D;
  int item = blockIdx.x;
  if (item >= items) return;
  stage_f32_async<kF32BatchThreads>(k + item * head, base, N, D);
  stage_f32_async<kF32BatchThreads>(v + item * head, base + rows, N, D);
  cp_async_commit();
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int next = item + gridDim.x;
    const int buf = stages == 2 ? it % 2 : 0;
    float* k_s = base + buf * 2 * rows;
    if (stages == 2 && next < items) {
      // The other buffer was freed by the barrier that ended the last item.
      float* other = base + (1 - buf) * 2 * rows;
      stage_f32_async<kF32BatchThreads>(k + next * head, other, N, D);
      stage_f32_async<kF32BatchThreads>(v + next * head, other + rows, N, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's K and V have landed, from every thread's copies
    for (int r = 16 * (threadIdx.x / 32); r < N; r += 16 * (kF32BatchThreads / 32)) {
      attend_tile_f32<NKP, false>(q + item * head, k_s, k_s + rows, o + item * head, r, N, D, scale);
    }
    __syncthreads();  // every warp is done with this buffer
    if (stages == 1 && next < items) {
      stage_f32_async<kF32BatchThreads>(k + next * head, base, N, D);
      stage_f32_async<kF32BatchThreads>(v + next * head, base + rows, N, D);
      cp_async_commit();
    }
  }
}

// ---------------------------------------------------------------------------
// The "mma" variant in fp32 at N <= 192 and D <= 64: 3xTF32 by wgmma (see
// the notes at the top).

// One head's K and V^T as wgmma reads them, each split into big and small
// TF32 parts (RNA-rounded fp32 bit patterns, which wgmma's truncation to
// TF32 leaves exact), in the 128-byte swizzled layout of 32 floats a row:
// K big, K small: 2 column blocks (d 0..31, 32..63) of NKP key rows;
// V^T big, V^T small: NKP / 32 key blocks of 64 rows (d), the keys of each
// 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7 (slot t of P's A
// fragment holds key 2t, slot t + 4 key 2t + 1). 1024 * NKP bytes.
__host__ __device__ inline size_t wg_head_bytes(int n) { return (size_t)1024 * padded_keys(n); }

__host__ __device__ inline size_t wg_smem_bytes(int n) { return wg_head_bytes(n) + kSmemAlign; }

// The big and small TF32 parts of four floats.
__device__ inline void split4(const float4& x, uint4& big, uint4& small) {
  split_tf32(x.x, big.x, small.x);
  split_tf32(x.y, big.y, small.y);
  split_tf32(x.z, big.z, small.z);
  split_tf32(x.w, big.w, small.w);
}

// Writes one head's K and V^T, split, into st (1024-byte aligned), zero past
// n keys and d columns. The block's Threads threads share the 16-byte chunks;
// a warp's V^T stores are 32 keys of one row, 32 different banks.
template <int NKP, int Threads>
__device__ inline void stage_wg(const float* __restrict__ kh, const float* __restrict__ vh, unsigned char* st,
                                int n, int d) {
  unsigned char* kb = st;
  unsigned char* ks = kb + (size_t)NKP * 256;
  unsigned char* vb = ks + (size_t)NKP * 256;
  unsigned char* vs = vb + (size_t)NKP * 256;
  for (int i = threadIdx.x; i < NKP * 16; i += Threads) {
    const int r = i / 16, c = i % 16;  // key, 4-column chunk
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n && 4 * c < d) x = *reinterpret_cast<const float4*>(kh + (size_t)r * d + 4 * c);
    uint4 big, small;
    split4(x, big, small);
    const size_t off = (size_t)(c / 8) * NKP * 128 + swz(r, c % 8);
    *reinterpret_cast<uint4*>(kb + off) = big;
    *reinterpret_cast<uint4*>(ks + off) = small;
  }
  for (int i = threadIdx.x; i < NKP * 16; i += Threads) {
    const int c = i / NKP, key = i - c * NKP;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < n && 4 * c < d) x = *reinterpret_cast<const float4*>(vh + (size_t)key * d + 4 * c);
    uint4 big, small;
    split4(x, big, small);
    const int pos = (key & ~7) | ((key & 1) << 2) | ((key & 7) >> 1);
    const int w = pos % 32;
    const size_t blk = (size_t)(pos / 32) * 64 * 128 + 4 * (w % 4);
    const uint32_t bw[4] = {big.x, big.y, big.z, big.w}, sw[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t off = blk + swz(4 * c + e, w / 4);
      *reinterpret_cast<uint32_t*>(vb + off) = bw[e];
      *reinterpret_cast<uint32_t*>(vs + off) = sw[e];
    }
  }
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(i) WG_F4(i), WG_F4(i + 4)
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)

// d[0, 32) += A (64 x 8 TF32 in registers) B (8 x 64 TF32, K-major in
// shared memory, read by descriptor).
__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_F32
#undef WG_F8
#undef WG_F4

__device__ __forceinline__ void reg_fence_u(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// A fragment registers (big and small) of one k8 step: kept allocated and
// untouched from the wgmma that reads them until the wait that retires it.
struct SplitA {
  uint32_t big[4], small[4];
  __device__ void fence() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      reg_fence_u(big[e]);
      reg_fence_u(small[e]);
    }
  }
  __device__ void set(const float (&x)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
  }
};

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}

// d += a b in 3xTF32 over one k8 step, for N = 64 columns per descriptor
// pair: a_small b_big, a_big b_small, a_big b_big.
__device__ __forceinline__ void wgmma_3xtf32_n64(float* d, const SplitA& a, uint64_t b_big, uint64_t b_small) {
  wgmma_tf32_rs_n64(d, a.small, b_big);
  wgmma_tf32_rs_n64(d, a.big, b_small);
  wgmma_tf32_rs_n64(d, a.big, b_big);
}


// One warpgroup: the 64 query rows row0 .. row0 + 63 of one head, q at qh,
// o at oh ((n, d), row-major), K and V^T split at st (`stage_wg`). The
// arithmetic is `attend_tile_f32`'s, step for step, with wgmma for the
// products: the A operands (q, then P) come from registers, two k8 steps
// of S in flight and kPvInFlight (1 or 2) of P.V, each step's registers
// retired by wgmma.wait_group before they are written again. kPvInFlight
// changes when the routine waits, not what it computes: K1 takes 2, K3 1,
// the depth at which ptxas fits each kernel's registers without a spill.
template <int NKP, int kPvInFlight>
__device__ inline void attend_tile_wg(const float* __restrict__ qh, const unsigned char* st,
                                      float* __restrict__ oh, int row0, int n, int d, float scale) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w = (threadIdx.x / 32) % 4;
  const int ra = row0 + 16 * w + g, rb = ra + 8;
  const float* qa = qh + (size_t)min(ra, n - 1) * d;
  const float* qb = qh + (size_t)min(rb, n - 1) * d;
  // Descriptors of K big, K small, V^T big and V^T small; a k8 step or a
  // block adds its byte offset / 16 to the start-address field (14 bits,
  // shared memory stays below 256 KB, so the sum never carries out of it).
  const uint64_t dkb = gmma_desc(smem_u32(st), 16, 1024);
  const uint64_t dks = dkb + NKP * 256 / 16, dvb = dkb + NKP * 512 / 16, dvs = dkb + NKP * 768 / 16;

  float s[NKP / 8][4];
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 0.f;
      reg_fence(s[j][e]);
    }
  }
  // S over the 8 k8 steps of D <= 64 (q reads 0 and K holds zeros past d).
  SplitA a[2];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = 8 * kk + t;
    const bool lo = c < d, hi = c + 4 < d;
    const float x[4] = {lo ? __fmul_rn(qa[c], scale) : 0.f, lo ? __fmul_rn(qb[c], scale) : 0.f,
                        hi ? __fmul_rn(qa[c + 4], scale) : 0.f, hi ? __fmul_rn(qb[c + 4], scale) : 0.f};
    SplitA& cur = a[kk % 2];
    wgmma_wait<1>();  // the step that read these registers two steps ago is done
    cur.fence();
    cur.set(x);
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < NKP / 64; ++nb) {
      const uint32_t off = ((kk / 4) * NKP * 128 + nb * 64 * 128 + 32 * (kk % 4)) / 16;
      wgmma_3xtf32_n64(&s[8 * nb][0], cur, dkb + off, dks + off);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  a[0].fence();
  a[1].fence();
#pragma unroll
  for (int j = 0; j < NKP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(s[j][e]);
  }

  softmax_f32<NKP>(s, n, t);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = 0.f;
    reg_fence(o[i]);
  }
#pragma unroll
  for (int kk = 0; kk < NKP / 8; ++kk) {
    SplitA& cur = a[kPvInFlight == 2 ? kk % 2 : 0];
    if (kPvInFlight == 2) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    cur.fence();
    const float x[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};  // keys 2t (rows g, g + 8), then 2t + 1
    cur.set(x);
    wgmma_fence();
    const uint32_t off = ((kk / 4) * 64 * 128 + 32 * (kk % 4)) / 16;
    wgmma_3xtf32_n64(o, cur, dvb + off, dvs + off);
    wgmma_commit();
  }
  wgmma_wait<0>();
  a[0].fence();
  a[1].fence();
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(o[i]);

  // Written once: columns 8j + 2t and 8j + 2t + 1, rows g and g + 8 of the warp's 16.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c < d) {
      if (ra < n) *reinterpret_cast<float2*>(oh + (size_t)ra * d + c) = make_float2(o[4 * j], o[4 * j + 1]);
      if (rb < n) *reinterpret_cast<float2*>(oh + (size_t)rb * d + c) = make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  }
}

// K1, fp32 by wgmma: grid (H, B), one block of NKP / 64 warpgroups per
// head, one 64-row tile each.
template <int NKP>
__global__ void __launch_bounds__(NKP * 2, 1)
attention_f32_wg_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o, int H, int N, int D,
                            float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st = aligned_smem(smem_raw);
  const size_t head = ((size_t)blockIdx.y * H + blockIdx.x) * (size_t)N * D;
  stage_wg<NKP, NKP * 2>(k + head, v + head, st, N, D);
  fence_proxy_async();
  __syncthreads();
  attend_tile_wg<NKP, 2>(q + head, st, o + head, 64 * (threadIdx.x / 128), N, D, scale);
}

// K3, fp32 by wgmma: a persistent grid walking the items b * H + h, one
// block an SM (the split head takes 192 KB at 192 keys), staging each item
// after the last one's tiles are done. Its block has at most 2 warpgroups,
// which take the 64-row tiles of an item in turn: 3 warpgroups hold 168
// registers a thread, and with the item loop's the routine spills there
// (K1's 3 warpgroups fit, at 164).
template <int NKP>
struct BatchWg {
  static constexpr int kThreads = NKP >= 128 ? 256 : 128;
};

template <int NKP>
__global__ void __launch_bounds__(BatchWg<NKP>::kThreads, 1)
attention_batch_f32_wg_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, float* __restrict__ o, int items, int N,
                                  int D, float scale) {
  constexpr int kThreads = BatchWg<NKP>::kThreads;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st = aligned_smem(smem_raw);
  const size_t head = (size_t)N * D;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    stage_wg<NKP, kThreads>(k + item * head, v + item * head, st, N, D);
    fence_proxy_async();
    __syncthreads();
    for (int r = 64 * (threadIdx.x / 128); r < N; r += kThreads / 2) {
      attend_tile_wg<NKP, 1>(q + item * head, st, o + item * head, r, N, D, scale);
    }
    __syncthreads();  // every warpgroup is done with st
  }
}

template <int NKP>
int launch_f32_wg_nkp(const float* q, const float* k, const float* v, float* o, int B, int H, int N, int D,
                      float scale, int per_batch, cudaStream_t stream) {
  cudaError_t err;
  const size_t smem = wg_smem_bytes(N);
  if (!per_batch) {
    static size_t allowed[kMaxDevices];
    if ((err = allow_smem(attention_f32_wg_mma_kernel<NKP>, smem, allowed)) != cudaSuccess) return (int)err;
    attention_f32_wg_mma_kernel<NKP><<<dim3(H, B), NKP * 2, smem, stream>>>(q, k, v, o, H, N, D, scale);
    return (int)cudaGetLastError();
  }
  static size_t allowed[kMaxDevices];
  if ((err = allow_smem(attention_batch_f32_wg_mma_kernel<NKP>, smem, allowed)) != cudaSuccess) return (int)err;
  static SlotCache cache;
  int slots = 0;
  err = resident_blocks(attention_batch_f32_wg_mma_kernel<NKP>, BatchWg<NKP>::kThreads, smem, cache, &slots);
  if (err != cudaSuccess) return (int)err;
  const int items = B * H;
  attention_batch_f32_wg_mma_kernel<NKP><<<items < slots ? items : slots, BatchWg<NKP>::kThreads, smem, stream>>>(
      q, k, v, o, items, N, D, scale);
  return (int)cudaGetLastError();
}

template <int NKP>
int launch_f32_mma_nkp(const float* q, const float* k, const float* v, float* o, int B, int H, int N,
                       int D, float scale, int per_batch, cudaStream_t stream) {
  cudaError_t err;
  if (!per_batch) {
    const size_t smem = f32_head_bytes(N);
    static size_t allowed[kMaxDevices];
    if ((err = allow_smem(attention_f32_mma_kernel<NKP>, smem, allowed)) != cudaSuccess) return (int)err;
    const dim3 grid((N + kF32Rows - 1) / kF32Rows, H, B);
    attention_f32_mma_kernel<NKP><<<grid, kF32Threads, smem, stream>>>(q, k, v, o, H, N, D, scale);
    return (int)cudaGetLastError();
  }
  const size_t smem = batch_f32_smem_bytes(N);
  static size_t allowed[kMaxDevices];
  if ((err = allow_smem(attention_batch_f32_mma_kernel<NKP>, smem, allowed)) != cudaSuccess) return (int)err;
  static SlotCache cache;
  int slots = 0;
  err = resident_blocks(attention_batch_f32_mma_kernel<NKP>, kF32BatchThreads, smem, cache, &slots);
  if (err != cudaSuccess) return (int)err;
  const int items = B * H;
  attention_batch_f32_mma_kernel<NKP><<<items < slots ? items : slots, kF32BatchThreads, smem, stream>>>(
      q, k, v, o, items, N, D, scale, batch_f32_stages(N));
  return (int)cudaGetLastError();
}

// The fp32 "mma" variant's shared memory: K1's block, or K3's with per_batch.
__host__ __device__ inline size_t f32_mma_smem_bytes(int n, int d, int per_batch) {
  if (d <= 64) return wg_smem_bytes(n);
  return per_batch ? batch_f32_smem_bytes(n) : f32_head_bytes(n);
}

int launch_f32_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
                   float scale, int per_batch, cudaStream_t s) {
  // 16-byte rows from 16-byte boundaries (float4 loads and cp.async); at
  // most 192 keys (the wrapper sends other shapes to "rows").
  if (N > kF32MaxN || D % 4 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (D <= 64) {  // wgmma
    switch (padded_keys(N)) {
      case 64: return launch_f32_wg_nkp<64>(qf, kf, vf, of, B, H, N, D, scale, per_batch, s);
      case 128: return launch_f32_wg_nkp<128>(qf, kf, vf, of, B, H, N, D, scale, per_batch, s);
      default: return launch_f32_wg_nkp<192>(qf, kf, vf, of, B, H, N, D, scale, per_batch, s);
    }
  }
  switch (padded_keys(N)) {  // mma.sync
    case 64: return launch_f32_mma_nkp<64>(qf, kf, vf, of, B, H, N, D, scale, per_batch, s);
    case 128: return launch_f32_mma_nkp<128>(qf, kf, vf, of, B, H, N, D, scale, per_batch, s);
    default: return launch_f32_mma_nkp<192>(qf, kf, vf, of, B, H, N, D, scale, per_batch, s);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes above
// the card's per-block limit before it launches. per_batch selects K3's
// block, else K1's; use_mma the "mma" variant (bf16 with esize 2, fp32 with
// esize 4; N <= 256), else "rows".
size_t whmr_attention_smem_bytes(int n, int d, int esize, int per_batch, int use_mma) {
  if (use_mma && esize == 4) return f32_mma_smem_bytes(n, d, per_batch);
  if (use_mma) return per_batch ? batch_mma_smem_bytes(n, d) : mma_tile_bytes(n, d);
  return smem_bytes(n, d, esize, per_batch ? kBatchWarps : kWarps);
}

// q, k, v, o: contiguous (B, H, N, D); is_bf16 selects bf16, else fp32;
// use_mma the tensor-core variant, which takes N <= 256 and 16-byte aligned
// pointers only, with D % 8 == 0 in bf16 and, in fp32, D % 4 == 0 and K and
// V of a head within a block's shared memory.
// Returns cudaGetLastError() after the launch (0 on success).
int whmr_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                       int D, float scale, int is_bf16, int use_mma, void* stream) {
  if (D < 1 || D > kMaxD || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (N > kMmaMaxN) return (int)cudaErrorInvalidValue;
    if (is_bf16) {
      const Layout l = bhnd_layout(H, N, D);
      return launch_mma(q, k, v, o, l, l, B, H, N, D, scale, 0, s);
    }
    return launch_f32_mma(q, k, v, o, B, H, N, D, scale, 0, s);
  }
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, o, B, H, N, D, scale, s);
  return launch<float>(q, k, v, o, B, H, N, D, scale, s);
}

// K3: the same contract as whmr_attention_fwd, with K3's launch shapes.
int whmr_attention_batch_fwd(const void* q, const void* k, const void* v, void* o, int B, int H,
                             int N, int D, float scale, int is_bf16, int use_mma, void* stream) {
  if (D < 1 || D > kMaxD || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (N > kMmaMaxN) return (int)cudaErrorInvalidValue;
    if (is_bf16) {
      const Layout l = bhnd_layout(H, N, D);
      return launch_mma(q, k, v, o, l, l, B, H, N, D, scale, 1, s);
    }
    return launch_f32_mma(q, k, v, o, B, H, N, D, scale, 1, s);
  }
  if (is_bf16) return launch_batch<__nv_bfloat16>(q, k, v, o, B, H, N, D, scale, s);
  return launch_batch<float>(q, k, v, o, B, H, N, D, scale, s);
}

// K1 in bf16 on tensor cores, reading q, k and v in place from the fused
// projection: qkv a contiguous (B, N, 3, H, D) bf16 tensor, o a contiguous
// (B, N, H, D) one, both 16-byte aligned, N <= 256 and D % 8 == 0. The same
// kernel and staged values as whmr_attention_fwd on contiguous copies, so
// the same output bits.
int whmr_attention_qkv_fwd(const void* qkv, void* o, int B, int H, int N, int D, float scale,
                           void* stream) {
  if (D < 1 || D > kMaxD || N < 1 || N > kMmaMaxN) return (int)cudaErrorInvalidValue;
  const int64_t hd = (int64_t)H * D;
  const Layout in = {3 * hd, (int64_t)D, (int64_t)N * 3 * hd};
  const Layout out = {hd, (int64_t)D, (int64_t)N * hd};
  const bf16* q = static_cast<const bf16*>(qkv);
  return launch_mma(q, q + hd, q + 2 * hd, o, in, out, B, H, N, D, scale, 0,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
