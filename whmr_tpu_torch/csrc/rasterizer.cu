// K2: the z-buffer rasterizer of the GT IUV render, forward only.
//
// Replaces the TPU kernel `rasterize_pallas` of
// whmr_tpu/ops/rasterizer_pallas.py:255 (body `_kernel` :152, pallas_call
// :316). Per pixel centre (x + 0.5 + ox, y + 0.5 + oy) and face chunk:
// barycentrics b_j = (px*a_j + py*b_j) + c_j; the face covers the pixel when
// every b_j >= 0; depth z = (b0*tz0 + b1*tz1) + b2*tz2; the chunk minimum cz
// over covering faces; the winners are the covering faces with z == cz,
// weighted 1/cnt; their attributes sum_j (w * sum_faces b_j*ta_j). Across
// chunks a strictly nearer chunk wins (cz < best_z), so an exact tie across
// chunks keeps the earlier chunk. Output attrs are zeroed where
// zbuf >= 0.5e9 (background).
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn): nvcc
// would otherwise contract px*a + py*b + c into FMAs, and a pixel on an edge
// shared by two faces would flip its coverage against the plain version
// (ops/rasterizer_kernel.py::rasterize_kernel_reference), which rounds each
// operation. So mask and zbuf agree with it bit for bit. The attributes agree
// bit for bit where one face wins; where cnt faces tie, the weight is applied
// to the per-j sums instead of each term, a difference of a few ulps.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s): the work is the coverage-and-depth test of each (pixel, face)
// pair of the chunks that pass the cull, 22 fp32 operations a pair (three
// barycentrics at 2 mul + 2 add, three compares, depth at 3 mul + 2 add, a
// select and a min). At the train step's render (B=64, 128x96 window,
// 14 chunks of 1024 faces) the face tables are 64 * 14336 * 21 * 4 B = 77 MB
// (23 us), so it is bound by operations; chip_smoke.py counts the pairs of
// each run and prints the bound. What the design does about it: the
// chunk-vs-tile bbox cull skips whole chunks per block (the KD-sorted
// topology makes a chunk a compact patch of the body), each staged face
// feeds every pixel of the tile from shared memory, and the second pass
// (ties and attributes) runs only where the chunk's depth beats the pixel's
// best so far. It is the simple first design: one thread per pixel, two
// passes over each hit chunk, no warp-level face culling yet.
//
// Layout: grid (tiles, B), one block per (image, pixel tile), one thread per
// pixel of the tile (row-major, tile_w fastest); threads past the image's
// edge stage faces but write nothing. A hit chunk is staged `piece` faces at
// a time into shared memory as 12 + 3C rows of `piece` floats: coef_a[j],
// coef_b[j], coef_c[j], tz[j] for j = 0..2, then ta[j*C + c].
//
// Built by whmr_tpu_torch/ops/cuda_build.py (nvcc, sm_90a) into a shared
// library with a plain C interface, loaded with ctypes by
// ops/rasterizer_kernel.py.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxAttr = 8;
constexpr int kMaxThreads = 256;

struct Args {
  const float* bbox;  // (B, 4, K): xmin, xmax, ymin, ymax of each chunk
  const float* ca;    // (B, 3, F)
  const float* cb;    // (B, 3, F)
  const float* cc;    // (B, 3, F)
  const float* tz;    // (B, 3, F)
  const float* ta;    // (B, 3C, F), row j*C + c
  float* zbuf;        // (B, H, W)
  float* attrs;       // (B, H, W, C)
  int H, W, F, K, chunk, piece, C, tile_h, tile_w;
  float ox, oy;
};

__device__ __forceinline__ float bary(float px, float py, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__device__ __forceinline__ float depth(float b0, float b1, float b2, float z0,
                                       float z1, float z2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1)), __fmul_rn(b2, z2));
}

// Copies faces [f0, f0 + n) of image `img` into the staged rows.
__device__ void stage(const Args& a, float* s, size_t img, int f0, int n) {
  const int rows = 12 + 3 * a.C;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
    const int r = i / n;
    const int f = i - r * n;
    const float* src;
    if (r < 12) {
      const float* t = r < 3 ? a.ca : r < 6 ? a.cb : r < 9 ? a.cc : a.tz;
      src = t + (img * 3 + (size_t)(r % 3)) * (size_t)a.F;
    } else {
      src = a.ta + (img * 3 * (size_t)a.C + (size_t)(r - 12)) * (size_t)a.F;
    }
    s[(size_t)r * a.piece + f] = src[f0 + f];
  }
}

__global__ void __launch_bounds__(kMaxThreads) raster_kernel(const Args a) {
  extern __shared__ float s[];
  const int P = a.piece;
  const int nbx = (a.W + a.tile_w - 1) / a.tile_w;
  const int bx = (int)blockIdx.x % nbx;
  const int by = (int)blockIdx.x / nbx;
  const size_t img = blockIdx.y;
  const int x = bx * a.tile_w + (int)threadIdx.x % a.tile_w;
  const int y = by * a.tile_h + (int)threadIdx.x / a.tile_w;
  const bool on = x < a.W && y < a.H;
  const float px = __fadd_rn(__fadd_rn((float)x, 0.5f), a.ox);
  const float py = __fadd_rn(__fadd_rn((float)y, 0.5f), a.oy);
  // The tile's rectangle of pixel centres (rasterizer_pallas.py:165-168).
  const float x0 = __fadd_rn(__fadd_rn(__fmul_rn((float)bx, (float)a.tile_w), 0.5f), a.ox);
  const float y0 = __fadd_rn(__fadd_rn(__fmul_rn((float)by, (float)a.tile_h), 0.5f), a.oy);
  const float x1 = __fadd_rn(x0, (float)(a.tile_w - 1));
  const float y1 = __fadd_rn(y0, (float)(a.tile_h - 1));
  const float* bb = a.bbox + img * 4 * (size_t)a.K;
  const float* ta_s = s + 12 * (size_t)P;

  float best_z = kBig;
  float best[kMaxAttr];
#pragma unroll
  for (int c = 0; c < kMaxAttr; ++c) best[c] = 0.f;

  for (int ci = 0; ci < a.K; ++ci) {
    // Block-uniform cull: a face covers only pixel centres inside its bbox.
    if (!(bb[a.K + ci] >= x0 && bb[ci] <= x1 && bb[3 * a.K + ci] >= y0 &&
          bb[2 * a.K + ci] <= y1)) {
      continue;
    }
    const int c0 = ci * a.chunk;

    // Pass 1: the chunk's nearest depth over the faces covering the pixel.
    float cz = kBig;
    for (int q = 0; q < a.chunk; q += P) {
      const int n = min(P, a.chunk - q);
      __syncthreads();  // the previous piece is read by every thread
      stage(a, s, img, c0 + q, n);
      __syncthreads();
      if (on) {
        for (int f = 0; f < n; ++f) {
          const float b0 = bary(px, py, s[f], s[3 * P + f], s[6 * P + f]);
          const float b1 = bary(px, py, s[P + f], s[4 * P + f], s[7 * P + f]);
          const float b2 = bary(px, py, s[2 * P + f], s[5 * P + f], s[8 * P + f]);
          if (b0 >= 0.f && b1 >= 0.f && b2 >= 0.f) {
            cz = fminf(cz, depth(b0, b1, b2, s[9 * P + f], s[10 * P + f], s[11 * P + f]));
          }
        }
      }
    }

    // Pass 2, only where this chunk replaces the pixel's best: the faces
    // tied at cz and their per-j attribute sums.
    const bool need = on && cz < best_z;
    if (!__syncthreads_or(need)) continue;
    int cnt = 0;
    float acc[3][kMaxAttr];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int c = 0; c < kMaxAttr; ++c) acc[j][c] = 0.f;
    }
    for (int q = 0; q < a.chunk; q += P) {
      const int n = min(P, a.chunk - q);
      __syncthreads();
      stage(a, s, img, c0 + q, n);
      __syncthreads();
      if (need) {
        for (int f = 0; f < n; ++f) {
          float b[3];
          b[0] = bary(px, py, s[f], s[3 * P + f], s[6 * P + f]);
          b[1] = bary(px, py, s[P + f], s[4 * P + f], s[7 * P + f]);
          b[2] = bary(px, py, s[2 * P + f], s[5 * P + f], s[8 * P + f]);
          if (!(b[0] >= 0.f && b[1] >= 0.f && b[2] >= 0.f)) continue;
          if (depth(b[0], b[1], b[2], s[9 * P + f], s[10 * P + f], s[11 * P + f]) != cz) continue;
          ++cnt;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
#pragma unroll
            for (int c = 0; c < kMaxAttr; ++c) {
              if (c < a.C) {
                acc[j][c] = __fadd_rn(acc[j][c],
                                      __fmul_rn(b[j], ta_s[(size_t)(j * a.C + c) * P + f]));
              }
            }
          }
        }
      }
    }
    if (need) {
      const float w = __fdiv_rn(1.f, (float)max(cnt, 1));
      best_z = cz;
#pragma unroll
      for (int c = 0; c < kMaxAttr; ++c) {
        best[c] = __fadd_rn(__fadd_rn(__fmul_rn(w, acc[0][c]), __fmul_rn(w, acc[1][c])),
                            __fmul_rn(w, acc[2][c]));
      }
    }
  }

  if (!on) return;
  const size_t pix = (img * a.H + y) * (size_t)a.W + x;
  a.zbuf[pix] = best_z;
  const bool fg = best_z < 0.5f * kBig;
#pragma unroll
  for (int c = 0; c < kMaxAttr; ++c) {
    if (c < a.C) a.attrs[pix * a.C + c] = fg ? best[c] : 0.f;
  }
}

size_t smem_bytes(int piece, int C) {
  return (size_t)(12 + 3 * C) * (size_t)piece * sizeof(float);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses more than the
// card's per-block limit before it launches.
size_t whmr_raster_smem_bytes(int piece, int C) { return smem_bytes(piece, C); }

// Tables as ops/rasterizer_kernel.py::raster_tables makes them, contiguous
// fp32; F = K * chunk. Returns cudaGetLastError() after the launch (0 on
// success).
int whmr_raster_fwd(const void* bbox, const void* ca, const void* cb, const void* cc,
                    const void* tz, const void* ta, void* zbuf, void* attrs, int B,
                    int H, int W, int F, int K, int chunk, int piece, int C, int tile_h,
                    int tile_w, float ox, float oy, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || K < 1 || chunk < 1 || F != K * chunk ||
      piece < 1 || piece > chunk || C < 1 || C > kMaxAttr || tile_h < 1 || tile_w < 1 ||
      tile_h * tile_w > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.bbox = static_cast<const float*>(bbox);
  a.ca = static_cast<const float*>(ca);
  a.cb = static_cast<const float*>(cb);
  a.cc = static_cast<const float*>(cc);
  a.tz = static_cast<const float*>(tz);
  a.ta = static_cast<const float*>(ta);
  a.zbuf = static_cast<float*>(zbuf);
  a.attrs = static_cast<float*>(attrs);
  a.H = H;
  a.W = W;
  a.F = F;
  a.K = K;
  a.chunk = chunk;
  a.piece = piece;
  a.C = C;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.ox = ox;
  a.oy = oy;
  const size_t smem = smem_bytes(piece, C);
  cudaError_t err = cudaFuncSetAttribute(
      raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nbx = (W + tile_w - 1) / tile_w;
  const int nby = (H + tile_h - 1) / tile_h;
  const dim3 grid((unsigned)(nbx * nby), (unsigned)B);
  raster_kernel<<<grid, tile_h * tile_w, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
