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
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores), counted from the inputs by ops/rasterizer_kernel.py::raster_work:
// the table rows (12 + 3C floats) of the faces whose padded bbox holds a
// pixel centre of the window, read once, and zbuf and attrs written once,
// against 22 fp32 operations for each (pixel, face) pair whose pixel centre
// lies in the face's padded bbox. At the train step's render (B=64, a
// 128x96 window, 13,776 faces, most smaller than a pixel) that is bytes,
// about 60 MB, against only 1.2e6 pairs: a face shades one or two pixels.
//
// Design. The rule above does not depend on the order of the faces except
// in the sums of tied winners: a pixel's depth is the least z of a covering
// face, its chunk the earliest chunk that reaches it, and its winners every
// covering face of that chunk at that z, summed in face order. So the work
// goes face by face, touching only the pairs the bound counts, and the
// order is put back where it matters:
// 1. raster_faces, a warp per 32 faces of an image. Each lane reads its
//    face's padded bbox (coalesced), finds the window's pixel centres inside
//    it (a rectangle of columns and rows, from the same fp32 centres as the
//    plain version) and, if any, stages the face's 12 edge and depth floats
//    in shared memory. A warp scan of the lanes' pair counts lets the 32
//    lanes take the warp's pairs in turn, so a face larger than a pixel
//    costs no more than its pairs. A covering pair with z < 1e9 lowers two
//    per-pixel keys with atomicMin (no value returned, so no wait):
//    (z, face) and (z, ~face). The first gives the least depth and the
//    first face reaching it, whose chunk is the earliest (faces of an
//    earlier chunk have lower indices); the second the last face reaching
//    it. A pixel whose two faces differ has tied faces.
// 2. raster_resolve, a thread a pixel. One face at the least depth: its
//    attributes from its row, the barycentrics recomputed with the same
//    operations, so the same bits. Tied faces (rare at the train render):
//    the faces from the first to the last, within the first one's chunk,
//    walked in order, summing those that cover the pixel at that depth, as
//    the TPU kernel does.
// No barrier, no per-tile cull, and no pass over a face whose bbox holds no
// pixel centre; the keys are 16 bytes a pixel, set to all ones by a memset.
// The face tables keep the TPU kernel's struct-of-arrays layout, which the
// face pass reads coalesced (a warp's faces are consecutive).
//
// Built by whmr_tpu_torch/ops/cuda_build.py (nvcc, sm_90a) into a shared
// library with a plain C interface, loaded with ctypes by
// ops/rasterizer_kernel.py.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxAttr = 8;
constexpr int kCoef = 12;           // a face's edge and depth floats
constexpr int kFaceWarps = 8;       // warps of a raster_faces block
constexpr int kResolveThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;
// Pixels a window may hold: a warp's 32 faces then have at most 32 * H * W
// pairs, which its int scan and pair loop count without overflow.
constexpr long long kMaxWindow = 0x7fffffffLL / 32;

struct Args {
  const float* fbox;         // (B, 4, F): xmin, xmax, ymin, ymax of each face, padded
  const float* coef[4];      // (B, 3, F) each: coef_a, coef_b, coef_c, tz
  const float* ta;           // (B, 3C, F), row j*C + c
  unsigned long long* keys;  // (2, B, H, W): (z, face) and (z, ~face) minima
  float* zbuf;               // (B, H, W)
  float* attrs;              // (B, H, W, C)
  int B, H, W, F, chunk, C;
  float ox, oy;
};

// Face f's k-th edge or depth float: coef_a[j], coef_b[j], coef_c[j], tz[j]
// for k = 3i + j.
__device__ __forceinline__ float coef(const Args& a, size_t img, int k, size_t f) {
  return a.coef[k / 3][(img * 3 + (size_t)(k % 3)) * (size_t)a.F + f];
}

__device__ __forceinline__ float bary(float px, float py, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(px, a), __fmul_rn(py, b)), c);
}

__device__ __forceinline__ float depth(float b0, float b1, float b2, float z0,
                                       float z1, float z2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(b0, z0), __fmul_rn(b1, z1)), __fmul_rn(b2, z2));
}

// The window's pixel centres, as the plain version makes them.
__device__ __forceinline__ float centre(int i, float o) {
  return __fadd_rn(__fadd_rn((float)i, 0.5f), o);
}

// Bits of z that order as z does; -0 counts as +0, as it compares equal.
__device__ __forceinline__ unsigned ordered(float z) {
  const unsigned u = __float_as_uint(__fadd_rn(z, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The indices [lo, hi] of the n centres (o + i + 0.5) inside [vlo, vhi]:
// estimated, then moved until the centres themselves say so.
__device__ __forceinline__ void span(float vlo, float vhi, int n, float o, int& lo, int& hi) {
  const float c0 = centre(0, o);
  lo = (int)fminf(fmaxf(__fsub_rn(vlo, c0), 0.f), (float)(n - 1));
  while (lo > 0 && centre(lo - 1, o) >= vlo) --lo;
  while (lo < n && centre(lo, o) < vlo) ++lo;
  hi = (int)fminf(fmaxf(__fsub_rn(vhi, c0), -1.f), (float)(n - 1));
  while (hi < n - 1 && centre(hi + 1, o) <= vhi) ++hi;
  while (hi >= 0 && centre(hi, o) > vhi) --hi;
}

// A warp per 32 faces of one image: the per-pixel keys of their covering
// pairs.
__global__ void __launch_bounds__(32 * kFaceWarps) raster_faces(const Args a) {
  __shared__ float s_coef[kFaceWarps][kCoef][32];
  __shared__ int s_first[kFaceWarps][32];   // a lane's first pair among the warp's
  __shared__ int s_geo[kFaceWarps][3][32];  // its first column, first row, columns
  const int lane = (int)threadIdx.x % 32, warp = (int)threadIdx.x / 32;
  const size_t img = blockIdx.y;
  const int f = ((int)blockIdx.x * kFaceWarps + warp) * 32 + lane;
  const size_t F = (size_t)a.F;
  int c0 = 0, c1 = -1, r0 = 0, r1 = -1;
  if (f < a.F) {
    const float* fb = a.fbox + img * 4 * F + (size_t)f;
    span(fb[0], fb[F], a.W, a.ox, c0, c1);
    span(fb[2 * F], fb[3 * F], a.H, a.oy, r0, r1);
  }
  const int nc = max(0, c1 - c0 + 1);
  const int count = nc * max(0, r1 - r0 + 1);
  int inc = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += v;
  }
  const int total = __shfl_sync(kFull, inc, 31);
  if (total == 0) return;  // warp-uniform
  s_first[warp][lane] = inc - count;
  s_geo[warp][0][lane] = c0;
  s_geo[warp][1][lane] = r0;
  s_geo[warp][2][lane] = nc;
  if (count > 0) {
#pragma unroll
    for (int k = 0; k < kCoef; ++k) s_coef[warp][k][lane] = coef(a, img, k, (size_t)f);
  }
  __syncwarp();
  const size_t plane = (size_t)a.B * a.H * a.W;
  const int fbase = f - lane;
  for (int p = lane; p < total; p += 32) {
    int lo = 0, hi = 31;  // the last lane whose pairs start at or before p
#pragma unroll
    for (int step = 0; step < 5; ++step) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_first[warp][mid] <= p) lo = mid; else hi = mid - 1;
    }
    const int i = lo, k = p - s_first[warp][i], ncol = s_geo[warp][2][i];
    const int col = s_geo[warp][0][i] + k % ncol, row = s_geo[warp][1][i] + k / ncol;
    const float px = centre(col, a.ox), py = centre(row, a.oy);
    const float* cf = &s_coef[warp][0][i];
    float b[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) b[j] = bary(px, py, cf[j * 32], cf[(3 + j) * 32], cf[(6 + j) * 32]);
    if (!(b[0] >= 0.f && b[1] >= 0.f && b[2] >= 0.f)) continue;
    const float z = depth(b[0], b[1], b[2], cf[9 * 32], cf[10 * 32], cf[11 * 32]);
    if (!(z < kBig)) continue;  // never nearer than the background (nor NaN)
    const unsigned long long hi_bits = (unsigned long long)ordered(z) << 32;
    const unsigned face = (unsigned)(fbase + i);
    const size_t o = (img * a.H + (size_t)row) * a.W + (size_t)col;
    atomicMin(&a.keys[o], hi_bits | face);
    atomicMin(&a.keys[plane + o], hi_bits | (unsigned)~face);
  }
}

// A thread a pixel: depth, mask and attributes from the keys.
__global__ void __launch_bounds__(kResolveThreads) raster_resolve(const Args a) {
  const int pix = (int)blockIdx.x * kResolveThreads + (int)threadIdx.x;
  if (pix >= a.H * a.W) return;
  const size_t img = blockIdx.y;
  const size_t o = img * a.H * a.W + (size_t)pix;
  const unsigned long long first = a.keys[o];
  if (first == kNoKey) {
    a.zbuf[o] = kBig;
    for (int c = 0; c < a.C; ++c) a.attrs[o * a.C + c] = 0.f;
    return;
  }
  const size_t plane = (size_t)a.B * a.H * a.W;
  const unsigned long long last = a.keys[plane + o];
  const float z = unordered((unsigned)(first >> 32));
  const int f0 = (int)(first & 0xffffffffu);
  const int f1 = min((int)~(unsigned)(last & 0xffffffffu), (f0 / a.chunk + 1) * a.chunk - 1);
  const float px = centre(pix % a.W, a.ox), py = centre(pix / a.W, a.oy);
  const size_t F = (size_t)a.F;
  const float* fb = a.fbox + img * 4 * F;
  float acc[3][kMaxAttr];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < kMaxAttr; ++c) acc[j][c] = 0.f;
  }
  // f0 covers the pixel at z; faces after it in its chunk (up to the last
  // face at z) are tied winners if they do too.
  int cnt = 0;
  for (size_t f = (size_t)f0; f <= (size_t)f1; ++f) {
    if (f > (size_t)f0 && !(fb[f] <= px && fb[F + f] >= px && fb[2 * F + f] <= py && fb[3 * F + f] >= py)) {
      continue;
    }
    float b[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      b[j] = bary(px, py, coef(a, img, j, f), coef(a, img, 3 + j, f), coef(a, img, 6 + j, f));
    }
    if (f > (size_t)f0) {
      if (!(b[0] >= 0.f && b[1] >= 0.f && b[2] >= 0.f)) continue;
      if (!(depth(b[0], b[1], b[2], coef(a, img, 9, f), coef(a, img, 10, f), coef(a, img, 11, f)) == z)) continue;
    }
    ++cnt;
    const float* ta = a.ta + img * 3 * (size_t)a.C * F + f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int c = 0; c < kMaxAttr; ++c) {
        if (c < a.C) acc[j][c] = __fadd_rn(acc[j][c], __fmul_rn(b[j], ta[(size_t)(j * a.C + c) * F]));
      }
    }
  }
  const float w = __fdiv_rn(1.f, (float)cnt);
  a.zbuf[o] = z;
#pragma unroll
  for (int c = 0; c < kMaxAttr; ++c) {
    if (c < a.C) {
      a.attrs[o * a.C + c] = __fadd_rn(__fadd_rn(__fmul_rn(w, acc[0][c]), __fmul_rn(w, acc[1][c])),
                                       __fmul_rn(w, acc[2][c]));
    }
  }
}

}  // namespace

extern "C" {

// Tables as ops/rasterizer_kernel.py::kernel_inputs makes them, contiguous
// fp32; F a multiple of chunk; 1 <= C <= kMaxAttr; H * W <= kMaxWindow;
// keys (2, B, H, W) 64-bit working memory. Enqueues a memset of the keys and
// two kernels on `stream`; returns cudaErrorInvalidValue for arguments outside
// these limits, else cudaGetLastError() after the launches (0 on success).
int whmr_raster_fwd(const void* fbox, const void* ca, const void* cb, const void* cc,
                    const void* tz, const void* ta, void* keys, void* zbuf, void* attrs, int B,
                    int H, int W, int F, int chunk, int C, float ox, float oy, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (long long)H * W > kMaxWindow || F < 1 ||
      chunk < 1 || F % chunk != 0 || C < 1 || C > kMaxAttr) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.fbox = static_cast<const float*>(fbox);
  a.coef[0] = static_cast<const float*>(ca);
  a.coef[1] = static_cast<const float*>(cb);
  a.coef[2] = static_cast<const float*>(cc);
  a.coef[3] = static_cast<const float*>(tz);
  a.ta = static_cast<const float*>(ta);
  a.keys = static_cast<unsigned long long*>(keys);
  a.zbuf = static_cast<float*>(zbuf);
  a.attrs = static_cast<float*>(attrs);
  a.B = B;
  a.H = H;
  a.W = W;
  a.F = F;
  a.chunk = chunk;
  a.C = C;
  a.ox = ox;
  a.oy = oy;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, 2 * sizeof(unsigned long long) * B * (size_t)H * W, st);
  if (err != cudaSuccess) return (int)err;
  const int face_block = 32 * kFaceWarps;
  raster_faces<<<dim3((unsigned)((F + face_block - 1) / face_block), (unsigned)B), face_block, 0, st>>>(a);
  const dim3 grid((unsigned)((H * W + kResolveThreads - 1) / kResolveThreads), (unsigned)B);
  raster_resolve<<<grid, kResolveThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
