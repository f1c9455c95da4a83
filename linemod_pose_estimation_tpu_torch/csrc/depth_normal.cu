// Kernel DN: the DepthNormal quantizer (cv::linemod DepthNormal::
// quantizedNormals) with its 5x5 median, bit-exact, in one launch.
//
// Replaces no Pallas kernel: the reference computes DepthNormal in XLA
// (linemod_pose_estimation_tpu/ops/features.py::quantize_depth_normal).
// The port's plain version, ops/features.py::quantize_depth_normal, is a
// chain of ~750 elementwise PyTorch launches over (B, H, W) tensors, each
// a round trip through device memory; this kernel keeps every
// intermediate on chip.
//
// What bounds it on the H100: operations, not bytes.  It reads 4 bytes
// (f32 depth) and writes 1 byte a pixel, but does ~600 operations a pixel
// (the 8-neighbour plane fit, the normal and its LUT cell, and the radix
// median's 8 x 25 compares; ops/roofline.py counts them).
//
// Design: one block of NTH threads per TH x TW output tile of one frame
// (frames on blockIdx.z).
//   1. the block stages the depth of its tile with a HALO = 7 pixel ring
//      (5 for the plane fit, 2 for the median) in shared memory,
//      truncated to whole millimetres, with 16-byte loads along rows where
//      the frame's width and pointer allow (zeros outside the frame), and
//      the (11, 21, 21) NORMAL_LUT (4,851 bytes; in shared memory, not
//      __constant__, since the lookups of a warp diverge by address);
//   2. each thread computes the quantized normal q of pixels of the tile
//      and its 2-pixel ring into a shared u8 tile (0 outside the frame,
//      which is what the median's replicate border reads there: a
//      replicated pixel lies in row 0 or H - 1 or column 0 or W - 1, all
//      outside the quantizer's band);
//   3. thread t takes column t % TW and a strip of STRIP rows, slides a
//      5 x 5 window of registers down it (5 shared loads a row) and
//      writes the median of each window.
//
// Exactness (each step is one f32 operation rounded to nearest, as in the
// plain version; the __f*_rn intrinsics are never contracted into an FMA,
// and the build passes -fmad=false besides):
// - the depth is truncated to int and back to f32, as `.to(int32)`;
// - |delta| < difference_threshold in f32; the fit's sums in the plain
//   version's neighbour order (exact integers in f32 either way);
// - nx = ddx * 1150, ny = ddy * 1150, nz = -det * d, the two products
//   above 2^24 rounded once; sq = (nx*nx + ny*ny) + nz*nz;
// - a correctly rounded square root and IEEE 1 / max(sqr, 1e-30);
// - (n * inv) * 10 + 10 truncated to int, clamped to the LUT's cell;
// - q = LUT value where d < distance_threshold and sqr > 0, zero outside
//   rows and columns [5, dim - 6);
// - the median is the plain version's MSB-first bitwise-majority radix
//   over the 25 window values (the 13th smallest), exact for any u8: the
//   LUT holds multi-bit entries, so a count of one-bit bins would not be.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 5;                    // plane-fit radius
constexpr int MR = 2;                   // median radius (5 x 5)
constexpr int TW = 64;                  // output columns per block
constexpr int TH = 32;                  // output rows per block
constexpr int NTH = 256;                // threads per block
constexpr int STRIP = TH * TW / NTH;    // median rows per thread
constexpr int HALO = R + MR;
constexpr int QW = TW + 2 * MR;         // q tile: the output tile and its ring
constexpr int QH = TH + 2 * MR;
constexpr int DX0 = 8;                  // depth tile columns [x0 - 8, x0 + TW + 8):
constexpr int DW = TW + 2 * DX0;        // whole float4s that cover the 7-pixel halo
constexpr int DW4 = DW / 4;
constexpr int DH = TH + 2 * HALO;
constexpr int LUT_SIZE = 11 * 21 * 21;
constexpr float G = 10.f;               // GRANULARITY

static_assert(NTH % TW == 0 && TH % (NTH / TW) == 0, "strips must tile the output");
static_assert(DX0 >= HALO && DX0 % 4 == 0, "the depth tile must start on a float4");

__device__ __forceinline__ float trunc_mm(float v) {
  return static_cast<float>(__float2int_rz(v));
}

// One neighbour of the bilateral-masked plane fit at offset (OY, OX).
template <int OY, int OX>
__device__ __forceinline__ void accum(const float (*sd)[DW], int r, int c, float d,
                                      float diff_thr, float& A00, float& A01, float& A11,
                                      float& b0, float& b1) {
  constexpr float u = OX, v = OY;
  const float delta = __fsub_rn(sd[r + OY][c + OX], d);
  const float w = fabsf(delta) < diff_thr ? 1.f : 0.f;
  A00 = __fadd_rn(A00, __fmul_rn(w, u * u));
  A01 = __fadd_rn(A01, __fmul_rn(w, u * v));
  A11 = __fadd_rn(A11, __fmul_rn(w, v * v));
  b0 = __fadd_rn(b0, __fmul_rn(__fmul_rn(w, u), delta));
  b1 = __fadd_rn(b1, __fmul_rn(__fmul_rn(w, v), delta));
}

// The LUT cell coordinate of one normal component: trunc(n * inv * G + G),
// clamped to [0, hi].
__device__ __forceinline__ int cell(float n, float inv, int hi) {
  const int v = __float2int_rz(__fadd_rn(__fmul_rn(__fmul_rn(n, inv), G), G));
  return min(max(v, 0), hi);
}

// The quantized normal of the pixel at depth-tile row r, column c (inside
// the quantizer's band, so its 8 neighbours lie in the frame).
__device__ __forceinline__ uint8_t normal_code(const float (*sd)[DW], const uint8_t* lut,
                                               int r, int c, float dist_thr,
                                               float diff_thr) {
  const float d = sd[r][c];
  float A00 = 0.f, A01 = 0.f, A11 = 0.f, b0 = 0.f, b1 = 0.f;
  accum<-R, -R>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<-R, 0>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<-R, R>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<0, -R>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<0, R>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<R, -R>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<R, 0>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  accum<R, R>(sd, r, c, d, diff_thr, A00, A01, A11, b0, b1);
  const float det = __fsub_rn(__fmul_rn(A00, A11), __fmul_rn(A01, A01));
  const float ddx = __fsub_rn(__fmul_rn(A11, b0), __fmul_rn(A01, b1));
  const float ddy = __fadd_rn(__fmul_rn(-A01, b0), __fmul_rn(A00, b1));
  const float nx = __fmul_rn(ddx, 1150.f);
  const float ny = __fmul_rn(ddy, 1150.f);
  const float nz = __fmul_rn(-det, d);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)),
                             __fmul_rn(nz, nz));
  const float sqr = __fsqrt_rn(sq);
  const float inv = sqr > 0.f ? __fdiv_rn(1.f, fmaxf(sqr, 1e-30f)) : 0.f;
  const int flat = (cell(nz, inv, 10) * 21 + cell(ny, inv, 20)) * 21 + cell(nx, inv, 20);
  return (d < dist_thr && sqr > 0.f) ? lut[flat] : uint8_t(0);
}

// The 13th smallest of the 25 window values, MSB first: keep each bit
// whose probe still has at least 13 values at or above it.
__device__ __forceinline__ uint8_t median25(const int (&w)[5][5]) {
  int med = 0;
#pragma unroll
  for (int bit = 7; bit >= 0; --bit) {
    const int probe = med | (1 << bit);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) cnt += w[i][j] >= probe;
    med = cnt >= 13 ? probe : med;
  }
  return static_cast<uint8_t>(med);
}

__global__ void __launch_bounds__(NTH)
depth_normal_kernel(const float* __restrict__ depth, const uint8_t* __restrict__ lut_g,
                    uint8_t* __restrict__ out, int H, int W, float dist_thr,
                    float diff_thr, int vec) {
  __shared__ __align__(16) float sd[DH][DW];
  __shared__ uint8_t sq[QH][QW];
  __shared__ uint8_t lut[LUT_SIZE];
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = depth + blockIdx.z * plane;

  // 1. the LUT and the truncated depth tile, rows [y0 - 7, y0 + TH + 7),
  //    columns [x0 - 8, x0 + TW + 8).
  for (int i = t; i < LUT_SIZE; i += NTH) lut[i] = lut_g[i];
  const int gy0 = y0 - HALO, gx0 = x0 - DX0;
  if (vec) {  // W % 4 == 0 and a 16-byte aligned frame: each float4 is in or out whole
    for (int i = t; i < DH * DW4; i += NTH) {
      const int r = i / DW4, c4 = i - r * DW4;
      const int gy = gy0 + r, gx = gx0 + 4 * c4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(gy) * W + gx));
        v = make_float4(trunc_mm(v.x), trunc_mm(v.y), trunc_mm(v.z), trunc_mm(v.w));
      }
      *reinterpret_cast<float4*>(&sd[r][4 * c4]) = v;
    }
  } else {
    for (int i = t; i < DH * DW; i += NTH) {
      const int r = i / DW, c = i - r * DW;
      const int gy = gy0 + r, gx = gx0 + c;
      sd[r][c] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                     ? trunc_mm(__ldg(src + static_cast<size_t>(gy) * W + gx))
                     : 0.f;
    }
  }
  __syncthreads();

  // 2. q over rows [y0 - 2, y0 + TH + 2), columns [x0 - 2, x0 + TW + 2):
  //    zero outside the band [5, H - 6) x [5, W - 6), so outside the frame.
  for (int i = t; i < QH * QW; i += NTH) {
    const int r = i / QW, c = i - r * QW;
    const int gy = y0 - MR + r, gx = x0 - MR + c;
    uint8_t q = 0;
    if (gy >= R && gy < H - R - 1 && gx >= R && gx < W - R - 1)
      q = normal_code(sd, lut, r + (HALO - MR), c + (DX0 - MR), dist_thr, diff_thr);
    sq[r][c] = q;
  }
  __syncthreads();

  // 3. the 5 x 5 median: column c of the tile, rows [ly0, ly0 + STRIP).
  const int c = t % TW, ly0 = (t / TW) * STRIP;
  const int ox = x0 + c;
  uint8_t* dst = out + blockIdx.z * plane;
  int w[5][5] = {};
#pragma unroll
  for (int k = 0; k < STRIP + 4; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) w[i][j] = w[i + 1][j];
#pragma unroll
    for (int j = 0; j < 5; ++j) w[4][j] = sq[ly0 + k][c + j];
    if (k >= 4) {
      const int oy = y0 + ly0 + k - 4;
      if (oy < H && ox < W) dst[static_cast<size_t>(oy) * W + ox] = median25(w);
    }
  }
}

}  // namespace

// depth: (B, H, W) f32 millimetres; lut: the 4,851-byte NORMAL_LUT; out:
// (B, H, W) u8.  Launches on `stream`; returns cudaGetLastError().
extern "C" int lpe_depth_normal(const void* depth, const void* lut, void* out, int B, int H,
                                int W, float dist_thr, float diff_thr, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0 || W == 0) return 0;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(depth) % 16 == 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  depth_normal_kernel<<<grid, NTH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<const uint8_t*>(lut),
      static_cast<uint8_t*>(out), H, W, dist_thr, diff_thr, vec);
  return static_cast<int>(cudaGetLastError());
}
