// Kernel K2: orientation spread + graded response maps, bit-exact.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_kernels.py::
// spread_response_batched (kernel body _spread_response_kernel +
// _graded_response_planes); at B=1 it is the port of the single-frame
// spread_response (K2b).  Plain version: ops/cuda_kernels.py::
// spread_response_plain (ops/features.py orientation_spread +
// response_maps).
//
// What bounds it on the H100: device-memory bytes.  It reads a (B, H, W)
// u8 bitmask once and writes 8 u8 response planes per pixel: 9 bytes a
// pixel against ~30 integer operations, far below the card's ~20
// operations-per-byte balance point.  The planes go straight into a
// channel slice [c0, c0 + 8) of a (B, C, H, W) response stack, so the
// caller needs no concatenation pass afterwards.
//
// Design: each thread owns 4 consecutive pixels of one column group and
// walks down a strip of `rows` rows (the wrapper picks it so that the grid
// holds enough threads to keep the stores in flight).
// - Horizontal OR over [x, x + T): the row's bytes x0 .. x0 + T + 2 come
//   in as 32-bit words (one aligned load each when W % 4 == 0), and the T
//   shifted windows are funnel shifts of neighbouring words, OR-ed.
// - Vertical OR over [y, y + T): a ring of the last T horizontal ORs in
//   registers; each row loads one new row of input.
// - The four pixels travel as the four bytes of one word: the circular
//   dilations and the 8 response planes are byte-parallel (SWAR), and each
//   plane is one 32-bit store.
// Zero past the bottom/right edge, as the plain version pads.
//
// Response: with s_d the circular radius-d OR-dilation of the spread
// byte over the 8 bins, response[o] = sum_{d=0..3} bit_o(s_d) = 4 minus
// the circular distance from o to the nearest set bit (0 if none).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GX = 32;    // column groups (of 4 pixels) per block row
constexpr int GY = 4;     // strips per block
constexpr uint32_t ONES = 0x01010101u;

// Circular one-step dilation of each of the four bytes over its 8 bits.
__device__ __forceinline__ uint32_t dil1(uint32_t x) {
  uint32_t rol = ((x << 1) & 0xFEFEFEFEu) | ((x >> 7) & ONES);
  uint32_t ror = ((x >> 1) & 0x7F7F7F7Fu) | ((x << 7) & 0x80808080u);
  return x | rol | ror;
}

// Horizontal OR over [x0 + i, x0 + i + T) for the 4 pixels i of the group,
// as the 4 bytes of a word; 0 for a row past the bottom edge.
template <int T, bool VEC>
__device__ __forceinline__ uint32_t hrow(const uint8_t* __restrict__ q, int y,
                                         int x0, int H, int W) {
  constexpr int NW = (T + 2) / 4 + 1;  // words covering x0 .. x0 + T + 2
  if (y >= H) return 0u;
  const uint8_t* row = q + (size_t)y * W;
  uint32_t w[NW + 1];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int x = x0 + 4 * i;
    if (VEC) {
      w[i] = x < W ? __ldg(reinterpret_cast<const uint32_t*>(row + x)) : 0u;
    } else {
      uint32_t v = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x + k < W) v |= static_cast<uint32_t>(__ldg(row + x + k)) << (8 * k);
      w[i] = v;
    }
  }
  w[NW] = 0u;
  uint32_t h = 0u;
#pragma unroll
  for (int j = 0; j < T; ++j)
    h |= __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));
  return h;
}

template <int T, bool VEC>
__global__ void __launch_bounds__(GX * GY)
spread_response_kernel(const uint8_t* __restrict__ quant, uint8_t* __restrict__ out,
                       int H, int W, int C, int c0, int rows) {
  const int x0 = 4 * (blockIdx.x * GX + threadIdx.x);
  const int ys = (blockIdx.y * GY + threadIdx.y) * rows;
  const int b = blockIdx.z;
  if (x0 >= W || ys >= H) return;
  const int ye = min(ys + rows, H);
  const uint8_t* q = quant + (size_t)b * H * W;
  const size_t plane = (size_t)H * W;
  uint8_t* o = out + ((size_t)b * C + c0) * plane + x0;

  uint32_t ring[T];  // ring[j]: horizontal OR of row y + j
#pragma unroll
  for (int j = 1; j < T; ++j) ring[j] = hrow<T, VEC>(q, ys + j - 1, x0, H, W);
  for (int y = ys; y < ye; ++y) {
#pragma unroll
    for (int j = 0; j + 1 < T; ++j) ring[j] = ring[j + 1];
    ring[T - 1] = hrow<T, VEC>(q, y + T - 1, x0, H, W);
    uint32_t s = 0u;
#pragma unroll
    for (int j = 0; j < T; ++j) s |= ring[j];
    const uint32_t s1 = dil1(s), s2 = dil1(s1), s3 = dil1(s2);
    uint8_t* p = o + (size_t)y * W;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = ((s >> k) & ONES) + ((s1 >> k) & ONES) +
                         ((s2 >> k) & ONES) + ((s3 >> k) & ONES);
      if (VEC) {
        *reinterpret_cast<uint32_t*>(p + k * plane) = v;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (x0 + i < W) p[k * plane + i] = static_cast<uint8_t>(v >> (8 * i));
      }
    }
  }
}

template <int T>
void launch(const uint8_t* q, uint8_t* out, int B, int H, int W, int C, int c0,
            int rows, bool vec, cudaStream_t s) {
  dim3 block(GX, GY);
  dim3 grid((W + 4 * GX - 1) / (4 * GX), (H + GY * rows - 1) / (GY * rows), B);
  if (vec)
    spread_response_kernel<T, true><<<grid, block, 0, s>>>(q, out, H, W, C, c0, rows);
  else
    spread_response_kernel<T, false><<<grid, block, 0, s>>>(q, out, H, W, C, c0, rows);
}

}  // namespace

// Writes the 8 response planes of each frame into channels [c0, c0 + 8)
// of `out` (B, C, H, W) u8.  T in [1, 8]; `rows`: rows per thread strip.
extern "C" int lpe_spread_response(const void* quant, void* out, int B, int H,
                                   int W, int T, int C, int c0, int rows, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 1 || T > 8 || c0 < 0 || c0 + 8 > C || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const uint8_t* q = static_cast<const uint8_t*>(quant);
  uint8_t* o = static_cast<uint8_t*>(out);
  // Aligned word loads and stores need every row to start on 4 bytes.
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(o) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1: launch<1>(q, o, B, H, W, C, c0, rows, vec, s); break;
    case 2: launch<2>(q, o, B, H, W, C, c0, rows, vec, s); break;
    case 3: launch<3>(q, o, B, H, W, C, c0, rows, vec, s); break;
    case 4: launch<4>(q, o, B, H, W, C, c0, rows, vec, s); break;
    case 5: launch<5>(q, o, B, H, W, C, c0, rows, vec, s); break;
    case 6: launch<6>(q, o, B, H, W, C, c0, rows, vec, s); break;
    case 7: launch<7>(q, o, B, H, W, C, c0, rows, vec, s); break;
    default: launch<8>(q, o, B, H, W, C, c0, rows, vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
