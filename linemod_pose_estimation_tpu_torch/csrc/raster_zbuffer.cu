// Kernel K4: triangle z-buffer with flat shade, bit-exact.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_raster.py::
// raster_zbuffer_pallas (what it computes is the XLA scan of
// models/renderer.py::render).  Plain version and the shared per-triangle
// precompute: ops/raster.py (raster_zbuffer_plain, triangle_coefficients).
//
// What bounds it on the H100: arithmetic and the triangle walk, not
// device memory — the coefficient table is ~170 KB per pose (L2-resident)
// and each pixel is written once.  The brute-force scan evaluates every
// triangle at every pixel; here one block owns a 16 x 16 pixel tile of
// one pose (grid.z = pose, the reference's vmap), stages the triangles
// through shared memory in index order, and skips — uniformly across the
// block — every triangle whose grown bounding box misses the tile (the
// per-pixel bbox test would reject all its pixels anyway, so the skip is
// exact).
//
// Exactness: each thread keeps (z, shade) and replaces them only when a
// triangle's depth is STRICTLY smaller, so the first triangle in index
// order that reaches the minimum wins — the scan's argmin-within-chunk,
// strict-< across chunks.  The per-pixel expressions are the reference's,
// in its operation order, built with -fmad=false and IEEE division (no
// fast-math), so depth and shade equal the plain version bit for bit.
#include <cuda_runtime.h>

namespace {

// Column order of ops/raster.py::COEFS.
enum {
  UX0, UY0, UX1, UY1, UX2, UY2, IZ0, IZ1, IZ2, AREA, GL0, GL1, GL2,
  XMIN, XMAX, YMIN, YMAX, ZTMIN, ZTMAX, SHADE, LIVE, NCOEF
};

constexpr int TILE = 16;
constexpr int CH = 256;  // triangles staged per round (one per thread)

__global__ void raster_zbuffer_kernel(const float* __restrict__ coefs,
                                      float* __restrict__ zbuf,
                                      float* __restrict__ sbuf,
                                      int Tn, int H, int W) {
  __shared__ float tri[CH * NCOEF];
  const int x = blockIdx.x * TILE + threadIdx.x;
  const int y = blockIdx.y * TILE + threadIdx.y;
  const int p = blockIdx.z;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  // Pixel-centre range of the tile's in-image pixels.
  const float tx0 = static_cast<float>(blockIdx.x * TILE) + 0.5f;
  const float tx1 = static_cast<float>(min(blockIdx.x * TILE + TILE, W) - 1) + 0.5f;
  const float ty0 = static_cast<float>(blockIdx.y * TILE) + 0.5f;
  const float ty1 = static_cast<float>(min(blockIdx.y * TILE + TILE, H) - 1) + 0.5f;
  const float* c_pose = coefs + static_cast<size_t>(p) * Tn * NCOEF;

  float z = __int_as_float(0x7f800000);  // +inf: no triangle yet
  float s = 0.0f;
  for (int base = 0; base < Tn; base += CH) {
    const int n = min(CH, Tn - base);
    __syncthreads();
    for (int i = tid; i < n * NCOEF; i += TILE * TILE)
      tri[i] = c_pose[static_cast<size_t>(base) * NCOEF + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* c = tri + j * NCOEF;
      if (!(c[LIVE] > 0.5f) || c[XMAX] < tx0 || c[XMIN] > tx1 ||
          c[YMAX] < ty0 || c[YMIN] > ty1)
        continue;  // block-uniform: the grown bbox misses the tile
      const float ux0 = c[UX0], uy0 = c[UY0], ux1 = c[UX1], uy1 = c[UY1];
      const float ux2 = c[UX2], uy2 = c[UY2];
      const float w0 = (ux2 - ux1) * (py - uy1) - (uy2 - uy1) * (px - ux1);
      const float w1 = (ux0 - ux2) * (py - uy2) - (uy0 - uy2) * (px - ux2);
      const float w2 = (ux1 - ux0) * (py - uy0) - (uy1 - uy0) * (px - ux0);
      const float gl0 = c[GL0], gl1 = c[GL1], gl2 = c[GL2];
      const bool pos = (w0 >= -gl0) && (w1 >= -gl1) && (w2 >= -gl2);
      const bool neg = (w0 <= gl0) && (w1 <= gl1) && (w2 <= gl2);
      const bool inb = (px >= c[XMIN]) && (px <= c[XMAX]) &&
                       (py >= c[YMIN]) && (py <= c[YMAX]);
      const float a = c[AREA];
      const float inv_z = (w0 / a) * c[IZ0] + (w1 / a) * c[IZ1] + (w2 / a) * c[IZ2];
      float zp = 1.0f / fmaxf(inv_z, 1e-9f);
      zp = fminf(fmaxf(zp, c[ZTMIN]), c[ZTMAX]);
      if ((pos || neg) && inb && inv_z > 1e-9f && zp < z) {
        z = zp;
        s = c[SHADE];
      }
    }
  }
  if (x < W && y < H) {
    const size_t o = (static_cast<size_t>(p) * H + y) * W + x;
    zbuf[o] = z;
    sbuf[o] = s;
  }
}

}  // namespace

extern "C" int lpe_raster_zbuffer(const void* coefs, void* zbuf, void* sbuf,
                                  int P, int Tn, int H, int W, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(TILE, TILE);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, P);
  raster_zbuffer_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coefs), static_cast<float*>(zbuf),
      static_cast<float*>(sbuf), Tn, H, W);
  return static_cast<int>(cudaGetLastError());
}
