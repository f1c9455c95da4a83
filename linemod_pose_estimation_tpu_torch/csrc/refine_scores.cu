// Kernel K5: dense window x window refinement scores around each coarse
// candidate.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_kernels.py::
// refine_scores_pallas (kernel body _refine_kernel).  Plain version:
// ops/cuda_kernels.py::refine_scores_plain.
//
// out[k, wy, wx] = sum over slots f < nf[k] of
//     R[frame[k], ori[k, f], ay[k] + dy[k, f] + wy, ax[k] + dx[k, f] + wx]
// with reads outside the frame counting 0 (the reference pads the frame
// with zeros below and to the right; anchors and offsets are >= 0).
//
// What bounds it on the H100: scattered byte reads — K * window^2 * F
// gathers (~302M at K = 4096 candidates, a 24 x 24 window, F = 128)
// against a response stack of B * C * H * W bytes (157 MB at B = 32, 16
// channels, 480 x 640) that the 50 MB L2 holds a few frames of at a time.
// Design: one block per candidate with one thread per window cell; the
// candidate's feature rows (ori, dy, dx) are staged in shared memory once
// per chunk of 256 slots, and for each feature a warp reads contiguous
// bytes of one or two rows of R through L1.  Integer sums only, so the
// result is bitwise the plain version's.  The TPU kernel's 32/128
// alignment residuals, power-of-two lane width, SMEM chunking of the
// candidate axis, double-buffered patch DMA and lane rolls are TPU layout
// workarounds and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 1024;  // a window of at most 32 x 32 cells
constexpr int CHUNK = 256;    // feature slots staged per pass

__global__ void __launch_bounds__(MAX_NT)
refine_scores_kernel(const uint8_t* __restrict__ R,
                     const int32_t* __restrict__ oris,
                     const int32_t* __restrict__ dys,
                     const int32_t* __restrict__ dxs,
                     const int32_t* __restrict__ nf,
                     const int32_t* __restrict__ anchor_y,
                     const int32_t* __restrict__ anchor_x,
                     const int32_t* __restrict__ frame,
                     int32_t* __restrict__ out,
                     int C, int H, int W, int F, int window) {
  __shared__ int32_t s_off[CHUNK];  // (ori * H + dy) * W + dx of a feature
  __shared__ int32_t s_dy[CHUNK];
  __shared__ int32_t s_dx[CHUNK];

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;  // window * window
  const int wy = t / window, wx = t % window;
  const int y0 = anchor_y[k] + wy;  // this cell's origin for offset (0, 0)
  const int x0 = anchor_x[k] + wx;
  const uint8_t* Rb = R + (size_t)frame[k] * C * H * W;
  const size_t fbase = (size_t)k * F;
  const int n = min(nf[k], F);
  int32_t acc = 0;
  for (int f0 = 0; f0 < n; f0 += CHUNK) {
    const int m = min(CHUNK, n - f0);
    __syncthreads();
    for (int j = t; j < m; j += nt) {
      const size_t fi = fbase + f0 + j;
      const int dy = dys[fi], dx = dxs[fi];
      s_dy[j] = dy;
      s_dx[j] = dx;
      s_off[j] = (oris[fi] * H + dy) * W + dx;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const int yy = y0 + s_dy[j], xx = x0 + s_dx[j];
      if ((unsigned)yy >= (unsigned)H || (unsigned)xx >= (unsigned)W) continue;
      acc += Rb[(size_t)s_off[j] + (size_t)y0 * W + x0];
    }
  }
  out[(size_t)k * nt + t] = acc;
}

}  // namespace

extern "C" int lpe_refine_scores(const void* R, const void* oris,
                                 const void* dys, const void* dxs,
                                 const void* nf, const void* anchor_y,
                                 const void* anchor_x, const void* frame,
                                 void* out, int C, int H, int W, int K, int F,
                                 int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  refine_scores_kernel<<<K, window * window, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(R), static_cast<const int32_t*>(oris),
      static_cast<const int32_t*>(dys), static_cast<const int32_t*>(dxs),
      static_cast<const int32_t*>(nf), static_cast<const int32_t*>(anchor_y),
      static_cast<const int32_t*>(anchor_x), static_cast<const int32_t*>(frame),
      static_cast<int32_t*>(out), C, H, W, F, window);
  return static_cast<int>(cudaGetLastError());
}
