// Kernel K3: cv::linemod's exact 16 x 16 stride-T local walk scores.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_kernels.py::
// walk_scores_pallas (kernel body _walk_kernel).  Plain version:
// ops/cuda_kernels.py::walk_scores_plain.
//
// out[b, k, r, c] = sum over live features f of
//     R0[b, ori[f], (gy0 + r) * T + dy[f], (gx0 + c) * T + dx[f]]
// with reads outside the frame counting 0 (the reference pads with
// zeros), and exact zeros for slots k >= n_valid[b] (the sub-threshold
// top-k filler the walk skips).
//
// What bounds it on the H100: scattered byte reads — B*K*256*F gathers
// (~134M at B=32, K=128, F=128) against a ~157 MB response stack that
// mostly sits in the 50 MB L2 per frame.  Design: one block per (b, k)
// slot with one thread per placement; the slot's feature list is staged
// in shared memory once, and for each feature the 16 threads of a
// placement row read 16 bytes T apart in one row, so a warp touches two
// rows per feature.  Dead slots exit after writing zeros.  The TPU
// kernel's phase-major frame, selector-matrix dot and power-of-two lane
// windows are TPU layout workarounds and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 16;
constexpr int NT = WIN * WIN;

__global__ void __launch_bounds__(NT)
walk_scores_kernel(const uint8_t* __restrict__ R0,
                   const int32_t* __restrict__ oris,
                   const int32_t* __restrict__ dys,
                   const int32_t* __restrict__ dxs,
                   const uint8_t* __restrict__ live,
                   const int32_t* __restrict__ gy0,
                   const int32_t* __restrict__ gx0,
                   const int32_t* __restrict__ n_valid,
                   int32_t* __restrict__ out,
                   int C, int H, int W, int K, int F, int T) {
  __shared__ int32_t s_off[NT];  // (ori * H + dy) * W + dx of a feature
  __shared__ int32_t s_dy[NT];
  __shared__ int32_t s_dx[NT];
  __shared__ uint8_t s_live[NT];

  const int slot = blockIdx.x;  // b * K + k
  const int b = slot / K, k = slot % K;
  const int t = threadIdx.x;
  int32_t* o = out + (size_t)slot * NT;
  if (k >= n_valid[b]) {
    o[t] = 0;
    return;
  }
  const int r = t / WIN, c = t % WIN;
  const int py = (gy0[slot] + r) * T;  // placement pixel row / col
  const int px = (gx0[slot] + c) * T;
  const uint8_t* Rb = R0 + (size_t)b * C * H * W;
  const size_t fbase = (size_t)slot * F;
  int32_t acc = 0;
  for (int f0 = 0; f0 < F; f0 += NT) {
    const int nf = min(NT, F - f0);
    __syncthreads();
    if (t < nf) {
      const size_t fi = fbase + f0 + t;
      s_dy[t] = dys[fi];
      s_dx[t] = dxs[fi];
      s_off[t] = (oris[fi] * H + dys[fi]) * W + dxs[fi];
      s_live[t] = live[fi];
    }
    __syncthreads();
    for (int j = 0; j < nf; ++j) {
      if (!s_live[j]) continue;
      const int yy = py + s_dy[j], xx = px + s_dx[j];
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      acc += Rb[(size_t)s_off[j] + (size_t)py * W + px];
    }
  }
  o[t] = acc;
}

}  // namespace

extern "C" int lpe_walk_scores(const void* R0, const void* oris,
                               const void* dys, const void* dxs,
                               const void* live, const void* gy0,
                               const void* gx0, const void* n_valid, void* out,
                               int B, int C, int H, int W, int K, int F, int T,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_scores_kernel<<<B * K, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(R0), static_cast<const int32_t*>(oris),
      static_cast<const int32_t*>(dys), static_cast<const int32_t*>(dxs),
      static_cast<const uint8_t*>(live), static_cast<const int32_t*>(gy0),
      static_cast<const int32_t*>(gx0), static_cast<const int32_t*>(n_valid),
      static_cast<int32_t*>(out), C, H, W, K, F, T);
  return static_cast<int>(cudaGetLastError());
}
