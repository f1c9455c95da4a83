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
// What bounds it on the H100: not bytes (each walked slot reads 256 x F
// scattered bytes, mostly L2 hits, and writes 1 KB) but the load path.
// One warp-wide gather takes 32 single bytes from two placement rows of a
// plane, T bytes apart: 4-6 sectors in several cache lines, which L1
// serves in several passes; and at the B=32 batch's ~570 walked slots the
// card holds only ~17 warps an SM to cover the latency.  Design: one
// block per (b, k) slot, 128 threads, each owning placements (r, c) and
// (r + 8, c) (a warp: two rows of 16 placements, twice).  The block stages the
// slot's features in rounds of 128: one thread per feature computes its
// plane offset (ori * H + dy) * W + dx and a 32-bit in-frame mask (bit r:
// placement row r reads inside the frame, bit 16 + c: column c does), and
// a ballot compacts the features that are live and reach the frame at
// all, in feature order, into shared memory.  The walk then takes UNROLL
// features at a time with no branch, so each thread has 2 x UNROLL byte
// loads in flight before an add consumes them.  When every feature of the
// round reads inside the frame at every placement — always on the
// matcher's plans, whose anchors keep the window off the frame's edges —
// the walk skips the masks: a feature costs one shared load and, per
// placement, an add, a load and an add.  Dead slots write zeros and exit.
// The TPU kernel's phase-major frame, selector-matrix dot and power-of-two
// lane windows are TPU layout workarounds and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 16;
constexpr int NT = WIN * WIN / 2;  // threads a block, two placements each
constexpr int UNROLL = 16;         // features a step
constexpr unsigned FULL = 0xffffffffu;

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
  // Plane offsets and in-frame masks of the round's compacted features.
  __shared__ int s_off[NT + UNROLL];
  __shared__ unsigned s_mask[NT + UNROLL];
  __shared__ int s_warp[NT / 32];

  const int slot = blockIdx.x;  // b * K + k
  const int b = slot / K, k = slot % K;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int32_t* o = out + static_cast<size_t>(slot) * WIN * WIN;
  if (k >= n_valid[b]) {
    o[t] = 0;
    o[t + NT] = 0;
    return;
  }
  const int r = t / WIN, c = t % WIN;  // placements (r, c) and (r + 8, c)
  const int gy = gy0[slot], gx = gx0[slot];
  // Offsets of the two placements in a plane; the wrapper keeps C * H * W
  // below 2^31, and a read happens only where it lies inside the frame.
  const int at0 = (gy + r) * T * W + (gx + c) * T;
  const int at1 = at0 + (WIN / 2) * T * W;
  const uint8_t* Rb = R0 + static_cast<size_t>(b) * C * H * W;
  const size_t fbase = static_cast<size_t>(slot) * F;
  int32_t acc0 = 0, acc1 = 0;
  for (int f0 = 0; f0 < F; f0 += NT) {
    const int f = f0 + t;
    int off = 0;
    unsigned mask = 0;
    if (f < F) {
      const bool lv = live[fbase + f];
      const int dy = dys[fbase + f], dx = dxs[fbase + f];
      const int ori = min(max(oris[fbase + f], 0), C - 1);  // as the plain version
      off = (ori * H + dy) * W + dx;
#pragma unroll
      for (int q = 0; q < WIN; ++q) {
        const int yy = (gy + q) * T + dy, xx = (gx + q) * T + dx;
        mask |= static_cast<unsigned>(yy >= 0 && yy < H) << q;
        mask |= static_cast<unsigned>(xx >= 0 && xx < W) << (WIN + q);
      }
      if (!lv) mask = 0;
    }
    const bool keep = (mask & 0xffffu) != 0 && (mask >> WIN) != 0;
    const unsigned ballot = __ballot_sync(FULL, keep);
    __syncthreads();  // the previous round's walk is done with s_off, s_mask
    if (lane == 0) s_warp[warp] = __popc(ballot);
    // Block-uniform: every kept feature reads inside the frame everywhere.
    const bool inside = __syncthreads_and(!keep || mask == FULL);
    int pos = 0, n = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const int cw = s_warp[w];
      pos += w < warp ? cw : 0;
      n += cw;
    }
    if (keep) {
      const int i = pos + __popc(ballot & ((1u << lane) - 1u));
      s_off[i] = off;
      s_mask[i] = mask;
    }
    if (t < UNROLL) {  // padding past n: reads nothing
      s_off[n + t] = 0;
      s_mask[n + t] = 0;
    }
    __syncthreads();
    if (inside) {
      const int n_even = n & ~(UNROLL - 1);
      for (int j = 0; j < n_even; j += UNROLL) {
        unsigned v0[UNROLL], v1[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int e = s_off[j + u];
          v0[u] = __ldg(Rb + (e + at0));
          v1[u] = __ldg(Rb + (e + at1));
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          acc0 += static_cast<int32_t>(v0[u]);
          acc1 += static_cast<int32_t>(v1[u]);
        }
      }
      for (int j = n_even; j < n; ++j) {
        const int e = s_off[j];
        acc0 += __ldg(Rb + (e + at0));
        acc1 += __ldg(Rb + (e + at1));
      }
    } else {
      for (int j = 0; j < n; j += UNROLL) {
        unsigned v0[UNROLL], v1[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int e = s_off[j + u];
          const unsigned m = s_mask[j + u];
          const unsigned col = m >> (WIN + c);
          v0[u] = (m >> r) & col & 1u ? __ldg(Rb + (e + at0)) : 0u;
          v1[u] = (m >> (r + WIN / 2)) & col & 1u ? __ldg(Rb + (e + at1)) : 0u;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          acc0 += static_cast<int32_t>(v0[u]);
          acc1 += static_cast<int32_t>(v1[u]);
        }
      }
    }
  }
  o[t] = acc0;
  o[t + NT] = acc1;
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
