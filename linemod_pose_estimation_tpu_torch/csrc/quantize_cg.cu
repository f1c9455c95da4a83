// Kernel K1: fused ColorGradient quantizer (cv::linemod ColorGradient::
// quantizedOrientations + hysteresisGradient), bit-exact.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_preprocess.py::
// quantize_color_gradient_pallas (kernel body _quant_cg_kernel).  Plain
// version: ops/features.py::quantize_color_gradient.
//
// What bounds it on the H100: operations, not bytes.  It reads 3 bytes
// (level 0, u8) or 12 bytes (level 1, f32) and writes 1 byte a pixel, but
// does ~190 operations a pixel (two 7-tap blur passes over 3 channels,
// Sobel, magnitudes, fastAtan2 with an IEEE division, binning, the 3x3
// vote; ops/roofline.py counts them), so at level 0 the operations set
// the least time.  The kernel itself is held back by instruction issue
// and latency: by a count of its source, ~400 thread-instructions a pixel
// with the halo and the pipeline's fill, and its measured time is about
// twice what issuing them alone would take.
//
// Design: a row-streaming stencil.  A block of NTH threads owns a strip of
// S output rows and OW = NTH - 4 output columns; thread t owns column
// bx0 - 2 + t and walks down the strip one input row per step, with every
// intermediate an exact integer.  One step:
//   1. stages the next input row (clamped: replicate) in shared memory
//      from registers and issues the loads of the row after it, which fly
//      while the stages below compute;
//   2. row-blurs its column of this step's input row (7 taps x 3 channels
//      from shared memory) into a 7-row ring in registers and column-blurs
//      the ring: blurred row v - 3, rounded once, into a 4-row ring in
//      shared memory;
//   3. Sobel, the strongest channel, fastAtan2 and the bin of row v - 5
//      (94 columns) as a nibble vote word and a strength flag, into a
//      4-row ring;
//   4. the 3x3 vote and the output byte of row v - 7 (92 columns).
// Each stage reads only what earlier steps wrote, so one barrier closes a
// step, and the stages of one step are free to overlap.  The step loop is
// unrolled by 7, the blur ring's period, so the compiler can rename the
// ring's registers rather than move them.
//
// Exactness:
// - integer-valued inputs (u8 at level 0, the f32 pyrDown output at level
//   1, converted once on load): Q6 taps, the Q12 accumulator is at most
//   255 * 64 * 64 = 1,044,480, and (acc + 2048) >> 12 is the plain
//   version's floor((acc + 2048) / 4096); Sobel and the squared
//   magnitudes (< 2^24) are exact integers, so their f32 values for the
//   channel maximum, the tie rule and mag2 > weak2 equal the plain ones.
// - replicate clamps: the blur clamps at the INPUT edge, Sobel at the
//   BLURRED image's edge (blurred rows and columns outside the frame are
//   never read: Sobel clamps its neighbour indices into the frame).
// - fastAtan2 uses the reference's f32 constants and operation order;
//   the build passes -fmad=false so no product/sum pair contracts into an
//   FMA (that would move the last ulp and flip half-even bins).  IEEE
//   division (no fast math).  The first channel wins magnitude ties.
// - binning rounds half to even (rintf), then & 15, & 7.
// - the 3x3 vote adds 8 nibble counters packed in one uint32; at most one
//   bin can reach 5 of the 9 votes, and then it is the first maximum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 96;           // threads per block = blurred columns
constexpr int OW = NTH - 4;       // output columns per block
constexpr int NBIN = NTH - 2;     // binned columns per block
constexpr int IN_COLS = NTH + 6;  // staged input columns [bx0 - 5, bx0 + NTH + 1)
constexpr unsigned NS = 4;        // rows in the blurred and the bin rings

// f32 constants, bit-identical to the reference's numpy float32 values.
constexpr float P1 = 0x1.ca44dep+5f;
constexpr float P3 = -0x1.2aaddcp+4f;
constexpr float P5 = 0x1.1d3f7ep+3f;
constexpr float P7 = -0x1.4515b2p+1f;
constexpr float DBL_EPS_F = 0x1p-52f;
constexpr float BIN_SCALE = 0x1.6c16c2p-5f;  // float32(16 / 360)

__device__ __forceinline__ int to_int(uint8_t v) { return v; }
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }

// The Q6 taps of OpenCV's 7-tap small-sigma Gaussian, [2, 7, 14, 18, 14,
// 7, 2], over a0..a6 (symmetric: 4 multiplies, 6 adds).
__device__ __forceinline__ int gauss7(int a0, int a1, int a2, int a3, int a4, int a5,
                                      int a6) {
  return 2 * (a0 + a6) + 7 * (a1 + a5) + 14 * (a2 + a4) + 18 * a3;
}

// fastAtan2 (degrees) of the strongest channel's gradient, binned to 8.
__device__ __forceinline__ int orientation_bin(int idx, int idy) {
  const float dx = static_cast<float>(idx), dy = static_cast<float>(idy);
  const float ax = fabsf(dx), ay = fabsf(dy);
  const bool big = ax >= ay;
  const float num = big ? ay : ax;
  const float den = (big ? ax : ay) + DBL_EPS_F;
  const float cr = num / den;
  const float c2 = cr * cr;
  float a = (((P7 * c2 + P5) * c2 + P3) * c2 + P1) * cr;
  a = big ? a : 90.f - a;
  a = dx < 0.f ? 180.f - a : a;
  a = dy < 0.f ? 360.f - a : a;
  return (static_cast<int>(rintf(a * BIN_SCALE)) & 15) & 7;
}

// One input row (clamped, replicate) held in registers between its load
// and its store to shared memory: columns t and NTH + t, 3 channels.
template <typename T>
struct RowLoader {
  int v[2][3];
  __device__ __forceinline__ void load(const T* __restrict__ src, int y, int H, int W,
                                       int bx0, int t) {
    const T* row = src + (size_t)min(max(y, 0), H - 1) * W * 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = t + i * NTH;
      if (k < IN_COLS) {
        const T* px = row + (size_t)min(max(bx0 - 5 + k, 0), W - 1) * 3;
        v[i][0] = to_int(px[0]);
        v[i][1] = to_int(px[1]);
        v[i][2] = to_int(px[2]);
      }
    }
  }
  __device__ __forceinline__ void store(int (*s)[IN_COLS], int t) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = t + i * NTH;
      if (k < IN_COLS) {
        s[0][k] = v[i][0];
        s[1][k] = v[i][1];
        s[2][k] = v[i][2];
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NTH)
quantize_cg_kernel(const T* __restrict__ img, uint8_t* __restrict__ out,
                   int H, int W, int S, float weak2) {
  __shared__ int s_in[2][3][IN_COLS];    // this step's and the next step's input row
  __shared__ int s_bl[NS][3][NTH];       // [row % NS][channel][column - (bx0 - 2)]
  __shared__ uint32_t s_vote[NS][NTH];   // [row % NS][column - (bx0 - 1)]: 1 << 4 bin
  __shared__ uint8_t s_strong[NS][NTH];  // the same bins' mag2 > weak2

  const int t = threadIdx.x;
  const int bx0 = blockIdx.x * OW;
  const int y0 = blockIdx.y * S;
  const int y_end = min(y0 + S, H);  // output rows [y0, y_end)
  const int b = blockIdx.z;
  const T* src = img + (size_t)b * H * W * 3;
  const int bin_lo = max(y0 - 1, 0), bin_hi = min(y_end, H - 1);
  const int xb = bx0 - 1 + t;  // this thread's binned column
  const int x = bx0 + t;       // and output column
  const bool bin_col = t < NBIN && xb >= 0 && xb < W;

  int ring[3][7];
  RowLoader<T> next;
  const int v_begin = y0 - 5;
  next.load(src, v_begin, H, W, bx0, t);
  next.store(s_in[0], t);
  next.load(src, v_begin + 1, H, W, bx0, t);
  __syncthreads();

  int buf = 0;
#pragma unroll 7
  for (int v = v_begin; v <= y_end + 6; ++v, buf ^= 1) {
    // 1. Stage the next input row; load the one after.
    next.store(s_in[buf ^ 1], t);
    next.load(src, v + 2, H, W, bx0, t);

    // 2. Row blur of column bx0 - 2 + t of input row v into the ring;
    //    column blur of row v - 3.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int* a = &s_in[buf][c][t];
#pragma unroll
      for (int k = 0; k < 6; ++k) ring[c][k] = ring[c][k + 1];
      ring[c][6] = gauss7(a[0], a[1], a[2], a[3], a[4], a[5], a[6]);
    }
    const int r = v - 3;
    if (v - v_begin >= 6 && r >= 0 && r < H) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int* g = ring[c];
        s_bl[(unsigned)r % NS][c][t] =
            (gauss7(g[0], g[1], g[2], g[3], g[4], g[5], g[6]) + 2048) >> 12;
      }
    }

    // 3. Sobel + strongest channel + fastAtan2 + binning of row v - 5
    //    (its blurred rows v - 6 .. v - 4 are from earlier steps).
    const int rb = v - 5;
    if (rb >= bin_lo && rb <= bin_hi && t < NBIN) {
      uint32_t vote = 0u;  // stays 0 for a column outside the frame
      bool strong = false;
      if (bin_col) {
        const unsigned ru = (unsigned)max(rb - 1, 0) % NS, rc = (unsigned)rb % NS,
                       rd = (unsigned)min(rb + 1, H - 1) % NS;
        const int il = max(xb - 1, 0) - (bx0 - 2), ic = xb - (bx0 - 2),
                  ir = min(xb + 1, W - 1) - (bx0 - 2);
        int dxs[3], dys[3], mags[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int* u = s_bl[ru][c];
          const int* m = s_bl[rc][c];
          const int* d = s_bl[rd][c];
          dxs[c] = (u[ir] + 2 * m[ir] + d[ir]) - (u[il] + 2 * m[il] + d[il]);
          dys[c] = (d[il] - u[il]) + 2 * (d[ic] - u[ic]) + (d[ir] - u[ir]);
          mags[c] = dxs[c] * dxs[c] + dys[c] * dys[c];
        }
        const int mag2 = max(max(mags[0], mags[1]), mags[2]);
        int dx = dxs[2], dy = dys[2];
        if (mags[1] == mag2) { dx = dxs[1]; dy = dys[1]; }
        if (mags[0] == mag2) { dx = dxs[0]; dy = dys[0]; }
        const bool interior = rb >= 1 && rb <= H - 2 && xb >= 1 && xb <= W - 2;
        const int bin = interior ? orientation_bin(dx, dy) : 0;  // border votes bin 0
        vote = 1u << (4 * bin);
        strong = static_cast<float>(mag2) > weak2;
      }
      s_vote[(unsigned)rb % NS][t] = vote;
      s_strong[(unsigned)rb % NS][t] = strong;
    }

    // 4. 3x3 vote of row v - 7 (its bin rows v - 8 .. v - 6 are from
    //    earlier steps); gate and emit.
    const int y = v - 7;
    if (y >= y0 && y < y_end && t < OW && x < W) {
      uint32_t acc = 0u;
#pragma unroll
      for (int dr = -1; dr <= 1; ++dr) {
        const int yy = y + dr;
        if (yy < 0 || yy >= H) continue;
        const uint32_t* sv = s_vote[(unsigned)yy % NS];
        acc += sv[t] + sv[t + 1] + sv[t + 2];
      }
      // Nibble n >= 5 exactly when n + 3 sets its bit 3 (n <= 9: no carry
      // crosses nibbles); that bin is then the unique maximum.
      const uint32_t five = (acc + 0x33333333u) & 0x88888888u;
      const bool interior = y >= 1 && y <= H - 2 && x >= 1 && x <= W - 2;
      const bool ok = s_strong[(unsigned)y % NS][t + 1] && five != 0u && interior;
      out[((size_t)b * H + y) * W + x] =
          ok ? static_cast<uint8_t>(1u << ((__ffs(five) - 1) >> 2)) : 0;
    }
    __syncthreads();
  }
}

}  // namespace

// `rows`: output rows per block (the strip height S).
extern "C" int lpe_quantize_cg(const void* img, int img_is_f32, void* out,
                               int B, int H, int W, int rows, float weak2,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  dim3 grid((W + OW - 1) / OW, (H + rows - 1) / rows, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_is_f32)
    quantize_cg_kernel<float><<<grid, NTH, 0, s>>>(
        static_cast<const float*>(img), static_cast<uint8_t*>(out), H, W, rows, weak2);
  else
    quantize_cg_kernel<uint8_t><<<grid, NTH, 0, s>>>(
        static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), H, W, rows, weak2);
  return static_cast<int>(cudaGetLastError());
}
