// Kernel K1: fused ColorGradient quantizer (cv::linemod ColorGradient::
// quantizedOrientations + hysteresisGradient), bit-exact.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_preprocess.py::
// quantize_color_gradient_pallas (kernel body _quant_cg_kernel).  Plain
// version: ops/features.py::quantize_color_gradient.
//
// What bounds it on the H100: the chain is ~25 elementwise passes over
// frame-sized planes (7-tap blur x3 channels, Sobel, magnitudes, atan2,
// binning, 3x3 vote); run as separate ops it is bound by device-memory
// traffic.  Design: one block per 32 x 16 output tile keeps every
// intermediate in shared memory (input tile with a 5-px halo, row-blurred
// and blurred tiles with a 2-px halo, the bin tile with a 1-px halo), so
// device memory sees one read of the input and one write of the output.
//
// Exactness:
// - integer-valued inputs (u8 at level 0, the f32 pyrDown output at level
//   1): Q6 Gaussian taps and Sobel keep every value an exact integer in
//   f32; the blur rounds once, floor((acc + 2048) / 4096).
// - replicate clamps: the blur clamps at the INPUT edge, Sobel clamps at
//   the BLURRED image's edge.
// - fastAtan2 uses the reference's f32 constants and operation order;
//   the build passes -fmad=false so no product/sum pair contracts into an
//   FMA (that would move the last ulp and flip half-even bins).  IEEE
//   division (no fast math).
// - binning rounds half to even (rintf), then & 15, & 7.
// - the 3x3 vote packs 8 nibble counters into one uint32 (bin 7 overflows
//   a signed int32 by design; unsigned arithmetic keeps it defined).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // output tile width
constexpr int TH = 16;  // output tile height
constexpr int NT = TW * TH;
constexpr int IH = TH + 10, IW = TW + 10;  // input tile: 5-px halo
constexpr int RW = TW + 4;                 // blur cols: 2-px halo
constexpr int RH = TH + 4;                 // blur rows: 2-px halo
constexpr int BH = TH + 2, BW = TW + 2;    // bin tile: 1-px halo
constexpr uint8_t OUTSIDE = 0xFF;          // bin-tile marker: no vote

// f32 constants, bit-identical to the reference's numpy float32 values.
constexpr float P1 = 0x1.ca44dep+5f;
constexpr float P3 = -0x1.2aaddcp+4f;
constexpr float P5 = 0x1.1d3f7ep+3f;
constexpr float P7 = -0x1.4515b2p+1f;
constexpr float DBL_EPS_F = 0x1p-52f;
constexpr float BIN_SCALE = 0x1.6c16c2p-5f;  // float32(16 / 360)

__device__ __forceinline__ float gauss_q6(int k) {
  // [2, 7, 14, 18, 14, 7, 2]
  return k == 3 ? 18.f : (k == 2 || k == 4) ? 14.f : (k == 1 || k == 5) ? 7.f : 2.f;
}

template <typename T>
__device__ __forceinline__ float load_px(const T* img, int b, int y, int x, int c,
                                         int H, int W) {
  y = min(max(y, 0), H - 1);
  x = min(max(x, 0), W - 1);
  return static_cast<float>(img[(((size_t)b * H + y) * W + x) * 3 + c]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
quantize_cg_kernel(const T* __restrict__ img, uint8_t* __restrict__ out,
                   int H, int W, float weak2) {
  __shared__ float s_in[3][IH][IW];
  __shared__ float s_row[3][IH][RW];
  __shared__ float s_blur[3][RH][RW];
  __shared__ uint8_t s_bin[BH][BW];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // 1. Input tile rows [y0-5, y0+TH+5), cols [x0-5, x0+TW+5), replicate.
  for (int i = tid; i < 3 * IH * IW; i += NT) {
    int c = i / (IH * IW), r = (i / IW) % IH, q = i % IW;
    s_in[c][r][q] = load_px(img, b, y0 - 5 + r, x0 - 5 + q, c, H, W);
  }
  __syncthreads();

  // 2. Row pass (along x): blur cols [x0-2, x0+TW+2).
  for (int i = tid; i < 3 * IH * RW; i += NT) {
    int c = i / (IH * RW), r = (i / RW) % IH, q = i % RW;
    float acc = 0.f;
    for (int k = 0; k < 7; ++k) acc = acc + gauss_q6(k) * s_in[c][r][q + k];
    s_row[c][r][q] = acc;
  }
  __syncthreads();

  // 3. Column pass (along y) and the single rounding: blur rows
  //    [y0-2, y0+TH+2).
  for (int i = tid; i < 3 * RH * RW; i += NT) {
    int c = i / (RH * RW), r = (i / RW) % RH, q = i % RW;
    float acc = 0.f;
    for (int k = 0; k < 7; ++k) acc = acc + gauss_q6(k) * s_row[c][r + k][q];
    s_blur[c][r][q] = floorf((acc + 2048.f) * (1.f / 4096.f));
  }
  __syncthreads();

  // 4. Sobel + strongest channel + fastAtan2 + binning over the bin tile
  //    rows [y0-1, y0+TH+1), cols [x0-1, x0+TW+1).  Packed: bin | strong<<3.
  for (int i = tid; i < BH * BW; i += NT) {
    int r = i / BW, q = i % BW;
    int gy = y0 - 1 + r, gx = x0 - 1 + q;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
      s_bin[r][q] = OUTSIDE;
      continue;
    }
    // Neighbours clamped to the blurred image, then mapped into s_blur.
    int yu = max(gy - 1, 0) - (y0 - 2), yd = min(gy + 1, H - 1) - (y0 - 2);
    int xl = max(gx - 1, 0) - (x0 - 2), xr = min(gx + 1, W - 1) - (x0 - 2);
    int yc = gy - (y0 - 2), xc = gx - (x0 - 2);
    float dxs[3], dys[3], mags[3];
    for (int c = 0; c < 3; ++c) {
      const float(*s)[RW] = s_blur[c];
      float sm_l = s[yu][xl] + 2.f * s[yc][xl] + s[yd][xl];
      float sm_r = s[yu][xr] + 2.f * s[yc][xr] + s[yd][xr];
      float d_l = s[yd][xl] - s[yu][xl];
      float d_c = s[yd][xc] - s[yu][xc];
      float d_r = s[yd][xr] - s[yu][xr];
      dxs[c] = sm_r - sm_l;
      dys[c] = d_l + 2.f * d_c + d_r;
      mags[c] = dxs[c] * dxs[c] + dys[c] * dys[c];
    }
    float mag2 = fmaxf(fmaxf(mags[0], mags[1]), mags[2]);
    float dx = dxs[2], dy = dys[2];
    if (mags[1] == mag2) { dx = dxs[1]; dy = dys[1]; }
    if (mags[0] == mag2) { dx = dxs[0]; dy = dys[0]; }

    float ax = fabsf(dx), ay = fabsf(dy);
    bool big = ax >= ay;
    float num = big ? ay : ax;
    float den = (big ? ax : ay) + DBL_EPS_F;
    float cr = num / den;
    float c2 = cr * cr;
    float a = (((P7 * c2 + P5) * c2 + P3) * c2 + P1) * cr;
    a = big ? a : 90.f - a;
    a = dx < 0.f ? 180.f - a : a;
    a = dy < 0.f ? 360.f - a : a;
    int bin = (static_cast<int>(rintf(a * BIN_SCALE)) & 15) & 7;
    bool interior = gy >= 1 && gy <= H - 2 && gx >= 1 && gx <= W - 2;
    if (!interior) bin = 0;  // border pixels vote as bin 0
    s_bin[r][q] = static_cast<uint8_t>(bin | ((mag2 > weak2) ? 8 : 0));
  }
  __syncthreads();

  // 5. 3x3 vote with nibble-packed counters; gate and emit.
  const int ty = threadIdx.y, tx = threadIdx.x;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= H || gx >= W) return;
  uint32_t acc = 0u;
  for (int dr = 0; dr < 3; ++dr)
    for (int dc = 0; dc < 3; ++dc) {
      uint8_t v = s_bin[ty + dr][tx + dc];
      if (v != OUTSIDE) acc += 1u << (4 * (v & 7));
    }
  uint32_t best = acc & 15u;
  int win = 0;
  for (int o = 1; o < 8; ++o) {
    uint32_t vo = (acc >> (4 * o)) & 15u;
    if (vo > best) { best = vo; win = o; }
  }
  uint8_t center = s_bin[ty + 1][tx + 1];
  bool interior = gy >= 1 && gy <= H - 2 && gx >= 1 && gx <= W - 2;
  bool ok = (center & 8) && best >= 5u && interior;
  out[((size_t)b * H + gy) * W + gx] = ok ? static_cast<uint8_t>(1u << win) : 0;
}

}  // namespace

extern "C" int lpe_quantize_cg(const void* img, int img_is_f32, void* out,
                               int B, int H, int W, float weak2, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(TW, TH);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_is_f32)
    quantize_cg_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(img), static_cast<uint8_t*>(out), H, W, weak2);
  else
    quantize_cg_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(img), static_cast<uint8_t*>(out), H, W, weak2);
  return static_cast<int>(cudaGetLastError());
}
