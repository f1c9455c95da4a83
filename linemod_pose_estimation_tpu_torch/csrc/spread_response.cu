// Kernel K2: orientation spread + graded response maps, bit-exact.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_kernels.py::
// spread_response_batched (kernel body _spread_response_kernel +
// _graded_response_planes).  Plain version: ops/features.py
// orientation_spread + response_maps.
//
// What bounds it on the H100: device-memory bytes — it reads a (B, H, W)
// u8 bitmask and writes (B, 8, H, W) u8 responses, with trivial integer
// work per pixel.  As separate ops the T*T shifted ORs and 8 LUT planes
// are ~T*T + 40 passes over the frame.  Design: one thread per output
// pixel ORs its T x T window straight from the input (neighbouring
// threads read neighbouring bytes, so the window re-reads hit L1/L2) and
// writes the 8 planes once: one read + one write of device memory.
//
// Response: with s_d the circular radius-d OR-dilation of the spread
// byte over the 8 bins, response[o] = sum_{d=0..3} bit_o(s_d) = 4 minus
// the circular distance from o to the nearest set bit; the 8 responses
// are built at once as nibbles of one uint32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t dil1(uint32_t x) {
  uint32_t rol = ((x << 1) | (x >> 7)) & 255u;
  uint32_t ror = ((x >> 1) | (x << 7)) & 255u;
  return x | rol | ror;
}

__device__ __forceinline__ uint32_t nib(uint32_t x) {  // bit o -> bit 4o
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

__global__ void spread_response_kernel(const uint8_t* __restrict__ quant,
                                       uint8_t* __restrict__ out,
                                       int H, int W, int T) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;
  const uint8_t* q = quant + (size_t)b * H * W;
  uint32_t s = 0u;
  const int ye = min(y + T, H), xe = min(x + T, W);  // zero past the edge
  for (int yy = y; yy < ye; ++yy)
    for (int xx = x; xx < xe; ++xx) s |= q[(size_t)yy * W + xx];
  uint32_t s1 = dil1(s), s2 = dil1(s1), s3 = dil1(s2);
  uint32_t packed = nib(s) + nib(s1) + nib(s2) + nib(s3);
  const size_t plane = (size_t)H * W;
  uint8_t* o = out + (size_t)b * 8 * plane + (size_t)y * W + x;
  for (int k = 0; k < 8; ++k)
    o[k * plane] = static_cast<uint8_t>((packed >> (4 * k)) & 15u);
}

}  // namespace

extern "C" int lpe_spread_response(const void* quant, void* out, int B, int H,
                                   int W, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 block(128);
  dim3 grid((W + 127) / 128, H, B);
  spread_response_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(quant), static_cast<uint8_t*>(out), H, W, T);
  return static_cast<int>(cudaGetLastError());
}
