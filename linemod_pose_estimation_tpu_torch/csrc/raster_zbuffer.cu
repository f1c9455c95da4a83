// Kernel K4: triangle z-buffer with flat shade, bit-exact.
//
// Replaces linemod_pose_estimation_tpu/ops/pallas_raster.py::
// raster_zbuffer_pallas (what it computes is the XLA scan of
// models/renderer.py::render).  Plain version and the shared per-triangle
// precompute: ops/raster.py (raster_zbuffer_plain, triangle_coefficients).
//
// What bounds it on the H100: neither device memory nor arithmetic in
// bulk — the coefficient table is ~170 KB per pose, each pixel is written
// once, and only a few (pixel, triangle) pairs per pixel pass the
// triangles' bounding boxes.  The time goes to finding, for each 16 x 16
// tile, the few dozen triangles that reach it among ~2000, and then to the
// per-pixel work of the busiest tiles: one block on one SM rasterizes a
// tile, and where a face of the mesh is seen edge-on ~130 triangles reach
// one tile, three times the average.  Design, three launches on one stream:
//
//   1. clear: zero the per-tile counters;
//   2. bin: one warp per (pose, triangle), its lanes over the tiles the
//      triangle's grown bbox may reach; each tile it meets gets the
//      triangle's index appended to its list (atomics; up to CAP indices a
//      tile, the count goes on past CAP);
//   3. raster: one block of 16 warps per tile of one pose.  A tile no
//      triangle reaches writes inf / 0.  Otherwise the block takes its
//      candidates in rounds of CAP — the tile's list, or, for a tile whose
//      count overflowed CAP, every triangle in index order, culled in
//      parallel on its 5 cull columns and compacted with a ballot — and
//      gathers their 21 coefficients into shared memory.  Each warp then
//      takes whole triangles, its lanes the pixels of the triangle's bbox
//      within the tile (a triangle is ~8 pixels across: a warp that swept
//      all 256 pixels for each triangle would find work on a few lanes),
//      and merges each hit into the tile's per-pixel key in shared memory
//      with one 64-bit atomicMin.
//
// Exactness: the key is (depth as an order-preserving integer) << 32 |
// triangle index, so its minimum is the smallest depth and, on an exact
// tie, the smallest index: what the scan keeps (argmin within a chunk,
// first index on ties; strict < across chunks), whatever order the lists
// and the warps take the triangles in.  A pixel keeps +inf and shade 0
// until a hit with a finite depth, as in the scan.  The tile test keeps a
// live triangle whose grown bbox meets the tile's pixel-centre range, and
// a warp's pixel range is one pixel wider than the bbox; the per-pixel
// test then applies the bbox exactly, so nothing is dropped that could
// cover a pixel (a NaN bound covers none).  The per-pixel expressions are
// the reference's, in its operation order, built with -fmad=false and IEEE
// division (no fast-math), so depth and shade equal the plain version bit
// for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Column order of ops/raster.py::COEFS.
enum {
  UX0, UY0, UX1, UY1, UX2, UY2, IZ0, IZ1, IZ2, AREA, GL0, GL1, GL2,
  XMIN, XMAX, YMIN, YMAX, ZTMIN, ZTMAX, SHADE, LIVE, NCOEF
};

constexpr int TILE = 16;          // ops/raster.py::TILE
constexpr int NPIX = TILE * TILE;
constexpr int NT = 512;           // raster threads a block: 16 warps
constexpr int NW = NT / 32;
constexpr int CAP = 256;          // ops/raster.py::BIN_CAP; also a cull round
constexpr unsigned long long EMPTY = ~0ull;

struct Box {
  float x0, x1, y0, y1;
};

// Pixel-centre range of the in-image pixels of tile (tx, ty).
__device__ __forceinline__ Box tile_box(int tx, int ty, int H, int W) {
  return {static_cast<float>(tx * TILE) + 0.5f,
          static_cast<float>(min(tx * TILE + TILE, W) - 1) + 0.5f,
          static_cast<float>(ty * TILE) + 0.5f,
          static_cast<float>(min(ty * TILE + TILE, H) - 1) + 0.5f};
}

__device__ __forceinline__ bool meets(float live, float xmin, float xmax, float ymin,
                                      float ymax, Box b) {
  return live > 0.5f && xmax >= b.x0 && xmin <= b.x1 && ymax >= b.y0 && ymin <= b.y1;
}

// A tile index range that holds every tile a bound [lo, hi] may meet (one
// tile of margin for rounding); NaN and infinite bounds clamp into [0, n).
__device__ __forceinline__ int tile_lo(float lo, int n) {
  const float f = fminf(fmaxf((lo - 0.5f) / TILE, -1.0f), static_cast<float>(n));
  return max(static_cast<int>(floorf(f)) - 1, 0);
}
__device__ __forceinline__ int tile_hi(float hi, int n) {
  const float f = fminf(fmaxf((hi - 0.5f) / TILE, -1.0f), static_cast<float>(n));
  return min(static_cast<int>(floorf(f)) + 1, n - 1);
}

// floor(v) clamped into [lo, hi] (NaN gives lo); `up` takes ceil instead.
__device__ __forceinline__ int clamp_px(float v, bool up, int lo, int hi) {
  const float f = up ? ceilf(v) : floorf(v);
  return static_cast<int>(fminf(fmaxf(f, static_cast<float>(lo)), static_cast<float>(hi)));
}

// Float bits mapped so that unsigned order is float order.
__device__ __forceinline__ unsigned order_bits(float z) {
  const unsigned u = __float_as_uint(z);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float from_order_bits(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

__global__ void raster_zbuffer_clear_kernel(int* __restrict__ counts, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) counts[i] = 0;
}

__global__ void raster_zbuffer_bin_kernel(const float* __restrict__ coefs,
                                          int* __restrict__ counts,
                                          int* __restrict__ lists, int Tn, int H,
                                          int W, int ntx, int nty) {
  const int i = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);  // triangle
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.y;
  if (i >= Tn) return;
  const float* c = coefs + (static_cast<size_t>(p) * Tn + i) * NCOEF;
  const float live = c[LIVE];
  if (!(live > 0.5f)) return;
  const float xmin = c[XMIN], xmax = c[XMAX], ymin = c[YMIN], ymax = c[YMAX];
  const int x_lo = tile_lo(xmin, ntx), y_lo = tile_lo(ymin, nty);
  const int nx = tile_hi(xmax, ntx) - x_lo + 1, ny = tile_hi(ymax, nty) - y_lo + 1;
  if (nx <= 0 || ny <= 0) return;
  for (int q = lane; q < nx * ny; q += 32) {
    const int ty = y_lo + q / nx, tx = x_lo + q % nx;
    if (!meets(live, xmin, xmax, ymin, ymax, tile_box(tx, ty, H, W))) continue;
    const int t = (p * nty + ty) * ntx + tx;
    const int slot = atomicAdd(counts + t, 1);
    if (slot < CAP) lists[static_cast<size_t>(t) * CAP + slot] = i;
  }
}

// One warp rasterizes triangle `id` (coefficients `c`) over the pixels of
// its bbox inside the tile's image part [x0, xe) x [y0, ye).
__device__ __forceinline__ void raster_triangle(const float* c, unsigned id, int x0,
                                                int y0, int xe, int ye, int lane,
                                                unsigned long long* s_key) {
  const float xmin = c[XMIN], xmax = c[XMAX], ymin = c[YMIN], ymax = c[YMAX];
  // Pixel x has centre x + 0.5 in [xmin, xmax] only if floor(xmin - 0.5)
  // <= x <= ceil(xmax - 0.5): a superset, the exact test follows.
  const int xa = clamp_px(xmin - 0.5f, false, x0, xe - 1);
  const int xb = clamp_px(xmax - 0.5f, true, x0, xe - 1);
  const int ya = clamp_px(ymin - 0.5f, false, y0, ye - 1);
  const int yb = clamp_px(ymax - 0.5f, true, y0, ye - 1);
  const int w = xb - xa + 1, n = w * (yb - ya + 1);
  if (w <= 0 || n <= 0) return;
  const float ux0 = c[UX0], uy0 = c[UY0], ux1 = c[UX1], uy1 = c[UY1];
  const float ux2 = c[UX2], uy2 = c[UY2];
  const float gl0 = c[GL0], gl1 = c[GL1], gl2 = c[GL2], a = c[AREA];
  const float iz0 = c[IZ0], iz1 = c[IZ1], iz2 = c[IZ2];
  const float ztmin = c[ZTMIN], ztmax = c[ZTMAX];
  const float rw = 1.0f / static_cast<float>(w);
  for (int i = lane; i < n; i += 32) {
    // i / w for i < 256, w <= 16: (i + 0.5) / w is >= 1/32 away from an
    // integer, far beyond the product's rounding error.
    const int r = static_cast<int>((static_cast<float>(i) + 0.5f) * rw);
    const int x = xa + (i - r * w), y = ya + r;
    const float px = static_cast<float>(x) + 0.5f;
    const float py = static_cast<float>(y) + 0.5f;
    const bool inb = (px >= xmin) && (px <= xmax) && (py >= ymin) && (py <= ymax);
    if (!inb) continue;
    const float w0 = (ux2 - ux1) * (py - uy1) - (uy2 - uy1) * (px - ux1);
    const float w1 = (ux0 - ux2) * (py - uy2) - (uy0 - uy2) * (px - ux2);
    const float w2 = (ux1 - ux0) * (py - uy0) - (uy1 - uy0) * (px - ux0);
    const bool pos = (w0 >= -gl0) && (w1 >= -gl1) && (w2 >= -gl2);
    const bool neg = (w0 <= gl0) && (w1 <= gl1) && (w2 <= gl2);
    if (!(pos || neg)) continue;
    const float inv_z = (w0 / a) * iz0 + (w1 / a) * iz1 + (w2 / a) * iz2;
    if (!(inv_z > 1e-9f)) continue;
    float zp = 1.0f / fmaxf(inv_z, 1e-9f);
    zp = fminf(fmaxf(zp, ztmin), ztmax);
    if (!(zp < CUDART_INF_F)) continue;  // an infinite depth never replaces the empty +inf
    atomicMin(s_key + (y - y0) * TILE + (x - x0),
              static_cast<unsigned long long>(order_bits(zp)) << 32 | id);
  }
}

__global__ void __launch_bounds__(NT)
raster_zbuffer_kernel(const float* __restrict__ coefs, const int* __restrict__ counts,
                      const int* __restrict__ lists, float* __restrict__ zbuf,
                      float* __restrict__ sbuf, int Tn, int H, int W, int ntx,
                      int nty) {
  __shared__ float s_tri[CAP * NCOEF];              // the round's triangles
  __shared__ int s_idx[CAP];                        // their indices
  __shared__ unsigned long long s_key[NPIX];        // per pixel: depth, index
  __shared__ int s_warp[CAP / 32];                  // survivors per culling warp
  const int tx = blockIdx.x, ty = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = tx * TILE, y0 = ty * TILE;
  const int xe = min(x0 + TILE, W), ye = min(y0 + TILE, H);
  const int tile = (p * nty + ty) * ntx + tx;
  const int binned = counts[tile];
  const bool listed = binned <= CAP;
  const int n_cand = listed ? binned : Tn;  // an overflowed list: scan them all
  const Box box = tile_box(tx, ty, H, W);
  const float* c_pose = coefs + static_cast<size_t>(p) * Tn * NCOEF;
  const int* list = lists + static_cast<size_t>(tile) * CAP;
  if (tid < NPIX) s_key[tid] = EMPTY;

  for (int base = 0; base < n_cand; base += CAP) {
    // This round's candidates, culled (an overflowed tile) and compacted.
    const int j = base + tid;
    int idx = 0;
    bool keep = false;
    if (tid < CAP && j < n_cand) {
      if (listed) {
        idx = list[j];
        keep = true;
      } else {
        const float* c = c_pose + static_cast<size_t>(j) * NCOEF;
        idx = j;
        keep = meets(c[LIVE], c[XMIN], c[XMAX], c[YMIN], c[YMAX], box);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    __syncthreads();  // the previous round is done with s_tri, s_idx
    if (lane == 0 && warp < CAP / 32) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < CAP / 32; ++w) {
      const int cw = s_warp[w];
      off += w < warp ? cw : 0;
      n += cw;
    }
    if (keep) s_idx[off + __popc(ballot & ((1u << lane) - 1u))] = idx;
    __syncthreads();
    for (int i = tid; i < n * NCOEF; i += NT) {
      const int r = i / NCOEF;
      s_tri[i] = c_pose[static_cast<size_t>(s_idx[r]) * NCOEF + (i - r * NCOEF)];
    }
    __syncthreads();
    for (int k = warp; k < n; k += NW)
      raster_triangle(s_tri + k * NCOEF, static_cast<unsigned>(s_idx[k]), x0, y0, xe,
                      ye, lane, s_key);
  }
  __syncthreads();
  if (tid < NPIX) {
    const int x = x0 + (tid % TILE), y = y0 + tid / TILE;
    if (x < W && y < H) {
      const unsigned long long key = s_key[tid];
      const size_t o = (static_cast<size_t>(p) * H + y) * W + x;
      zbuf[o] = key == EMPTY ? CUDART_INF_F : from_order_bits(static_cast<unsigned>(key >> 32));
      sbuf[o] = key == EMPTY ? 0.0f
                             : c_pose[static_cast<size_t>(key & 0xffffffffu) * NCOEF + SHADE];
    }
  }
}

}  // namespace

// scratch: int32 [counts (P * tiles) | lists (P * tiles * CAP)], from
// ops/raster.py::raster_zbuffer.
extern "C" int lpe_raster_zbuffer(const void* coefs, void* zbuf, void* sbuf,
                                  void* scratch, int P, int Tn, int H, int W,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntx = (W + TILE - 1) / TILE, nty = (H + TILE - 1) / TILE;
  const int ntiles = P * ntx * nty;
  int* counts = static_cast<int*>(scratch);
  int* lists = counts + ntiles;
  const float* c = static_cast<const float*>(coefs);
  raster_zbuffer_clear_kernel<<<(ntiles + 255) / 256, 256, 0, st>>>(counts, ntiles);
  if (Tn > 0) {
    raster_zbuffer_bin_kernel<<<dim3((Tn + 7) / 8, P), 256, 0, st>>>(c, counts, lists, Tn,
                                                                      H, W, ntx, nty);
  }
  raster_zbuffer_kernel<<<dim3(ntx, nty, P), NT, 0, st>>>(
      c, counts, lists, static_cast<float*>(zbuf), static_cast<float*>(sbuf), Tn, H, W,
      ntx, nty);
  return static_cast<int>(cudaGetLastError());
}
