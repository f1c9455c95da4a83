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
// with zeros below and to the right).
//
// What bounds it on the H100: not device memory (the windows of 4096
// candidates touch ~10 MB of a 157 MB response stack and write 9 MB) but
// the gather between L2 and the SMs.  A feature's read is a window x window
// byte tile at an arbitrary byte offset of one plane: K * F * window rows
// of `window` bytes (~12M rows of 24 bytes at K = 4096, F ~ 126 live), each
// in its own cache line and in one or two 32-byte sectors, far more rows
// than L1 can keep between the reads that share them.  So every row costs
// L1 a pass and L2 a sector or two (~0.7 GB of sectors for the 10 MB), and
// the threads must keep enough rows in flight to cover L2's latency.
//
// Design: one block per candidate (and per tile of its window when the
// window needs more than MAX_NT threads).  Eight lanes own one row segment
// of SEG = 28 cells: lane q loads the q-th aligned 32-bit word that covers
// the segment, takes its neighbour's word by shuffle, funnel-shifts the two
// by the read's byte misalignment and so holds the 4 bytes of its 4 cells
// (lanes 0-6; lane 7 only supplies the last word).  One warp-wide load
// thus fetches 4 whole rows, one L1 pass each, and a 24-wide window costs
// one load, one shuffle, one shift and four dp4a (each adds one byte to an
// int32 sum, so any u8 is exact and nothing needs flushing) per thread and
// feature.  The block stages the candidate's live features once per round
// of CHUNK (plane offset with the anchor folded in, and the window rows and
// cells that read inside the frame), and decides per round, block-uniform:
// when every feature reads inside the frame at every cell, and the words
// past the last cell still lie in the tensor, the walk takes UNROLL
// features a step with no mask and no branch, all loads started before the
// first sum.  Otherwise (windows over the frame's edges, offsets or
// anchors that leave it) a masked walk loads only words that hold a byte
// read inside the frame and zeroes the other bytes one by one, since a
// word past a row's end holds the next row's bytes.  Words are addressed
// by the byte address, so any W and any data pointer work; when the
// tensor's storage does not cover the aligned words around it (words_ok =
// 0) the masked walk assembles each word from single in-tensor bytes.
// Integer sums only, so the result is bitwise the plain version's.  The
// TPU kernel's 32/128 alignment residuals, power-of-two lane width, SMEM
// chunking of the candidate axis, double-buffered patch DMA and lane rolls
// are TPU layout workarounds and are not carried over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NT = 512;  // threads a block; a larger window takes tiles
constexpr int CHUNK = 256;   // feature slots staged per round
constexpr int UNROLL = 8;    // features a step of the unmasked walk
constexpr int LANES = 8;     // lanes a row segment
constexpr int SEG = 28;      // cells a row segment: lanes 0-6 own 4 each
constexpr unsigned FULL = 0xffffffffu;

// Adds the four bytes of v to four int32 sums.
__device__ __forceinline__ void add_bytes(unsigned v, unsigned (&acc)[4]) {
  acc[0] = __dp4a(v, 0x00000001u, acc[0]);
  acc[1] = __dp4a(v, 0x00000100u, acc[1]);
  acc[2] = __dp4a(v, 0x00010000u, acc[2]);
  acc[3] = __dp4a(v, 0x01000000u, acc[3]);
}

// 0xff in byte c for each c in [a, b) and [0, 4).
__device__ __forceinline__ unsigned byte_mask(int a, int b) {
  a = max(a, 0);
  b = min(b, 4);
  if (b <= a) return 0u;
  const unsigned m = b - a == 4 ? FULL : (1u << (8 * (b - a))) - 1u;
  return m << (8 * a);
}

// An aligned word that holds at least one byte of the tensor.
struct WordLoad {
  __device__ static unsigned load(const uint32_t* p, const uint8_t*, const uint8_t*) {
    return __ldg(p);
  }
};

// The same word from its bytes in [beg, end), zeros for the others.
struct ByteLoad {
  __device__ static unsigned load(const uint32_t* p, const uint8_t* beg,
                                  const uint8_t* end) {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
    unsigned v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (b + i >= beg && b + i < end) v |= static_cast<unsigned>(__ldg(b + i)) << (8 * i);
    return v;
  }
};

struct Staged {
  int off[CHUNK];  // offset in the frame of the window's first cell
  int y0[CHUNK];   // window rows [y0, y1) read inside the frame
  int y1[CHUNK];
  int x0[CHUNK];   // window cells [x0, x1) of a row do
  int x1[CHUNK];
};

// The masked walk over m staged features: loads only words that hold a
// byte read inside the frame, and zeroes every other byte.
template <typename Load>
__device__ __forceinline__ void walk_masked(const Staged& s, int m, const uint32_t* tb,
                                            int tr, int q, bool live, int wy, int c0,
                                            int ncell, const uint8_t* beg,
                                            const uint8_t* end, unsigned (&acc)[4]) {
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const int x = s.off[j] + tr;  // byte offset from the lane's word base
    const int mis = x & 3;
    const bool row = live && wy >= s.y0[j] && wy < s.y1[j];
    const int lo = max(s.x0[j] - c0, 0), hi = min(s.x1[j] - c0, ncell);
    const bool ld = row && lo < hi && 4 * q + 4 > mis + lo && 4 * q < mis + hi;
    const unsigned w = ld ? Load::load(tb + (x >> 2), beg, end) : 0u;
    const unsigned nx = __shfl_down_sync(FULL, w, 1, LANES);
    const unsigned v = __funnelshift_r(w, nx, static_cast<unsigned>(x) << 3);
    add_bytes(row ? v & byte_mask(lo - 4 * q, hi - 4 * q) : 0u, acc);
  }
}

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
                     int B, int C, int H, int W, int F, int window, int segs,
                     int words_ok) {
  __shared__ Staged s;

  const int k = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const int q = t & (LANES - 1);
  // This lane's row segment: window row wy, cells [c0, c0 + ncell).  The
  // lanes past the window's last segment repeat segment 0 and store nothing.
  int g = blockIdx.y * (nt / LANES) + t / LANES;
  const bool live = g < window * segs;
  if (!live) g = 0;
  const int wy = g / segs, c0 = (g % segs) * SEG;
  const int ncell = min(SEG, window - c0);
  const int ay = anchor_y[k], ax = anchor_x[k];
  const long long chw = static_cast<long long>(C) * H * W;
  const long long fbyte = static_cast<long long>(frame[k]) * chw;
  const long long total = static_cast<long long>(B) * chw;
  // The segment's first cell for a feature at offset 0 of the frame, split
  // into an aligned word pointer (this lane's word) and the residual.
  const uintptr_t cell = reinterpret_cast<uintptr_t>(R) + fbyte
                         + static_cast<long long>(wy) * W + c0;
  const int tr = static_cast<int>(cell & 3);
  const uint32_t* tb = reinterpret_cast<const uint32_t*>(cell - tr) + q;
  // The bytes past a window's last cell that the unmasked walk may load.
  const long long reach = static_cast<long long>(window - 1) * W + segs * SEG + 3;
  const size_t fbase = static_cast<size_t>(k) * F;
  const int n = min(nf[k], F);
  unsigned acc[4] = {0u, 0u, 0u, 0u};
  for (int f0 = 0; f0 < n; f0 += CHUNK) {
    const int m = min(CHUNK, n - f0);
    __syncthreads();  // the previous round's walk is done with s
    bool ok = true;
    for (int j = t; j < m; j += nt) {
      const size_t fi = fbase + f0 + j;
      const int ori = min(max(oris[fi], 0), C - 1);  // as the plain version
      const int y = ay + dys[fi], x = ax + dxs[fi];
      // The wrapper keeps a frame below 2^31 bytes, so the offset of every
      // byte that is read fits; an offset that does not is never used.
      const long long off = (static_cast<long long>(ori) * H + y) * W + x;
      s.off[j] = static_cast<int>(off);
      s.y0[j] = max(-y, 0);
      s.y1[j] = min(H - y, window);
      s.x0[j] = max(-x, 0);
      s.x1[j] = min(W - x, window);
      ok = ok && y >= 0 && x >= 0 && y + window <= H && x + window <= W
           && fbyte + off + reach < total;
    }
    // Block-uniform: every feature of the round reads inside the frame at
    // every cell, and every word the lanes load lies in the tensor.
    const bool inside = __syncthreads_and(ok) && words_ok;
    if (inside) {
      const int m_even = m & ~(UNROLL - 1);
      for (int j = 0; j < m_even; j += UNROLL) {
        int x[UNROLL];
        unsigned w[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          x[u] = s.off[j + u] + tr;
          w[u] = __ldg(tb + (x[u] >> 2));
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const unsigned nx = __shfl_down_sync(FULL, w[u], 1, LANES);
          add_bytes(__funnelshift_r(w[u], nx, static_cast<unsigned>(x[u]) << 3), acc);
        }
      }
      for (int j = m_even; j < m; ++j) {
        const int x = s.off[j] + tr;
        const unsigned w = __ldg(tb + (x >> 2));
        const unsigned nx = __shfl_down_sync(FULL, w, 1, LANES);
        add_bytes(__funnelshift_r(w, nx, static_cast<unsigned>(x) << 3), acc);
      }
    } else if (words_ok) {
      walk_masked<WordLoad>(s, m, tb, tr, q, live, wy, c0, ncell, R, R + total, acc);
    } else {
      walk_masked<ByteLoad>(s, m, tb, tr, q, live, wy, c0, ncell, R, R + total, acc);
    }
  }
  if (!live || 4 * q >= ncell) return;
  int32_t* o = out + (static_cast<size_t>(k) * window + wy) * window + c0 + 4 * q;
  if ((window & 3) == 0) {  // whole quads, 16-byte aligned
    *reinterpret_cast<int4*>(o) = make_int4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < ncell) o[c] = static_cast<int32_t>(acc[c]);
  }
}

}  // namespace

extern "C" int lpe_refine_scores(const void* R, const void* oris,
                                 const void* dys, const void* dxs,
                                 const void* nf, const void* anchor_y,
                                 const void* anchor_x, const void* frame,
                                 void* out, int B, int C, int H, int W, int K,
                                 int F, int window, int words_ok, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One row segment per LANES threads; a window past MAX_NT threads is cut
  // into equal tiles of whole warps along the grid's second axis.
  const int segs = (window + SEG - 1) / SEG;
  const long long groups = static_cast<long long>(window) * segs;
  const long long tiles = (groups * LANES + MAX_NT - 1) / MAX_NT;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per_tile = static_cast<int>((groups + tiles - 1) / tiles);
  const int nt = (per_tile * LANES + 31) / 32 * 32;
  refine_scores_kernel<<<dim3(K, static_cast<unsigned>(tiles)), nt, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(R), static_cast<const int32_t*>(oris),
      static_cast<const int32_t*>(dys), static_cast<const int32_t*>(dxs),
      static_cast<const int32_t*>(nf), static_cast<const int32_t*>(anchor_y),
      static_cast<const int32_t*>(anchor_x), static_cast<const int32_t*>(frame),
      static_cast<int32_t*>(out), B, C, H, W, F, window, segs, words_ok);
  return static_cast<int>(cudaGetLastError());
}
