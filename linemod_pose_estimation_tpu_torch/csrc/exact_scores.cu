// Kernel XS: the exact coarse scorer, cv::linemod's linearized-memory
// gather-sum, equal bit for bit to the one-hot int8 GEMM it replaces.
//
// Replaces no Pallas kernel: the reference scores with an XLA dot_general
// over one-hot count weights (linemod_pose_estimation_tpu/ops/match.py::
// build_gemm_weights and the coarse_scores_gemm* functions), which is how
// a TPU's MXU wants the sum.  Each template column of those weights holds
// at most one count per live feature among its C*T*T*Kc*Kc rows, so the
// GEMM does about a thousand times the useful additions, behind an int8
// im2col of every scored row.  Here the score of row (frame b, cell (py,
// px)) and template n is the sum, over n's table entries e (the GEMM row
// ((qy*Kc + qx)*C + ori)*T*T + ry*T + rx of each live feature, duplicates
// kept), of one response byte: lane e % (C*T*T) of cell (py + qy, px +
// qx).  The sums are integers, so any order gives the GEMM's bits.
//
// One entry point, two launch geometries, chosen by the rows asked for:
//
// Every cell of B frames (the exhaustive scorer; row b*Hc*Wc + py*Wc + px):
// planes lane-major, (B, L, Hp, XS) u8 with L = C*T*T, zero past (Hc, Wc).
// A block takes one frame, a band of BH cell rows and TT = 64 templates,
// WT = 4 a warp; lane (r, s) of a warp holds cell row r, columns [20 s,
// 20 s + 20) as SEG = 5 words of 4 byte-wide sums.  The band's plane rows
// [y0, y0 + BH + Kc - 1) pass through shared memory LS lanes at a time,
// double-buffered by cp.async.  For each staged feature a lane reads 6
// words at the feature's cell shift, funnel-shifts them by its byte
// misalignment qx % 4 and adds 4 cells a word: the row pitch XS makes the
// warp's 32 reads fall in 32 banks.  Responses are at most 4, so a byte
// sum takes 63 features before it spills into 16-bit pairs.  The band's
// (cells, 64) tile leaves through shared memory, so the (M, N) store runs
// along templates.  Blocks run frame-major, so each frame's planes stay
// in L2 while its blocks stage them.
//
// A row list (the pooled tiers' survivors): planes lanes-last, (B, Hc +
// Kc, Wc + Kc, L) u8.  A block takes two rows and stages their Kc x Kc
// cells of L lanes in shared memory in the GEMM's row order, one byte a
// GEMM row holding both rows' responses as nibbles, so a table entry is
// the byte's address there and one read serves both rows; a thread sums
// its templates' entries, read as int4s of a template-minor copy of the
// table (coalesced), with dead entries (-1) pointed at a zero byte past
// the patch.  What bounds it is the table's traffic from L2 (5.4 MB a row
// pair at 10,624 templates) and the shared-memory reads' bank conflicts.
// A patch larger than shared memory is staged a range of cells at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// n / d for 0 <= n < 2^31 by a multiply and a shift (PyTorch's IntDivider).
struct FastDiv {
  uint32_t m, s;
};

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t m = ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1;
  return {static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, FastDiv f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Every cell of B frames
// ---------------------------------------------------------------------------

constexpr int DTH = 512;               // threads a block
constexpr int DWARPS = DTH / 32;
constexpr int WT = 4;                  // templates a warp
constexpr int TT = DWARPS * WT;        // templates a block
constexpr int TTP = TT + 1;            // the output tile's row pitch (words)
constexpr int SEG = 5;                 // words (4 cells each) a lane holds
constexpr int FLUSH = 63;              // features a byte sum takes: 63 * 4 < 256
constexpr uint32_t DEAD = 0xFFFFFFFFu; // an entry that matches no stage
constexpr uint32_t OFF_MASK = (1u << 18) - 1;

struct DenseArgs {
  const uint8_t* planes;  // (B, L, Hp, XS)
  const int32_t* table;   // (N, F)
  int32_t* out;           // (B * Hc * Wc, N)
  int L, Hp, XS, Hc, Wc, Kc, N, F;
  int BH, segs, BHs, LS, nstages, stage_bytes;
  FastDiv divL, divKc, divLS;
};

// Stage s: lanes [s * LS, min(L, (s + 1) * LS)) of frame b, plane rows
// [y0, y0 + BHs), each lane's rows contiguous at dst + (lane - s * LS) *
// BHs * XS.  A warp copies a lane's rows, 8 bytes a thread.
__device__ __forceinline__ void stage_in(const DenseArgs& a, int b, int y0, int s,
                                         uint8_t* dst) {
  const int l0 = s * a.LS;
  const int nl = min(a.LS, a.L - l0);
  const int chunk = a.BHs * a.XS;
  const int words = chunk >> 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < nl; l += DWARPS) {
    const uint8_t* src =
        a.planes + ((static_cast<size_t>(b) * a.L + l0 + l) * a.Hp + y0) * a.XS;
    uint8_t* d = dst + l * chunk;
    for (int w = lane; w < words; w += 32) cp_async8(d + 8 * w, src + 8 * w);
  }
}

__device__ __forceinline__ void spill(uint32_t (&a8)[SEG], uint32_t (&lo)[SEG],
                                      uint32_t (&hi)[SEG]) {
#pragma unroll
  for (int k = 0; k < SEG; ++k) {
    lo[k] += a8[k] & 0x00FF00FFu;          // cells 0 and 2 of the word
    hi[k] += (a8[k] >> 8) & 0x00FF00FFu;   // cells 1 and 3
    a8[k] = 0;
  }
}

template <int FJ>
__global__ void __launch_bounds__(DTH, 1) exact_dense_kernel(const DenseArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * TT, y0 = blockIdx.y * a.BH, b = blockIdx.z;
  const int XSW = a.XS >> 2;

  // The warp's templates' entries, lane holding slots lane + 32 j, decoded
  // to (stage << 20) | (qx % 4 << 18) | the word offset of the feature's
  // first cell in its stage buffer.
  uint32_t ent[WT][FJ];
  bool live = false;
#pragma unroll
  for (int t = 0; t < WT; ++t) {
    const int n = n0 + warp * WT + t;
#pragma unroll
    for (int j = 0; j < FJ; ++j) {
      const int f = lane + 32 * j;
      int e = -1;
      if (n < a.N && f < a.F) e = __ldg(a.table + static_cast<size_t>(n) * a.F + f);
      uint32_t v = DEAD;
      if (e >= 0) {
        const uint32_t cell = fdiv(e, a.divL), ln = e - cell * a.L;
        const uint32_t qy = fdiv(cell, a.divKc), qx = cell - qy * a.Kc;
        const uint32_t s = fdiv(ln, a.divLS), li = ln - s * a.LS;
        v = (s << 20) | ((qx & 3u) << 18) | ((li * a.BHs + qy) * XSW + (qx >> 2));
        live = true;
      }
      ent[t][j] = v;
    }
  }

  const int rows = min(a.BH, a.Hc - y0);
  const size_t m0 = (static_cast<size_t>(b) * a.Hc + y0) * a.Wc;
  const int ncols = min(TT, a.N - n0);
  if (!__syncthreads_or(live)) {  // only dead templates: their scores are 0
    for (int i = threadIdx.x; i < rows * a.Wc * TT; i += DTH) {
      const int pl = i / TT, tl = i % TT;
      if (tl < ncols) a.out[(m0 + pl) * a.N + n0 + tl] = 0;
    }
    return;
  }

  const int r = lane / a.segs, sg = lane - r * a.segs;
  const bool active = r < a.BH;
  const int pos_off = active ? r * XSW + sg * SEG : 0;

  uint32_t a8[WT][SEG], lo[WT][SEG], hi[WT][SEG];
  int cnt[WT];
#pragma unroll
  for (int t = 0; t < WT; ++t) {
    cnt[t] = 0;
#pragma unroll
    for (int k = 0; k < SEG; ++k) a8[t][k] = lo[t][k] = hi[t][k] = 0;
  }

  uint8_t* const buf0 = smem;
  uint8_t* const buf1 = smem + a.stage_bytes;
  stage_in(a, b, y0, 0, buf0);
  cp_commit();
  for (int s = 0; s < a.nstages; ++s) {
    if (s + 1 < a.nstages) {
      stage_in(a, b, y0, s + 1, (s & 1) ? buf0 : buf1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t* sw = reinterpret_cast<const uint32_t*>((s & 1) ? buf1 : buf0) + pos_off;
#pragma unroll
    for (int t = 0; t < WT; ++t) {
#pragma unroll
      for (int j = 0; j < FJ; ++j) {
        uint32_t mask = __ballot_sync(0xFFFFFFFFu, (ent[t][j] >> 20) == static_cast<uint32_t>(s));
        while (mask) {  // two features a step, their reads issued together
          const int i0 = __ffs(mask) - 1;
          mask &= mask - 1;
          const bool two = mask != 0;
          const int i1 = two ? __ffs(mask) - 1 : i0;
          mask &= mask - 1;
          const uint32_t e0 = __shfl_sync(0xFFFFFFFFu, ent[t][j], i0);
          const uint32_t e1 = __shfl_sync(0xFFFFFFFFu, ent[t][j], i1);
          const uint32_t *p0 = sw + (e0 & OFF_MASK), *p1 = sw + (e1 & OFF_MASK);
          const uint32_t sh0 = (e0 >> 15) & 24u, sh1 = (e1 >> 15) & 24u;  // 8 * (qx % 4)
          uint32_t w0[SEG + 1], w1[SEG + 1];
#pragma unroll
          for (int k = 0; k <= SEG; ++k) {
            w0[k] = p0[k];
            w1[k] = p1[k];
          }
          if (cnt[t] > FLUSH - 2) {
            spill(a8[t], lo[t], hi[t]);
            cnt[t] = 0;
          }
#pragma unroll
          for (int k = 0; k < SEG; ++k)
            a8[t][k] += __funnelshift_r(w0[k], w0[k + 1], sh0) +
                        (two ? __funnelshift_r(w1[k], w1[k + 1], sh1) : 0u);
          cnt[t] += 1 + two;
        }
      }
    }
    __syncthreads();
  }

  // The band's (cells, TT) tile through shared memory, then out along n.
  int32_t* tile = reinterpret_cast<int32_t*>(smem);
  if (active) {
#pragma unroll
    for (int t = 0; t < WT; ++t) {
      spill(a8[t], lo[t], hi[t]);
      const int tl = warp * WT + t;
#pragma unroll
      for (int k = 0; k < SEG; ++k) {
        const int px = sg * 4 * SEG + 4 * k;
        const uint32_t v[4] = {lo[t][k] & 0xFFFFu, hi[t][k] & 0xFFFFu, lo[t][k] >> 16,
                               hi[t][k] >> 16};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (px + q < a.Wc) tile[(r * a.Wc + px + q) * TTP + tl] = static_cast<int32_t>(v[q]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * a.Wc * TT; i += DTH) {
    const int pl = i / TT, tl = i % TT;
    if (tl < ncols) a.out[(m0 + pl) * a.N + n0 + tl] = tile[pl * TTP + tl];
  }
}

// ---------------------------------------------------------------------------
// A row list
// ---------------------------------------------------------------------------

constexpr int PTH = 1024;  // threads a block
constexpr int PAD = 16;    // zero bytes past the staged cells: the dead entries' target

struct PoolArgs {
  const uint8_t* lanes;   // (B, Hy, Wx, L), Hy = Hc + Kc, Wx = Wc + Kc
  const int64_t* frame;   // (M,)
  const int64_t* pos;     // (M,) flat cell py * Wc + px
  const int4* table;      // (F / 4, N) int4: slots 4f .. 4f + 3 of template n at [f][n]
  int32_t* out;           // (M, N)
  int M, L, Hy, Wx, Wc, Kc, N, F4, cells_per_pass;
};

// A patch byte's two responses as the halves of a word.
__device__ __forceinline__ uint32_t pair_sums(uint32_t v) { return (v & 15u) | (v & 0xF0u) << 12; }

// A block scores rows m0 = 2 * blockIdx.x and m0 + 1: their patches share
// one byte a GEMM row, row m0's response in the low nibble and m0 + 1's in
// the high one, so one shared-memory read serves both rows, and a template's
// two sums ride in the halves of one 32-bit word.
__global__ void __launch_bounds__(PTH, 1) exact_pool_kernel(const PoolArgs a) {
  extern __shared__ __align__(16) uint8_t patch[];
  const int m0 = 2 * blockIdx.x;
  const bool pair = m0 + 1 < a.M;
  const uint8_t* src[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = pair ? m0 + r : m0;
    const int p = static_cast<int>(a.pos[m]), py = p / a.Wc, px = p - py * a.Wc;
    src[r] = a.lanes + ((a.frame[m] * a.Hy + py) * a.Wx + px) * a.L;
  }
  const int cells = a.Kc * a.Kc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < cells; c0 += a.cells_per_pass) {
    const int nc = min(a.cells_per_pass, cells - c0);
    const uint32_t base = static_cast<uint32_t>(c0) * a.L;
    const uint32_t span = static_cast<uint32_t>(nc) * a.L;
    if (c0) __syncthreads();  // the previous pass has read its cells
    for (int q = warp; q < nc; q += PTH / 32) {
      const int qy = (c0 + q) / a.Kc, qx = c0 + q - qy * a.Kc;
      const size_t off = (static_cast<size_t>(qy) * a.Wx + qx) * a.L;
      const uint8_t *s0 = src[0] + off, *s1 = src[1] + off;
      uint8_t* dst = patch + q * a.L;
      if ((a.L & 15) == 0) {  // responses <= 4: a byte << 4 stays in its byte
        for (int w = lane; w < (a.L >> 4); w += 32) {
          const int4 v0 = __ldg(reinterpret_cast<const int4*>(s0) + w);
          const int4 v1 = __ldg(reinterpret_cast<const int4*>(s1) + w);
          reinterpret_cast<int4*>(dst)[w] =
              make_int4(v0.x | v1.x << 4, v0.y | v1.y << 4, v0.z | v1.z << 4, v0.w | v1.w << 4);
        }
      } else {
        for (int w = lane; w < a.L; w += 32) dst[w] = s0[w] | s1[w] << 4;
      }
    }
    if (threadIdx.x < PAD) patch[span + threadIdx.x] = 0;
    __syncthreads();
    for (int n = threadIdx.x; n < a.N; n += PTH) {
      uint32_t acc = 0;
      for (int f = 0; f < a.F4; ++f) {
        const int4 e = __ldg(a.table + static_cast<size_t>(f) * a.N + n);
        // An entry outside [base, base + span), -1 included, reads the zeros.
        acc += pair_sums(patch[min(static_cast<uint32_t>(e.x) - base, span)]) +
               pair_sums(patch[min(static_cast<uint32_t>(e.y) - base, span)]) +
               pair_sums(patch[min(static_cast<uint32_t>(e.z) - base, span)]) +
               pair_sums(patch[min(static_cast<uint32_t>(e.w) - base, span)]);
      }
      int32_t* out = a.out + static_cast<size_t>(m0) * a.N + n;
      const int32_t s0 = static_cast<int32_t>(acc & 0xFFFFu), s1 = static_cast<int32_t>(acc >> 16);
      if (c0 == 0) {
        out[0] = s0;
        if (pair) out[a.N] = s1;
      } else {
        out[0] += s0;
        if (pair) out[a.N] += s1;
      }
    }
  }
}

int max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 48 * 1024;
  return v;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace

// Raw exact coarse scores, (M, N) int32, of the (N, F) int32 table (the
// GEMM row of each live feature, -1 for a dead slot; F <= 256).
//
// frame == NULL: every cell of B frames, M = B * Hc * Wc, from lane-major
// planes (B, L, Hp, XS) u8 with the band geometry BH (cell rows a block)
// and LS (lanes a stage): XS a multiple of 8, Hp = ceil(Hc / BH) * BH +
// Kc - 1, ceil(Wc / 20) lanes a cell row, BH of them a warp.
// frame != NULL: the M rows (frame[m], pos[m]) (int64), from lanes-last
// planes (B, Hc + Kc, Wc + Kc, L) u8, with the table template-minor as
// (F / 4, N) int4 (F % 4 == 0; Hp, XS, BH, LS unused).
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for a geometry the kernel does not take).
extern "C" int lpe_exact_scores(const void* planes, const void* frame, const void* pos,
                                const void* table, void* out, int B, int M, int L, int Hc,
                                int Wc, int Kc, int N, int F, int Hp, int XS, int BH, int LS,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem_max = max_smem(device);
  if (frame == nullptr) {
    DenseArgs a;
    a.planes = static_cast<const uint8_t*>(planes);
    a.table = static_cast<const int32_t*>(table);
    a.out = static_cast<int32_t*>(out);
    a.L = L, a.Hp = Hp, a.XS = XS, a.Hc = Hc, a.Wc = Wc, a.Kc = Kc, a.N = N, a.F = F;
    a.BH = BH, a.segs = (Wc + 4 * SEG - 1) / (4 * SEG), a.BHs = BH + Kc - 1, a.LS = LS;
    a.nstages = (L + LS - 1) / LS;
    a.stage_bytes = (LS * a.BHs * XS + 15) / 16 * 16;
    const int nbands = (Hc + BH - 1) / BH;
    const int tile_bytes = BH * Wc * TTP * 4;
    const int smem = 2 * a.stage_bytes > tile_bytes ? 2 * a.stage_bytes : tile_bytes;
    if (XS % 8 || a.segs * BH > 32 || BH < 1 || nbands * BH + Kc - 1 > Hp || F > 256 ||
        a.nstages >= 4095 || a.stage_bytes / 4 > static_cast<int>(OFF_MASK) ||
        4 * ((Kc - 1) / 4 + a.segs * SEG + 1) > XS || smem > smem_max)
      return static_cast<int>(cudaErrorInvalidValue);
    a.divL = make_div(L), a.divKc = make_div(Kc), a.divLS = make_div(LS);
    const dim3 grid((N + TT - 1) / TT, nbands, B);
    if (F <= 128) {
      static int allowed = 0;
      if ((err = allow_smem(exact_dense_kernel<4>, smem, allowed)) != cudaSuccess)
        return static_cast<int>(err);
      exact_dense_kernel<4><<<grid, DTH, smem, st>>>(a);
    } else {
      static int allowed = 0;
      if ((err = allow_smem(exact_dense_kernel<8>, smem, allowed)) != cudaSuccess)
        return static_cast<int>(err);
      exact_dense_kernel<8><<<grid, DTH, smem, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  PoolArgs a;
  a.lanes = static_cast<const uint8_t*>(planes);
  a.frame = static_cast<const int64_t*>(frame);
  a.pos = static_cast<const int64_t*>(pos);
  a.table = static_cast<const int4*>(table);
  a.out = static_cast<int32_t*>(out);
  a.M = M, a.L = L, a.Hy = Hc + Kc, a.Wx = Wc + Kc, a.Wc = Wc, a.Kc = Kc, a.N = N;
  a.F4 = F / 4;
  const int fit = (smem_max - PAD) / L;
  a.cells_per_pass = fit < Kc * Kc ? fit : Kc * Kc;
  if (F % 4 || a.cells_per_pass < 1 || F > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = a.cells_per_pass * L + PAD;
  static int allowed = 0;
  if ((err = allow_smem(exact_pool_kernel, smem, allowed)) != cudaSuccess)
    return static_cast<int>(err);
  exact_pool_kernel<<<(M + 1) / 2, PTH, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
