// Kernel BM: the pooled matcher's bound margins.  For each row m of an
// int8 patch matrix A (M, K) and the first n rows of a K-major int8 weight
// W (>= n, K):
//
//   out[m] = max over n' < n of (valid(m, n') ? sum_k A[m, k] W[n', k] - t[n']
//                                             : sentinel)
//   valid(m, n') = vpos[row_pos(m), n'] && keep[m]
//
// with row_pos(m) = pos[m], or m % P without a row list, and keep all true
// without one.  That is, bit for bit, torch._int_mm followed by the (M, n)
// int32 epilogue (validity gather, subtract, select, row max) the pooled
// tiers ran before; the products and sums are exact integers, so any order
// gives the same bits.
//
// Replaces no Pallas kernel: the reference leaves the bound to XLA's
// dot_general and its int16/int32 margin max (linemod_pose_estimation_tpu/
// ops/match.py:609, position_margins_batched).  It was added because the
// port's epilogue wrote and re-read an (M, n) int32 bound and two (M, n)
// bool masks, ~10 GB of device memory a B=32 batch, to keep one int32 a row.
//
// What bounds it on an H100 is the int8 tensor cores: 2 M ceil8(n) K
// operations (1.88e12 at the cell tier's 38,400 x 10,624 x 2304) against
// 1,979 TOPS; its bytes (A once, W once, vpos, t, out) are ~0.15 GB.  So
// the design feeds wgmma at its rate and keeps the epilogue in registers:
//
// - A persistent grid, one 384-thread block an SM, walks 128 x 256 output
//   tiles template-tile fastest, so the blocks in flight share a few A row
//   tiles and all of W (24.5 MB at most) stays in the 50 MB L2.
// - Warp 0 of warpgroup 0 is the producer: one thread issues TMA loads of
//   a 128-row A box and a 256-row W box, 128 bytes of K each (the 128-byte
//   swizzle's width), into a ring of 4 stages of 48 KB, each stage guarded
//   by a full and an empty mbarrier.  TMA zero-fills rows past M and n and
//   bytes past K, so ragged edges need no code in the main loop.
// - Warpgroups 1 and 2 consume: each issues four m64n256k32 s8 wgmma a
//   stage over its 64 rows, from shared memory, keeping one group in
//   flight and releasing the previous stage when it retires.
// - Warps 1-3 of warpgroup 0 load the tile's validity while the consumers
//   run its main loop: each (row, template) byte of vpos[row_pos(m), n0 :
//   n0 + 256), zero for a dead row, a row past M or a template past n,
//   a row as one 256-byte line per warp, into a shared buffer whose row
//   pitch spreads the epilogue's reads over the banks.  Read straight
//   from L2 in the epilogue, those lines cost as much as the main loop.
// - The epilogue runs on the 128 int32 accumulators a thread holds (two
//   rows, 64 templates): subtract t (an int2 read), test validity (a
//   2-byte shared read), row max, two quad shuffles, then one atomicMax a
//   row and template tile on out, which the wrapper fills with INT32_MIN.
//   Templates past n add nothing; an invalid one adds the sentinel, as
//   the plain chain's select does.
// - With a keep mask, a 128-row tile with no live row (a pool's dead
//   slots trail its live ones) is skipped by every role alike: its first
//   template tile's consumers store the sentinel in its rows, which is
//   what the plain chain gives a row with no valid template.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // rows a tile: two consumer warpgroups of 64
constexpr int BN = 256;  // templates a tile: one m64n256k32 wgmma wide
constexpr int BK = 128;  // contraction bytes a stage: the 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK;  // 16 KB
constexpr int W_TILE = BN * BK;  // 32 KB
constexpr int STAGE = A_TILE + W_TILE;
constexpr int THREADS = 384;
constexpr int LOADERS = 96;  // warps 1-3 of warpgroup 0
constexpr int ROWS_PER_LOADER = (BM + LOADERS / 32 - 1) / (LOADERS / 32);  // a warp's rows
constexpr int VROW = BN + 8;  // a validity row's pitch in shared memory (bank spread)
// the ring, the validity rows, the barriers, and slack to align the ring
constexpr int SMEM = STAGES * STAGE + BM * VROW + (2 * STAGES + 2) * 8 + 1024;

struct Args {
  const int32_t* t;     // (n_tiles * BN,) thresholds, zero past n
  const uint8_t* vpos;  // (P, vstride) validity, 8-byte aligned, zero past n
  const int64_t* pos;   // (M,) row positions, or null: m % P
  const uint8_t* keep;  // (m_tiles * BM,) live rows, zero past M, or null
  int32_t* out;         // (M,), INT32_MIN on entry
  int M, n, P, vstride, kblocks, n_tiles, tiles, sentinel;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A (box_rows, 128)-byte box of a 2-D u8 tensor map at (row, k) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle (1024-byte aligned): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void fence_acc(int32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256 s32, the warpgroup's fragment) += A (64 x 32 s8) W^T.
__device__ __forceinline__ void wgmma_256(int32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// Does row tile mt hold a live row?  Every role reads the same 128 bytes,
// so the producer, the loader and both consumers skip the same tiles.
__device__ __forceinline__ bool tile_live(const uint8_t* keep, int mt) {
  if (keep == nullptr) return true;
  const uint4* k = reinterpret_cast<const uint4*>(keep + static_cast<int64_t>(mt) * BM);
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const uint4 v = __ldg(k + i);
    any |= v.x | v.y | v.z | v.w;
  }
  return any != 0;
}

// The block's tiles in order, with each one's liveness read a tile ahead,
// so that the keep bytes' latency hides behind the current tile's work.
struct TileWalk {
  int tile, next;
  bool live, next_live;
  __device__ __forceinline__ TileWalk(const Args& a) : tile(blockIdx.x), next(0),
                                                       live(false), next_live(false) {
    live = tile < a.tiles && tile_live(a.keep, tile / a.n_tiles);
  }
  __device__ __forceinline__ void prefetch(const Args& a) {
    next = tile + gridDim.x;
    next_live = next < a.tiles && tile_live(a.keep, next / a.n_tiles);
  }
  __device__ __forceinline__ void advance() { tile = next, live = next_live; }
};

__global__ void __launch_bounds__(THREADS, 1)
    bound_margins_kernel(const __grid_constant__ CUtensorMap tmA,
                         const __grid_constant__ CUtensorMap tmW, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* vbuf = smem_raw + (base - raw) + STAGES * STAGE;  // (BM, VROW) validity
  // full[s], empty[s], then the validity buffer's full and empty
  const uint32_t bars = base + STAGES * STAGE + BM * VROW;
  const uint32_t vfull = bars + 16 * STAGES, vempty = vfull + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 2);
    }
    mbar_init(vfull, LOADERS);
    mbar_init(vempty, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    // Producer: one thread keeps the ring full across the block's tiles.
    int stage = 0;
    uint32_t phase = 0;
    for (TileWalk w(a); w.tile < a.tiles; w.advance()) {
      w.prefetch(a);
      if (!w.live) continue;
      const int mt = w.tile / a.n_tiles, nt = w.tile - mt * a.n_tiles;
      for (int kb = 0; kb < a.kblocks; ++kb) {
        const uint32_t full = bars + 8 * stage, empty = bars + 8 * (STAGES + stage);
        mbar_wait(empty, phase ^ 1);
        mbar_expect(full, STAGE);
        const uint32_t dst = base + stage * STAGE;
        tma_load(dst, &tmA, kb * BK, mt * BM, full);
        tma_load(dst + A_TILE, &tmW, kb * BK, nt * BN, full);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }
  if (wg == 0) {
    if (threadIdx.x < 32) return;
    // Loader, warps 1-3: the tile's validity rows vpos[row_pos(m), n0 : n0
    // + 256), zero for a dead row, a row past M and a template past n,
    // into vbuf while the consumers run the tile's main loop.  A warp
    // reads a row as one 256-byte line.
    const int lw = threadIdx.x / 32 - 1, lane = threadIdx.x & 31;
    uint32_t vphase = 0;
    for (TileWalk w(a); w.tile < a.tiles; w.advance()) {
      w.prefetch(a);
      if (!w.live) continue;
      const int mt = w.tile / a.n_tiles, nt = w.tile - mt * a.n_tiles;
      // Row lw + 3 i of the tile: lane i holds its position (-1: dead),
      // lane i - 32 that of i >= 32.
      int prow[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = mt * BM + lw + 3 * (lane + 32 * j);
        prow[j] = -1;
        if (lw + 3 * (lane + 32 * j) < BM && m < a.M &&
            (a.keep == nullptr || a.keep[m] != 0))
          prow[j] = a.pos != nullptr ? static_cast<int>(a.pos[m]) : m % a.P;
      }
      const int col = nt * BN + 8 * lane;
      uint8_t* dst = vbuf + 8 * lane;
      // Every row's 8 bytes in flight at once (a row with nothing to read
      // reads vpos's first 8 bytes, and is zeroed after), then the stores.
      // A conditional load would wait for each value in turn.
      uint2 v[ROWS_PER_LOADER];
      uint64_t ok = 0;
#pragma unroll
      for (int i = 0; i < ROWS_PER_LOADER; ++i) {
        const int p = __shfl_sync(0xFFFFFFFFu, i < 32 ? prow[0] : prow[1], i & 31);
        const bool read = p >= 0 && col < a.n;
        ok |= static_cast<uint64_t>(read) << i;
        v[i] = __ldg(reinterpret_cast<const uint2*>(
            a.vpos + (read ? static_cast<int64_t>(p) * a.vstride + col : 0)));
      }
      mbar_wait(vempty, vphase ^ 1);
#pragma unroll
      for (int i = 0; i < ROWS_PER_LOADER; ++i) {
        const int r = lw + 3 * i;
        if (r < BM)
          *reinterpret_cast<uint2*>(dst + r * VROW) = (ok >> i) & 1 ? v[i] : make_uint2(0, 0);
      }
      mbar_arrive(vfull);
      vphase ^= 1;
    }
    return;
  }

  // Consumers: warpgroup cw takes rows [64 cw, 64 cw + 64) of each tile.
  const int cw = wg - 1;
  const int tw = threadIdx.x - 128 * wg;
  const int lane = tw & 31, q = lane & 3;
  const int row0 = 64 * cw + 16 * (tw >> 5) + (lane >> 2);  // and row0 + 8
  int stage = 0;
  uint32_t phase = 0, vphase = 0;
  int32_t acc[128];
  for (TileWalk w(a); w.tile < a.tiles; w.advance()) {
    w.prefetch(a);
    const int mt = w.tile / a.n_tiles, nt = w.tile - mt * a.n_tiles;
    if (!w.live) {
      if (nt == 0 && q == 0) {
        for (int h = 0; h < 2; ++h) {
          const int m = mt * BM + row0 + 8 * h;
          if (m < a.M) a.out[m] = a.sentinel;
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int prev = -1;
    for (int kb = 0; kb < a.kblocks; ++kb) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t sa = base + stage * STAGE + cw * (64 * BK);
      const uint32_t sb = base + stage * STAGE + A_TILE;
      const uint64_t da = sw128_desc(sa), db = sw128_desc(sb);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_256(acc, da + 2 * kk, db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (tw == 0) mbar_arrive(bars + 8 * (STAGES + prev));
      }
      prev = stage;
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (tw == 0) mbar_arrive(bars + 8 * (STAGES + prev));

    // Epilogue: accumulator i of this thread is row row0 + 8 ((i / 2) % 2),
    // template 8 (i / 4) + 2 q + i % 2 of the tile.
    const int n0 = nt * BN;
    mbar_wait(vfull, vphase);
    vphase ^= 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const uint8_t* vrow = vbuf + r * VROW + 2 * q;
      int best = INT32_MIN;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * q;
        const int2 tt = __ldg(reinterpret_cast<const int2*>(a.t + col));
        const unsigned short v = *reinterpret_cast<const unsigned short*>(vrow + 8 * c);
        const int x0 = col < a.n ? ((v & 0xFF) ? acc[4 * c + 2 * h] - tt.x : a.sentinel)
                                 : INT32_MIN;
        const int x1 = col + 1 < a.n ? ((v >> 8) ? acc[4 * c + 2 * h + 1] - tt.y : a.sentinel)
                                     : INT32_MIN;
        best = max(best, max(x0, x1));
      }
      best = max(best, __shfl_xor_sync(0xFFFFFFFFu, best, 1));
      best = max(best, __shfl_xor_sync(0xFFFFFFFFu, best, 2));
      const int m = mt * BM + r;
      if (q == 0 && m < a.M) atomicMax(a.out + m, best);
    }
    mbar_arrive(vempty);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, from the libcuda the runtime has loaded
// (the library links no libcuda of its own).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 2-D map of a row-major (rows, K) u8 tensor, boxes of (box_rows, 128)
// bytes in the 128-byte swizzle, zero fill past its edges.
bool row_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// Bound margins (M,) int32 of A (M, K) int8 against the first n of the
// w_rows K-major int8 weight rows W (w_rows, K), thresholds t (n_tiles *
// 256,) int32, validity vpos (P, n) bool in rows of vstride bytes (a
// multiple of 8, zero past n), row positions pos (M,) int64 or null (m %
// P), live rows keep (m_tiles * 128,) u8 or null; out (M,) int32 holds
// INT32_MIN on entry.  K % 16 == 0; A and W 16-byte aligned, vpos 8.
extern "C" int lpe_bound_margins(const void* A, const void* W, const void* t, const void* vpos,
                                 const void* pos, const void* keep, void* out, int M, int n,
                                 int w_rows, int K, int P, int vstride, int sentinel, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0) return 0;
  if (n < 1 || w_rows < n || P < 1 || K < 16 || K % 16 || vstride < n || vstride % 8 ||
      reinterpret_cast<uintptr_t>(A) % 16 || reinterpret_cast<uintptr_t>(W) % 16 ||
      reinterpret_cast<uintptr_t>(vpos) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap mapA, mapW;
  if (!row_map(enc, &mapA, A, M, K, BM) || !row_map(enc, &mapW, W, w_rows, K, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.t = static_cast<const int32_t*>(t);
  a.vpos = static_cast<const uint8_t*>(vpos);
  a.pos = static_cast<const int64_t*>(pos);
  a.keep = static_cast<const uint8_t*>(keep);
  a.out = static_cast<int32_t*>(out);
  a.M = M, a.n = n, a.P = P, a.vstride = vstride, a.sentinel = sentinel;
  a.kblocks = (K + BK - 1) / BK;
  a.n_tiles = (n + BN - 1) / BN;
  const int64_t tiles = static_cast<int64_t>((M + BM - 1) / BM) * a.n_tiles;
  if (tiles >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  static bool allowed = false;
  if (!allowed) {
    err = cudaFuncSetAttribute(bound_margins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.tiles < sms ? a.tiles : sms;
  bound_margins_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(mapA, mapW,
                                                                                   a);
  return static_cast<int>(cudaGetLastError());
}
