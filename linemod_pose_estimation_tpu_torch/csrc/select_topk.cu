// Kernel TK: the exhaustive select's top-k over every frame of a batch,
// equal bit for bit to ops/cuda_kernels.py::select_topk_plain (the
// per-frame torch.topk over unique int64 keys that it replaces).
//
// Replaces no Pallas kernel: the reference selects with jax.lax.top_k
// (linemod_pose_estimation_tpu/ops/match.py::select_candidates_flat).
//
// For each frame b of raw (B, P, ld) int32 it returns the k largest of
// sim = vpos[p, n] ? (float)raw[b, p, col0 + n] * scale[n] : -1.0f over
// the window's flat index e = p * N + n (N <= ld columns from col0: one
// class's columns of a merged template axis, read in place; the whole row
// where col0 = 0 and N = ld), ordered by sim's order key, largest first,
// and on equal keys by e, lowest first: the plain twin's order, the -1.0
// filler slots included.
//
// What bounds it is the bytes of raw, 4 an element: 1.63 GB at B = 32,
// P = 1200, N = 10,624, 0.49 ms at 3.35 TB/s.  No sim, no key and no
// list of frame size is written: an element's key is the unsigned order
// image u of sim's bits (a negative's bits inverted, a positive's sign bit
// set), made from raw, scale and vpos each time they are read.  An exact
// radix select on u reads raw three times, each pass over all B frames,
// a block taking a contiguous range of one frame:
//
//   1. per-frame histograms of u >> 16: 65,536 bins held as two 16-bit
//      counts a word of shared memory, flushed to device memory every
//      49,152 elements, before a count could carry (a warp's adds to one
//      bin, common as quantized scores tie, cost less as they come than
//      gathered first by __match_any_sync: 2.22 against 3.07 ms for both
//      passes on an H100).  A find, one block a frame, takes the bin that
//      holds the k-th largest key and the rank inside it;
//   2. the same over u & 0xffff of the elements in that bin: the k-th key
//      u* exactly, and `need`, how many elements equal to u* are kept;
//   3. the compaction: every element above u* goes to the frame's k slots
//      (at most k - 1 do, so the order they arrive in is of no account);
//      a block ranks its elements equal to u* in index order by a block
//      scan and lists its first `need` of them.  A sort, one block a
//      frame, fills the other slots from the blocks' lists in block order
//      -- the lowest indices, whatever order the blocks ran in -- and
//      orders the k by (u desc, e asc).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 1024;               // threads of a pass block
constexpr int GROUP = 4;               // consecutive elements a thread loads at once
constexpr int ROW = TH * GROUP;        // a block's 4,096 consecutive elements
constexpr int ROWS = 4;                // rows a step: a thread's loads in flight
constexpr int STEP = ROW * ROWS;       // 16,384 elements a step
constexpr int FLUSH_STEPS = 3;         // 49,152 elements between flushes (< 2^16)
constexpr int BINS = 1 << 16;
constexpr int HIST_SMEM = BINS / 2 * 4;  // 128 KB: two 16-bit counts a word
constexpr int KMAX = 512;              // the largest k; also the sort's threads
constexpr int FTH = 1024;              // threads of a find
constexpr int PER = BINS / FTH;        // bins a find thread sums

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

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  const uint32_t u = static_cast<uint32_t>(n);
  return static_cast<int>((__umulhi(u, f.m) + u) >> f.s);
}

struct Args {
  const int32_t* raw;     // (B, P, ld): the window is columns [col0, col0 + N)
  const float* scale;     // (N,)
  const uint8_t* vpos;    // (n,) bools
  uint32_t* hist;         // (B, BINS) of the running pass
  int32_t* state;         // (B, 4): pass 1's bin, the rank in it, u*, need
  uint32_t* cand_key;     // (B, KMAX): the keys above u*
  int32_t* cand_idx;      // (B, KMAX): their indices
  int32_t* cand_cnt;      // (B,)
  int32_t* eq_idx;        // (B, G, k): each block's first elements equal to u*
  int32_t* eq_cnt;        // (B, G)
  float* vals;            // (B, k)
  int64_t* idx;           // (B, k)
  int n, N, ld, col0, k, G, steps;  // n = P * N, the window's elements a frame
  size_t frame;                     // P * ld, raw's elements a frame
  FastDiv divN;
};

__device__ __forceinline__ uint32_t order_key(int32_t r, float s, uint32_t v) {
  const float x = v ? __fmul_rn(__int2float_rn(r), s) : -1.0f;
  const uint32_t bits = __float_as_uint(x);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// The offset in a frame of raw of the window's element e.
__device__ __forceinline__ int raw_at(const Args& a, int e, int p) {
  return p * a.ld + a.col0 + (e - p * a.N);
}

// The element index of slot j (row j / GROUP, element j % GROUP) of step s.
__device__ __forceinline__ int elem(int s, int j) {
  return s * STEP + (j / GROUP) * ROW + GROUP * threadIdx.x + j % GROUP;
}

// The keys of this thread's ROWS groups of GROUP consecutive elements of
// step s; bit j of `live` is set where slot j lies inside the frame.  VEC:
// N, ld and col0 multiples of 4 and 16-byte aligned operands, so a group
// lies in one row p and loads as one int4, one word of vpos and one float4
// of scale.
template <bool VEC>
__device__ __forceinline__ void load_step(const Args& a, const int32_t* fr, int s,
                                          uint32_t (&key)[ROWS * GROUP], uint32_t& live) {
  live = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int e = elem(s, r * GROUP);
    if (VEC) {
      if (e < a.n) {
        const int p = fdiv(e, a.divN);
        const int c = e - p * a.N;
        const int4 v = __ldcs(reinterpret_cast<const int4*>(fr + raw_at(a, e, p)));
        const uint32_t m = __ldg(reinterpret_cast<const uint32_t*>(a.vpos + e));
        const float4 sc = __ldg(reinterpret_cast<const float4*>(a.scale + c));
        key[r * GROUP + 0] = order_key(v.x, sc.x, m & 0xffu);
        key[r * GROUP + 1] = order_key(v.y, sc.y, (m >> 8) & 0xffu);
        key[r * GROUP + 2] = order_key(v.z, sc.z, (m >> 16) & 0xffu);
        key[r * GROUP + 3] = order_key(v.w, sc.w, m >> 24);
        live |= 0xfu << (r * GROUP);
      } else {
#pragma unroll
        for (int q = 0; q < GROUP; ++q) key[r * GROUP + q] = 0;
      }
    } else {
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        const int eq = e + q;
        key[r * GROUP + q] = 0;
        if (eq < a.n) {
          const int p = fdiv(eq, a.divN);
          key[r * GROUP + q] = order_key(__ldcs(fr + raw_at(a, eq, p)),
                                         __ldg(a.scale + (eq - p * a.N)), a.vpos[eq]);
          live |= 1u << (r * GROUP + q);
        }
      }
    }
  }
}

// The exclusive prefix of c over the block's threads in thread order, and
// the block's sum in `total`.  Every thread calls it; it uses sh[0, 32).
__device__ int block_scan(int c, int* sh, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? sh[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    sh[lane] = t;
  }
  __syncthreads();
  const int before = w ? sh[w - 1] : 0;
  total = sh[nw - 1];
  __syncthreads();
  return before + x - c;
}

__device__ __forceinline__ void block_range(const Args& a, int g, int& s0, int& s1) {
  s0 = static_cast<int>(static_cast<long long>(a.steps) * g / a.G);
  s1 = static_cast<int>(static_cast<long long>(a.steps) * (g + 1) / a.G);
}

// Passes 1 and 2: the frame's histogram of u >> 16 (PASS 1), or of
// u & 0xffff over the elements whose u >> 16 is pass 1's bin (PASS 2).
template <int PASS, bool VEC>
__global__ void __launch_bounds__(TH, 1) select_hist_kernel(Args a) {
  extern __shared__ uint32_t sh[];
  const int b = blockIdx.y;
  int s0, s1;
  block_range(a, blockIdx.x, s0, s1);
  for (int i = threadIdx.x; i < BINS / 2; i += TH) sh[i] = 0;
  __syncthreads();
  const uint32_t hi = PASS == 2 ? static_cast<uint32_t>(a.state[4 * b]) : 0u;
  const int32_t* fr = a.raw + b * a.frame;
  uint32_t* gh = a.hist + static_cast<size_t>(b) * BINS;
  bool counted = false;
  int since = 0;
  for (int s = s0; s < s1; ++s) {
    uint32_t key[ROWS * GROUP], live;
    load_step<VEC>(a, fr, s, key, live);
#pragma unroll
    for (int j = 0; j < ROWS * GROUP; ++j) {
      bool in = (live >> j) & 1u;
      if (PASS == 2) in = in && (key[j] >> 16) == hi;
      if (in) {
        const uint32_t bin = PASS == 1 ? key[j] >> 16 : key[j] & 0xffffu;
        atomicAdd(&sh[bin >> 1], 1u << ((bin & 1u) * 16));
        counted = true;
      }
    }
    if (++since == FLUSH_STEPS || s + 1 == s1) {
      since = 0;
      if (__syncthreads_or(counted)) {
        for (int i = threadIdx.x; i < BINS / 2; i += TH) {
          const uint32_t w = sh[i];
          if (w) {
            sh[i] = 0;
            if (w & 0xffffu) atomicAdd(gh + 2 * i, w & 0xffffu);
            if (w >> 16) atomicAdd(gh + 2 * i + 1, w >> 16);
          }
        }
        __syncthreads();
      }
      counted = false;
    }
  }
}

// One block a frame: the bin of `hist` that holds the element of rank
// `rank` counted from the largest (1-based), and the rank inside it.
// Pass 1 starts from k; pass 2 from pass 1's rank, and yields u*.
__global__ void __launch_bounds__(FTH) select_find_kernel(const uint32_t* hist, int32_t* state,
                                                          int k, int pass) {
  __shared__ int sh[32];
  const int b = blockIdx.x;
  const uint32_t* h = hist + static_cast<size_t>(b) * BINS;
  const int rank = pass == 1 ? k : state[4 * b + 1];
  const int lo = BINS - (threadIdx.x + 1) * PER;  // thread 0 holds the top bins
  int c = 0;
  for (int i = 0; i < PER; ++i) c += static_cast<int>(h[lo + i]);
  int total;
  int acc = block_scan(c, sh, total);
  if (acc < rank && acc + c >= rank) {
    for (int i = PER - 1; i >= 0; --i) {
      const int ci = static_cast<int>(h[lo + i]);
      if (acc + ci >= rank) {
        if (pass == 1) {
          state[4 * b] = lo + i;
          state[4 * b + 1] = rank - acc;
        } else {
          state[4 * b + 2] = static_cast<int32_t>(
              (static_cast<uint32_t>(state[4 * b]) << 16) | static_cast<uint32_t>(lo + i));
          state[4 * b + 3] = rank - acc;
        }
        break;
      }
      acc += ci;
    }
  }
}

// Pass 3: the keys above u* to the frame's slots; each block's first
// `need` elements equal to u*, in index order, to its list.
template <bool VEC>
__global__ void __launch_bounds__(TH) select_compact_kernel(Args a) {
  __shared__ int sh[32];
  const int b = blockIdx.y, g = blockIdx.x;
  int s0, s1;
  block_range(a, g, s0, s1);
  const uint32_t kth = static_cast<uint32_t>(a.state[4 * b + 2]);
  const int need = a.state[4 * b + 3];
  const int32_t* fr = a.raw + b * a.frame;
  int32_t* eq = a.eq_idx + (static_cast<size_t>(b) * a.G + g) * a.k;
  int running = 0;  // block-uniform: elements equal to u* met so far
  for (int s = s0; s < s1; ++s) {
    uint32_t key[ROWS * GROUP], live;
    load_step<VEC>(a, fr, s, key, live);
#pragma unroll
    for (int j = 0; j < ROWS * GROUP; ++j) {
      if (((live >> j) & 1u) && key[j] > kth) {
        const int slot = atomicAdd(a.cand_cnt + b, 1);
        if (slot < KMAX) {
          a.cand_key[b * KMAX + slot] = key[j];
          a.cand_idx[b * KMAX + slot] = elem(s, j);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (running >= need) break;
      uint32_t m = 0;
#pragma unroll
      for (int q = 0; q < GROUP; ++q)
        if (((live >> (r * GROUP + q)) & 1u) && key[r * GROUP + q] == kth) m |= 1u << q;
      if (!__syncthreads_or(m)) continue;
      int total;
      int rk = running + block_scan(__popc(m), sh, total);
#pragma unroll
      for (int q = 0; q < GROUP; ++q) {
        if ((m >> q) & 1u) {
          if (rk < need) eq[rk] = elem(s, r * GROUP + q);
          ++rk;
        }
      }
      running += total;
    }
  }
  if (threadIdx.x == 0) a.eq_cnt[b * a.G + g] = running < need ? running : need;
}

// One block a frame: the k slots (the keys above u*, then the blocks'
// lists in block order up to k), sorted by (u desc, e asc) as one 64-bit
// key (u, ~e); then each slot's sim and index.
__global__ void __launch_bounds__(KMAX) select_sort_kernel(Args a) {
  __shared__ unsigned long long s[KMAX];
  __shared__ int sh[32];
  const int b = blockIdx.x, t = threadIdx.x, k = a.k;
  const uint32_t kth = static_cast<uint32_t>(a.state[4 * b + 2]);
  const int gt = k - a.state[4 * b + 3];
  s[t] = t < gt ? (static_cast<unsigned long long>(a.cand_key[b * KMAX + t]) << 32) |
                      static_cast<uint32_t>(~a.cand_idx[b * KMAX + t])
                : 0ull;  // below every real slot: ~e has its top bit set
  const int c = t < a.G ? a.eq_cnt[b * a.G + t] : 0;
  int total;
  const int off = block_scan(c, sh, total);
  const int32_t* eq = a.eq_idx + (static_cast<size_t>(b) * a.G + t) * k;
  for (int r = 0; r < c && gt + off + r < k; ++r)
    s[gt + off + r] = (static_cast<unsigned long long>(kth) << 32) | static_cast<uint32_t>(~eq[r]);
  for (int size = 2; size <= KMAX; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int j = t ^ stride;
      if (j > t) {
        const unsigned long long x = s[t], y = s[j];
        if ((t & size) == 0 ? x < y : x > y) {
          s[t] = y;
          s[j] = x;
        }
      }
    }
  }
  __syncthreads();
  if (t < k) {
    const unsigned long long x = s[t];
    const uint32_t u = static_cast<uint32_t>(x >> 32);
    const uint32_t bits = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    a.vals[static_cast<size_t>(b) * k + t] = __uint_as_float(bits);
    a.idx[static_cast<size_t>(b) * k + t] = static_cast<int64_t>(~static_cast<uint32_t>(x));
  }
}

int max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 48 * 1024;
  return v;
}

template <int PASS, bool VEC>
cudaError_t launch_hist(const Args& a, int B, cudaStream_t st) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_hist_kernel<PASS, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, HIST_SMEM);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  select_hist_kernel<PASS, VEC><<<dim3(a.G, B), TH, HIST_SMEM, st>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t run(Args a, int B, cudaStream_t st) {
  cudaError_t err;
  uint32_t* hist = a.hist;
  if ((err = launch_hist<1, VEC>(a, B, st)) != cudaSuccess) return err;
  select_find_kernel<<<B, FTH, 0, st>>>(hist, a.state, a.k, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  a.hist = hist + static_cast<size_t>(B) * BINS;
  if ((err = launch_hist<2, VEC>(a, B, st)) != cudaSuccess) return err;
  select_find_kernel<<<B, FTH, 0, st>>>(a.hist, a.state, a.k, 2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  select_compact_kernel<VEC><<<dim3(a.G, B), TH, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  select_sort_kernel<<<B, KMAX, 0, st>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The top k (k <= 512) of each frame of the window raw[:, :, col0:col0 + N]
// of raw (B, P, ld) int32 by the key of sim = vpos[p, n] ? raw * scale[n]
// : -1.0f, lower flat index p * N + n first on ties: vals (B, k) f32 and
// idx (B, k) int64.  vpos (P, N) and scale (N,) are the window's.  Scratch, all device memory
// of the caller: hist (2, B, 65536) int32, zero; state (B, 4) int32;
// cand_key, cand_idx (B, 512) int32; cand_cnt (B,) int32, zero; eq_idx
// (B, G, k) int32; eq_cnt (B, G) int32.  G blocks take each frame, each a
// contiguous range of whole steps of 16,384 elements (1 <= G <= 512 and
// G <= the steps of a frame).
extern "C" int lpe_select_topk(const void* raw, const void* scale, const void* vpos, void* hist,
                               void* state, void* cand_key, void* cand_idx, void* cand_cnt,
                               void* eq_idx, void* eq_cnt, void* vals, void* idx, int B, int P,
                               int N, int ld, int col0, int k, int G, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const long long n = static_cast<long long>(P) * N;
  const long long steps = (n + STEP - 1) / STEP;
  if (n < 1 || n >= (1ll << 30) || static_cast<long long>(P) * ld >= (1ll << 31) ||
      col0 < 0 || col0 + N > ld || k < 1 || k > KMAX || k > n || G < 1 || G > KMAX ||
      G > steps || B > 65535 || HIST_SMEM > max_smem(device))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.raw = static_cast<const int32_t*>(raw);
  a.scale = static_cast<const float*>(scale);
  a.vpos = static_cast<const uint8_t*>(vpos);
  a.hist = static_cast<uint32_t*>(hist);
  a.state = static_cast<int32_t*>(state);
  a.cand_key = static_cast<uint32_t*>(cand_key);
  a.cand_idx = static_cast<int32_t*>(cand_idx);
  a.cand_cnt = static_cast<int32_t*>(cand_cnt);
  a.eq_idx = static_cast<int32_t*>(eq_idx);
  a.eq_cnt = static_cast<int32_t*>(eq_cnt);
  a.vals = static_cast<float*>(vals);
  a.idx = static_cast<int64_t*>(idx);
  a.n = static_cast<int>(n), a.N = N, a.ld = ld, a.col0 = col0, a.k = k, a.G = G;
  a.steps = static_cast<int>(steps);
  a.frame = static_cast<size_t>(P) * ld;
  a.divN = make_div(static_cast<uint32_t>(N));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 4 == 0 && ld % 4 == 0 && col0 % 4 == 0 && aligned(raw, 16) &&
                   aligned(scale, 16) && aligned(vpos, 4);
  return static_cast<int>(vec ? run<true>(a, B, st) : run<false>(a, B, st));
}
