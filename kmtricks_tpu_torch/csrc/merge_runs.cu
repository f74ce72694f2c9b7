// Merge-path merge of two ascending runs: kernels K3 (one key word, no
// payload) and K4 (one to five key words, an int64 payload).
//
// Replaces the Pallas TPU kernels kmtricks_tpu/ops/pallas_sort.py
// _merge_kernel (K3, via merge_sorted_runs_u32) and _merge_kernel_mw (K4,
// via merge_sorted_runs_words). Same output, bit for bit, as the plain
// PyTorch version kmtricks_tpu_torch/ops/merge_runs.py::
// merge_sorted_runs_torch: a stable sort of the concatenation A ++ B.
//
// Keys are NW in 1..5 int64 words, compared lexicographically (word 0
// most significant) as signed int64, the order torch.sort uses; the port's
// sort words keep the top bit clear, so that is also their unsigned order.
// Equal keys take A's element first (the TPU split's `av <= bv`), which
// makes the merge stable. Runs are exactly sized: no sentinel padding, no
// power-of-two lengths, any length including 0.
//
// What bounds it on an H100: device-memory bytes. Each element is read
// once and written once, 8 * (NW + payload) bytes each way: 16 B/element
// for K3, 48 B for K4 with two words, 96 B with five. At 3.35 TB/s that
// is 52.5 us for K3 and 157 us for K4 at 10,983,197 elements. The
// arithmetic is a handful of compares per element.
//
// Design, two launches per merge:
// 1. merge_partition: the merge-path split (the number of A elements among
//    the first d outputs) at every tile boundary d = t * TILE, written to a
//    scratch array of ntiles + 1 int64 that the wrapper allocates. One warp
//    per boundary; each round its 32 lanes test 32 evenly spaced
//    candidates, first among the samples A[k * TILE] (their partners in B
//    are shared by all boundaries, so these rounds read L2), then within
//    one tile: a few dependent rounds of loads, few of them from device
//    memory. This is the TPU's _merge_splits pass: the searches leave every
//    tile's critical path.
// 2. merge_tiles: persistent blocks (as many as fit on the card, each
//    walking tiles blockIdx.x, + gridDim.x, ...) over output tiles of
//    TILE = 4096 elements, THREADS = 512 threads of ITEMS = 8 outputs, for
//    up to three staged arrays (key words and payload); 2048 elements and
//    256 threads for four to six (the wide k-mers' sort words), whose two
//    stages of 4096 would not fit in shared memory.
//    Two shared-memory stages: while a tile merges from one, the next
//    tile's A and B windows (key words and payload) arrive in the other by
//    cp.async. A window is fetched from the 16-byte boundary at or below
//    its first element (16-byte copies, 8-byte ones at its ragged ends,
//    nothing outside the window read) and read at an offset of 0 or 1
//    element per array: the TPU kernel's ALIGN at the card's granularity.
//    Each 128-byte row of a stage has its 16-byte chunks permuted (XOR
//    with the row number) against bank conflicts between threads.
//    Each thread binary-searches its diagonal in the staged windows, merges
//    ITEMS outputs with the current A and B keys in registers and writes
//    where each output comes from (16 bits: A's index, or ta + B's) to
//    shared memory; the block then gathers keys and payload from the stage
//    in output order and writes them with 16-byte stores, fully coalesced.
// Shared memory per block: 2 stages x (NW + payload) arrays x (TILE + 16)
// int64 + 2 * TILE bytes of positions: 72 KB for K3 (two blocks per SM,
// held to two by registers), 201 KB for K4 with two words (one block),
// 132 / 165 / 198 KB for K4 with three / four / five words at the
// 2048 tile (one block).
// The shape was chosen on the card by timing builds of other shapes: at
// the engine's phase-A runs 512 threads of 8 beat 256 of 16 and 128 of 32
// on K4 (fewer warps idle behind the merge's shared-memory latency) and
// tied on K3; tiles of 2048 merged as fast but paid for twice the splits,
// and K4's two stages of 8192 do not fit in shared memory. The merge
// kernel runs within a few percent of a plain copy of the same bytes;
// the partition's few microseconds are the rest.
//
// Not carried over from the TPU kernel: _dyn_normalize (Mosaic DMA
// limits), the sentinel pad tiles, the sign flip (the TPU compares int32)
// and the Batcher odd-even network that stands in for a sequential merge
// on the vector unit. R runs merge as a tree of pairwise merges on the
// host side (ops/merge_runs.py).
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 4096                   // outputs per tile, 1-3 arrays
#define TILE_WIDE 2048              // outputs per tile, 4-6 arrays
#define ITEMS 8                     // outputs per thread
#define PART_THREADS 256            // partition: 8 warps, one split each
#define MAX_DEVICES 64
#define MAX_WORDS 5                 // key words

typedef long long i64;

// outputs per tile for `arrays` staged arrays (key words + payload)
__host__ __device__ constexpr int tile_for(int arrays) {
  return arrays <= 3 ? TILE : TILE_WIDE;
}

// The merge kernel's shape for NA staged arrays
template <int NA>
struct Shape {
  static constexpr int T = tile_for(NA);       // outputs per tile
  static constexpr int THREADS = T / ITEMS;
  static constexpr int BUF = T + 16;           // staged elements per array
  static_assert(ITEMS % 8 == 0 && T % ITEMS == 0, "tile shape");
  static_assert(THREADS >= 32 && THREADS <= 1024, "block size");
  static_assert(T <= 65536, "src entries must fit 16 bits");
  static_assert(BUF % 16 == 0, "a stage is whole 128-byte rows");
};

template <int NW>
struct Words {
  const i64* w[NW];
};

template <int NW>
struct OutWords {
  i64* w[NW];
};

// a[i] <= b[j], lexicographic over the NW words (device memory)
template <int NW>
__device__ __forceinline__ bool le_global(const Words<NW>& a, i64 i,
                                          const Words<NW>& b, i64 j) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    i64 x = a.w[w][i], y = b.w[w][j];
    if (x != y) return x < y;
  }
  return true;
}

// The first k in [klo, khi) at which P(k * unit) fails, or khi, where
// P(x) = a[x] <= b[d - 1 - x] holds below the merge-path split and fails
// from it: each round the warp's 32 lanes test 32 evenly spaced k at once
template <int NW>
__device__ __forceinline__ i64 warp_search(const Words<NW>& a,
                                           const Words<NW>& b, i64 d,
                                           i64 unit, i64 klo, i64 khi,
                                           int lane) {
  while (klo < khi) {
    const i64 step = (khi - klo + 31) >> 5;
    const i64 k = klo + lane * step, x = k * unit;
    const bool p = k < khi && le_global<NW>(a, x, b, d - 1 - x);
    const int c = __popc(__ballot_sync(0xffffffffu, p));
    if (c == 0) break;                          // P fails at klo
    if (c < 32 && klo + c * step < khi) khi = klo + c * step;
    klo += (i64)(c - 1) * step + 1;
  }
  return klo;
}

// splits[t] = number of A elements among the first d = min(t * T, na +
// nb) outputs of merge(A, B), ties to A; one warp per t. A coarse search
// over the samples x = k * T (whose partners b[(t - k) * T - 1] are the
// same for every diagonal, so they stay in L2) narrows the split to one
// tile's width; a fine search finds it there.
template <int NW, int T>
__global__ void __launch_bounds__(PART_THREADS)
merge_partition(Words<NW> a, i64 na, Words<NW> b, i64 nb, i64 nsplit,
                i64* __restrict__ splits) {
  const i64 t = ((i64)blockIdx.x * PART_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= nsplit) return;                      // the whole warp
  const i64 n = na + nb;
  const i64 d = t * T < n ? t * T : n;
  i64 lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  const i64 klo = (lo + T - 1) / T, khi = (hi + T - 1) / T;
  const i64 kf = warp_search<NW>(a, b, d, T, klo, khi, lane);
  if (kf > klo) lo = (kf - 1) * T + 1;
  if (kf < khi) hi = kf * T;
  lo = warp_search<NW>(a, b, d, 1, lo, hi, lane);
  if (lane == 0) splits[t] = lo;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 0 or 1: is the address of p at an odd 8-byte slot of its 16 bytes
__device__ __forceinline__ int parity(const i64* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 3) & 1);
}

// Shared-memory slot of element p of a staged array: the eight 16-byte
// chunks of each 128-byte row (16 elements) are permuted by XOR with the
// row number, so threads whose windows lie ITEMS / 2 elements apart read
// different banks; a chunk keeps its two elements side by side.
__device__ __forceinline__ int swz(int p) {
  return p ^ (((p >> 4) & 7) << 1);
}

// Copy g[s .. s + c) into the staged array arr from slot off (even) on, as
// it lies from the 16-byte boundary at or below &g[s]: g[s + j] lands at
// slot off + par + j. Nothing outside the window is read.
template <int THREADS>
__device__ __forceinline__ void stage(i64* arr, int off, const i64* g, i64 s,
                                      int c, int par) {
  const int chunks = (par + c + 1) >> 1;
  for (int k = threadIdx.x; k < chunks; k += THREADS) {
    const int e = 2 * k - par;          // window index of the chunk's head
    const int q = off + 2 * k;
    if (e >= 0 && e + 1 < c) {
      cp_async16(arr + swz(q), g + s + e);
    } else {
      if (e >= 0) cp_async8(arr + swz(q), g + s + e);
      if (e + 1 >= 0 && e + 1 < c)
        cp_async8(arr + swz(q + 1), g + s + e + 1);
    }
  }
}

// One tile's windows: A[a0, a0 + ta) and B[b0, b0 + tb), merged into
// outputs [d0, d0 + ta + tb). Array x stages A[0] at pa[x] (its parity)
// and B[0] at pb[x] (the even slot after A's window plus B's parity).
template <int NA>
struct Tile {
  i64 d0, a0, b0;
  int ta, tb;
  int pa[NA], pb[NA];
};

template <int NA>
__device__ __forceinline__ Tile<NA> tile_of(i64 tile, i64 s0, i64 s1, i64 n,
                                            const i64* const* ga,
                                            const i64* const* gb) {
  constexpr int T = Shape<NA>::T;
  Tile<NA> t;
  t.d0 = tile * T;
  const i64 d1 = t.d0 + T < n ? t.d0 + T : n;
  t.a0 = s0;
  t.b0 = t.d0 - s0;
  t.ta = (int)(s1 - s0);
  t.tb = (int)(d1 - t.d0) - t.ta;
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    t.pa[x] = parity(ga[x] + t.a0);
    t.pb[x] = ((t.pa[x] + t.ta + 1) & ~1) + parity(gb[x] + t.b0);
  }
  return t;
}

template <int NA>
__device__ __forceinline__ void fetch(const Tile<NA>& t, i64* buf,
                                      const i64* const* ga,
                                      const i64* const* gb) {
  constexpr int BUF = Shape<NA>::BUF, THREADS = Shape<NA>::THREADS;
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    stage<THREADS>(buf + x * BUF, 0, ga[x], t.a0, t.ta, t.pa[x]);
    stage<THREADS>(buf + x * BUF, t.pb[x] & ~1, gb[x], t.b0, t.tb,
                   t.pb[x] & 1);
  }
}

// A[i] <= B[j] over the tile's staged words (stage buf)
template <int NW, int NA>
__device__ __forceinline__ bool le_shared(const Tile<NA>& t, const i64* buf,
                                          int i, int j) {
  constexpr int BUF = Shape<NA>::BUF;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    i64 x = buf[w * BUF + swz(t.pa[w] + i)];
    i64 y = buf[w * BUF + swz(t.pb[w] + j)];
    if (x != y) return x < y;
  }
  return true;
}

template <int NW>
__device__ __forceinline__ bool le_regs(const i64* x, const i64* y) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
    if (x[w] != y[w]) return x[w] < y[w];
  return true;
}

// this thread's ITEMS outputs: where each comes from (A's index, or ta +
// B's) into src, two 16-bit entries per 32-bit word
template <int NW, int NA>
__device__ __forceinline__ void merge_src(const Tile<NA>& t, const i64* buf,
                                          unsigned short* src) {
  constexpr int BUF = Shape<NA>::BUF;
  const int ta = t.ta, tb = t.tb, len = ta + tb;
  const int t0 = threadIdx.x * ITEMS;
  if (t0 >= len) return;
  int lo = t0 > tb ? t0 - tb : 0, hi = t0 < ta ? t0 : ta;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (le_shared<NW>(t, buf, mid, t0 - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = t0 - lo;
  // A[ta] and B[tb] lie inside the stage (BUF >= T + 4): read, not used
  i64 ka[NW], kb[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    ka[w] = buf[w * BUF + swz(t.pa[w] + i)];
    kb[w] = buf[w * BUF + swz(t.pb[w] + j)];
  }
  unsigned packed[ITEMS / 2];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    unsigned s = 0;
    if (t0 + q < len) {
      if (j >= tb || (i < ta && le_regs<NW>(ka, kb))) {
        s = i++;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          ka[w] = buf[w * BUF + swz(t.pa[w] + i)];
      } else {
        s = ta + j++;
#pragma unroll
        for (int w = 0; w < NW; ++w)
          kb[w] = buf[w * BUF + swz(t.pb[w] + j)];
      }
    }
    if (q & 1) packed[q >> 1] |= s << 16;
    else packed[q >> 1] = s;
  }
  uint4* dst = reinterpret_cast<uint4*>(src + t0);
#pragma unroll
  for (int v = 0; v < ITEMS / 8; ++v)
    dst[v] = make_uint4(packed[4 * v], packed[4 * v + 1], packed[4 * v + 2],
                        packed[4 * v + 3]);
}

// the tile's outputs in order, gathered from the stage, two per thread
// and array as one 16-byte store
template <int NA>
__device__ __forceinline__ void store_tile(const Tile<NA>& t, const i64* buf,
                                           const unsigned short* src,
                                           i64* const* go) {
  constexpr int BUF = Shape<NA>::BUF, THREADS = Shape<NA>::THREADS;
  const int len = t.ta + t.tb;
  const unsigned* src2 = reinterpret_cast<const unsigned*>(src);
  for (int p = threadIdx.x; 2 * p < len; p += THREADS) {
    const unsigned pr = src2[p];
    const int s0 = (int)(pr & 0xffff), s1 = (int)(pr >> 16);
    const bool two = 2 * p + 1 < len;
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const i64* arr = buf + x * BUF;
      const i64 v0 =
          arr[swz(s0 < t.ta ? t.pa[x] + s0 : t.pb[x] + s0 - t.ta)];
      i64* out = go[x] + t.d0 + 2 * p;
      if (two) {
        const i64 v1 =
            arr[swz(s1 < t.ta ? t.pa[x] + s1 : t.pb[x] + s1 - t.ta)];
        *reinterpret_cast<longlong2*>(out) = make_longlong2(v0, v1);
      } else {
        *out = v0;
      }
    }
  }
}

template <int NW, bool PAY>
__global__ void __launch_bounds__(Shape<NW + (PAY ? 1 : 0)>::THREADS)
merge_tiles(Words<NW> a, const i64* __restrict__ pay_a, i64 na, Words<NW> b,
            const i64* __restrict__ pay_b, i64 nb, OutWords<NW> o,
            i64* __restrict__ pay_o, const i64* __restrict__ splits,
            i64 ntiles) {
  constexpr int NA = NW + (PAY ? 1 : 0);
  constexpr int BUF = Shape<NA>::BUF;
  extern __shared__ __align__(16) i64 smem[];   // [2][NA][BUF], then src
  unsigned short* src = reinterpret_cast<unsigned short*>(smem + 2 * NA * BUF);
  const i64* ga[NA];
  const i64* gb[NA];
  i64* go[NA];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    ga[w] = a.w[w];
    gb[w] = b.w[w];
    go[w] = o.w[w];
  }
  if constexpr (PAY) {
    ga[NA - 1] = pay_a;
    gb[NA - 1] = pay_b;
    go[NA - 1] = pay_o;
  }
  const i64 n = na + nb;
  i64 tile = blockIdx.x;                        // < ntiles: grid <= ntiles
  Tile<NA> cur = tile_of<NA>(tile, splits[tile], splits[tile + 1], n, ga, gb);
  fetch<NA>(cur, smem, ga, gb);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  i64 nxt = tile + gridDim.x, s0 = 0, s1 = 0;
  if (nxt < ntiles) {
    s0 = splits[nxt];
    s1 = splits[nxt + 1];
  }
  for (int st = 0;; st ^= 1) {
    // the next tile's windows go into the other stage while this one merges
    Tile<NA> next = cur;
    if (nxt < ntiles) {
      next = tile_of<NA>(nxt, s0, s1, n, ga, gb);
      fetch<NA>(next, smem + (st ^ 1) * NA * BUF, ga, gb);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const i64 after = nxt + gridDim.x;          // its splits, loaded early
    if (after < ntiles) {
      s0 = splits[after];
      s1 = splits[after + 1];
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const i64* buf = smem + st * NA * BUF;
    merge_src<NW, NA>(cur, buf, src);
    __syncthreads();
    store_tile<NA>(cur, buf, src, go);
    if (nxt >= ntiles) break;
    __syncthreads();                            // the stage is free again
    cur = next;
    nxt = after;
  }
}

static size_t smem_bytes(int arrays) {
  const int t = tile_for(arrays);
  return (size_t)2 * arrays * (t + 16) * sizeof(i64) + t * sizeof(short);
}

template <int NW, bool PAY>
static int launch(const void* const* aw, const void* ap, int64_t na,
                  const void* const* bw, const void* bp, int64_t nb,
                  void* const* ow, void* op, i64* splits, int64_t nsplit,
                  cudaStream_t st) {
  constexpr int NA = NW + (PAY ? 1 : 0);
  constexpr int T = Shape<NA>::T, THREADS = Shape<NA>::THREADS;
  static int grid_of[MAX_DEVICES];   // persistent grid per device, set once
  const int64_t ntiles = (na + nb + T - 1) / T;
  if (nsplit != ntiles + 1) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(NA);
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!grid_of[dev]) {
    e = cudaFuncSetAttribute(merge_tiles<NW, PAY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_tiles<NW, PAY>, THREADS, smem);
    if (e) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_of[dev] = sms * per_sm;
  }
  Words<NW> a, b;
  OutWords<NW> o;
  for (int w = 0; w < NW; ++w) {
    a.w[w] = (const i64*)aw[w];
    b.w[w] = (const i64*)bw[w];
    o.w[w] = (i64*)ow[w];
  }
  const int warps = PART_THREADS / 32;
  merge_partition<NW, T><<<(unsigned)((nsplit + warps - 1) / warps),
                           PART_THREADS, 0, st>>>(a, na, b, nb, nsplit,
                                                  splits);
  e = cudaGetLastError();
  if (e) return e;
  const unsigned grid =
      (unsigned)(ntiles < grid_of[dev] ? ntiles : grid_of[dev]);
  merge_tiles<NW, PAY><<<grid, THREADS, smem, st>>>(
      a, (const i64*)ap, na, b, (const i64*)bp, nb, o, (i64*)op, splits,
      ntiles);
  return (int)cudaGetLastError();
}

template <int NW>
static int launch_nw(bool pay, const void* const* aw, const void* ap,
                     int64_t na, const void* const* bw, const void* bp,
                     int64_t nb, void* const* ow, void* op, i64* splits,
                     int64_t nsplit, cudaStream_t st) {
  return pay ? launch<NW, true>(aw, ap, na, bw, bp, nb, ow, op, splits,
                                nsplit, st)
             : launch<NW, false>(aw, ap, na, bw, bp, nb, ow, op, splits,
                                 nsplit, st);
}

extern "C" const char* km_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// outputs per tile of the merge for `arrays` staged arrays (key words
// plus payload): the wrapper sizes the split scratch from it
extern "C" int km_merge_tile(int arrays) { return tile_for(arrays); }

// dynamic shared memory of merge_tiles, in bytes, for `arrays` staged
// arrays
extern "C" int64_t km_merge_smem(int arrays) {
  return (int64_t)smem_bytes(arrays);
}

// Merge run A (na elements) and run B (nb) into out (na + nb elements).
// a, b and o are arrays of nw key-word pointers (word 0 most
// significant), 1 <= nw <= 5; ap/bp/op the payloads, all null for the
// payload-free form. splits is int64 scratch of nsplit = ceil((na + nb) /
// km_merge_tile(nw + payload)) + 1 entries. Inputs must be 8-byte and
// outputs 16-byte aligned. Two launches on `stream`: the partition, then
// the merge. Returns a cudaError_t.
extern "C" int km_merge_runs(int nw, const void* const* a, const void* ap,
                             int64_t na, const void* const* b, const void* bp,
                             int64_t nb, void* const* o, void* op,
                             void* splits, int64_t nsplit, void* stream) {
  if (na < 0 || nb < 0 || nw < 1 || nw > MAX_WORDS)
    return cudaErrorInvalidValue;
  const bool pay = op != 0;
  if ((ap != 0) != pay || (bp != 0) != pay) return cudaErrorInvalidValue;
  if (na + nb == 0) return 0;
  if ((na + nb + TILE_WIDE - 1) / TILE_WIDE > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  uintptr_t in = (uintptr_t)splits |
                 (pay ? (uintptr_t)ap | (uintptr_t)bp : 0);
  uintptr_t out = pay ? (uintptr_t)op : 0;
  for (int w = 0; w < nw; ++w) {
    in |= (uintptr_t)a[w] | (uintptr_t)b[w];
    out |= (uintptr_t)o[w];
  }
  if ((in & 7) || (out & 15)) return cudaErrorMisalignedAddress;
  i64* sp = (i64*)splits;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nw) {
    case 1:
      return launch_nw<1>(pay, a, ap, na, b, bp, nb, o, op, sp, nsplit, st);
    case 2:
      return launch_nw<2>(pay, a, ap, na, b, bp, nb, o, op, sp, nsplit, st);
    case 3:
      return launch_nw<3>(pay, a, ap, na, b, bp, nb, o, op, sp, nsplit, st);
    case 4:
      return launch_nw<4>(pay, a, ap, na, b, bp, nb, o, op, sp, nsplit, st);
    default:
      return launch_nw<5>(pay, a, ap, na, b, bp, nb, o, op, sp, nsplit, st);
  }
}
