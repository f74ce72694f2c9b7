// Merge-path merge of two ascending runs: kernels K3 (one key word, no
// payload) and K4 (one or two key words, an int64 payload).
//
// Replaces the Pallas TPU kernels kmtricks_tpu/ops/pallas_sort.py
// _merge_kernel (K3, via merge_sorted_runs_u32) and _merge_kernel_mw (K4,
// via merge_sorted_runs_words). Same output, bit for bit, as the plain
// PyTorch version kmtricks_tpu_torch/ops/merge_runs.py::
// merge_sorted_runs_torch: a stable sort of the concatenation A ++ B.
//
// Keys are NW in {1, 2} int64 words, compared lexicographically (word 0
// most significant) as signed int64, the order torch.sort uses; the port's
// sort words keep the top bit clear, so that is also their unsigned order.
// Equal keys take A's element first (the TPU split's `av <= bv`), which
// makes the merge stable. Runs are exactly sized: no sentinel padding, no
// power-of-two lengths, any length including 0.
//
// What bounds it on an H100: device-memory bytes. Each merged element is
// read once and written once: (8*NW + 8) bytes in and the same out per
// element per merge level with a payload (8*NW without). At 3.35 TB/s the
// floor for NW = 2 with a payload is 48 B / 3.35 TB/s = 14.3 ps per
// element per level, 1.43 ms for 100M elements. The arithmetic is a
// handful of compares per element.
//
// Design. One block owns one output tile of TILE = THREADS * ITEMS
// elements. It finds the tile's split of A and B (merge path: the number
// of A elements among the first d outputs) by a binary search in device
// memory at the tile's two diagonals; the TPU did this search in XLA
// outside the kernel. The block stages its A window and B window in shared
// memory with coalesced loads, each thread binary-searches its own
// diagonal in shared memory and merges ITEMS outputs one after another,
// writing the shared-memory source of each output; then the block writes
// the tile's keys (and gathers its payload) with coalesced stores. Shared
// memory: 8 * NW * TILE bytes of keys + 4 * TILE of sources = 40 KB at
// NW = 2, under the 48 KB static limit.
//
// Not carried over from the TPU kernel: the ALIGN-ed windows and
// _dyn_normalize (Mosaic DMA limits), the sentinel pad tiles, the sign
// flip (the TPU compares int32) and the Batcher odd-even network that
// stands in for a sequential merge on the vector unit. R runs merge as a
// tree of pairwise merges on the host side (ops/merge_runs.py).
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ITEMS 8
#define TILE (THREADS * ITEMS)

typedef long long i64;

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

// number of A elements among the first d outputs of merge(A, B)
template <int NW>
__device__ i64 split_global(const Words<NW>& a, i64 na, const Words<NW>& b,
                            i64 nb, i64 d) {
  i64 lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    i64 mid = (lo + hi) >> 1;
    if (le_global<NW>(a, mid, b, d - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// s[i] <= s[j] over the staged words (shared memory)
template <int NW>
__device__ __forceinline__ bool le_shared(i64 (*s)[TILE], int i, int j) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    i64 x = s[w][i], y = s[w][j];
    if (x != y) return x < y;
  }
  return true;
}

template <int NW, bool PAYLOAD>
__global__ void __launch_bounds__(THREADS)
merge_tile(Words<NW> a, const i64* __restrict__ pa, i64 na, Words<NW> b,
           const i64* __restrict__ pb, i64 nb, OutWords<NW> o,
           i64* __restrict__ po) {
  __shared__ i64 sk[NW][TILE];   // A window, then B window
  __shared__ int src[TILE];      // staged position of each output
  __shared__ i64 split[2];
  const i64 n = na + nb;
  const i64 d0 = (i64)blockIdx.x * TILE;
  const i64 d1 = d0 + TILE < n ? d0 + TILE : n;
  if (threadIdx.x < 2)
    split[threadIdx.x] =
        split_global<NW>(a, na, b, nb, threadIdx.x ? d1 : d0);
  __syncthreads();
  const i64 a0 = split[0], b0 = d0 - a0;
  const int len = (int)(d1 - d0);
  const int ta = (int)(split[1] - a0), tb = len - ta;
  for (int j = threadIdx.x; j < ta; j += THREADS) {
#pragma unroll
    for (int w = 0; w < NW; ++w) sk[w][j] = a.w[w][a0 + j];
  }
  for (int j = threadIdx.x; j < tb; j += THREADS) {
#pragma unroll
    for (int w = 0; w < NW; ++w) sk[w][ta + j] = b.w[w][b0 + j];
  }
  __syncthreads();

  // this thread's diagonal within the tile, then a sequential merge
  const int t0 = min((int)threadIdx.x * ITEMS, len);
  const int t1 = min(t0 + ITEMS, len);
  int lo = t0 > tb ? t0 - tb : 0, hi = t0 < ta ? t0 : ta;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (le_shared<NW>(sk, mid, ta + t0 - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int i = lo, j = t0 - lo;
  for (int q = t0; q < t1; ++q) {
    bool take_a = j >= tb || (i < ta && le_shared<NW>(sk, i, ta + j));
    src[q] = take_a ? i++ : ta + j++;
  }
  __syncthreads();

  for (int q = threadIdx.x; q < len; q += THREADS) {
    int s = src[q];
#pragma unroll
    for (int w = 0; w < NW; ++w) o.w[w][d0 + q] = sk[w][s];
    if (PAYLOAD) po[d0 + q] = s < ta ? pa[a0 + s] : pb[b0 + s - ta];
  }
}

template <int NW, bool PAYLOAD>
static int launch(const void* const* aw, const void* ap, int64_t na,
                  const void* const* bw, const void* bp, int64_t nb,
                  void* const* ow, void* op, cudaStream_t st) {
  Words<NW> a, b;
  OutWords<NW> o;
  for (int w = 0; w < NW; ++w) {
    a.w[w] = (const i64*)aw[w];
    b.w[w] = (const i64*)bw[w];
    o.w[w] = (i64*)ow[w];
  }
  const int64_t n = na + nb;
  const unsigned grid = (unsigned)((n + TILE - 1) / TILE);
  merge_tile<NW, PAYLOAD><<<grid, THREADS, 0, st>>>(
      a, (const i64*)ap, na, b, (const i64*)bp, nb, o, (i64*)op);
  return (int)cudaGetLastError();
}

extern "C" const char* km_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Merge run A (na elements) and run B (nb) into out (na + nb elements).
// a1/b1/o1 are the second key words (ignored when nw == 1); ap/bp/op the
// payloads, all null for the payload-free form. Returns a cudaError_t.
extern "C" int km_merge_runs(int nw, const void* a0, const void* a1,
                             const void* ap, int64_t na, const void* b0,
                             const void* b1, const void* bp, int64_t nb,
                             void* o0, void* o1, void* op, void* stream) {
  if (na < 0 || nb < 0 || (nw != 1 && nw != 2)) return cudaErrorInvalidValue;
  const bool pay = op != 0;
  if ((ap != 0) != pay || (bp != 0) != pay) return cudaErrorInvalidValue;
  if (na + nb == 0) return 0;
  if ((na + nb + TILE - 1) / TILE > 0x7fffffffLL) return cudaErrorInvalidValue;
  const void* aw[2] = {a0, a1};
  const void* bw[2] = {b0, b1};
  void* ow[2] = {o0, o1};
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 1)
    return pay ? launch<1, true>(aw, ap, na, bw, bp, nb, ow, op, st)
               : launch<1, false>(aw, ap, na, bw, bp, nb, ow, op, st);
  return pay ? launch<2, true>(aw, ap, na, bw, bp, nb, ow, op, st)
             : launch<2, false>(aw, ap, na, bw, bp, nb, ow, op, st);
}
