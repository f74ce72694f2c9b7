// Count+merge segment-stage kernels K1 (backward) and K2 (forward).
//
// Replaces the Pallas TPU kernels kmtricks_tpu/ops/pallas_segscan.py
// _bwd_kernel (K1) and _fwd_kernel (K2), reached through
// segment_stage_pallas. Same outputs, bit for bit, as the plain PyTorch
// version kmtricks_tpu_torch/ops/segscan.py::segment_stage_torch.
//
// What bounds it on an H100: device-memory bytes. Every element is a
// handful of flag bytes and int32s read and written once per pass (K1 reads
// 15 B and writes 10 B per element over its three element passes, K2 reads
// 19 B and writes 10 B over its two); the arithmetic is a few integer ops
// per element.
//
// Design. The TPU grid runs tiles in order and carries scalars in SMEM
// from one tile to the next; CUDA blocks run in any order, so each pass is
// split into per-tile summaries, one single-block scan over the tile
// summaries, and a per-tile apply with the incoming carry. The carries are
// chained, and are resolved in dependency order:
//   K1: (A) per tile, the first occurrence boundary;
//       (B) scan -> next boundary after each tile;
//       (C) per tile: run lengths, hard-min, saturation, solid, and the
//           tile's segmented-suffix-sum summary (needs B: solid after a
//           tile's last boundary depends on tiles to the right);
//       (D) scan -> suffix-sum carry entering each tile from the right;
//       (E) per tile: the segmented suffix sum of solid.
//   K2: (F) per tile: head suffix carry, "segment already had a present
//           entry" carry, row-head count with that carry clear, and whether
//           a present entry precedes the tile's first key head;
//       (G) scan -> all three carries (the row count needs the present
//           carry first);
//       (H) per tile: solid_in, row heads, rescue, final, keep, row index.
// Inside a tile each of 256 threads owns 16 consecutive elements; thread
// aggregates are combined with a block-wide Hillis-Steele scan. All values
// are int32 (counts and indices < 2^31), flags are bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 4096
#define THREADS 256
#define ITEMS (TILE / THREADS)
#define SCAN_THREADS 1024
#define BIG 0x7fffffff

typedef unsigned char u8;

// ---------------------------------------------------------------------------
// Scan operators. op(a, b) composes a (earlier in scan order, i.e. nearer
// the carry's source) with b (later). apply(g, c) runs carry c through g.
// ---------------------------------------------------------------------------

struct MinOp {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};

struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// segmented suffix sum, scanned right to left: element i is (solid_i,
// stop_i); value_i = solid_i + (stop_i ? 0 : value_{i+1})
struct Seg { int s, f; };
struct SegOp {
  __device__ Seg operator()(Seg a, Seg b) const {
    Seg r; r.s = b.s + (b.f ? 0 : a.s); r.f = a.f | b.f; return r;
  }
};
__device__ __forceinline__ int seg_apply(Seg g, int c) {
  return g.s + (g.f ? 0 : c);
}

// forward carries of K2: the suffix of the last key head (v, h) and the
// "segment had a present entry" state (e, eh): e_out = eh ? e : (e_in | e)
struct Fwd { int v, h, e, eh; };
struct FwdOp {
  __device__ Fwd operator()(Fwd a, Fwd b) const {
    Fwd r;
    r.v = b.h ? b.v : a.v;
    r.h = a.h | b.h;
    r.e = b.eh ? b.e : (a.e | b.e);
    r.eh = a.eh | b.eh;
    return r;
  }
};

// Block-wide exclusive scan in scan order ``li`` (a permutation of the
// thread index); optionally returns the block total.
template <typename T, typename Op>
__device__ T block_scan(T v, T ident, Op op, T* sh, int li, T* total) {
  sh[li] = v;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    T other = ident;
    if (li >= off) other = sh[li - off];
    __syncthreads();
    if (li >= off) { v = op(other, v); sh[li] = v; }
    __syncthreads();
  }
  T excl = li > 0 ? sh[li - 1] : ident;
  if (total) *total = sh[blockDim.x - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ int is_mark(const u8* occ, const u8* valid,
                                       int64_t i) {
  return occ[i] | !valid[i];
}

__device__ __forceinline__ int stop_at(const u8* kd, int64_t i, int64_t n) {
  return i + 1 < n ? kd[i + 1] : 1;
}

// ---------------------------------------------------------------------------
// K1: backward pass
// ---------------------------------------------------------------------------

// (A) first occurrence boundary (mark = occ_diff | ~valid) of each tile
__global__ void k1_first_mark(const u8* occ, const u8* valid, int64_t n,
                              int* minmark) {
  __shared__ int sh[THREADS];
  int64_t base = (int64_t)blockIdx.x * TILE;
  int m = BIG;
  for (int e = threadIdx.x; e < TILE; e += THREADS) {
    int64_t i = base + e;
    if (i < n && is_mark(occ, valid, i)) m = min(m, (int)i);
  }
  int tot;
  block_scan(m, BIG, MinOp(), sh, threadIdx.x, &tot);
  if (threadIdx.x == 0) minmark[blockIdx.x] = tot;
}

// (B) nb[t] = min(first marks of tiles > t, n)
__global__ void k1_scan_next(const int* minmark, int nt, int n, int* nb) {
  __shared__ int sh[SCAN_THREADS];
  int per = (nt + SCAN_THREADS - 1) / SCAN_THREADS;
  int s0 = min((int)threadIdx.x * per, nt), s1 = min(s0 + per, nt);
  int agg = BIG;
  for (int s = s0; s < s1; ++s) agg = min(agg, minmark[nt - 1 - s]);
  int run = block_scan(agg, BIG, MinOp(), sh, threadIdx.x, (int*)0);
  for (int s = s0; s < s1; ++s) {
    int t = nt - 1 - s;
    nb[t] = min(run, n);
    run = min(run, minmark[t]);
  }
}

// (C) run lengths at occurrence heads, hard-min, saturation, solid; the
// tile's segmented-suffix-sum summary of solid
__global__ void k1_count(const u8* occ, const u8* kd, const u8* valid,
                         const int* amin, const int* hmin, int64_t n,
                         int cmax, const int* nb_in, int* cnt, u8* present,
                         u8* solid, int* seg_s, int* seg_f) {
  __shared__ int shm[THREADS];
  __shared__ Seg shs[THREADS];
  int t = blockIdx.x;
  int li = THREADS - 1 - threadIdx.x;      // right-to-left scan order
  int64_t base = (int64_t)t * TILE + (int64_t)threadIdx.x * ITEMS;
  int m = BIG;
  for (int e = 0; e < ITEMS; ++e) {
    int64_t i = base + e;
    if (i < n && is_mark(occ, valid, i)) m = min(m, (int)i);
  }
  int nb = min(block_scan(m, BIG, MinOp(), shm, li, (int*)0), nb_in[t]);
  Seg agg = {0, 0};
  for (int e = ITEMS - 1; e >= 0; --e) {
    int64_t i = base + e;
    if (i >= n) continue;
    int oh = occ[i] & valid[i];
    int c_raw = oh ? nb - (int)i : 0;
    int pres = oh && c_raw >= hmin[i];
    int c = min(c_raw, cmax);
    int sol = pres && c >= amin[i];
    cnt[i] = c;
    present[i] = (u8)pres;
    solid[i] = (u8)sol;
    if (is_mark(occ, valid, i)) nb = (int)i;
    Seg g = {sol, stop_at(kd, i, n)};
    agg = SegOp()(agg, g);
  }
  Seg tot;
  block_scan(agg, Seg{0, 0}, SegOp(), shs, li, &tot);
  if (threadIdx.x == 0) { seg_s[t] = tot.s; seg_f[t] = tot.f; }
}

// (D) ks[t] = suffix sum entering tile t from the right
__global__ void k1_scan_suffix(const int* seg_s, const int* seg_f, int nt,
                               int* ks) {
  __shared__ Seg sh[SCAN_THREADS];
  int per = (nt + SCAN_THREADS - 1) / SCAN_THREADS;
  int s0 = min((int)threadIdx.x * per, nt), s1 = min(s0 + per, nt);
  Seg agg = {0, 0};
  for (int s = s0; s < s1; ++s) {
    Seg g = {seg_s[nt - 1 - s], seg_f[nt - 1 - s]};
    agg = SegOp()(agg, g);
  }
  Seg run = block_scan(agg, Seg{0, 0}, SegOp(), sh, threadIdx.x, (Seg*)0);
  for (int s = s0; s < s1; ++s) {
    int t = nt - 1 - s;
    ks[t] = seg_apply(run, 0);
    Seg g = {seg_s[t], seg_f[t]};
    run = SegOp()(run, g);
  }
}

// (E) segmented suffix sum of solid within key segments
__global__ void k1_suffix(const u8* solid, const u8* kd, int64_t n,
                          const int* ks, int* suffix) {
  __shared__ Seg shs[THREADS];
  int t = blockIdx.x;
  int li = THREADS - 1 - threadIdx.x;
  int64_t base = (int64_t)t * TILE + (int64_t)threadIdx.x * ITEMS;
  Seg agg = {0, 0};
  for (int e = ITEMS - 1; e >= 0; --e) {
    int64_t i = base + e;
    if (i >= n) continue;
    Seg g = {solid[i], stop_at(kd, i, n)};
    agg = SegOp()(agg, g);
  }
  Seg excl = block_scan(agg, Seg{0, 0}, SegOp(), shs, li, (Seg*)0);
  int c = seg_apply(excl, ks[t]);
  for (int e = ITEMS - 1; e >= 0; --e) {
    int64_t i = base + e;
    if (i >= n) continue;
    c = solid[i] + (stop_at(kd, i, n) ? 0 : c);
    suffix[i] = c;
  }
}

// ---------------------------------------------------------------------------
// K2: forward pass
// ---------------------------------------------------------------------------

struct FwdTile {       // per-tile scratch rows
  int *v, *h, *e, *eh, *cnt0, *pf, *si_in, *emt_in;
};

// (F) with APPLY = false: per-tile summaries with all carries clear.
// (H) with APPLY = true: outputs with the carries from (G).
template <bool APPLY>
__global__ void k2_tile(const u8* present, const u8* solid,
                        const int* suffix, const u8* kd, const u8* valid,
                        const int* cnt, int64_t n, int rmin, int save_if,
                        FwdTile sc, int* final_, u8* row_head, u8* row_keep,
                        int* row_of) {
  __shared__ Fwd shf[THREADS];
  __shared__ int shr[THREADS];
  __shared__ int first_head;
  int t = blockIdx.x;
  int64_t tbase = (int64_t)t * TILE;
  int64_t base = tbase + (int64_t)threadIdx.x * ITEMS;
  if (threadIdx.x == 0) first_head = TILE;
  int pres[ITEMS], kh[ITEMS], suf[ITEMS];
  Fwd agg = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    int64_t i = base + e;
    if (i < n) {
      pres[e] = present[i];
      kh[e] = kd[i] & valid[i];
      suf[e] = suffix[i];
    } else {
      pres[e] = 0; kh[e] = 0; suf[e] = 0;
    }
    Fwd g = {suf[e], kh[e], pres[e], kh[e]};
    agg = FwdOp()(agg, g);
  }
  __syncthreads();                                   // first_head init
  Fwd tot;
  Fwd excl = block_scan(agg, Fwd{0, 0, 0, 0}, FwdOp(), shf, threadIdx.x,
                        &tot);
  int si = APPLY ? sc.si_in[t] : 0;
  int emt = APPLY ? sc.emt_in[t] : 0;
  si = excl.h ? excl.v : si;
  emt = excl.eh ? excl.e : (emt | excl.e);
  // row heads of this thread's elements
  unsigned heads = 0;
  int nheads = 0, st = emt;
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    int before = kh[e] ? 0 : st;
    int rh = pres[e] && !before;
    heads |= (unsigned)rh << e;
    nheads += rh;
    st = kh[e] ? pres[e] : (st | pres[e]);
  }
  int tot_heads;
  int rows = block_scan(nheads, 0, AddOp(), shr, threadIdx.x, &tot_heads);
  if (!APPLY) {
    for (int e = 0; e < ITEMS; ++e)
      if (kh[e]) { atomicMin(&first_head, threadIdx.x * ITEMS + e); break; }
    __syncthreads();
    int pf = 0;
    for (int e = 0; e < ITEMS; ++e)
      pf |= pres[e] && threadIdx.x * ITEMS + e < first_head;
    pf = __syncthreads_or(pf);
    if (threadIdx.x == 0) {
      sc.v[t] = tot.v; sc.h[t] = tot.h; sc.e[t] = tot.e; sc.eh[t] = tot.eh;
      sc.cnt0[t] = tot_heads; sc.pf[t] = pf;
    }
    return;
  }
  rows += sc.cnt0[t];                   // (G) stored the row carry here
#pragma unroll
  for (int e = 0; e < ITEMS; ++e) {
    int64_t i = base + e;
    if (i >= n) break;
    if (kh[e]) si = suf[e];
    int rh = (heads >> e) & 1;
    rows += rh;
    int sol = solid[i];
    int rescued = save_if > 0 && pres[e] && !sol && si >= save_if;
    final_[i] = (sol || rescued) ? cnt[i] : 0;
    row_head[i] = (u8)rh;
    row_keep[i] = (u8)(rh && si >= rmin);
    row_of[i] = max(rows - 1, 0);
  }
}

// (G) si_in / emt_in: carries entering each tile from the left; then the
// row carry, whose per-tile delta needs emt_in (stored over cnt0)
__global__ void k2_scan(FwdTile sc, int nt) {
  __shared__ Fwd shf[SCAN_THREADS];
  __shared__ int shr[SCAN_THREADS];
  int per = (nt + SCAN_THREADS - 1) / SCAN_THREADS;
  int s0 = min((int)threadIdx.x * per, nt), s1 = min(s0 + per, nt);
  Fwd agg = {0, 0, 0, 0};
  for (int s = s0; s < s1; ++s) {
    Fwd g = {sc.v[s], sc.h[s], sc.e[s], sc.eh[s]};
    agg = FwdOp()(agg, g);
  }
  Fwd run = block_scan(agg, Fwd{0, 0, 0, 0}, FwdOp(), shf, threadIdx.x,
                       (Fwd*)0);
  int dsum = 0;
  for (int s = s0; s < s1; ++s) {
    sc.si_in[s] = run.h ? run.v : 0;
    int emt = run.eh ? run.e : 0;
    sc.emt_in[s] = emt;
    Fwd g = {sc.v[s], sc.h[s], sc.e[s], sc.eh[s]};
    run = FwdOp()(run, g);
    dsum += sc.cnt0[s] - (emt & sc.pf[s]);
  }
  int rows = block_scan(dsum, 0, AddOp(), shr, threadIdx.x, (int*)0);
  for (int s = s0; s < s1; ++s) {
    int d = sc.cnt0[s] - (sc.emt_in[s] & sc.pf[s]);
    sc.cnt0[s] = rows;
    rows += d;
  }
}

// ---------------------------------------------------------------------------
// C interface. Each function launches its pass on ``stream`` and returns
// the first non-zero cudaGetLastError() (0 on success). ``scratch`` holds
// 8 int32 rows of ceil(n / TILE) entries.
// ---------------------------------------------------------------------------

#define LAUNCH_CHECK()                                   \
  do {                                                   \
    cudaError_t err_ = cudaGetLastError();               \
    if (err_ != cudaSuccess) return (int)err_;           \
  } while (0)

extern "C" int km_segscan_tile() { return TILE; }

extern "C" const char* km_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int km_segscan_bwd(const void* occ_diff, const void* key_diff,
                              const void* valid, const void* amin,
                              const void* hmin, int64_t n, int cmax,
                              void* cnt, void* present, void* solid,
                              void* suffix, void* scratch, void* stream) {
  if (n <= 0) return 0;
  int nt = (int)((n + TILE - 1) / TILE);
  int* sc = (int*)scratch;
  int *minmark = sc, *nb = sc + nt, *seg_s = sc + 2 * nt,
      *seg_f = sc + 3 * nt, *ks = sc + 4 * nt;
  cudaStream_t st = (cudaStream_t)stream;
  const u8 *occ = (const u8*)occ_diff, *kd = (const u8*)key_diff,
           *vld = (const u8*)valid;
  k1_first_mark<<<nt, THREADS, 0, st>>>(occ, vld, n, minmark);
  LAUNCH_CHECK();
  k1_scan_next<<<1, SCAN_THREADS, 0, st>>>(minmark, nt, (int)n, nb);
  LAUNCH_CHECK();
  k1_count<<<nt, THREADS, 0, st>>>(occ, kd, vld, (const int*)amin,
                                   (const int*)hmin, n, cmax, nb,
                                   (int*)cnt, (u8*)present, (u8*)solid,
                                   seg_s, seg_f);
  LAUNCH_CHECK();
  k1_scan_suffix<<<1, SCAN_THREADS, 0, st>>>(seg_s, seg_f, nt, ks);
  LAUNCH_CHECK();
  k1_suffix<<<nt, THREADS, 0, st>>>((const u8*)solid, kd, n, ks,
                                    (int*)suffix);
  LAUNCH_CHECK();
  return 0;
}

extern "C" int km_segscan_fwd(const void* present, const void* solid,
                              const void* suffix, const void* key_diff,
                              const void* valid, const void* cnt, int64_t n,
                              int rmin, int save_if, void* final_,
                              void* row_head, void* row_keep, void* row_of,
                              void* scratch, void* stream) {
  if (n <= 0) return 0;
  int nt = (int)((n + TILE - 1) / TILE);
  int* s = (int*)scratch;
  FwdTile sc = {s, s + nt, s + 2 * nt, s + 3 * nt, s + 4 * nt, s + 5 * nt,
                s + 6 * nt, s + 7 * nt};
  cudaStream_t st = (cudaStream_t)stream;
  const u8 *pres = (const u8*)present, *sol = (const u8*)solid,
           *kd = (const u8*)key_diff, *vld = (const u8*)valid;
  k2_tile<false><<<nt, THREADS, 0, st>>>(pres, sol, (const int*)suffix, kd,
                                         vld, (const int*)cnt, n, rmin,
                                         save_if, sc, (int*)0, (u8*)0,
                                         (u8*)0, (int*)0);
  LAUNCH_CHECK();
  k2_scan<<<1, SCAN_THREADS, 0, st>>>(sc, nt);
  LAUNCH_CHECK();
  k2_tile<true><<<nt, THREADS, 0, st>>>(pres, sol, (const int*)suffix, kd,
                                        vld, (const int*)cnt, n, rmin,
                                        save_if, sc, (int*)final_,
                                        (u8*)row_head, (u8*)row_keep,
                                        (int*)row_of);
  LAUNCH_CHECK();
  return 0;
}
