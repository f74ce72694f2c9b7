"""Port run merge (plain PyTorch version of kernels K3/K4) against numpy
lexsort and against the JAX package's Pallas merge
``merge_sorted_runs_words`` in interpret mode, and a CPU model of the CUDA
kernels against the plain version. All outputs are integers: exact
equality."""

import os
import re

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops.pallas_sort import TILE, merge_sorted_runs_words
from kmtricks_tpu_torch import _build
from kmtricks_tpu_torch.ops import merge_runs as MR
from kmtricks_tpu_torch.ops.merge_runs import (
    merge_sorted_runs, merge_sorted_runs_torch)

torch.set_num_threads(2)


def make_runs(rng, lens, nw, payload=True, span=1 << 62):
    """Ascending runs of ``nw`` int64 words (top bit clear) with values
    drawn from a small pool, so equal keys occur within and across runs.
    The payload numbers every entry in concatenation order, which shows
    where each output came from."""
    pool = [rng.integers(0, span, max(8, sum(lens) // 3), dtype=np.int64)
            for _ in range(nw)]
    runs, base = [], 0
    for n in lens:
        pick = rng.integers(0, len(pool[0]), n)
        cols = [p[pick] for p in pool]
        order = np.lexsort(cols[::-1])
        words = tuple(torch.from_numpy(np.ascontiguousarray(c[order]))
                      for c in cols)
        pay = torch.arange(base, base + n, dtype=torch.int64) \
            if payload else None
        runs.append((words, pay))
        base += n
    return runs


def lexsort_reference(runs):
    """numpy: stable lexsort of the concatenation (first word most
    significant), payload gathered by the permutation."""
    nw = len(runs[0][0])
    cols = [np.concatenate([r[0][j].numpy() for r in runs])
            for j in range(nw)]
    order = np.lexsort(cols[::-1])      # lexsort is stable
    pay = None
    if runs[0][1] is not None:
        pay = np.concatenate([r[1].numpy() for r in runs])[order]
    return [c[order] for c in cols], pay


GRID = [
    (2, 1, [TILE, TILE]),
    (4, 1, [TILE] * 4),
    (8, 2, [TILE] * 8),
    (2, 2, [TILE + 1000, 3 * TILE - 512]),     # not powers of two
    (3, 1, [5000, 0, 777]),                     # short and empty runs
    (5, 2, [1, 2, 0, 300, 8191]),
    (6, 1, [100] * 6),                          # ties across runs
    (7, 2, [4096, 123, 9000, 0, 17, 2048, 5]),
    (3, 3, [2048, 2049, 2047]),                 # the kw layouts' words
    (4, 4, [5000, 0, 1, 3000]),
    (2, 5, [TILE + 7, 2 * TILE - 1]),
]


@pytest.mark.parametrize("nruns,nw,lens", GRID,
                         ids=[f"r{g[0]}w{g[1]}" for g in GRID])
@pytest.mark.parametrize("payload", [True, False],
                         ids=["payload", "keys_only"])
def test_merge_matches_lexsort(nruns, nw, lens, payload):
    assert len(lens) == nruns
    rng = np.random.default_rng(nruns * 10 + nw)
    span = 1 << 62 if nruns != 6 else 50          # ties across runs
    runs = make_runs(rng, lens, nw, payload, span)
    words, pay = merge_sorted_runs(runs)
    exp_words, exp_pay = lexsort_reference(runs)
    assert len(words) == nw
    for g, e in zip(words, exp_words):
        np.testing.assert_array_equal(g.numpy(), e)
    if payload:
        # equal keys keep their run order: the payload is the stable order
        np.testing.assert_array_equal(pay.numpy(), exp_pay)
    else:
        assert pay is None


def test_merge_ties_keep_run_order():
    """Every key equal: the output is run 0, then run 1, then run 2."""
    runs = [((torch.full((n,), 7, dtype=torch.int64),),
             torch.full((n,), r, dtype=torch.int64))
            for r, n in enumerate((3, 5, 2))]
    _words, pay = merge_sorted_runs_torch(runs)
    assert pay.tolist() == [0] * 3 + [1] * 5 + [2] * 2


def _msb_u32(x):
    """int64 words -> msb-first (hi, lo) u32 words, the JAX layout."""
    u = x.astype(np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("nruns,nw", [(2, 2), (4, 1)])
def test_merge_matches_pallas_interpret(nruns, nw):
    """The JAX Pallas multi-word merge (interpret mode) over the same runs,
    each int64 word split into msb-first u32 pairs, gives the same keys."""
    rng = np.random.default_rng(100 + nruns * nw)
    runs = make_runs(rng, [TILE] * nruns, nw, payload=False)
    words, _ = merge_sorted_runs(runs)
    u32 = []
    for j in range(nw):
        hi, lo = zip(*(_msb_u32(r[0][j].numpy()) for r in runs))
        u32 += [np.stack(hi), np.stack(lo)]
    got = merge_sorted_runs_words(tuple(u32), interpret=True)
    got = [np.asarray(g) for g in got]
    for j in range(nw):
        exp = ((got[2 * j].astype(np.uint64) << np.uint64(32))
               | got[2 * j + 1]).view(np.int64)
        np.testing.assert_array_equal(words[j].numpy(), exp)


def test_merge_rejects_bad_runs():
    w = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        merge_sorted_runs([((w,), None), ((w.to(torch.int32),), None)])
    with pytest.raises(ValueError):
        merge_sorted_runs([((w,), w), ((w,), None)])
    with pytest.raises(ValueError):
        merge_sorted_runs([((w,) * 6, None)])       # 1 to 5 key words
    with pytest.raises(ValueError):
        merge_sorted_runs([((w,) * 3, w), ((w,) * 2, w)])
    m = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError):
        merge_sorted_runs([((m,), None), ((m,), None)])


def test_wrapper_sizes_split_scratch_from_merge_tile():
    """The wrapper hands the kernel one split per tile boundary of the
    tile its instantiation is built with (``_build.merge_tile``: the
    source's TILE for up to three staged arrays, TILE_WIDE for four to
    six), the key words as a pointer array, and counts one partition and
    one merge launch per pairwise merge."""
    src = os.path.join(os.path.dirname(_build.__file__), "csrc",
                       "merge_runs.cu")
    with open(src) as f:
        text = f.read()
    tile = int(re.search(r"#define TILE (\d+)", text)[1])
    wide = int(re.search(r"#define TILE_WIDE (\d+)", text)[1])
    assert (tile, wide) == (_build.MERGE_TILE, _build.MERGE_TILE_WIDE)
    assert [_build.merge_tile(a) for a in range(1, 7)] == [tile] * 3 + [
        wide] * 3

    class FakeLib:
        calls = []

        def km_merge_runs(self, *args):
            self.calls.append(args)
            return 0

    rng = np.random.default_rng(5)
    before = dict(MR.LAUNCHES)
    for lens, nw, payload in (([1, 0], 1, False), ([2, 3], 1, False),
                              ([tile, 0], 2, True), ([tile - 1, 1], 1, True),
                              ([tile, 1], 2, False),
                              ([3 * tile + 5, 2 * tile], 2, True),
                              ([tile, 1], 3, False),
                              ([wide, 1], 3, True),
                              ([2 * wide + 1, wide - 1], 5, True)):
        lib = FakeLib()
        lib.calls = []
        a, b = make_runs(rng, lens, nw, payload)
        MR._merge_two_cuda(a, b, lib, 0)
        n = sum(lens)
        if min(lens) == 0:
            assert not lib.calls                 # nothing to merge
            continue
        (args,) = lib.calls
        t = tile if nw + payload <= 3 else wide
        assert args[0] == nw and args[-2] == -(-n // t) + 1
        assert args[3] == lens[0] and args[6] == lens[1]
        assert list(args[1]) == [w.data_ptr() for w in a[0]]
        assert list(args[4]) == [w.data_ptr() for w in b[0]]
        assert (args[2] is None) == (args[8] is None) == (not payload)
    counted = {k: MR.LAUNCHES[k] - before[k] for k in MR.LAUNCHES}
    assert counted == {"K3": 1, "K4": 6, "K3_split": 1, "K4_split": 6}
    assert MR.split_scratch(2 * tile + 1, "cpu", tile).numel() == 4


# ---------------------------------------------------------------------------
# CPU model of the kernels of csrc/merge_runs.cu: the partition pass (one
# warp per tile boundary, M_LANES candidates a round, over the samples
# x = k * tile, then within one tile), the persistent tile
# walk over two shared-memory stages (the next tile staged while this one
# merges), the windows fetched from 16-byte boundaries and read at their
# 0/1 offsets through the chunk swizzle, the per-thread diagonals and
# sequential merges, and the
# gather in output order, at a tile of 64 (8 threads x 8 outputs) for up to
# three staged arrays and of 32 (4 threads) for four to six (model_shape),
# against the plain version. It checks the kernels' index algebra where no
# GPU runs them.
# ---------------------------------------------------------------------------

M_ITEMS = 8
M_LANES = 4         # lanes of the partition's warp (32 on the card)
M_GRID = 3          # persistent blocks


def model_shape(arrays):
    """(tile, threads) of the model kernel staging ``arrays`` arrays: a
    tile of 64 (8 threads x 8) for up to three, half of it for four to six,
    as ``_build.merge_tile`` halves 4096 to 2048."""
    tile = 64 if arrays <= 3 else 32
    return tile, tile // M_ITEMS


class Mem:
    """An int64 device array whose element 0 sits at 8-byte slot ``slot``
    (0 or 1) of its 16 bytes. Reads outside the array fail, and so do
    16-byte reads from an odd slot (cp.async needs aligned addresses)."""

    def __init__(self, data, slot=0):
        self.data, self.slot = np.asarray(data, dtype=np.int64), slot

    def read(self, i, k=1):
        assert 0 <= i and i + k <= len(self.data), "read outside the array"
        assert k == 1 or (self.slot + i) % 2 == 0, "unaligned 16-byte copy"
        return self.data[i:i + k]


def le_words(x, y):
    """x <= y over tuples of int64 words, first word most significant;
    ties are true (A's element first)."""
    for a, b in zip(x, y):
        if a != b:
            return a < b
    return True


def warp_search(A, B, d, unit, klo, khi):
    """warp_search(): the first k in [klo, khi) at which
    P(x) = A[x] <= B[d - 1 - x] fails at x = k * unit, or khi, testing
    M_LANES evenly spaced k a round."""
    while klo < khi:
        step = (khi - klo + M_LANES - 1) // M_LANES
        p = [klo + lane * step < khi and le_words(
            A((klo + lane * step) * unit),
            B(d - 1 - (klo + lane * step) * unit))
            for lane in range(M_LANES)]
        c = sum(p)
        assert p == [True] * c + [False] * (M_LANES - c)     # monotone
        if c == 0:
            break
        if c < M_LANES and klo + c * step < khi:
            khi = klo + c * step
        klo += (c - 1) * step + 1
    return klo


def model_partition(A, B, na, nb, tile):
    """merge_partition: the merge-path split at every tile boundary, a
    coarse search over the samples x = k * tile, then within one tile."""
    n = na + nb
    splits = np.zeros(-(-n // tile) + 1, dtype=np.int64)
    for t in range(len(splits)):
        d = min(t * tile, n)
        lo, hi = max(0, d - nb), min(d, na)
        klo, khi = -(-lo // tile), -(-hi // tile)
        kf = warp_search(A, B, d, tile, klo, khi)
        if kf > klo:
            lo = (kf - 1) * tile + 1
        if kf < khi:
            hi = kf * tile
        assert hi - lo < tile
        splits[t] = warp_search(A, B, d, 1, lo, hi)
    return splits


def swz(p):
    """The shared-memory slot of staged element p (chunks of each 16-element
    row permuted by XOR with the row number)."""
    return p ^ (((p >> 4) & 7) << 1)


def model_stage(arr, off, g, s, c, par):
    """stage(): g[s + j] -> slot swz(off + par + j) of arr, fetched in
    16-byte chunks from the boundary at or below g[s]; 8-byte copies at
    ragged ends."""
    assert off % 2 == 0
    for k in range((par + c + 1) >> 1):
        e, q = 2 * k - par, off + 2 * k
        if e >= 0 and e + 1 < c:
            assert swz(q) % 2 == 0 and swz(q + 1) == swz(q) + 1
            arr[swz(q):swz(q) + 2] = g.read(s + e, 2)
        else:
            if e >= 0:
                arr[swz(q)] = g.read(s + e)[0]
            if 0 <= e + 1 < c:
                arr[swz(q + 1)] = g.read(s + e + 1)[0]


def model_tile(tile, s0, s1, n, ga, gb, size):
    """tile_of(): the windows and each array's staged offsets (tiles of
    ``size`` outputs)."""
    d0 = tile * size
    ta = int(s1 - s0)
    tb = min(d0 + size, n) - d0 - ta
    pa = [(g.slot + int(s0)) & 1 for g in ga]
    pb = [((pa[x] + ta + 1) & ~1) + ((gb[x].slot + d0 - int(s0)) & 1)
          for x in range(len(ga))]
    return {"d0": d0, "a0": int(s0), "b0": d0 - int(s0), "ta": ta, "tb": tb,
            "pa": pa, "pb": pb}


def model_fetch(t, buf, ga, gb):
    for x in range(len(ga)):
        model_stage(buf[x], 0, ga[x], t["a0"], t["ta"], t["pa"][x])
        model_stage(buf[x], t["pb"][x] & ~1, gb[x], t["b0"], t["tb"],
                    t["pb"][x] & 1)


def model_merge_src(t, buf, src, nw, threads):
    """merge_src(): each thread's diagonal, then ITEMS outputs in turn."""
    ta, tb = t["ta"], t["tb"]
    pa, pb = t["pa"], t["pb"]

    def a_key(i):
        return tuple(buf[w][swz(pa[w] + i)] for w in range(nw))

    def b_key(j):
        return tuple(buf[w][swz(pb[w] + j)] for w in range(nw))

    for tid in range(threads):
        t0 = tid * M_ITEMS
        if t0 >= ta + tb:
            continue
        lo, hi = max(0, t0 - tb), min(t0, ta)
        while lo < hi:
            mid = (lo + hi) >> 1
            if le_words(a_key(mid), b_key(t0 - 1 - mid)):
                lo = mid + 1
            else:
                hi = mid
        i, j = lo, t0 - lo
        ka, kb = a_key(i), b_key(j)         # inside the stage, maybe unused
        for q in range(M_ITEMS):
            s = 0
            if t0 + q < ta + tb:
                if j >= tb or (i < ta and le_words(ka, kb)):
                    s, i = i, i + 1
                    ka = a_key(i)
                else:
                    s, j = ta + j, j + 1
                    kb = b_key(j)
            assert s < 1 << 16
            src[t0 + q] = s


def model_store(t, buf, src, outs):
    """store_tile(): two outputs per thread and array, gathered from the
    stage in output order (one 16-byte store at an even index)."""
    ta, n = t["ta"], t["ta"] + t["tb"]
    for p in range((n + 1) // 2):
        for x, out in enumerate(outs):
            for q in range(2 * p, min(2 * p + 2, n)):
                s = src[q]
                out[t["d0"] + q] = buf[x][swz(t["pa"][x] + s if s < ta
                                              else t["pb"][x] + s - ta)]


def model_kernel(a, b, slots=None):
    """km_merge_runs on two runs (words, payload) as numpy, each array at
    the 8-byte slot ``slots[side][x]``: the partition, then the
    persistent merge. Returns (words, payload)."""
    (aw, ap), (bw, bp) = a, b
    nw = len(aw)
    slots = slots or ((0,) * 6, (0,) * 6)
    ga = [Mem(x, slots[0][i]) for i, x in enumerate(
        list(aw) + ([] if ap is None else [ap]))]
    gb = [Mem(x, slots[1][i]) for i, x in enumerate(
        list(bw) + ([] if bp is None else [bp]))]
    na, nb = len(aw[0]), len(bw[0])
    n = na + nb
    outs = [np.full(n, -1, dtype=np.int64) for _ in ga]
    if n == 0:
        return outs[:nw], (None if ap is None else outs[nw])
    size, threads = model_shape(len(ga))
    splits = model_partition(
        lambda i: tuple(g.read(i)[0] for g in ga[:nw]),
        lambda j: tuple(g.read(j)[0] for g in gb[:nw]), na, nb, size)
    ntiles = len(splits) - 1
    grid = min(ntiles, M_GRID)
    rng = np.random.default_rng(n)
    for block in range(grid):
        # garbage, as shared memory holds it
        smem = rng.integers(-2**62, 2**62, (2, len(ga), size + 16))
        src = rng.integers(0, 1 << 16, size)
        tile, st = block, 0
        cur = model_tile(tile, splits[tile], splits[tile + 1], n, ga, gb,
                         size)
        model_fetch(cur, smem[0], ga, gb)
        nxt = tile + grid
        while True:
            if nxt < ntiles:
                nt = model_tile(nxt, splits[nxt], splits[nxt + 1], n, ga, gb,
                                size)
                model_fetch(nt, smem[st ^ 1], ga, gb)
            model_merge_src(cur, smem[st], src, nw, threads)
            model_store(cur, smem[st], src, outs)
            if nxt >= ntiles:
                break
            cur, nxt, st = nt, nxt + grid, st ^ 1
    return outs[:nw], (None if ap is None else outs[nw])


def model_merge(runs, slots=None):
    """The wrapper's tree of pairwise merges over the model kernel (the
    first level's arrays at ``slots``, outputs 16-byte aligned)."""
    level = [(tuple(w.numpy() for w in ws), None if p is None else p.numpy())
             for ws, p in runs]
    first = True
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            a, b = level[i], level[i + 1]
            if not len(b[0][0]):
                nxt.append(a)
            elif not len(a[0][0]):
                nxt.append(b)
            else:
                nxt.append(model_kernel(a, b, slots if first else None))
        if len(level) % 2:
            nxt.append(level[-1])
        level, first = nxt, False
    return level[0]


def equal_runs(lens, nw, payload, value=7):
    """Runs whose keys are all equal; the payload numbers the entries."""
    runs, base = [], 0
    for n in lens:
        runs.append((tuple(torch.full((n,), value, dtype=torch.int64)
                           for _ in range(nw)),
                     torch.arange(base, base + n) if payload else None))
        base += n
    return runs


def model_cases():
    for nruns, nw, lens in GRID:
        span = 1 << 62 if nruns != 6 else 50
        rng = np.random.default_rng(nruns * 10 + nw)
        yield f"grid_r{nruns}w{nw}", (make_runs(rng, lens, nw, True, span),
                                      None, False)
    yield "ties_over_4_tiles_w1", (equal_runs([100, 160], 1, True), None,
                                   False)
    yield "ties_3_runs_w2", (equal_runs([70, 130, 65], 2, True), None, False)
    rng = np.random.default_rng(7)
    yield "few_keys_w2", (make_runs(rng, [300, 257], 2, True, 3), None,
                          False)
    lo = torch.arange(200, dtype=torch.int64)
    hi = torch.arange(150, dtype=torch.int64) + (1 << 40)
    yield "a_wholly_before_b", ([((lo,), None), ((hi,), None)], None, False)
    yield "b_wholly_before_a", ([((hi,), None), ((lo,), None)], None, False)
    for lens in ([64, 64], [63, 65], [65, 64], [64, 63], [127, 1], [1, 127],
                 [128, 129], [192, 65]):
        rng = np.random.default_rng(sum(lens) * lens[0])
        yield f"edge_{lens[0]}_{lens[1]}", (
            make_runs(rng, lens, 2, True), None, False)
    for name, slots in (("a", ((1, 1, 0), (0, 0, 0))),
                        ("b", ((0, 0, 0), (1, 1, 0))),
                        ("payload", ((0, 0, 1), (0, 0, 1))),
                        ("mixed", ((1, 0, 1), (0, 1, 1))),
                        ("all", ((1, 1, 1), (1, 1, 1)))):
        rng = np.random.default_rng(len(name))
        yield f"odd_slots_{name}", (make_runs(rng, [203, 190], 2, True),
                                    slots, False)
    for lens in ([0, 100], [100, 0], [1, 200], [200, 1], [1, 1], [1, 64],
                 [0, 0]):
        rng = np.random.default_rng(lens[1] + 3)
        yield f"kernel_{lens[0]}_{lens[1]}", (
            make_runs(rng, lens, 1, True, 40), ((1, 0, 0), (1, 0, 1)), True)
    rng = np.random.default_rng(11)
    yield "two_words_payload", (make_runs(rng, [500, 460, 301], 2, True),
                                None, False)
    yield "one_word_keys_only", (make_runs(rng, [333, 444], 1, False), None,
                                 False)
    # the kw layouts' 3-5 key words: the 32-output tile of four to six
    # staged arrays (the 64 one of three), its edges, ties, odd slots
    for nw in (3, 4, 5):
        rng = np.random.default_rng(20 + nw)
        yield f"wide_w{nw}_payload", (make_runs(rng, [250, 199, 77], nw,
                                                True, 1 << 40), None, False)
        yield f"wide_w{nw}_few_keys", (make_runs(rng, [130, 97], nw, True,
                                                 2), None, False)
        yield f"wide_w{nw}_ties", (equal_runs([70, 33], nw, True), None,
                                   False)
        for lens in ([32, 32], [31, 33], [33, 32], [64, 1], [1, 95]):
            yield f"wide_w{nw}_edge_{lens[0]}_{lens[1]}", (
                make_runs(rng, lens, nw, True), None, False)
        slots = (tuple(rng.integers(0, 2, 6)), tuple(rng.integers(0, 2, 6)))
        yield f"wide_w{nw}_odd_slots", (make_runs(rng, [111, 150], nw, True),
                                        slots, False)
        yield f"wide_w{nw}_kernel_1_40", (make_runs(rng, [1, 40], nw, True),
                                          ((1,) * 6, (1,) * 6), True)
    rng = np.random.default_rng(30)
    yield "wide_w3_keys_only", (make_runs(rng, [200, 150], 3, False), None,
                                False)


MODEL_CASES = dict(model_cases())


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_matches_plain(case):
    runs, slots, direct = MODEL_CASES[case]
    exp_words, exp_pay = merge_sorted_runs_torch(runs)
    if direct:                     # the kernel itself, empty runs included
        a, b = [(tuple(w.numpy() for w in ws),
                 None if p is None else p.numpy()) for ws, p in runs]
        words, pay = model_kernel(a, b, slots)
    else:
        words, pay = model_merge(runs, slots)
    assert len(words) == len(exp_words)
    for g, e in zip(words, exp_words):
        np.testing.assert_array_equal(g, e.numpy())
    if exp_pay is None:
        assert pay is None
    else:
        np.testing.assert_array_equal(pay, exp_pay.numpy())
