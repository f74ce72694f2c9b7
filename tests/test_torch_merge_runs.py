"""Port run merge (plain PyTorch version of kernels K3/K4) against numpy
lexsort and against the JAX package's Pallas merge
``merge_sorted_runs_words`` in interpret mode. All outputs are integers:
exact equality."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops.pallas_sort import TILE, merge_sorted_runs_words
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
        merge_sorted_runs([((w, w, w), None)])
    m = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(NotImplementedError):
        merge_sorted_runs([((m,), None), ((m,), None)])
