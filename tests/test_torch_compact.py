"""Port compact_count_rows against kmtricks_tpu.ops.compact on the same
sorted count outputs: rows, dense pre-merge counts, nrows, maxc, npres."""

import jax
import numpy as np
import pytest
import torch

from kmtricks_tpu.ops import count_merge as jcm
from kmtricks_tpu.ops.compact import compact_count_rows as jax_compact
from kmtricks_tpu_torch.convert import keys_from_msb_words
from kmtricks_tpu_torch.ops.compact import compact_count_rows

torch.set_num_threads(2)


def sorted_counts(seed, nsamp, hard_min, n=5000):
    rng = np.random.default_rng(seed)
    pool = 300
    hi = rng.integers(0, 1 << 30, pool, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, pool, dtype=np.uint64).astype(np.uint32)
    kpart = rng.integers(0, 4, pool).astype(np.int32)
    pick = np.minimum(rng.zipf(1.4, n) - 1, pool - 1)
    samp = rng.integers(0, nsamp, n).astype(np.int32)
    valid = rng.random(n) < 0.95
    return jcm.count_merge_keys(
        kpart[pick], (hi[pick], lo[pick]), samp, valid,
        np.ones(nsamp, np.uint32), nsamp=nsamp, hard_min=hard_min, rmin=1,
        save_if=0, count_max=255, key_bits=62, part_bits=2)


@pytest.mark.parametrize("nsamp,hard_min", [(3, 1), (6, 2)])
def test_compact_matches_jax(nsamp, hard_min):
    (part_s, keys_s, samp_s, _f, cnt, present, row_head, _k, _r,
     _st) = sorted_counts(nsamp, nsamp, hard_min)
    nrows_exp = int(np.asarray(row_head).sum())
    rows_j, pre_j, nrows_j, maxc_j, npres_j = jax.jit(
        jax_compact, static_argnames=("rows_cap", "nsamp"))(
        part_s, keys_s, samp_s, cnt, present, row_head,
        rows_cap=nrows_exp + 5, nsamp=nsamp)
    key_s = keys_from_msb_words(np.asarray(keys_s[0]), np.asarray(keys_s[1]))
    t = lambda a: torch.from_numpy(np.array(a))
    rows, pre, nrows, maxc, npres = compact_count_rows(
        t(part_s), key_s, t(samp_s), t(cnt).to(torch.int32), t(present),
        t(row_head), nsamp=nsamp)
    assert nrows == int(nrows_j) == nrows_exp > 0
    assert maxc == int(maxc_j) and npres == int(npres_j)
    rows_j, pre_j = np.asarray(rows_j)[:nrows], np.asarray(pre_j)[:nrows]
    assert rows.shape == (nrows, 2) and pre.shape == (nrows, nsamp)
    np.testing.assert_array_equal(
        rows[:, 0].numpy(), keys_from_msb_words(rows_j[:, 0],
                                                rows_j[:, 1]).numpy())
    np.testing.assert_array_equal(rows[:, 1].numpy(), rows_j[:, 2])
    np.testing.assert_array_equal(pre.numpy(), pre_j.astype(np.int64))


def test_compact_row_budget_raises():
    (part_s, keys_s, samp_s, _f, cnt, present, row_head, _k, _r,
     _st) = sorted_counts(1, 3, 1)
    t = lambda a: torch.from_numpy(np.array(a))
    key_s = keys_from_msb_words(np.asarray(keys_s[0]), np.asarray(keys_s[1]))
    with pytest.raises(ValueError, match="compaction budget"):
        compact_count_rows(t(part_s), key_s, t(samp_s),
                           t(cnt).to(torch.int32), t(present), t(row_head),
                           nsamp=3, max_rows=10)
