"""Port count_merge_keys (k2 and k3 sort layouts) against the JAX
package's count_merge_keys (its XLA segment stage, the CPU default): the
decoded sorted (partition, key, sample) order and every per-position
output, exactly."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops import count_merge as jcm
from kmtricks_tpu_torch.convert import keys_from_msb_words
from kmtricks_tpu_torch.ops import count_merge as tcm

torch.set_num_threads(2)


def make_occurrences(seed, k, nsamp, nparts, n=6000, pool=400):
    """Occurrences drawn from a pool of keys (each with a fixed partition)
    with skewed multiplicities, so runs span 1 to hundreds of entries."""
    rng = np.random.default_rng(seed)
    kb = 2 * k
    hi = rng.integers(0, 1 << max(0, kb - 32), pool, dtype=np.uint64) \
        if kb > 32 else np.zeros(pool, np.uint64)
    lo = rng.integers(0, 1 << min(32, kb), pool, dtype=np.uint64)
    if k == 32:
        hi[:pool // 2] |= np.uint64(1 << 31)          # keys with bit 63 set
    kpart = rng.integers(0, nparts, pool).astype(np.int32)
    pick = np.minimum(rng.zipf(1.3, n) - 1, pool - 1)
    samp = rng.integers(0, nsamp, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return (kpart[pick], hi[pick].astype(np.uint32),
            lo[pick].astype(np.uint32), samp, valid)


CASES = [
    # k, nsamp, nparts, hard_min, rmin, save_if, count_max, per-sample hmin
    (21, 4, 4, 1, 1, 0, 0xFFFFFFFF, False),
    (21, 5, 8, 2, 2, 2, 255, True),
    (31, 10, 16, 2, 1, 2, 0xFFFFFFFF, False),
    (31, 3, 4, 1, 2, 1, 255, True),
    (32, 3, 4, 1, 1, 2, 65535, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"k{c[0]}s{c[1]}")
def test_count_merge_matches_jax(case):
    k, nsamp, nparts, hard_min, rmin, save_if, count_max, per_sample = case
    part, hi, lo, samp, valid = make_occurrences(k + nsamp, k, nsamp,
                                                 nparts)
    rng = np.random.default_rng(nsamp)
    amin = rng.integers(1, 4, nsamp).astype(np.uint32)
    hmv = rng.integers(1, 4, nsamp).astype(np.uint32) if per_sample else None
    pb = (nparts - 1).bit_length()
    layout = jcm.packed_layout(nsamp, 2, False, 2 * k, pb)
    assert tcm.packed_layout(nsamp, 2 * k, pb) == layout
    assert layout == ("k3" if k > 21 else f"k2.{pb}.{2 * k}")

    exp = jcm.count_merge_keys(
        part, (hi, lo), samp, valid, amin, nsamp=nsamp, hard_min=hard_min,
        rmin=rmin, save_if=save_if, count_max=count_max, key_bits=2 * k,
        part_bits=pb, hard_min_vec=hmv)
    got = tcm.count_merge_keys(
        torch.from_numpy(part), keys_from_msb_words(hi, lo),
        torch.from_numpy(samp), torch.from_numpy(valid),
        torch.from_numpy(amin.astype(np.int32)), nsamp=nsamp,
        hard_min=hard_min, rmin=rmin, save_if=save_if, count_max=count_max,
        key_bits=2 * k, part_bits=pb,
        hard_min_vec=None if hmv is None else torch.from_numpy(
            hmv.astype(np.int32)))
    e_part, e_keys, e_samp, e_final, e_cnt, e_pres, e_rh, e_rk, e_rof, _ = exp
    e_key = keys_from_msb_words(np.asarray(e_keys[0]), np.asarray(e_keys[1]))
    pairs = [("part", got[0], e_part), ("key", got[1], e_key),
             ("samp", got[2], e_samp), ("final", got[3], e_final),
             ("cnt", got[4], e_cnt), ("present", got[5], e_pres),
             ("row_head", got[6], e_rh), ("row_keep", got[7], e_rk),
             ("row_of", got[8], e_rof)]
    for name, g, e in pairs:
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(e).astype(np.int64),
                                      err_msg=name)
    assert got[5].sum() > 0 and got[6].sum() > 1


def test_unported_layout_raises():
    # 40 samples x 17 partition bits: the JAX package takes a "kw" layout
    assert jcm.packed_layout(40, 2, False, 62, 17).startswith("kw.")
    with pytest.raises(NotImplementedError):
        tcm.packed_layout(40, 62, 17)
