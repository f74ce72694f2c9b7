"""The device merge (``kmtricks_tpu_torch/parallel/pipeline.py::
merge_finalize``) against the JAX package's host reference
``kmtricks_tpu/host/ops.py::merge_dense`` over the counts the host
hard-min'd and saturated: final counts, keep flags and every
``MergeStats`` field, per partition, for recurrence minima 1-3, rescue off
and on, 1-, 2- and 4-byte count types, a uniform and a per-sample
hard-min, a soft-min above count_max, an empty partition and no rows;
over the whole matrix, per partition (as the engine and the one step call
it) and in small blocks. The pa form's packed bits are the JAX package's
``kmtricks_tpu/io/formats.py::pack_pa_bits`` of the final counts."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.host import ops as hops
from kmtricks_tpu.io import formats as F
from kmtricks_tpu_torch.parallel.pipeline import merge_finalize

torch.set_num_threads(2)

NSAMP, ROWS, NB_PARTS = 11, 1500, 4
FIELDS = ("non_solid", "rescued", "uniq_wo_rescue", "uniq_w_rescue",
          "total_wo_rescue", "total_w_rescue")
VARIANTS = ("uniform_hard_min", "per_sample_hard_min",
            "soft_min_over_count_max", "empty_partition", "zero_rows")


def make_case(variant, count_max, seed):
    """(raw u32 counts, hard-mins, soft-mins, partition bounds): counts
    mostly small (solid, rescue and hard-min decide), some up to twice
    count_max (saturation decides), 80% absent."""
    rng = np.random.default_rng(seed)
    rows = 0 if variant == "zero_rows" else ROWS
    top = min(count_max * 2, 2**32 - 1)
    pre = np.where(rng.random((rows, NSAMP)) < 0.7,
                   rng.integers(1, 8, (rows, NSAMP)),
                   rng.integers(0, top, (rows, NSAMP), dtype=np.uint64,
                                endpoint=True)).astype(np.uint32)
    pre[rng.random((rows, NSAMP)) < 0.8] = 0
    if variant == "per_sample_hard_min":
        hard_mins = rng.integers(0, 4, NSAMP).astype(np.uint32)
    else:
        hard_mins = np.full(NSAMP, 2, np.uint32)
    amin = rng.integers(1, 6, NSAMP).astype(np.uint64)
    if variant == "soft_min_over_count_max":
        amin[:3] = [count_max + 1, count_max + 45, 2**33]
    cuts = np.sort(rng.integers(0, rows + 1, NB_PARTS - 1))
    if variant == "empty_partition":
        cuts[1] = cuts[0]
    bounds = np.concatenate([[0], cuts, [rows]]).astype(np.int64)
    return pre, hard_mins, amin, bounds


def host_merge(pre, hard_mins, amin, bounds, rmin, save_if, count_max):
    """Each partition's MergeResult as the host tail made it: the
    per-sample hard-min on the raw counts, the count_max clamp, then
    ``merge_dense``."""
    pre_m = np.where(pre >= hard_mins[None, :], np.minimum(pre, count_max),
                     0)
    return [hops.merge_dense(np.zeros(hi - lo, np.uint64), pre_m[lo:hi],
                             amin, rmin, save_if)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def device_merge(pre, hard_mins, amin, bounds, rmin, save_if, count_max,
                 bits, block=None):
    t = [torch.from_numpy(np.asarray(a, dtype=np.int64))
         for a in (amin, hard_mins, bounds)]
    kw = {} if block is None else dict(block=block)
    return merge_finalize(torch.from_numpy(pre.view(np.int32)), *t,
                          rmin=rmin, save_if=save_if, count_max=count_max,
                          bits=bits, **kw)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("count_max", [255, 65535, 2**32 - 1])
@pytest.mark.parametrize("save_if", [0, 2])
@pytest.mark.parametrize("rmin", [1, 2, 3])
def test_device_merge_matches_merge_dense(rmin, save_if, count_max,
                                          variant):
    seed = rmin * 1000 + save_if * 100 + VARIANTS.index(variant) * 10 \
        + count_max % 7
    pre, hard_mins, amin, bounds = make_case(variant, count_max, seed)
    exp = host_merge(pre, hard_mins, amin, bounds, rmin, save_if, count_max)

    counts, keep, stats = device_merge(pre, hard_mins, amin, bounds, rmin,
                                       save_if, count_max, bits=False)
    counts = counts.numpy().view(np.uint32)
    packed, keep_b, stats_b = device_merge(pre, hard_mins, amin, bounds,
                                           rmin, save_if, count_max,
                                           bits=True)
    assert torch.equal(keep, keep_b) and torch.equal(stats, stats_b)
    blocked = device_merge(pre, hard_mins, amin, bounds, rmin, save_if,
                           count_max, bits=False, block=37 * NSAMP)
    assert torch.equal(blocked[0], torch.from_numpy(counts.view(np.int32)))
    assert torch.equal(blocked[1], keep) and torch.equal(blocked[2], stats)
    np.testing.assert_array_equal(packed.numpy(),
                                  F.pack_pa_bits(counts > 0))
    for p, res in enumerate(exp):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        np.testing.assert_array_equal(counts[lo:hi], res.counts)
        np.testing.assert_array_equal(keep.numpy()[lo:hi], res.keep)
        for i, f in enumerate(FIELDS):
            np.testing.assert_array_equal(
                stats[i, p].numpy().astype(np.uint64), getattr(res.stats, f),
                err_msg=f)
        # one partition alone, its rows' own bounds, as the tails call it
        c1, k1, s1 = device_merge(pre[lo:hi], hard_mins, amin,
                                  [0, hi - lo], rmin, save_if, count_max,
                                  bits=False)
        np.testing.assert_array_equal(c1.numpy().view(np.uint32),
                                      res.counts)
        np.testing.assert_array_equal(k1.numpy(), res.keep)
        assert torch.equal(s1[:, 0], stats[:, p])
    if variant == "empty_partition":
        assert bounds[1] == bounds[2] and not stats[:, 1].any()
    if variant == "zero_rows":
        assert counts.shape == (0, NSAMP) and not stats.any()
    else:
        assert keep.any() and not keep.all()
        assert (stats[1].sum() > 0) == (save_if > 0)
        if count_max < 2**32 - 1:
            assert counts.max() == count_max
    if variant == "soft_min_over_count_max":
        # never solid where the soft-min passes count_max
        assert not stats[2, :, :3].any()
