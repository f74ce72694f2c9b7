"""Port segment stage (plain PyTorch version of kernels K1/K2) against the
JAX package's Pallas kernels in interpret mode, on the cases of
tests/test_pallas_segscan.py. All outputs are integers: exact equality."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops.pallas_segscan import TILE, segment_stage_pallas
from kmtricks_tpu_torch.ops.segscan import (
    segment_stage, segscan_bwd_torch, segscan_fwd_torch)

torch.set_num_threads(2)

NAMES = ("cnt", "present", "solid", "final", "row_head", "row_keep", "row_of")


def make_case(rng, n, invalid_tail):
    key_diff = np.zeros(n, dtype=bool)
    key_diff[0] = True
    key_diff[1:] = rng.random(n - 1) < 0.3
    occ_diff = key_diff | (rng.random(n) < 0.5)
    occ_diff[0] = True
    valid = np.ones(n, dtype=bool)
    if invalid_tail:
        valid[n - invalid_tail:] = False
    amin_of = rng.integers(1, 4, n).astype(np.int32)
    return occ_diff, key_diff, valid, amin_of


PAD = 4 * TILE
BIG = 2**31 - 1


def pallas_reference(occ_diff, key_diff, valid, amin_of, hmin_of, **kw):
    """segment_stage_pallas in interpret mode on inputs padded to PAD the
    way it pads them itself (a run boundary, invalid, never-passing
    thresholds), so every case of one parameter set shares one compile;
    returns the outputs cut back to the case's n."""
    n = len(occ_diff)

    def pad(a, v):
        return np.concatenate([a, np.full(PAD - n, v, a.dtype)])

    exp = segment_stage_pallas(
        pad(occ_diff, True), pad(key_diff, True), pad(valid, False),
        pad(amin_of.astype(np.int32), BIG), pad(hmin_of.astype(np.int32), BIG),
        interpret=True, **kw)
    return [np.asarray(e)[:n] for e in exp]


def assert_same(occ_diff, key_diff, valid, amin_of, hmin_of, **kw):
    exp = pallas_reference(occ_diff, key_diff, valid, amin_of, hmin_of, **kw)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (occ_diff, key_diff, valid, amin_of.astype(np.int32),
          hmin_of.astype(np.int32))]
    got = segment_stage(*t, **kw)
    first = int(np.argmax(np.asarray(exp[4]))) if np.asarray(exp[4]).any() \
        else len(occ_diff)
    for name, g, e in zip(NAMES, got, exp):
        g = g.numpy().astype(np.int64)
        e = np.asarray(e).astype(np.int64)
        if name == "row_of":
            # only meaningful at/after the first row head
            g, e = g[first:], e[first:]
        np.testing.assert_array_equal(g, e, err_msg=name)
    return got


@pytest.mark.parametrize("n", [TILE // 2, TILE, TILE + 3, 3 * TILE + 1111])
@pytest.mark.parametrize("params", [(1, 1, 0, 0xFFFFFFFF), (2, 2, 3, 255)])
def test_segment_stage_matches_pallas(n, params):
    hard_min, rmin, save_if, count_max = params
    rng = np.random.default_rng(n + hard_min)
    occ_diff, key_diff, valid, amin_of = make_case(rng, n, min(200, n // 4))
    assert_same(occ_diff, key_diff, valid, amin_of,
                np.full(n, hard_min, np.int32), rmin=rmin, save_if=save_if,
                count_max=count_max)


def test_segment_stage_long_runs_cross_tiles():
    n = 3 * TILE
    occ_diff = np.zeros(n, dtype=bool)
    occ_diff[0] = True
    assert_same(occ_diff, occ_diff.copy(), np.ones(n, dtype=bool),
                np.full(n, 2, np.int32), np.ones(n, np.int32), rmin=1,
                save_if=0, count_max=0xFFFFFFFF)


def test_segment_stage_all_invalid():
    n = TILE + 77
    got = assert_same(np.ones(n, dtype=bool), np.ones(n, dtype=bool),
                      np.zeros(n, dtype=bool), np.ones(n, np.int32),
                      np.ones(n, np.int32), rmin=1, save_if=0, count_max=255)
    assert not got[1].any() and not got[4].any()


def test_segment_stage_per_position_hard_min():
    n = TILE
    rng = np.random.default_rng(3)
    occ_diff, key_diff, valid, amin_of = make_case(rng, n, 64)
    assert_same(occ_diff, key_diff, valid, amin_of,
                rng.integers(1, 4, n).astype(np.int32), rmin=1, save_if=0,
                count_max=255)


def test_k1_k2_twins_compose_to_the_stage():
    """The per-kernel plain versions (what chip_smoke.py holds K1 and K2
    against) compose to the whole stage; suffix is the segmented suffix
    sum of solid."""
    rng = np.random.default_rng(7)
    n = 5000
    occ_diff, key_diff, valid, amin_of = make_case(rng, n, 100)
    t = [torch.from_numpy(a) for a in (occ_diff, key_diff, valid, amin_of)]
    hmin = torch.full((n,), 2, dtype=torch.int32)
    cnt, present, solid, suffix = segscan_bwd_torch(*t, hmin, count_max=7)
    seg = np.cumsum(key_diff) - 1
    sol = solid.numpy().astype(np.int64)
    exp_suffix = np.array([sol[i:][seg[i:] == seg[i]].sum()
                           for i in range(n)])
    np.testing.assert_array_equal(suffix.numpy(), exp_suffix)
    fwd = segscan_fwd_torch(present, solid, suffix, t[1], t[2], cnt,
                            rmin=2, save_if=1)
    whole = segment_stage(*t, hmin, rmin=2, save_if=1, count_max=7)
    for a, b in zip((cnt, present, solid) + fwd, whole):
        assert torch.equal(a, b)


def test_segment_stage_rejects_other_devices():
    t = torch.zeros(4, dtype=torch.bool, device="meta")
    i = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        segment_stage(t, t, t, i, i, rmin=1, save_if=0, count_max=255)
