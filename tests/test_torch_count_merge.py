"""Port count_merge_keys (k2, k3 and kw sort layouts, and the h1/h2 hash
layouts) against the JAX package's count_merge_keys (its XLA segment
stage, the CPU default): the decoded sorted (partition, key, sample) order
and every per-position output, exactly; and the layout routing against
the JAX package's packed_layout / stream_layout."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops import count_merge as jcm
from kmtricks_tpu.parallel import pipeline as jpipe
from kmtricks_tpu_torch.convert import keys_from_msb_words, words_from_msb_u32
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
    """40 samples x 17 partition bits at k = 31: the JAX package's "kw"
    layout, which the port now takes (2 int64 sort words), with the same
    count_merge_keys outputs; beyond the kw bound (32 partition bits) both
    packages refuse to pack, and the fused path's stream_layout is None
    (the chunked path takes it)."""
    assert jcm.packed_layout(40, 2, False, 62, 17) == "kw.17.62.2"
    assert tcm.packed_layout(40, 62, 17) == "kw.17.62.2"
    assert tcm._kw_params("kw.17.62.2", 40)[4] == 2
    check_wide(62, 2, 1 << 17, 40)
    assert jcm.packed_layout(40, 2, False, 62, 32) is None
    assert tcm.packed_layout(40, 62, 32) is None
    assert tcm.stream_layout(31, 1 << 32, 40) is None


def make_wide_occurrences(rng, n, nb_parts, key_bits, nw, nsamp, pool=300):
    """Occurrences of pooled wide keys as the JAX package's msb-first u32
    words (as tests/test_packed_layouts.py draws them)."""
    kpart = rng.integers(0, nb_parts, pool).astype(np.int32)
    pick = np.minimum(rng.zipf(1.3, n) - 1, pool - 1)
    words = []
    for j in range(nw):
        b = key_bits - 32 * (nw - 1 - j)
        vals = (rng.integers(0, 1 << min(b, 32), pool, dtype=np.uint64)
                if b > 0 else np.zeros(pool, np.uint64))
        words.append(vals[pick].astype(np.uint32))
    samp = rng.integers(0, nsamp, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return kpart[pick], tuple(words), samp, valid


def check_wide(key_bits, nw, nb_parts, nsamp):
    """count_merge_keys on wide keys, port against JAX, every output."""
    rng = np.random.default_rng(key_bits * 5 + nw + nsamp)
    part, words, samp, valid = make_wide_occurrences(
        rng, 4096, nb_parts, key_bits, nw, nsamp)
    pb = (nb_parts - 1).bit_length()
    amin = rng.integers(1, 4, nsamp).astype(np.uint32)
    exp = jcm.count_merge_keys(
        part, words, samp, valid, amin, nsamp=nsamp, hard_min=2, rmin=1,
        save_if=2, count_max=255, key_bits=key_bits, part_bits=pb)
    keys = words_from_msb_u32(words)
    got = tcm.count_merge_keys(
        torch.from_numpy(part), keys[0] if len(keys) == 1 else keys,
        torch.from_numpy(samp), torch.from_numpy(valid),
        torch.from_numpy(amin.astype(np.int32)), nsamp=nsamp, hard_min=2,
        rmin=1, save_if=2, count_max=255, key_bits=key_bits, part_bits=pb)
    e_keys = words_from_msb_u32([np.asarray(w) for w in exp[1]])
    assert isinstance(got[1], tuple) and len(got[1]) == len(e_keys)
    for g, e in zip(got[1], e_keys):
        assert torch.equal(g, e)
    names = ("part", None, "samp", "final", "cnt", "present", "row_head",
             "row_keep", "row_of")
    for i, name in enumerate(names):
        if name:
            np.testing.assert_array_equal(
                got[i].numpy().astype(np.int64),
                np.asarray(exp[i]).astype(np.int64), err_msg=name)
    assert got[5].sum() > 0 and got[6].sum() > 1


@pytest.mark.parametrize("key_bits,nw,nb_parts,nsamp", [
    (66, 4, 16, 3),        # k = 33: 2 int64 sort words
    (94, 4, 64, 8),        # k = 47: 2
    (128, 4, 4, 4),        # k = 64: 3
    (192, 6, 16, 2),       # k = 96: 4
    (254, 8, 8, 5),        # k = 127: 5
    (256, 8, 1 << 20, 2048),   # k = 128 at the kw bound: 5
])
def test_kw_count_merge_matches_jax(key_bits, nw, nb_parts, nsamp):
    """The cases of tests/test_packed_layouts.py (and one at the bound)."""
    pb = (nb_parts - 1).bit_length()
    layout = f"kw.{pb}.{key_bits}.{nw}"
    assert jcm.packed_layout(nsamp, nw, False, key_bits, pb) == layout
    assert tcm.packed_layout(nsamp, key_bits, pb) == layout
    check_wide(key_bits, nw, nb_parts, nsamp)


def test_layout_routing_matches_jax():
    """stream_layout gives the JAX package's layout, or None where the
    JAX package returns None (its stage_mesh_chunked path), over k,
    partition counts, sample counts and hash windows; the table budget's
    word count is the JAX package's."""
    seen = set()
    for k in (15, 21, 27, 31, 32, 33, 47, 56, 64, 65, 80, 96, 97, 120, 128):
        for nparts in (1, 4, 512, 1 << 12, 1 << 17, 1 << 24, 1 << 28):
            for nsamp in (1, 10, 40, 2000):
                for mode, wb in (("kmer", None), ("hash", 250_048),
                                 ("hash", 1 << 40)):
                    if mode == "hash" and nparts > 512:
                        continue
                    exp = jpipe.stream_layout(k, 8, nparts, nsamp, mode, wb)
                    if exp is None:
                        assert tcm.stream_layout(k, nparts, nsamp, mode,
                                                 wb) is None
                        seen.add("none")
                        continue
                    got = tcm.stream_layout(k, nparts, nsamp, mode, wb)
                    assert got == exp, (k, nparts, nsamp, mode)
                    assert tcm._layout_words(got, nsamp) == \
                        jpipe._layout_words(exp, nsamp)
                    seen.add(got.split(".")[0])
    assert seen == {"none", "k2", "k3", "kw", "h1", "h2"}


def make_hash_occurrences(seed, window, nsamp, nparts, n=6000, pool=400):
    """Window-hash occurrences: pool keys h % window + window * partition
    (the partition follows the key), skewed multiplicities."""
    rng = np.random.default_rng(seed)
    kpart = rng.integers(0, nparts, pool).astype(np.int32)
    h = rng.integers(0, 2**64, pool, dtype=np.uint64) % np.uint64(window) \
        + np.uint64(window) * kpart.astype(np.uint64)
    pick = np.minimum(rng.zipf(1.3, n) - 1, pool - 1)
    samp = rng.integers(0, nsamp, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return kpart[pick], h[pick], samp, valid


HASH_CASES = [
    # window, nsamp, nparts, hard_min, rmin, save_if, count_max, hmin vec
    (250_048, 4, 4, 1, 1, 0, 0xFFFFFFFF, False),       # h1, 20 key bits
    (2_500_032, 10, 4, 2, 2, 2, 255, True),            # h1, 24 key bits
    (2**31 + 64, 5, 8, 1, 1, 2, 65535, False),         # h2, 35 key bits
    (2**58, 12, 16, 2, 2, 1, 255, True),               # 62 + 4: unpacked
]


@pytest.mark.parametrize("case", HASH_CASES, ids=lambda c: f"w{c[0]}s{c[1]}")
def test_hash_count_merge_matches_jax(case):
    w, nsamp, nparts, hard_min, rmin, save_if, count_max, per_sample = case
    part, h, samp, valid = make_hash_occurrences(w % 1000 + nsamp, w, nsamp,
                                                 nparts)
    rng = np.random.default_rng(nsamp)
    amin = rng.integers(1, 4, nsamp).astype(np.uint32)
    hmv = rng.integers(1, 4, nsamp).astype(np.uint32) if per_sample else None
    kb = tcm.hash_key_bits(w, nparts)
    layout = jcm.packed_layout(nsamp, 2, True, kb)
    if kb + (nsamp - 1).bit_length() > 63:
        # no packed layout: the fused path takes the chunked path,
        # count_merge_keys the JAX package's generic sort
        assert layout is None
        assert tcm.packed_layout(nsamp, kb, None,
                                 part_follows_keys=True) is None
        assert tcm.stream_layout(31, nparts, nsamp, "hash", w) is None
    else:
        assert tcm.packed_layout(nsamp, kb, None, part_follows_keys=True) \
            == layout
    hi = (h >> np.uint64(32)).astype(np.uint32)
    lo = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    exp = jcm.count_merge_keys(
        part, (hi, lo), samp, valid, amin, nsamp=nsamp, hard_min=hard_min,
        rmin=rmin, save_if=save_if, count_max=count_max, key_bits=kb,
        part_follows_keys=True, window_bits=w, hard_min_vec=hmv)
    got = tcm.count_merge_keys(
        torch.from_numpy(part), torch.from_numpy(h.view(np.int64)),
        torch.from_numpy(samp), torch.from_numpy(valid),
        torch.from_numpy(amin.astype(np.int32)), nsamp=nsamp,
        hard_min=hard_min, rmin=rmin, save_if=save_if, count_max=count_max,
        key_bits=kb, part_follows_keys=True, window_bits=w,
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
