"""Port encode against kmtricks_tpu.ops.encode: ``encode_batch`` (k <= 32)
and ``encode_batch_wide`` (32 < k <= 128, the span's int64 words against
the JAX package's u32 words), canonical k-mers, partitions (from the
table or --static-repart) and window validity, exactly."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops.encode import encode_batch as jax_encode_batch
from kmtricks_tpu.ops.encode import encode_batch_wide as jax_encode_wide
from kmtricks_tpu_torch.convert import (
    from_jax_inputs, keys_from_msb_words, words_from_msb_u32)
from kmtricks_tpu_torch.ops import u64
from kmtricks_tpu_torch.ops.encode import (
    encode_batch, encode_batch_wide, revcomp64)

torch.set_num_threads(2)


def make_batch(seed, B=7, L=128, m=8, nparts=5):
    """Random reads over ACGT with lowercase, N bytes, other bytes and
    short reads; 'N' padding past each length."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTacgtNNRy", dtype=np.uint8)
    batch = rng.choice(alphabet, size=(B, L))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[0], lengths[1] = L, 3                  # a full and a short read
    batch[0] = rng.choice(alphabet[:8], size=L)    # one clean read
    for r in range(B):
        batch[r, lengths[r]:] = ord("N")
    table = rng.integers(0, nparts, 4 ** m).astype(np.int32)
    return batch, lengths, table


@pytest.mark.parametrize("k,m,canonical", [(31, 8, True), (21, 6, True),
                                           (31, 8, False), (32, 7, True)])
def test_encode_matches_jax(k, m, canonical):
    batch, lengths, table = make_batch(k + m, m=m)
    hi, lo, parts, valid = jax_encode_batch(batch, lengths, table, k, m,
                                            mmer_canonical=canonical)
    b, ln, _s, tab, _a, _h = from_jax_inputs(batch, lengths, lengths, table,
                                             None, None, "cpu")
    keys, tparts, tvalid = encode_batch(b, ln, tab, k, m,
                                        mmer_canonical=canonical)
    exp_keys = keys_from_msb_words(np.asarray(hi), np.asarray(lo))
    assert torch.equal(keys, exp_keys.reshape(keys.shape))
    np.testing.assert_array_equal(tparts.numpy(), np.asarray(parts))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    assert tvalid.any() and not tvalid.all()


def test_revcomp_involution_and_unsigned_min():
    """k = 32 keys use bit 63: revcomp is an involution and the canonical
    pick is unsigned."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, 1000,
                                      dtype=np.int64))
    assert torch.equal(revcomp64(revcomp64(x, 32), 32), x)
    a, b = torch.tensor([-1, 5]), torch.tensor([3, -7])
    assert u64.umin(a, b).tolist() == [3, 5]
    assert u64.shr(torch.tensor([-1]), 60).tolist() == [15]


def test_encode_rejects_wide_k():
    """Each encode takes its own k range: encode_batch refuses k > 32 (the
    wide encode takes it) and encode_batch_wide k <= 32 and k > 128 (the
    reference's largest span)."""
    b = torch.full((1, 256), ord("A"), dtype=torch.uint8)
    ln = torch.tensor([256], dtype=torch.int32)
    tab = torch.zeros(4 ** 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        encode_batch(b, ln, tab, 33, 4)
    for k in (32, 129):
        with pytest.raises(NotImplementedError):
            encode_batch_wide(b, ln, tab, k, 4)


@pytest.mark.parametrize("k,static", [
    (33, False), (45, True), (55, False), (64, False), (65, True),
    (96, False), (97, True), (127, False), (128, True)])
def test_encode_wide_matches_jax(k, static):
    """The cases of tests/test_wide_k.py: canonical keys as the span's
    int64 words (least significant first), partitions and validity; with
    ``static_parts`` the partitions are XXH64(minimizer) % 7."""
    m = 8
    batch, lengths, table = make_batch(k, L=384, m=m)
    sp = 7 if static else None
    jkeys, jparts, jvalid = jax_encode_wide(batch, lengths, table, k, m,
                                            static_parts=sp)
    b, ln, _s, tab, _a, _h = from_jax_inputs(batch, lengths, lengths, table,
                                             None, None, "cpu")
    keys, parts, valid = encode_batch_wide(b, ln, tab, k, m,
                                           static_parts=sp)
    exp = words_from_msb_u32([np.asarray(w) for w in jkeys])
    assert len(keys) == len(exp) == (2 if k <= 64 else 3 if k <= 96 else 4)
    vm = np.asarray(jvalid)
    for g, e in zip(keys, exp):
        assert torch.equal(g, e.reshape(g.shape))
    np.testing.assert_array_equal(parts.numpy(), np.asarray(jparts))
    np.testing.assert_array_equal(valid.numpy(), vm)
    assert vm.any() and not vm.all()
    if static:
        assert 0 <= int(parts.min()) and int(parts.max()) < 7


def test_encode_static_parts_matches_jax():
    """k <= 32 with --static-repart: XXH64(minimizer) % P partitions."""
    k, m = 31, 8
    batch, lengths, table = make_batch(3, m=m)
    _hi, _lo, jparts, _v = jax_encode_batch(batch, lengths, table, k, m,
                                            static_parts=13)
    b, ln, _s, tab, _a, _h = from_jax_inputs(batch, lengths, lengths, table,
                                             None, None, "cpu")
    _keys, parts, _valid = encode_batch(b, ln, tab, k, m, static_parts=13)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(jparts))
