"""Port encode (k <= 32) against kmtricks_tpu.ops.encode.encode_batch:
canonical k-mers, partitions and window validity, exactly."""

import numpy as np
import pytest
import torch

from kmtricks_tpu.ops.encode import encode_batch as jax_encode_batch
from kmtricks_tpu_torch.convert import from_jax_inputs, keys_from_msb_words
from kmtricks_tpu_torch.ops import u64
from kmtricks_tpu_torch.ops.encode import encode_batch, revcomp64

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
    b = torch.full((1, 128), ord("A"), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        encode_batch(b, torch.tensor([128], dtype=torch.int32),
                     torch.zeros(4 ** 4, dtype=torch.int32), 33, 4)
