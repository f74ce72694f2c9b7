"""State carried across from the JAX package's inputs and outputs.

The system has no weights; its state is the read batch, the repartition
table, the per-sample thresholds and the key layout. These helpers feed
the port the same numpy inputs as the JAX package and read the JAX
package's keys in the port's form, so both are fed and compared alike.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1


def _thresholds(vec, device):
    """(nsamp,) u32 thresholds -> int32 (values saturate at INT32_MAX;
    counts never reach it)."""
    if vec is None:
        return None
    v = np.minimum(np.asarray(vec, dtype=np.int64), INT32_MAX)
    return torch.from_numpy(v.astype(np.int32)).to(device)


def from_jax_inputs(batch, lengths, samp, repart_table, amin_vec,
                    hard_min_vec, device):
    """numpy step inputs -> tensors on ``device``: batch (B, L) uint8,
    lengths (B,) int32, samp (B,) int32, repart_table (4^m,) int32,
    amin_vec (nsamp,) int32, hard_min_vec (nsamp,) int32 or None."""
    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    return (t(batch, np.uint8), t(lengths, np.int32), t(samp, np.int32),
            t(repart_table, np.int32), _thresholds(amin_vec, device),
            _thresholds(hard_min_vec, device))


def keys_from_msb_words(hi, lo) -> torch.Tensor:
    """The JAX package's (hi, lo) u32 key words -> the port's int64 key
    (the same u64 bits), as a CPU tensor."""
    u = ((np.asarray(hi, dtype=np.uint64) << np.uint64(32))
         | np.asarray(lo, dtype=np.uint64))
    return torch.from_numpy(u.view(np.int64))


def words_from_msb_u32(words) -> tuple:
    """The JAX package's msb-first u32 key words of a wide k-mer -> the
    port's int64 words, least significant first (the same u64 bits), as
    CPU tensors."""
    nw = len(words)
    return tuple(keys_from_msb_words(words[nw - 2 - 2 * i],
                                     words[nw - 1 - 2 * i])
                 for i in range(nw // 2))
