"""Row compaction: full-N sorted count outputs -> dense count rows.

Counterpart of ``kmtricks_tpu/ops/compact.py::compact_count_rows``, with
the same outputs. The JAX package compacts with a carry sort because TPU
scatters are slow; here it is plain stream compaction (``nonzero``, a
cumsum row index, then gather/scatter), and eager PyTorch knows the row
count before it allocates, so the outputs are sized exactly.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
U32_MAX = 2**32 - 1


def compact_count_rows(part_s, key_s, samp_s, cnt, present, row_head, *,
                       nsamp: int, max_rows: int | None = None):
    """Compact one device's sorted count output to dense rows.

    Inputs are :func:`~kmtricks_tpu_torch.ops.count_merge.count_merge_keys`
    outputs, or a collapsed table's (``cnt`` int64 up to 2^32 - 1).
    Returns (rows (nrows, 2) int64 of [key, partition], pre (nrows, nsamp)
    int32 holding the u32 bit pattern of the pre-merge counts (0 = absent;
    the host reads it with ``.view(np.uint32)``), nrows, maxc, npres) with
    the last three as Python ints. Raises ValueError when nrows exceeds
    ``max_rows``.
    """
    row_id = torch.cumsum(row_head, 0, dtype=torch.int32) - 1
    nrows = int(row_id[-1]) + 1 if row_id.numel() else 0
    if max_rows is not None and nrows > max_rows:
        raise ValueError(
            f"partition rows ({nrows}) exceed the device compaction budget "
            f"({max_rows} rows); raise --max-memory")
    heads = torch.nonzero(row_head).squeeze(1)
    rows = torch.stack([key_s[heads], part_s[heads].to(torch.int64)], dim=1)
    pres = torch.nonzero(present).squeeze(1)
    npres = int(pres.numel())
    pcnt = cnt[pres].to(torch.int64)
    maxc = int(pcnt.max()) if npres else 0
    if maxc > U32_MAX:
        raise ValueError(f"compact_count_rows: count {maxc} exceeds u32")
    # a present entry's row is its key's head: the latest row head so far
    flat = row_id[pres].to(torch.int64) * nsamp + samp_s[pres].to(torch.int64)
    pre = torch.zeros(nrows * nsamp, dtype=torch.int32, device=cnt.device)
    # u32 counts as int32 bit patterns: [2^31, 2^32) maps to negatives
    pre[flat] = torch.where(pcnt > INT32_MAX, pcnt - 2**32,
                            pcnt).to(torch.int32)
    return rows, pre.view(nrows, nsamp), nrows, maxc, npres
