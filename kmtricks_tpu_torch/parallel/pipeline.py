"""The fused single-device step: reads -> dense count rows.

Counterpart of ``kmtricks_tpu/parallel/pipeline.py::build_single_chip_step``
(k-mer mode, k <= 32, with row compaction): encode, count+merge (sort and
segment stage), then compaction. It is the same work as the JAX package's
sharded step on one device.
"""

from __future__ import annotations

from kmtricks_tpu_torch.ops.compact import compact_count_rows
from kmtricks_tpu_torch.ops.count_merge import count_merge_keys
from kmtricks_tpu_torch.ops.encode import encode_batch


def build_single_chip_step(*, k: int, m: int, nsamp: int, nb_parts: int,
                           hard_min: int = 1, rmin: int = 1,
                           save_if: int = 0, count_max: int = 0xFFFFFFFF,
                           hard_min_vec=None, mmer_canonical: bool = True,
                           max_rows: int | None = None):
    """Return ``step(batch, lengths, samp, repart_table, amin_vec)`` over
    tensors on one device (see :func:`~kmtricks_tpu_torch.convert.
    from_jax_inputs`), giving compact_count_rows' (rows, pre, nrows, maxc,
    npres)."""
    part_bits = (nb_parts - 1).bit_length()

    def step(batch, lengths, samp, repart_table, amin_vec):
        keys, parts, valid = encode_batch(batch, lengths, repart_table, k, m,
                                          mmer_canonical=mmer_canonical)
        sampw = samp[:, None].expand(parts.shape).reshape(-1)
        (part_s, key_s, samp_s, _final, cnt, present, row_head, _row_keep,
         _row_of) = count_merge_keys(
            parts.reshape(-1), keys.reshape(-1), sampw, valid.reshape(-1),
            amin_vec, nsamp=nsamp, hard_min=hard_min, rmin=rmin,
            save_if=save_if, count_max=count_max, key_bits=2 * k,
            part_bits=part_bits, hard_min_vec=hard_min_vec)
        return compact_count_rows(part_s, key_s, samp_s, cnt, present,
                                  row_head, nsamp=nsamp, max_rows=max_rows)

    return step
