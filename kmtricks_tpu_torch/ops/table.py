"""Count tables of the streaming engine: per-chunk pairs and their merge.

Counterpart of ``kmtricks_tpu/ops/table.py``. Each chunk's occurrences
reduce on the device to sorted unique (packed words, count) pairs; pair
runs then merge (kernel K4, :mod:`kmtricks_tpu_torch.ops.merge_runs`, with
the count as its payload) and equal keys collapse into one entry whose
count is their sum, saturated at 2^32 - 1 like the JAX package's u32
saturating adds.

Words are the port's int64 sort words (``ops/count_merge.py``). Eager
PyTorch knows every size before it allocates, so every output here is
exactly sized: there is no ``pair_cap``/``out_cap``, nothing is dropped
and nothing re-runs. Counts are int64.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.merge_runs import merge_sorted_runs

U32_MAX = 2**32 - 1


def _run_starts(ws):
    """(n,) bool: entry i starts a run of equal words."""
    n = ws[0].shape[0]
    head = torch.ones(n, dtype=torch.bool, device=ws[0].device)
    if n > 1:
        eq = ws[0][1:] == ws[0][:-1]
        for w in ws[1:]:
            eq &= w[1:] == w[:-1]
        head[1:] = ~eq
    return head


def _run_bounds(head):
    """Start index of each run and the index past its end (int64)."""
    starts = torch.nonzero(head).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), head.shape[0])])
    return starts, ends[:starts.numel()]


def chunk_count_pairs(ws):
    """Sorted packed words (every entry valid) -> unique (words, count)
    pairs: the counted (partition, key, sample) occurrences of a chunk."""
    starts, ends = _run_bounds(_run_starts(ws))
    return tuple(w[starts] for w in ws), ends - starts


def merged_sorted_ops(streams):
    """Globally sorted (words, cnt) over R sorted pair runs, through the
    run merge with ``cnt`` as the payload. Equal keys keep their run
    order (the JAX package orders them by count; both agree once
    :func:`run_sum_bounded` collapses them)."""
    return merge_sorted_runs(list(streams))


def run_sum_bounded(ws, cnt):
    """Per-run total of ``cnt`` over equal-key runs of the merged sorted
    words ``ws``, saturated at 2^32 - 1. Returns (run_start bool, total):
    ``total`` holds the run's sum at its first entry and 0 elsewhere.

    A plain segment sum in int64, then clamped, equals the JAX package's
    chain of saturating u32 adds (every count is positive); its
    log-doubling exists to avoid TPU gathers."""
    head = _run_starts(ws)
    starts, ends = _run_bounds(head)
    csum = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])
    total = torch.zeros_like(cnt)
    total[starts] = (csum[ends] - csum[starts]).clamp(max=U32_MAX)
    return head, total


def merge_pair_streams(streams):
    """Merge R sorted pair streams, each with unique keys, into one: a key
    found in r of them becomes one entry with the saturated sum of its
    counts. Returns (words, cnt), exactly sized."""
    ws, cnt = merged_sorted_ops(streams)
    head, total = run_sum_bounded(ws, cnt)
    return tuple(w[head] for w in ws), total[head]
