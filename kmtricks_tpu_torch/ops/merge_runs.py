"""Merge of ascending runs: R sorted runs -> one sorted run.

Counterpart of ``kmtricks_tpu/ops/pallas_sort.py``: the Pallas merge-path
kernels ``_merge_kernel`` (K3, one u32 word, via
``merge_sorted_runs_u32``) and ``_merge_kernel_mw`` (K4, tuples of u32
words, via ``merge_sorted_runs_words``).

A run is ``(words, payload)``: ``words`` a tuple of 1 or 2 int64 key
tensors (most significant first, compared lexicographically as signed
int64, the order ``torch.sort`` uses), ``payload`` an int64 tensor of the
same length or None. Runs are exactly sized and may be empty. Equal keys
keep their run order (the earlier run first), so the result is the stable
sort of the concatenation, bit for bit.

:func:`merge_sorted_runs_torch` is the plain PyTorch version;
:func:`merge_sorted_runs` runs it for CPU tensors and the hand-written CUDA
kernel of ``csrc/merge_runs.cu`` for CUDA tensors (K4 with a payload, K3
without), as a tree of pairwise merges. It never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch._build import merge_runs_lib

# kernel launches, counted where the wrapper launches its CUDA kernel
LAUNCHES = {"K3": 0, "K4": 0}


def merge_sorted_runs_torch(runs):
    """Plain version: a stable sort of the concatenated runs, least
    significant word first (as ``ops/count_merge.py::sort_packed``), with
    the payload gathered by the permutation. Returns (words, payload)."""
    nw = len(runs[0][0])
    words = [torch.cat([r[0][j] for r in runs]) for j in range(nw)]
    perm = None
    for w in reversed(words):
        key = w if perm is None else w[perm]
        p = torch.sort(key, stable=True).indices
        perm = p if perm is None else perm[p]
    out = tuple(w[perm] for w in words)
    if runs[0][1] is None:
        return out, None
    return out, torch.cat([r[1] for r in runs])[perm]


def _check_runs(runs):
    if not runs:
        raise ValueError("merge_sorted_runs: no runs")
    nw = len(runs[0][0])
    has_payload = runs[0][1] is not None
    if nw not in (1, 2):
        raise ValueError(f"merge_sorted_runs: {nw} key words (1 or 2)")
    dev = runs[0][0][0].device
    for words, payload in runs:
        n = words[0].shape[0]
        ts = list(words) + ([payload] if has_payload else [])
        if len(words) != nw or (payload is not None) != has_payload:
            raise ValueError("merge_sorted_runs: runs differ in word count "
                             "or payload")
        for t in ts:
            if t.device != dev or t.dtype != torch.int64 \
                    or t.shape != (n,) or not t.is_contiguous():
                raise ValueError(
                    f"merge_sorted_runs: every tensor must be a contiguous "
                    f"({n},) int64 tensor on {dev}, got {tuple(t.shape)} "
                    f"{t.dtype} on {t.device}")
    return dev


def merge_sorted_runs(runs):
    """Dispatch on the runs' device: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (never one for the other). Same signature
    and output as :func:`merge_sorted_runs_torch`."""
    dev = _check_runs(runs)
    if dev.type == "cpu":
        return merge_sorted_runs_torch(runs)
    if dev.type != "cuda":
        raise NotImplementedError(f"merge_sorted_runs: no kernel for {dev}")
    return merge_sorted_runs_cuda(runs)


def merge_sorted_runs_cuda(runs):
    """R runs merged as a tree of pairwise kernel merges of neighbours, so
    the earlier run is always A and ties keep run order. Runs on the
    current CUDA stream, no synchronisation."""
    _check_runs(runs)
    level = list(runs)
    while len(level) > 1:
        nxt = [_merge_two_cuda(level[i], level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return tuple(level[0][0]), level[0][1]


def _merge_two_cuda(a, b):
    """One launch of the merge kernel: run ``a`` then run ``b`` (ties to
    ``a``) -> (words, payload), exactly sized."""
    (aw, ap), (bw, bp) = a, b
    nw = len(aw)
    na, nb = aw[0].shape[0], bw[0].shape[0]
    if not nb:
        return a
    if not na:
        return b
    dev = aw[0].device
    ow = tuple(torch.empty(na + nb, dtype=torch.int64, device=dev)
               for _ in range(nw))
    op = None if ap is None else torch.empty(na + nb, dtype=torch.int64,
                                             device=dev)

    def ptrs(words, payload):
        """Two word pointers (the second None for one word), payload's."""
        return ([w.data_ptr() for w in words] + [None])[:2] + [
            None if payload is None else payload.data_ptr()]

    lib = merge_runs_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.km_merge_runs(nw, *ptrs(aw, ap), na, *ptrs(bw, bp), nb,
                                *ptrs(ow, op), stream)
    if err:
        raise RuntimeError(f"merge_runs launch failed: "
                           f"{lib.km_error_string(err).decode()}")
    LAUNCHES["K4" if op is not None or nw > 1 else "K3"] += 1
    return ow, op
