"""Merge of ascending runs: R sorted runs -> one sorted run.

Counterpart of ``kmtricks_tpu/ops/pallas_sort.py``: the Pallas merge-path
kernels ``_merge_kernel`` (K3, one u32 word, via
``merge_sorted_runs_u32``) and ``_merge_kernel_mw`` (K4, tuples of u32
words, via ``merge_sorted_runs_words``).

A run is ``(words, payload)``: ``words`` a tuple of 1 to 5 int64 key
tensors (most significant first, compared lexicographically as signed
int64, the order ``torch.sort`` uses), ``payload`` an int64 tensor of the
same length or None. Runs are exactly sized and may be empty. Equal keys
keep their run order (the earlier run first), so the result is the stable
sort of the concatenation, bit for bit.

:func:`merge_sorted_runs_torch` is the plain PyTorch version;
:func:`merge_sorted_runs` runs it for CPU tensors and the hand-written CUDA
kernels of ``csrc/merge_runs.cu`` for CUDA tensors (K4 with a payload, K3
without), as a tree of pairwise merges. It never falls back from one to
the other.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from kmtricks_tpu_torch._build import merge_runs_lib, merge_tile
from kmtricks_tpu_torch.ops.u64 import lex_perm

MAX_WORDS = 5       # the kw layouts' int64 sort words at k <= 128

# kernel launches, counted where the wrapper launches them: each pairwise
# merge is one partition launch (``*_split``) and one merge launch (under a
# lock: the shards of a mesh merge on host threads of their own)
LAUNCHES = {"K3": 0, "K4": 0, "K3_split": 0, "K4_split": 0}
_LAUNCHES_LOCK = threading.Lock()


def merge_sorted_runs_torch(runs):
    """Plain version: a stable sort of the concatenated runs, least
    significant word first (as ``ops/count_merge.py::sort_packed``), with
    the payload gathered by the permutation. Returns (words, payload)."""
    nw = len(runs[0][0])
    words = [torch.cat([r[0][j] for r in runs]) for j in range(nw)]
    perm = lex_perm(reversed(words))
    out = tuple(w[perm] for w in words)
    if runs[0][1] is None:
        return out, None
    return out, torch.cat([r[1] for r in runs])[perm]


def _check_runs(runs):
    if not runs:
        raise ValueError("merge_sorted_runs: no runs")
    nw = len(runs[0][0])
    has_payload = runs[0][1] is not None
    if not 1 <= nw <= MAX_WORDS:
        raise ValueError(f"merge_sorted_runs: {nw} key words (1 to "
                         f"{MAX_WORDS})")
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
    CUDA kernels for CUDA tensors (never one for the other). Same
    signature and output as :func:`merge_sorted_runs_torch`."""
    dev = _check_runs(runs)
    if dev.type == "cpu":
        return merge_sorted_runs_torch(runs)
    if dev.type != "cuda":
        raise NotImplementedError(f"merge_sorted_runs: no kernel for {dev}")
    return _merge_tree_cuda(runs, dev)


def merge_sorted_runs_cuda(runs):
    """The CUDA kernels on CUDA runs (see :func:`merge_sorted_runs`)."""
    dev = _check_runs(runs)
    if dev.type != "cuda":
        raise ValueError(f"merge_sorted_runs_cuda: runs on {dev}")
    return _merge_tree_cuda(runs, dev)


def _merge_tree_cuda(runs, dev):
    """R checked runs merged as a tree of pairwise kernel merges of
    neighbours, so the earlier run is always A and ties keep run order.
    Runs on the current CUDA stream, no synchronisation."""
    level = list(runs)
    if len(level) > 1:
        lib = merge_runs_lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            while len(level) > 1:
                nxt = [_merge_two_cuda(level[i], level[i + 1], lib, stream)
                       for i in range(0, len(level) - 1, 2)]
                if len(level) % 2:
                    nxt.append(level[-1])
                level = nxt
    return tuple(level[0][0]), level[0][1]


def split_scratch(n: int, dev, tile: int) -> torch.Tensor:
    """The partition's output: the merge-path split at each of the
    ceil(n / tile) + 1 tile boundaries of an n-element merge, ``tile``
    the merge kernel's (``_build.merge_tile`` of its staged arrays)."""
    return torch.empty(-(-n // tile) + 1, dtype=torch.int64, device=dev)


def _merge_two_cuda(a, b, lib, stream):
    """One partition launch and one merge launch: run ``a`` then run ``b``
    (ties to ``a``) -> (words, payload), exactly sized."""
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
    # referenced until after the launch
    splits = split_scratch(na + nb, dev, merge_tile(nw + (op is not None)))

    def ptrs(words, payload):
        """The key words' pointer array, the payload's pointer."""
        return ((ctypes.c_void_p * nw)(*(w.data_ptr() for w in words)),
                None if payload is None else payload.data_ptr())

    err = lib.km_merge_runs(nw, *ptrs(aw, ap), na, *ptrs(bw, bp), nb,
                            *ptrs(ow, op), splits.data_ptr(), splits.numel(),
                            stream)
    if err:
        raise RuntimeError(f"merge_runs launch failed: "
                           f"{lib.km_error_string(err).decode()}")
    kern = "K4" if op is not None or nw > 1 else "K3"
    with _LAUNCHES_LOCK:
        LAUNCHES[kern] += 1
        LAUNCHES[f"{kern}_split"] += 1
    return ow, op
