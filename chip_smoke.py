#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (kmtricks_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It drives the port's main path (``pipeline``, every ``--mode``; the
flagship ``hash:bf:bin`` at full size; the repartition tally on the card,
``--static-repart`` and wide k up to 128; the per-stage path and the
module commands) and checks it, in phases that each print one JSON line
(with ``t_s``, the seconds since the start). Port runs compute their own
repartition with the tally on the card unless they reuse another run's,
and their run directories are compared with the reference's repartition
and minimizer files included:

1. probe: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: compiles the CUDA kernels from ``kmtricks_tpu_torch/csrc``, with
   the registers, spills and shared memory that ``-Xptxas -v`` reports for
   each instantiation of the merge kernels (1-5 key words, with and
   without the payload);
3. kernels: K1/K2 against their plain PyTorch versions on the card, bit
   for bit and ten launches per case, on the cases of
   tests/test_pallas_segscan.py, at the CUDA tile's edges, on runs that
   span 64 tiles, and at the full-size step's N, with the kernel and plain
   times and the bytes bound there;
4. parity: the port's run directory against the port's copy of the JAX
   package's host stages (numpy), byte for byte, on a 10-sample synthetic
   bank at k = 31 (k3 sort layout) and k = 21 (k2 layout); the host
   stages of phases 4 and 5 run in processes of their own during phase 3;
5. full size: the 10-sample 1 Mbp 8x bank (~77.6M k-mer occurrences in one
   step) through the CLI, with the wall of each stage, peak device memory
   and the kernels' launch counts, and its matrices against the host
   stages byte for byte;
6. merge kernels: K4 (one and two key words, count payload) and K3 (one
   word, no payload) against their plain PyTorch version, bit for bit and
   ten launches per case, on the cases of tests/test_routed_merge.py, at
   the CUDA tile's edges (runs ending at a tile boundary and +-1, a last
   tile of one element, ties over 35 tiles, disjoint runs, windows at odd
   int64 slots), on the phase-A runs of the phase-8 bank and on the same
   entries dealt into 8 runs, with the kernel, plain and (K3) torch.sort
   times and the bytes bound there;
7. engine parity: the phase-4 bank through the streaming engine (about
   ten chunks at a low --max-memory) at k = 31 and k = 21 (against phase
   4's host stages, whose files do not depend on --max-memory), and with
   --hist --soft-min 0.5, against the host stages byte for byte,
   histograms included;
8. engine at full size: the 10-sample 1 Mbp 30x bank (~291M windows)
   through the CLI at the default --max-memory, which streams it from the
   banks, with the wall of each phase, chunk/run/fold counts, peak device
   memory and the launch counts; its matrices against the one-step path
   (--max-memory 65536) and against an engine run whose small table
   budget forces two or more folds through K4;
9. output parity: every --mode (hash and k-mer count formats; count, pa,
   bf, bft, bfc; bin and text) on the phase-4 bank at k = 31, through the
   one-step path and through the engine (``pa:bin`` by its pa-bits tail;
   the text modes, whose writer both branches share, one step only),
   against the host stages byte for byte, fpr files and filters included;
10. hash at full size: ``hash:bf:bin --bloom-size 10000000`` on the 8x
   bank in one step against the host stages; ``hash:bft:bin`` and
   ``kmer:pa:bin`` (pa-bits tail) on the 30x bank through the engine
   against the one-step path; walls, peak device memory and launches of
   each run; K4 on the hash engine run's phase-A runs (one key word and
   the count) against its plain version, ten launches, and timed; the
   device times of the window hash and the pa finalize (plain torch)
   beside their bytes bounds; and the pa-bits tail against the dense tail
   on the same ``kmer:pa:bin`` table, timed in turns, same files;
11. repartition tally: the tally on the card against the host numpy
   tally, bins bit for bit, on the phase-4 bank (k = 31, 21, 63) and on
   the 30x bank; the config + repartition wall of a 30x run with each
   tally (device, then host); one full tally block's device time beside its bytes bound; peak
   device bytes;
12. ``--static-repart`` (k = 31) and 13. wide k (k = 45, 63, 96 and 128
   ``kmer:count:bin``; ``hash:bf:bin`` and ``kmer:pa:bin`` at k = 63) on
   the phase-4 bank, one step and engine, against the host stages byte
   for byte (the host stages run up to seven at a time, in processes of
   their own, as in phase 9; k = 128 has none: its engine run is held
   against its one-step run);
14. k = 63 at full width: the 8x bank in one step; the 30x bank through
   the engine against the one-step path and a forced-fold run; walls,
   peak device memory and K1/K2/K4 launches of each;
15. K4 over 3, 4 and 5 int64 key words with the count (the kw layouts'
   sort words), ten launches per case, at the 2048 and 4096 tiles' edges,
   ties and odd int64 slots; on the k = 63 engine's phase-A runs (device
   time, ``call_ms``, plain time, bytes bound) and on synthetic runs of 3
   to 5 words;
16. the per-stage device path (``--backend device``: one K1 and one K2
   launch per sample's count, the merge per partition on the card): on
   the phase-4 bank at k = 31, 21, 63 and 96 (host merge), ``hash:bf:bin``
   and ``hash:bft:bin`` (bit transpose on the card) against the host
   stages of phases 4, 9 and 13; the module commands as processes of
   their own (``repart``, ``count --id`` per sample, ``merge``,
   ``aggregate``; ``--until count --restrict-to-list`` then ``merge
   --partition-id``); ``--minimizer-type 1``; the 8x bank at full width
   with ``-t 1`` and ``-t 4`` (count and merge stage walls, peak device
   bytes, launches) against phase 5's host stages; and the split of the
   30x ``hash:bft:bin`` engine tail (bf rows, host or device transpose,
   filters);
17. the host-aggregated chunked path (``stage_mesh_chunked``, the sort
   layouts no packed word takes): ``hash:count:bin --bloom-size 2^62
   --nb-partitions 4`` and ``hash:pa:bin --bloom-size 2^61
   --nb-partitions 8`` on the 8x bank in chunks, against the host stages
   (repartition included); ``stage_mesh_chunked`` itself, streaming, on
   the 30x bank at k = 31 against phase 8's engine run, and with --hist
   and a float soft-min against an engine run with the same options; K1/K2
   on the largest chunk's segment stage against their plain versions;
18. the mesh: the 8x bank in one step over four shards on one card (one
   shard per card as well where there are several) at k = 31 (k3
   receivers: K4), 21 (k2: K3), 63 (kw: K4 over three words) and
   ``hash:bf:bin --bloom-size 10000000`` (h1: K3), against the host stages
   and the one-shard run; the 30x bank through the engine over four
   shards against phase 8's run; walls, peaks and launches of each; K3
   and K4 on the largest receiver's own routed runs against their plain
   versions, timed beside their bytes bounds (and K3 beside
   ``torch.sort``);
19. several processes: the streaming engine over two ranks
   (``torch.distributed`` with gloo, ``torch.multiprocessing.spawn``),
   each a mesh of two shards on the one card, rank 0 running config +
   repartition: the 30x bank (against phase 8's run) and, on the phase-4
   bank, ``kmer:pa:bin``, ``--hist --soft-min 0.5``, ``hash:count:bin``
   and a forced-fold run, each against the same engine run in one
   process over four shards, byte for byte; each rank's wall and its
   split, the bytes and wall of its exchanges, peak device bytes, decode
   shares and K3/K4 launches. With two cards or more, the forced-fold run
   over nccl (one rank per card); otherwise a line says it did not run;
20. the dense tails' merge on the card: ``merge_finalize`` against the
   host's numpy hard-min, clamp and ``merge_dense`` on a random 6,000,000
   x 10 count matrix at 1-, 2- and 4-byte count types (final counts, keep
   flags and statistics equal), with the device time of its counts and
   bits forms, their extra device memory, the host merge's seconds and the
   copy of the final counts to the host, pageable and page-locked.

``python3 chip_smoke.py --tail`` runs phases 1, 4, 7 and 20 alone: what
the dense tail's merge on the card runs through, the engine's histogram
and float soft-min branch included.

Kernel times are device times: CUDA events around a batch of
back-to-back calls enqueued behind a sleep kernel, divided by their
count, three times (``device_ms``); ``call_ms`` is one call between two
events, the wrapper's host time included.

Then one JSON line of kernel results and, last, the device line. Any
failure raises and exits non-zero; without CUDA it exits non-zero before
printing a result. Nothing here imports jax or the JAX package
(``kmtricks_tpu``), and the end checks it. Scratch data lives in
``.smoke_work/`` under the repository and is removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
OPTS = ["--hard-min", "2", "--soft-min", "2", "--share-min", "2",
        "--recurrence-min", "1"]
TPU_TILE = 8192           # the Pallas kernels' tile (pallas_segscan.TILE)
REPEATS = 10              # kernel launches per phase-3 and phase-6 case
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SMALL_MEM = 75            # MB: about ten engine chunks of the phase-4 bank
# phase 9: every output mode (count format:mode:output) with its --bitw
MODES = (("hash:count:bin", None), ("hash:count:text", None),
         ("hash:pa:bin", None), ("hash:bf:bin", None), ("hash:bft:bin", None),
         ("hash:bfc:bin", 2), ("kmer:pa:bin", None), ("kmer:pa:text", None),
         ("kmer:count:text", None))
BLOOM_SMALL = 1_000_000   # --bloom-size of phase 9
BLOOM_FULL = 10_000_000   # phase 10: README's flagship hash:bf:bin line


T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase line gets the seconds since the start
    of the script (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median time of one call of ``fn`` in ms over ``reps`` calls, each
    between two CUDA events on an idle stream, after a warm-up call and a
    synchronize. The start event is stamped at once, so the number
    includes the wrapper's host time (``call_ms``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@functools.cache
def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card."""
    torch.cuda._sleep(10**6)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def device_ms(fn, repeats: int = 3, batch_ms: float = 20.0,
              max_calls: int = 200) -> list:
    """Device time of one call of ``fn`` in ms, ``repeats`` times: CUDA
    events around a batch of back-to-back calls (about ``batch_ms`` of
    work, at most ``max_calls``: the card queues about a thousand pending
    launches, past which enqueueing waits for the device), divided by
    their count. The batch is enqueued behind a sleep kernel, so the
    wrapper's host time overlaps the device's work; the start event must
    still be pending once the last call is enqueued (else the sleep is
    lengthened and the batch runs again)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    count = int(min(max_calls, max(3, batch_ms / max(cuda_ms(fn, 1),
                                                     1e-3))))
    out = []
    for _ in range(repeats):
        sleep_ms = 2.0 * count * host_ms + 1.0
        for _attempt in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(sleep_ms * sleep_cycles_per_ms()))
            start.record()
            for _ in range(count):
                fn()
            end.record()
            ahead = not start.query()
            end.synchronize()
            if ahead:
                break
            sleep_ms *= 4
        else:
            raise AssertionError("device_ms: the host never got ahead of "
                                 "the device")
        out.append(start.elapsed_time(end) / count)
    return out


def profiled_kernel_ms(fn, calls: int = 5) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches, in
    ms, from ``torch.profiler`` over ``calls`` calls (empty if the
    profiler recorded no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = ev.name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + (
                ev.time_range.elapsed_us() / 1e3 / calls)
    return out


def median(xs) -> float:
    return float(np.median(xs))


def max_err(got, exp) -> int:
    """Largest |got - exp| over tuples of integer/bool tensors (0 when
    bit-equal); raises if any output differs."""
    err = 0
    for g, e in zip(got, exp):
        if g.dtype != e.dtype or g.shape != e.shape:
            raise AssertionError(f"{g.dtype}{tuple(g.shape)} vs "
                                 f"{e.dtype}{tuple(e.shape)}")
        d = (g.to(torch.int64) - e.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    if err:
        raise AssertionError(f"kernel differs from its plain version by "
                             f"{err}")
    return err


# ---------------------------------------------------------------------------
# Phase 3 cases (tests/test_pallas_segscan.py)
# ---------------------------------------------------------------------------

def _case(rng, n, invalid_tail):
    key_diff = np.zeros(n, dtype=bool)
    key_diff[0] = True
    key_diff[1:] = rng.random(n - 1) < 0.3
    occ_diff = key_diff | (rng.random(n) < 0.5)
    occ_diff[0] = True
    valid = np.ones(n, dtype=bool)
    if invalid_tail:
        valid[n - invalid_tail:] = False
    amin = rng.integers(1, 4, n).astype(np.int32)
    return occ_diff, key_diff, valid, amin


def segscan_cases():
    """(inputs, params) of the Pallas segscan test cases."""
    for n in (TPU_TILE // 2, TPU_TILE, TPU_TILE + 3, 3 * TPU_TILE + 1111):
        for hard_min, rmin, save_if, cmax in ((1, 1, 0, 0xFFFFFFFF),
                                              (2, 2, 3, 255)):
            rng = np.random.default_rng(n + hard_min)
            occ, kd, valid, amin = _case(rng, n, min(200, n // 4))
            hmin = np.full(n, hard_min, np.int32)
            yield (occ, kd, valid, amin, hmin), (rmin, save_if, cmax)
    n = 3 * TPU_TILE                              # one run across tiles
    occ = np.zeros(n, bool)
    occ[0] = True
    yield ((occ, occ.copy(), np.ones(n, bool), np.full(n, 2, np.int32),
            np.ones(n, np.int32)), (1, 0, 0xFFFFFFFF))
    n = TPU_TILE + 77                             # all invalid
    yield ((np.ones(n, bool), np.ones(n, bool), np.zeros(n, bool),
            np.ones(n, np.int32), np.ones(n, np.int32)), (1, 0, 255))
    rng = np.random.default_rng(3)                # per-position hard-min
    occ, kd, valid, amin = _case(rng, TPU_TILE, 64)
    yield ((occ, kd, valid, amin,
            rng.integers(1, 4, TPU_TILE).astype(np.int32)), (1, 0, 255))


def single_pass_cases(tile):
    """Cases at the CUDA kernels' own tile: the tile's edges, a length of 7
    mod 16 (the scalar tail), a key segment and a (key, sample) run that
    each span 64 tiles, no key head in the first three tiles, and all
    invalid."""
    for n in (1, tile - 1, tile, tile + 1, 5 * tile + 7):
        for hard_min, rmin, save_if, cmax in ((1, 1, 0, 0xFFFFFFFF),
                                              (2, 2, 3, 255)):
            rng = np.random.default_rng(n + hard_min)
            occ, kd, valid, amin = _case(rng, n, min(200, n // 4))
            yield ((occ, kd, valid, amin, np.full(n, hard_min, np.int32)),
                   (rmin, save_if, cmax))
    spans = 64
    n = (2 * spans + 12) * tile + 9
    rng = np.random.default_rng(spans)
    occ, kd, valid, amin = _case(rng, n, 5)
    lo, hi = tile // 2, tile // 2 + spans * tile     # one key, a few samples
    kd[lo + 1:hi] = False
    occ[lo + 1:hi] = rng.random(hi - lo - 1) < 1e-4
    occ[lo] = kd[lo] = True
    lo = hi + 3 * tile                                # one (key, sample) run
    kd[lo + 1:lo + spans * tile] = False
    occ[lo + 1:lo + spans * tile] = False
    occ[lo] = kd[lo] = True
    yield (occ, kd, valid, amin, np.ones(n, np.int32)), (1, 1, 255)
    n = 9 * tile + 50                                 # late first key head
    occ, kd, valid, amin = _case(np.random.default_rng(9), n, 20)
    kd[:3 * tile + 10] = False
    yield (occ, kd, valid, amin, np.ones(n, np.int32)), (1, 2, 255)
    n = 3 * tile + 5                                  # all invalid
    yield ((np.ones(n, bool), np.ones(n, bool), np.zeros(n, bool),
            np.ones(n, np.int32), np.ones(n, np.int32)), (1, 0, 255))


def check_kernels(inputs, rmin, save_if, cmax, S, reps=REPEATS):
    """K1 and K2 against their plain versions on the same CUDA tensors,
    ``reps`` launches each (a look-back race would show only now and
    then); returns (K1 error, K2 error), both 0 or raises."""
    occ, kd, valid, amin, hmin = inputs
    bwd_p = S.segscan_bwd_torch(occ, kd, valid, amin, hmin, count_max=cmax)
    cnt, present, solid, suffix = bwd_p
    fwd_p = S.segscan_fwd_torch(present, solid, suffix, kd, valid, cnt,
                                rmin=rmin, save_if=save_if)
    e1 = e2 = 0
    for _ in range(reps):
        bwd_k = S.segscan_bwd_cuda(occ, kd, valid, amin, hmin,
                                   count_max=cmax)
        fwd_k = S.segscan_fwd_cuda(present, solid, suffix, kd, valid, cnt,
                                   rmin=rmin, save_if=save_if)
        torch.cuda.synchronize()
        e1 = max(e1, max_err(bwd_k, bwd_p))
        e2 = max(e2, max_err(fwd_k, fwd_p))
    return e1, e2


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

def host_run(fof, run_dir, k, repart_from=None, max_memory=8192,
             hist=False, soft_min="2", mode="kmer:count:bin",
             bloom_size=None, bitw=None, stage_format=False,
             static_repart=False, minim_type=0, nb_partitions=0):
    """The host stages one by one, from the port's copy of the JAX
    package's host layer (numpy, independent of the device path under
    test): config, repartition (the host numpy tally, or XXH64 under
    ``static_repart``; frequency-ordered minimizers under ``minim_type``
    1), per-sample count (with histograms under ``hist``; k-mers or window
    hashes, as ``mode`` says), soft-min, per-partition merge, and under
    ``stage_format`` the per-sample filters of ``bft``."""
    from kmtricks_tpu_torch import constants as C
    from kmtricks_tpu_torch.runtime import pipeline as P

    opts = P.PipelineOptions(
        fof=fof, run_dir=run_dir, kmer_size=k, hard_min=2,
        soft_min=soft_min, share_min=2, recurrence_min=1, backend="host",
        repart_from=repart_from, max_memory_mb=max_memory, hist=hist,
        mode=mode, bloom_size=bloom_size or C.DEFAULT_BLOOM_SIZE,
        bitw=bitw or C.DEFAULT_BITW, static_repart=static_repart,
        minim_type=minim_type, nb_partitions=nb_partitions)
    kmdir, config = P.stage_config(opts)
    rep = P.stage_repart(kmdir, config, opts)
    for s in range(len(kmdir.fof)):
        P.stage_count(kmdir, config, rep, s, opts)
    amin = P.resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    for p in range(config.nb_partitions):
        P.stage_merge(kmdir, config, opts, p, amin)
    if stage_format:
        P.stage_format(kmdir, config, opts)
    return config.nb_partitions


def host_runs(jobs) -> dict:
    """``host_run(**job)`` for each job of {tag: job}, up to seven at a
    time in processes of their own (the host stages are single-threaded
    numpy; the card's machine has eight cores); returns {tag: seconds}.
    The pool is joined before it returns."""
    import multiprocessing

    with ProcessPoolExecutor(
            max_workers=min(7, len(jobs)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {tag: ex.submit(timed_host_run, job)
                for tag, job in jobs.items()}
        return {tag: f.result() for tag, f in futs.items()}


def timed_host_run(job) -> float:
    """host_run(**job), timed (a pool worker's task)."""
    t0 = time.perf_counter()
    host_run(**job)
    return time.perf_counter() - t0


def port_run(fof, run_dir, k, repart_from=None, extra=()):
    """The port's main path through its command line: its own repartition
    (the tally on the card), or ``repart_from``'s."""
    from kmtricks_tpu_torch.cli import main

    reuse = ["--repart-from", repart_from] if repart_from else []
    main(["pipeline", "--file", fof, "--run-dir", run_dir, "--kmer-size",
          str(k), "-v", "warning"] + reuse + OPTS + list(extra))


def mode_args(mode, bloom_size, bitw=None):
    """Command-line options of an output mode (``mode_subs`` says which
    run-dir folders it writes)."""
    args = ["--mode", mode, "--bloom-size", str(bloom_size)]
    return args + (["--bitw", str(bitw)] if bitw else [])


RUN_SUBS = ("repartition", "minimizers", "matrices", "merge_infos")


def mode_subs(mode):
    """The run-dir folders a mode writes: the repartition and its
    minimizer lists, matrices and merge infos, the fpr files of bf, the
    per-sample filters of bft."""
    out = mode.split(":")[1]
    return (RUN_SUBS + (("fpr",) if out == "bf" else ())
            + (("filters",) if out == "bft" else ()))


def compare_run_dirs(a, b, subs=RUN_SUBS):
    """Every file under ``subs`` of run dir ``a`` must exist in ``b`` with
    the same bytes; returns (files, bytes) compared."""
    nfiles = nbytes = 0
    for sub in subs:
        names = sorted(os.listdir(os.path.join(a, sub)))
        if names != sorted(os.listdir(os.path.join(b, sub))) or not names:
            raise AssertionError(f"{sub}: file lists differ")
        for name in names:
            with open(os.path.join(a, sub, name), "rb") as f:
                x = f.read()
            with open(os.path.join(b, sub, name), "rb") as f:
                y = f.read()
            if x != y:
                raise AssertionError(f"{sub}/{name} differs")
            nfiles += 1
            nbytes += len(x)
    return nfiles, nbytes


def staged_step(fof, run_dir, k, dev):
    """The port's main path run stage by stage on ``dev``, with a
    synchronize after each device stage; returns ({stage: seconds},
    {shape facts}, segment-stage inputs)."""
    from kmtricks_tpu_torch.convert import from_jax_inputs
    from kmtricks_tpu_torch.host import ops as hops
    from kmtricks_tpu_torch.ops import count_merge as CM
    from kmtricks_tpu_torch.ops.compact import compact_count_rows
    from kmtricks_tpu_torch.ops.encode import encode_batch
    from kmtricks_tpu_torch.ops.segscan import segment_stage
    from kmtricks_tpu_torch.runtime.device_pipeline import (
        _load_global_batch, rows_budget)
    from kmtricks_tpu_torch.runtime.pipeline import (
        PipelineOptions, resolve_soft_min, stage_config, stage_repart,
        write_merge_outputs)

    walls = {}
    t = [time.perf_counter()]

    def lap(name, sync=True):
        if sync and dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        walls[name] = now - t[0]
        t[0] = now

    opts = PipelineOptions(fof=fof, run_dir=run_dir, kmer_size=k,
                           hard_min=2, soft_min="2", share_min=2,
                           recurrence_min=1)
    kmdir, config = stage_config(opts)
    rep = stage_repart(kmdir, config, opts)
    lap("config_repart_host", sync=False)
    batch, lengths, sarr = _load_global_batch(kmdir, opts)
    nsamp = len(kmdir.fof)
    amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
    lap("decode_host", sync=False)
    b, ln, sm, table, amin, _ = from_jax_inputs(
        batch, lengths, sarr, rep.table, amin_vec, None, dev)
    lap("h2d")
    keys, parts, valid = encode_batch(b, ln, table, k, config.minim_size)
    sampw = sm[:, None].expand(parts.shape).reshape(-1)
    keys, parts, valid = keys.reshape(-1), parts.reshape(-1), \
        valid.reshape(-1)
    lap("encode")
    layout = CM.packed_layout(nsamp, 2 * k,
                              (config.nb_partitions - 1).bit_length())
    words = CM.pack_words(layout, parts, keys, sampw, valid, nsamp)
    lap("pack")
    ws = CM.sort_packed(layout, words)
    lap("sort")
    part_s, key_s, samp_s, valid_s, occ_d, kd = CM.unpack_sorted(
        layout, ws, nsamp, valid.sum())
    ones = torch.ones(1, dtype=torch.bool, device=dev)
    key_diff, occ_diff = torch.cat([ones, kd]), torch.cat([ones, occ_d])
    amin_of = CM._thresholds(amin, samp_s, 0)
    hmin_of = CM._thresholds(None, samp_s, 2)
    lap("unpack")
    seg_in = (occ_diff, key_diff, valid_s, amin_of, hmin_of)
    cnt, present, _s, _f, row_head, _k, _r = segment_stage(
        *seg_in, rmin=1, save_if=2,
        count_max=(1 << (8 * config.count_bytes)) - 1)
    lap("segment_stage_K1_K2")
    rows, pre, nrows, _maxc, _npres = compact_count_rows(
        part_s, key_s, samp_s, cnt, present, row_head, nsamp=nsamp,
        max_rows=rows_budget(nsamp, opts.max_memory_mb))
    lap("compact")
    rows, pre = rows.cpu().numpy(), pre.cpu().numpy().view(np.uint32)
    lap("d2h")
    keys_h = np.ascontiguousarray(rows[:, 0]).view(np.uint64).reshape(-1, 1)
    bounds = np.searchsorted(rows[:, 1], np.arange(config.nb_partitions + 1))
    for p in range(config.nb_partitions):
        sl = slice(int(bounds[p]), int(bounds[p + 1]))
        write_merge_outputs(kmdir, config, opts, p, hops.merge_dense(
            keys_h[sl], pre[sl], amin_vec, 1, 2))
    lap("merge_write_host", sync=False)
    info = {"layout": layout, "reads": int(batch.shape[0]),
            "read_len_padded": int(batch.shape[1]),
            "windows": int(valid.numel()), "valid_windows": int(valid.sum()),
            "rows": int(nrows), "partitions": int(config.nb_partitions)}
    return walls, info, seg_in


def sorted_runs(rng, lens, nw, payload, span, dev):
    """Ascending runs of ``nw`` int64 words drawn from a small pool (equal
    keys within and across runs when ``span`` is small), with a payload
    numbering the entries, as CUDA tensors."""
    pool = [rng.integers(0, span, max(8, sum(lens) // 3), dtype=np.int64)
            for _ in range(nw)]
    runs, base = [], 0
    for n in lens:
        pick = rng.integers(0, len(pool[0]), n)
        cols = [p[pick] for p in pool]
        order = np.lexsort(cols[::-1])
        words = tuple(torch.from_numpy(np.ascontiguousarray(c[order])).to(dev)
                      for c in cols)
        pay = (torch.arange(base, base + n, dtype=torch.int64, device=dev)
               if payload else None)
        runs.append((words, pay))
        base += n
    return runs


def merge_cases(dev):
    """Runs on the grids of tests/test_routed_merge.py: 2 to 8
    runs, lengths that are and are not powers of two, runs shorter than
    the TPU tile, empty runs, and many ties across runs."""
    rng = np.random.default_rng(0)
    t = TPU_TILE
    grids = ([t, t], [t] * 4, [t] * 8, [t + 1000, 2 * t - 512],
             [4 * t - 1, 3 * t + 5, t], [5000, 0, 777],
             [1, 2, 0, 300, t - 1, 17], [300] * 7, [0, t])
    for lens in grids:
        for span in (1 << 62, 64):
            for nw, payload in ((1, True), (2, True), (1, False)):
                yield sorted_runs(rng, lens, nw, payload, span, dev)


def merge_kind(runs) -> str:
    """The kernel the wrapper counts for these runs."""
    words, payload = runs[0]
    return "K4" if payload is not None or len(words) > 1 else "K3"


def at_odd_slot(t):
    """A copy of ``t`` that starts 8 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def tile_edge_merge_cases(dev, tile):
    """Runs at the CUDA kernel's own tile: runs that end at a tile boundary
    and at +-1 of it, a last tile of one element, one run wholly before
    the other, equal keys over many tiles, and windows that start at odd
    int64 slots (key words, payload or both)."""
    rng = np.random.default_rng(4)
    t = tile
    for lens in ([t, t], [t - 1, t + 1], [t + 1, t], [2 * t - 1, 1],
                 [1, 2 * t], [3 * t, t + 1], [t - 1, 0, 2 * t + 2]):
        for nw, payload in ((1, False), (2, True), (1, True)):
            yield sorted_runs(rng, lens, nw, payload, 1 << 62, dev)
    for nw, payload in ((1, False), (2, True)):          # one key, 35 tiles
        yield [(tuple(torch.full((n,), 7, dtype=torch.int64, device=dev)
                      for _ in range(nw)),
                torch.arange(n, dtype=torch.int64, device=dev) + 10 * r
                if payload else None)
               for r, n in enumerate((20 * t + 3, 15 * t))]
    yield sorted_runs(rng, [12 * t + 5, 9 * t - 3], 2, True, 3, dev)
    for first, second in ((0, 1), (1, 0)):               # disjoint runs
        lo = torch.arange(5 * t + 7, dtype=torch.int64, device=dev)
        hi = torch.arange(3 * t, dtype=torch.int64, device=dev) + (1 << 40)
        ab = (lo, hi)
        yield [((ab[first],), None), ((ab[second],), None)]
    for shift in ("a", "b", "payload", "all"):
        (aw, ap), (bw, bp) = sorted_runs(rng, [4 * t + 3, 3 * t + 2], 2,
                                         True, 1 << 62, dev)
        if shift in ("a", "all"):
            aw = tuple(at_odd_slot(w) for w in aw)
        if shift in ("b", "all"):
            bw = tuple(at_odd_slot(w) for w in bw)
        if shift in ("payload", "all"):
            ap, bp = at_odd_slot(ap), at_odd_slot(bp)
        yield [(aw, ap), (bw, bp)]


def merge_err(runs, MR, reps: int = 1) -> int:
    """The merge kernel against its plain version on the same runs,
    ``reps`` launches (a race would show only now and then); 0 or
    raises."""
    def flat(res):
        words, payload = res
        return tuple(words) + (() if payload is None else (payload,))

    exp = flat(MR.merge_sorted_runs_torch(runs))
    err = 0
    for _ in range(reps):
        got = flat(MR.merge_sorted_runs_cuda(runs))
        torch.cuda.synchronize()
        if len(got) != len(exp):
            raise AssertionError("merge kernel output has the wrong arity")
        err = max(err, max_err(got, exp))
    return err


def split_runs(words, payload, parts, seed):
    """Sorted (words, payload) dealt at random into ``parts`` sorted runs
    that interleave over the whole key range."""
    g = torch.Generator(device=words[0].device).manual_seed(seed)
    label = torch.randint(0, parts, (words[0].numel(),), generator=g,
                          device=words[0].device)
    return [(tuple(w[label == r] for w in words), payload[label == r])
            for r in range(parts)]


def ptxas_report(name: str) -> dict:
    """Registers, spills and static shared memory of each kernel of
    ``csrc/<name>.cu``, as ``nvcc -Xptxas -v`` prints them."""
    from kmtricks_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"ptxas_{name}_{os.getpid()}.so")
    try:
        res = subprocess.run(
            [_build._nvcc()] + _build.NVCC_FLAGS + [
                "-Xptxas", "-v", "-o", out,
                os.path.join(_build._CSRC, f"{name}.cu")],
            capture_output=True, text=True, check=True)
    finally:
        if os.path.exists(out):
            os.remove(out)
    report, fn = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and ("spill" in line or "Used" in line):
            report.setdefault(fn, []).append(line.split(":", 1)[-1].strip()
                                             if "Used" in line
                                             else line.strip())
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(report),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
        report = {n.split("(")[0]: v for n, v in zip(names, report.values())}
    return report


def phase_a_runs(fof, run_dir, k, dev, repart_from=None, **kw):
    """The sorted pair runs that phase A of the engine merges for ``fof``
    at the default --max-memory (no fold: one run per chunk), made with
    the engine's own chunk source and chunk step (``kw``: further
    options, such as a hash ``mode`` and its ``bloom_size``); and the
    run's kmdir, config and options."""
    from kmtricks_tpu_torch.parallel.pipeline import build_chunk_pairs_step
    from kmtricks_tpu_torch.runtime.device_pipeline import hash_window_bits
    from kmtricks_tpu_torch.runtime.pipeline import (
        BYTES_PER_WINDOW, PipelineOptions, parse_mode, stage_config,
        stage_repart)
    from kmtricks_tpu_torch.runtime.device_pipeline import chunk_source

    opts = PipelineOptions(fof=fof, run_dir=run_dir, kmer_size=k,
                           repart_from=repart_from, **kw)
    if repart_from:
        opts.nb_partitions = len(os.listdir(os.path.join(repart_from,
                                                         "merge_infos")))
    kmdir, config = stage_config(opts)
    rep = stage_repart(kmdir, config, opts)
    gen, _rows = chunk_source(
        kmdir, opts, k, int(opts.max_memory_mb * 1e6 / BYTES_PER_WINDOW),
        None, None, None, True)
    cf = parse_mode(opts.mode)[0]
    step = build_chunk_pairs_step((dev,), k=k, m=config.minim_size,
                                  nsamp=len(kmdir.fof),
                                  nb_parts=config.nb_partitions, mode=cf,
                                  window_bits=hash_window_bits(kmdir, cf))
    table = torch.from_numpy(rep.table.astype(np.int32)).to(dev)
    return [step(*(torch.from_numpy(a).to(dev) for a in chunk), table)[0]
            for chunk in gen], kmdir, config, opts


def output_parity(fof, repart_from, SE) -> None:
    """Phase 9: every output mode on the phase-4 bank at k = 31, through
    the one-step path and through the engine (``SMALL_MEM``), each with
    its own repartition from the tally on the card, against the host
    stages (``repart_from``'s numpy tally) byte for byte (fpr files and
    filters included)."""
    tags = {mode: mode.replace(":", "_") for mode, _bitw in MODES}
    host_s = host_runs({mode: dict(
        fof=fof, run_dir=os.path.join(WORK, f"host_{tags[mode]}"), k=31,
        repart_from=repart_from, mode=mode, bloom_size=BLOOM_SMALL,
        bitw=bitw, stage_format=mode == "hash:bft:bin")
        for mode, bitw in MODES})
    for mode, bitw in MODES:
        host_rd = os.path.join(WORK, f"host_{tags[mode]}")
        res = {"phase": "output_parity", "mode": mode,
               "host_s": host_s[mode]}
        # the text writers are shared by both branches and take ~11 s a
        # run at k-mer scale: text modes run the one-step branch only
        for branch, extra in (("one_step", []),) + (
                () if mode.endswith(":text") else
                (("engine", ["--max-memory", str(SMALL_MEM)]),)):
            rd = os.path.join(WORK, f"port_{tags[mode]}_{branch}")
            SE.last_run.clear()
            t0 = time.perf_counter()
            port_run(fof, rd, 31, extra=mode_args(mode, BLOOM_SMALL, bitw)
                     + extra)
            res[f"{branch}_s"] = time.perf_counter() - t0
            stats = dict(SE.last_run)
            if branch == "one_step" and stats:
                raise AssertionError(f"{mode}: one-step run took the engine")
            if branch == "engine":
                tail = "pa_bits" if mode.endswith(":pa:bin") else "dense"
                if stats.get("chunks", 0) < 5 or stats["tail"] != tail:
                    raise AssertionError(f"{mode}: engine run {stats}")
                res.update(chunks=stats["chunks"], tail=stats["tail"])
            files, nbytes = compare_run_dirs(host_rd, rd, mode_subs(mode))
            res[f"{branch}_files_identical"] = files
            res["bytes"] = nbytes
        emit(res)


def timed_run(counters, SE, fof, run_dir, repart_from, extra, k=31):
    """One port run through the CLI with the kernel counters set to 0
    just before it: wall, peak device bytes, launches and engine stats."""
    reset(*counters)
    SE.last_run.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    port_run(fof, run_dir, k, repart_from, extra)
    torch.cuda.synchronize()
    launches = {}
    for c in counters:
        launches.update(c)
    return {"wall_s": time.perf_counter() - t0,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches,
            "engine": dict(SE.last_run)}


def hash_full_size(fof_big, host_full, fof_e2e, eng_rd, S, MR, SE, dev,
                   smi) -> dict:
    """Phase 10: the flagship ``hash:bf:bin --bloom-size 10000000`` on the
    8x bank in one step against the host stages; ``hash:bft:bin`` on the
    30x bank through the engine against one step (filters included);
    ``kmer:pa:bin`` on the 30x bank through the engine's pa-bits tail
    against the one-step dense merge; then the device times of the two
    plain-torch pieces of the slice, the window hash and the pa finalize,
    beside their bytes bounds. Returns each run's launches."""
    from kmtricks_tpu_torch.core import hashers
    from kmtricks_tpu_torch.core.repartition import Repartition
    from kmtricks_tpu_torch.ops.count_merge import stream_layout
    from kmtricks_tpu_torch.ops.encode import encode_batch
    from kmtricks_tpu_torch.ops.xxh64 import window_hash
    from kmtricks_tpu_torch.parallel.pipeline import (
        merge_finalize, table_compact, table_sort_collapse)
    from kmtricks_tpu_torch.runtime.device_pipeline import _load_global_batch
    from kmtricks_tpu_torch.runtime.kmdir import KmDir
    from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions

    counters = (S.LAUNCHES, MR.LAUNCHES)
    bf = "hash:bf:bin"
    host_rd = os.path.join(WORK, "host_full_hash_bf")
    t0 = time.perf_counter()
    host_run(fof_big, host_rd, 31, host_full, mode=bf, bloom_size=BLOOM_FULL)
    host_s = time.perf_counter() - t0
    port_rd = os.path.join(WORK, "port_full_hash_bf")
    runs = {"hash:bf:bin 8x one step": timed_run(
        counters, SE, fof_big, port_rd, host_full, mode_args(bf, BLOOM_FULL))}
    bf_files, bf_bytes = compare_run_dirs(host_rd, port_rd, mode_subs(bf))

    # the 30x bank: engine (default --max-memory) against one step
    nparts = len(os.listdir(os.path.join(eng_rd, "merge_infos")))
    cmp = {}
    for mode in ("hash:bft:bin", "kmer:pa:bin"):
        rds = []
        for branch, extra in (("engine", []),
                              ("one step", ["--max-memory", "65536"])):
            rds.append(os.path.join(WORK, f"{mode[:8]}_{branch[:3]}"))
            runs[f"{mode} 30x {branch}"] = timed_run(
                counters, SE, fof_e2e, rds[-1], eng_rd,
                mode_args(mode, BLOOM_FULL) + extra
                + ["--nb-partitions", str(nparts)])
        cmp[mode] = compare_run_dirs(rds[1], rds[0], mode_subs(mode))
    for name, r in runs.items():
        l, eng = r["launches"], r["engine"]
        if "engine" in name:
            tail = "pa_bits" if ":pa:" in name else "dense"
            if not (l["K4"] > 0 and l["K4_split"] == l["K4"]
                    and eng.get("tail") == tail):
                raise AssertionError(f"{name}: {l} {eng}")
        elif eng or not (l["bwd"] > 0 and l["fwd"] > 0):
            raise AssertionError(f"{name} skipped the one-step path: {l}")

    # the window hash on the 8x bank's windows, against the numpy golden
    kmdir = KmDir.init(port_rd)
    opts = PipelineOptions(fof=kmdir.fof_path, run_dir=port_rd, kmer_size=31)
    batch, lengths, _sarr = _load_global_batch(kmdir, opts)
    table = Repartition.load(kmdir.repart_path).table
    hw = hashers.HashWindow.load(kmdir.hash_win)
    wb = hw.window_size_bits
    keys, parts, _valid = encode_batch(
        torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev),
        torch.from_numpy(table.astype(np.int32)).to(dev), 31, hw.minim_size)
    del batch, _valid
    got = window_hash(keys[:256], parts[:256], wb).cpu().numpy()
    exp = hashers.window_hash(
        keys[:256].reshape(-1, 1).cpu().numpy().view(np.uint64),
        parts[:256].reshape(-1).cpu().numpy(), wb)
    if not np.array_equal(got.reshape(-1).view(np.uint64), exp):
        raise AssertionError("window_hash differs from the numpy golden")
    windows = keys.numel()
    hash_ms = device_ms(lambda: window_hash(keys, parts, wb))
    del keys, parts
    torch.cuda.empty_cache()

    # K4 on the phase-A runs of the hash engine run (one key word + the
    # count), against its plain version, and its device time
    hruns = phase_a_runs(fof_e2e, os.path.join(WORK, "runs_hash"), 31, dev,
                         repart_from=eng_rd, mode="hash:bft:bin",
                         bloom_size=BLOOM_FULL)[0]
    k4h = lambda: MR.merge_sorted_runs_cuda(hruns)  # noqa: E731
    hentries = sum(int(c.shape[0]) for _w, c in hruns)
    hnw = len(hruns[0][0])
    k4_hash = {
        "phase_a_runs": [int(c.shape[0]) for _w, c in hruns],
        "key_words": hnw, "max_abs_err": merge_err(hruns, MR, REPEATS),
        "device_ms_3_repeats": device_ms(k4h), "call_ms": cuda_ms(k4h),
        "plain_ms": cuda_ms(lambda: MR.merge_sorted_runs_torch(hruns)),
        # int64 key words and the count, read once and written once
        "bound_ms": hentries * 2 * 8 * (hnw + 1) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    k4_hash["ms"] = median(k4_hash["device_ms_3_repeats"])
    del hruns
    torch.cuda.empty_cache()

    # the pa finalize on the 30x bank's phase-B table (the kmer:pa:bin
    # engine run's options)
    pair_runs, kmdir, config, opts = phase_a_runs(
        fof_e2e, os.path.join(WORK, "runs_pa"), 31, dev, repart_from=eng_rd,
        mode="kmer:pa:bin", hard_min=2, soft_min="2", share_min=2,
        recurrence_min=1)
    nsamp = len(kmdir.fof)
    ws, cnt = table_sort_collapse(pair_runs)
    del pair_runs
    rows, pre, part_rows, _maxc, _npres = table_compact(
        ws, cnt, layout=stream_layout(31, config.nb_partitions, nsamp),
        nsamp=nsamp, hard_min=2, nb_parts=config.nb_partitions)
    del ws, cnt
    bounds = torch.zeros(config.nb_partitions + 1, dtype=torch.int64,
                         device=dev)
    torch.cuda.synchronize()
    torch.cumsum(part_rows, 0, out=bounds[1:])
    two = torch.full((nsamp,), 2, dtype=torch.int64, device=dev)
    count_max = (1 << (8 * config.count_bytes)) - 1
    fin = lambda: merge_finalize(  # noqa: E731
        pre, two, two, bounds, rmin=1, save_if=2, count_max=count_max,
        bits=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    packed, keep, stats = fin()
    torch.cuda.synchronize()
    fin_peak = torch.cuda.max_memory_allocated() - base
    fin_ms = device_ms(fin)
    # pre read once; bits, keep flags and statistics written once
    fin_bytes = (pre.numel() * 4 + packed.numel() + keep.numel()
                 + stats.numel() * 8)
    del packed, keep, stats

    # both engine tails on this table, in turns: the pa-bits tail and the
    # dense tail write the same files
    dense_root = kmdir.root + "_dense"
    shutil.copytree(kmdir.root, dense_root)
    kmdir_dense = KmDir.init(dense_root)
    amin_np = np.full(nsamp, 2, np.uint32)
    hard_np = np.asarray(kmdir.fof.abundance_mins(opts.hard_min), np.uint32)
    tails = {"pa_bits": [], "dense": []}
    for _ in range(2):
        for tail in tails:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tail == "pa_bits":
                SE._fetch_merge_write_pa_bits(
                    kmdir, config, opts, "kmer", (dev,),
                    [(rows, pre, part_rows)], amin_np, hard_np, count_max)
            else:
                SE._fetch_merge_write(
                    kmdir_dense, config, opts, "kmer", (dev,),
                    [(rows, pre, part_rows)], amin_np, hard_np, count_max,
                    False)
            tails[tail].append(time.perf_counter() - t0)
    tail_files = compare_run_dirs(kmdir.root, dense_root)
    emit({"phase": "hash_full_size", "bloom_size": BLOOM_FULL,
          "runs": runs, "host_stages_hash_bf_s": host_s,
          "hash_bf_files_identical": bf_files, "hash_bf_bytes": bf_bytes,
          "engine_vs_one_step_files_bytes": cmp,
          "window_hash": {"windows": windows, "window_bits": wb,
                          "device_ms_3_repeats": hash_ms,
                          "bound_ms": windows * 20 / HBM_BYTES_PER_S * 1e3,
                          "bound_by": "bytes"},
          "k4_hash_phase_a": k4_hash,
          "pa_finalize": {"rows": int(pre.shape[0]), "samples": nsamp,
                          "device_ms_3_repeats": fin_ms,
                          "peak_extra_device_bytes": fin_peak,
                          "bound_ms": fin_bytes / HBM_BYTES_PER_S * 1e3,
                          "bound_by": "bytes"},
          "kmer_pa_tails_same_table_s": tails,
          "kmer_pa_tails_files_bytes": tail_files,
          "gpu": smi})
    return {name: r["launches"] for name, r in runs.items()}, k4_hash


WIDE_MODES = ((45, "kmer:count:bin"), (63, "kmer:count:bin"),
              (96, "kmer:count:bin"), (128, "kmer:count:bin"),
              (63, "hash:bf:bin"), (63, "kmer:pa:bin"))


def tally_phase(fof_small, fof_e2e, dev, smi) -> dict:
    """Phase 11: the repartition tally on the card. Its bins against the
    host numpy tally's, bit for bit, on the phase-4 bank (k = 31, 21, 63)
    and on the 30x bank; the config + repartition wall of a run on the 30x
    bank with each tally; one full tally block of raw bytes against the
    host tally of its rows, and its device time beside its bytes bound;
    peak device bytes."""
    from kmtricks_tpu_torch.core.kmer import (
        ASCII_CODE_TABLE, ASCII_VALID_TABLE)
    from kmtricks_tpu_torch.io import sequences as seqio
    from kmtricks_tpu_torch.ops import repart_sample as RS
    from kmtricks_tpu_torch.runtime import pipeline as P

    bins = {}
    for name, fof, ks in (("small", fof_small, (31, 21, 63)),
                          ("e2e", fof_e2e, (31,))):
        for k in ks:
            opts = P.PipelineOptions(
                fof=fof, run_dir=os.path.join(WORK, f"tally_{name}_{k}"),
                kmer_size=k)
            kmdir, config = P.stage_config(opts)
            t0 = time.perf_counter()
            host = P.sample_minimizer_bins(kmdir, config)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t2 = time.perf_counter()
            got = P.sample_minimizer_bins(kmdir, config, device=dev)
            t3 = time.perf_counter()
            if not np.array_equal(got, host):
                raise AssertionError(f"device tally differs: {name} k={k}")
            bins[f"{name} k={k}"] = {
                "minimizer_size": config.minim_size,
                "kxmer_starts": int(host.sum()), "host_tally_s": t1 - t0,
                "device_tally_s": t3 - t2,
                "peak_device_bytes": torch.cuda.max_memory_allocated() - base}
    # the config + repartition stages of a run on the 30x bank, each tally
    walls = {"device": [], "host": []}
    tables = set()
    for side in ("device", "host"):
        rd = os.path.join(WORK, f"repart_e2e_{side}")
        shutil.rmtree(rd, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opts = P.PipelineOptions(fof=fof_e2e, run_dir=rd, kmer_size=31)
        kmdir, config = P.stage_config(opts)
        P.stage_repart(kmdir, config, opts, dev if side == "device" else None)
        torch.cuda.synchronize()
        walls[side].append(time.perf_counter() - t0)
        with open(kmdir.repart_path, "rb") as f:
            tables.add(f.read())
    if len(tables) != 1:
        raise AssertionError("the two tallies' repartitions differ")
    # one full block of the 30x bank (its first reads, as the sampler
    # blocks them: raw bytes, as wide as the longest read rounded up to 8):
    # its bins against the host tally of the same rows, and its device
    # time against the bytes read once and 4^m int64 bins written once
    m = config.minim_size
    batch, lengths = next(seqio.iter_batches(kmdir.fof.entries[0].paths))
    B = P.REPART_BLOCK
    while B > 128 and B * P._read_width(lengths[:B]) > P.REPART_BLOCK * 512:
        B //= 2
    n = min(B, len(lengths))
    L = P._read_width(lengths[:n])
    blk = np.full((n, L), ord("N"), np.uint8)
    w = min(L, batch.shape[1])
    blk[:, :w] = batch[:n, :w]
    raw = torch.from_numpy(blk).to(dev)
    lens_d = torch.from_numpy(lengths[:n]).to(dev)
    tbins = RS.make_bins(m, dev)
    step = lambda: RS.tally_step(tbins, raw, lens_d, k=31, m=m)  # noqa
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    block_peak = torch.cuda.max_memory_allocated() - base
    flat = np.hstack([blk, np.full((n, 1), ord("N"), np.uint8)]).ravel()
    host_block = np.zeros(4 ** m, np.int64)
    P._tally_kxmer_starts(host_block, ASCII_CODE_TABLE[flat],
                          ASCII_VALID_TABLE[flat], 31, m, None)
    if not np.array_equal(tbins.cpu().numpy(), host_block):
        raise AssertionError("the raw-byte block's tally differs")
    block_ms = device_ms(step)
    block_bytes = raw.numel() + lens_d.numel() * 4 + 4 ** m * 8
    res = {"phase": "repartition_tally", "bins_identical": bins,
           "e2e_config_repart_wall_s": walls,
           "block": {"reads": n, "rows": n, "read_width": L,
                     "k": 31, "minimizer_size": m,
                     "device_ms_3_repeats": block_ms,
                     "bound_ms": block_bytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes",
                     "peak_extra_device_bytes": block_peak},
           "gpu": smi}
    emit(res)
    return res


def wide_parity(fof_small, SE, MR, S) -> dict:
    """Phases 12-13: --static-repart (k = 31) and wide k (k = 45, 63, 96
    and 128 kmer:count:bin; hash:bf:bin and kmer:pa:bin at k = 63) on the
    phase-4 bank, through the one-step path and the engine
    (``SMALL_MEM``), against the host stages byte for byte; the host
    stages run in parallel (``host_runs``). k = 128, whose host stages
    take the longest, has no host reference: its engine run is held
    against its one-step run. Returns each run's launches."""
    jobs = {"static k=31": dict(fof=fof_small, k=31, static_repart=True,
                                run_dir=os.path.join(WORK, "host_static"))}
    for k, mode in WIDE_MODES:
        jobs[f"{mode} k={k}"] = dict(
            fof=fof_small, k=k, mode=mode, bloom_size=BLOOM_SMALL,
            run_dir=os.path.join(WORK, f"host_w{k}_{mode[:4]}{mode[5:7]}"))
    host_s = host_runs({tag: job for tag, job in jobs.items()
                        if not tag.endswith("k=128")})
    launches = {}
    for tag, job in jobs.items():
        mode = job.get("mode", "kmer:count:bin")
        extra = (["--static-repart"] if job.get("static_repart")
                 else mode_args(mode, BLOOM_SMALL))
        res = {"phase": "static_repart" if "static" in tag
               else "wide_k_parity", "case": tag,
               "host_s": host_s.get(tag)}
        ref = job["run_dir"] if tag in host_s else None
        for branch, more in (("one_step", []),
                             ("engine", ["--max-memory", str(SMALL_MEM)])):
            rd = job["run_dir"].replace("host_", "port_") + "_" + branch
            reset(MR.LAUNCHES, S.LAUNCHES)
            SE.last_run.clear()
            t0 = time.perf_counter()
            port_run(fof_small, rd, job["k"], extra=extra + more)
            res[f"{branch}_s"] = time.perf_counter() - t0
            stats = dict(SE.last_run)
            got = {**S.LAUNCHES, **MR.LAUNCHES}
            if branch == "one_step" and (stats or not got["bwd"]):
                raise AssertionError(f"{tag}: one-step run {stats} {got}")
            if branch == "engine" and (stats.get("chunks", 0) < 5
                                       or not got["K4"]):
                raise AssertionError(f"{tag}: engine run {stats} {got}")
            launches[f"{tag} {branch}"] = got
            res[f"{branch}_launches"] = got
            if ref is None:            # the engine against this run
                ref = res["reference"] = rd
                continue
            files, nbytes = compare_run_dirs(ref, rd, mode_subs(mode))
            res[f"{branch}_files_identical"] = files
            res["bytes"] = nbytes
        emit(res)
    return launches


def wide_full_size(fof_big, fof_e2e, S, MR, SE, smi):
    """Phase 14: k = 63 at full width: the 8x bank in one step; the 30x
    bank through the engine (default --max-memory) against the one-step
    path (--max-memory 65536) and against a forced-fold run; walls, peak
    device bytes and K1/K2/K4 launches of each. Returns the runs and the
    engine run's directory."""
    from kmtricks_tpu_torch.runtime.pipeline import (
        BYTES_PER_WINDOW, PipelineOptions, run_pipeline)

    counters = (S.LAUNCHES, MR.LAUNCHES)
    runs = {"kmer:count:bin 8x k=63 one step": timed_run(
        counters, SE, fof_big, os.path.join(WORK, "w63_8x"), None, [], 63)}
    eng_rd = os.path.join(WORK, "w63_e2e_engine")
    runs["kmer:count:bin 30x k=63 engine"] = timed_run(
        counters, SE, fof_e2e, eng_rd, None, [], 63)
    eng = runs["kmer:count:bin 30x k=63 engine"]["engine"]
    nparts = len(os.listdir(os.path.join(eng_rd, "merge_infos")))
    one_rd = os.path.join(WORK, "w63_e2e_one")
    runs["kmer:count:bin 30x k=63 one step"] = timed_run(
        counters, SE, fof_e2e, one_rd, eng_rd,
        ["--max-memory", "65536", "--nb-partitions", str(nparts)], 63)
    one_files = compare_run_dirs(eng_rd, one_rd)
    shutil.rmtree(one_rd)
    reset(*counters)
    fold_rd = os.path.join(WORK, "w63_e2e_folds")
    t0 = time.perf_counter()
    run_pipeline(PipelineOptions(
        fof=fof_e2e, run_dir=fold_rd, kmer_size=63, hard_min=2,
        soft_min="2", share_min=2, recurrence_min=1, repart_from=eng_rd,
        nb_partitions=nparts), device="cuda",
        chunk_windows=int(8192 * 1e6 / BYTES_PER_WINDOW) // 16,
        table_cap=int(eng["table_entries"] * 1.05))
    folds = {"wall_s": time.perf_counter() - t0,
             "engine": dict(SE.last_run), "launches": dict(MR.LAUNCHES)}
    if folds["engine"]["folds"] < 2:
        raise AssertionError(f"expected two or more folds: {folds}")
    fold_files = compare_run_dirs(eng_rd, fold_rd)
    shutil.rmtree(fold_rd)
    for name, r in runs.items():
        got = r["launches"]
        if "engine" in name:
            if not (got["K4"] > 0 and got["K4_split"] == got["K4"]
                    and r["engine"]):
                raise AssertionError(f"{name}: {got} {r['engine']}")
        elif r["engine"] or not (got["bwd"] > 0 and got["fwd"] > 0):
            raise AssertionError(f"{name} skipped the one-step path: {got}")
    emit({"phase": "wide_full_size", "k": 63, "runs": runs,
          "engine_vs_one_step_files_bytes": one_files,
          "forced_folds": folds, "engine_vs_forced_folds_files_bytes":
          fold_files, "gpu": smi})
    return runs, eng_rd


def k4_wide(dev, fof_e2e, eng_rd, MR, smi) -> dict:
    """Phase 15: K4 over 3, 4 and 5 int64 key words plus the count
    against its plain version, ten launches per case, at the tiles' edges
    (2048 outputs for four to six staged arrays, 4096 for three), over
    ties, few keys and windows at odd int64 slots; then on the k = 63
    engine's phase-A runs (device time, call_ms, plain time, bytes bound)
    and on synthetic runs of 3 to 5 words at the same entry count."""
    from kmtricks_tpu_torch import _build

    rng = np.random.default_rng(15)
    err, cases = 0, 0
    for nw in (3, 4, 5):
        for payload in (True, False):
            t = _build.merge_tile(nw + payload)
            for lens in ([t, t], [t - 1, t + 1], [t + 1, t], [2 * t - 1, 1],
                         [1, 2 * t], [3 * t + 5, 2 * t - 3],
                         [t - 1, 0, 2 * t + 2], [300] * 7):
                for span in (1 << 62, 3):
                    err = max(err, merge_err(sorted_runs(
                        rng, lens, nw, payload, span, dev), MR, REPEATS))
                    cases += 1
        t = _build.merge_tile(nw + 1)
        err = max(err, merge_err([                      # one key, 20 tiles
            (tuple(torch.full((n,), 7, dtype=torch.int64, device=dev)
                   for _ in range(nw)),
             torch.arange(n, dtype=torch.int64, device=dev) + 10 * r)
            for r, n in enumerate((12 * t + 3, 8 * t))], MR, REPEATS))
        cases += 1
        for shift in ("a", "b", "payload", "all"):
            (aw, ap), (bw, bp) = sorted_runs(rng, [4 * t + 3, 3 * t + 2], nw,
                                             True, 1 << 62, dev)
            if shift in ("a", "all"):
                aw = tuple(at_odd_slot(w) if i % 2 == 0 else w
                           for i, w in enumerate(aw))
            if shift in ("b", "all"):
                bw = tuple(at_odd_slot(w) if i % 2 else w
                           for i, w in enumerate(bw))
            if shift in ("payload", "all"):
                ap, bp = at_odd_slot(ap), at_odd_slot(bp)
            err = max(err, merge_err([(aw, ap), (bw, bp)], MR, REPEATS))
            cases += 1
    runs = phase_a_runs(fof_e2e, os.path.join(WORK, "runs_w63"), 63, dev,
                        repart_from=eng_rd)[0]
    nw = len(runs[0][0])
    err = max(err, merge_err(runs, MR, REPEATS))
    entries = sum(int(c.shape[0]) for _w, c in runs)
    k4 = lambda: MR.merge_sorted_runs_cuda(runs)  # noqa: E731
    phase_a = {"phase_a_runs": [int(c.shape[0]) for _w, c in runs],
               "key_words": nw, "device_ms_3_repeats": device_ms(k4),
               "call_ms": cuda_ms(k4),
               "plain_ms": cuda_ms(lambda: MR.merge_sorted_runs_torch(runs)),
               "bound_ms": entries * 2 * 8 * (nw + 1) / HBM_BYTES_PER_S
               * 1e3, "bound_by": "bytes", "max_abs_err": err}
    phase_a["ms"] = median(phase_a["device_ms_3_repeats"])
    del runs
    synth = {}
    lens = [entries // 2 + entries % 2, entries // 2]
    for w in (3, 4, 5):
        sruns = sorted_runs(rng, lens, w, True, 1 << 62, dev)
        f = lambda: MR.merge_sorted_runs_cuda(sruns)  # noqa: E731
        synth[w] = {"device_ms_3_repeats": device_ms(f),
                    "bound_ms": entries * 2 * 8 * (w + 1) / HBM_BYTES_PER_S
                    * 1e3}
        del sruns
    torch.cuda.empty_cache()
    emit({"phase": "k4_wide", "cases": cases, "repeats": REPEATS,
          "max_abs_err": err, "k63_phase_a": phase_a,
          "synthetic_runs": {"entries": entries, "by_key_words": synth},
          "gpu": smi})
    return phase_a


PER_STAGE = (  # phase 16: (k, mode) on the phase-4 bank, host reference
    (31, "kmer:count:bin", "host_k31"), (21, "kmer:count:bin", "host_k21"),
    (63, "kmer:count:bin", "host_w63_kmerco"),
    (96, "kmer:count:bin", "host_w96_kmerco"),
    (31, "hash:bf:bin", "host_hash_bf_bin"),
    (31, "hash:bft:bin", "host_hash_bft_bin"))


def cli_procs(argvs, cwd) -> float:
    """Run ``python -m kmtricks_tpu_torch <argv>`` for each argv at once
    (each its own process on the card); raise if one fails; return the
    wall seconds."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmtricks_tpu_torch"] + argv, cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for argv in argvs]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for argv, p, out in zip(argvs, procs, outs):
        if p.returncode:
            raise AssertionError(f"{argv[0]} exited {p.returncode}:\n"
                                 f"{out[-2000:]}")
    return time.perf_counter() - t0


class Timed:
    """Wrap ``owner.name`` so each call appends its seconds to
    ``walls[name]``; restored on exit."""

    def __init__(self, walls, owner, name):
        self.walls, self.owner, self.name = walls, owner, name

    def __enter__(self):
        fn = self.orig = getattr(self.owner, self.name)
        calls = self.walls.setdefault(self.name, [])

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            calls.append(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def per_stage_phase(fof_small, fof_big, fof_e2e, eng_rd, S, MR, SE,
                    smi) -> dict:
    """Phase 16: the per-stage device path (``--backend device``, what
    ``auto`` takes off the fused step). On the phase-4 bank against the
    host stages the earlier phases wrote: k = 31, 21, 63 (device merge,
    two slots) and 96 (host merge), ``hash:bf:bin`` and ``hash:bft:bin``
    (bit transpose on the card); the module
    commands as processes of their own (``repart``, ``count --id`` per
    sample, ``merge``, ``aggregate``; ``--until count
    --restrict-to-list`` then ``merge --partition-id``); ``--minimizer-type
    1`` (counts on the host, merges on the card). On the 8x bank at full
    width with ``-t 1`` and ``-t 4``: the count and merge stage walls, peak
    device bytes and K1/K2 launches, matrices against phase 5's host
    stages; then K1/K2 on one sample's segment stage of that path against
    their plain versions (:func:`per_stage_kernels`). On the 30x bank, the
    ``hash:bft:bin`` engine run's tail split (bf rows, host transpose,
    device transpose, filters). Returns each run's launches and the
    kernels' numbers on the per-stage inputs."""
    import multiprocessing

    from kmtricks_tpu_torch.core import bitmatrix
    from kmtricks_tpu_torch.core.hashers import HashWindow
    from kmtricks_tpu_torch.host import ops as hops
    from kmtricks_tpu_torch.runtime import modules
    from kmtricks_tpu_torch.runtime import pipeline as P

    counters = (S.LAUNCHES, MR.LAUNCHES)
    ids = [line.split(":")[0].strip()
           for line in open(fof_small).read().splitlines()]
    nsamp = len(ids)
    dev_opts = ["--backend", "device"]
    launches, res = {}, {"phase": "per_stage", "gpu": smi}
    with ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        # the --minimizer-type 1 host reference runs beside the card's work
        mt1_host = ex.submit(timed_host_run, dict(
            fof=fof_small, run_dir=os.path.join(WORK, "host_mt1"), k=31,
            minim_type=1))

        parity = {}
        for k, mode, ref in PER_STAGE:
            tag = f"{mode} k={k}"
            rd = os.path.join(WORK, f"stage_{k}_{mode[:4]}{mode[5:8]}")
            r = timed_run(counters, SE, fof_small, rd, None,
                          dev_opts + mode_args(mode, BLOOM_SMALL), k)
            got = r["launches"]
            if r["engine"] or got["bwd"] != nsamp or got["fwd"] != nsamp \
                    or got["K4"] or got["K3"]:
                raise AssertionError(f"{tag}: {got} {r['engine']}")
            files, nbytes = compare_run_dirs(os.path.join(WORK, ref), rd,
                                             mode_subs(mode))
            parity[tag] = {"wall_s": r["wall_s"], "files_identical": files,
                           "bytes": nbytes,
                           "peak_device_bytes": r["peak_device_bytes"]}
            launches[f"per-stage {tag}"] = got
        res["parity_vs_host"] = parity

        # the module commands, each a process of its own on the card, in
        # waves of independent commands: repart beside --until count
        # --restrict-to-list 1,3; every sample's count beside the merges
        # of partitions 1 and 3; the merge; the aggregate
        mods = os.path.join(WORK, "modules")
        rl = os.path.join(WORK, "restrict")
        flow = {"repart+until_count_restrict": cli_procs([
            ["repart", "--file", fof_small, "--run-dir", mods,
             "--kmer-size", "31", "--hard-min", "2"],
            ["pipeline", "--file", fof_small, "--run-dir", rl,
             "--kmer-size", "31", "--until", "count", "--restrict-to-list",
             "1,3"] + OPTS], WORK)}
        flow["count+merge_partition_ids"] = cli_procs([
            ["count", "--run-dir", mods, "--id", sid, "--hard-min", "2"]
            for sid in ids] + [
            ["merge", "--run-dir", rl, "--partition-id", p] + OPTS[2:]
            for p in ("1", "3")], WORK)
        flow["merge"] = cli_procs([["merge", "--run-dir", mods] + OPTS[2:]],
                                  WORK)
        # (a binary matrix: the text form takes ~10 s a run at this size)
        agg = [os.path.join(WORK, f"agg_{side}.count") for side in ("mod",
                                                                    "host")]
        flow["aggregate"] = cli_procs([[
            "aggregate", "--run-dir", mods, "--matrix", "kmer", "--sorted",
            "--format", "bin", "--output", agg[0]]], WORK)
        modules.module_aggregate(os.path.join(WORK, "host_k31"),
                                 matrix="kmer", sorted_out=True, fmt="bin",
                                 output=agg[1])
        if open(agg[0], "rb").read() != open(agg[1], "rb").read():
            raise AssertionError("aggregate of the module flow differs")
        flow["files_identical"] = compare_run_dirs(
            os.path.join(WORK, "host_k31"), mods)[0]
        for p in range(4):
            for sub, name in (("matrices", f"matrix_{p}.count"),
                              ("merge_infos", f"partition{p}.merge_info")):
                got = os.path.join(rl, sub, name)
                if os.path.exists(got) != (p in (1, 3)) or (
                        p in (1, 3) and open(got, "rb").read() != open(
                            os.path.join(WORK, "host_k31", sub, name),
                            "rb").read()):
                    raise AssertionError(f"restricted run: {sub}/{name}")
        res["module_processes_s"] = flow

        # --minimizer-type 1: the count on the host, the merge on the card
        rd = os.path.join(WORK, "stage_mt1")
        r = timed_run(counters, SE, fof_small, rd, None,
                      ["--minimizer-type", "1"])
        launches["minimizer-type 1"] = r["launches"]
        res["minimizer_type_1"] = {
            "wall_s": r["wall_s"], "host_s": mt1_host.result(),
            "launches": r["launches"],
            "files_identical": compare_run_dirs(
                os.path.join(WORK, "host_mt1"), rd)[0]}

    # full width: the 8x bank per stage, -t 1 and -t 4
    full = {}
    for threads in (1, 4):
        walls = {}
        rd = os.path.join(WORK, f"stage_full_t{threads}")
        with Timed(walls, P, "_pmap"):
            r = timed_run(counters, SE, fof_big, rd, None,
                          dev_opts + ["-t", str(threads)])
        stage_s = walls["_pmap"]           # the count stage, then the merge
        got = r["launches"]
        if got["bwd"] != 10 or got["fwd"] != 10 or got["K4"]:
            raise AssertionError(f"full width -t {threads}: {got}")
        full[f"-t {threads}"] = {
            "wall_s": r["wall_s"], "count_stage_s": stage_s[0],
            "merge_stage_s": stage_s[1],
            "peak_device_bytes": r["peak_device_bytes"], "launches": got,
            "files_identical": compare_run_dirs(
                os.path.join(WORK, "host_full"), rd)[0]}
        launches[f"per-stage kmer:count:bin 8x -t {threads}"] = got
        shutil.rmtree(rd)
    res["full_width_8x"] = full
    res["kernels_per_stage"] = per_stage_k = per_stage_kernels(
        fof_big, dev_opts, S)

    # the e2e hash:bft:bin engine tail: the device transpose the run takes,
    # and in a second run the host backend's numpy transpose in its place
    nparts = len(os.listdir(os.path.join(eng_rd, "merge_infos")))
    tails, rds = {}, []
    bft_transpose = P._bft_transpose
    for side in ("host", "device"):
        walls = {}
        rds.append(os.path.join(WORK, f"bft_tail_{side}"))
        if side == "host":
            P._bft_transpose = lambda rows, device: bitmatrix.transpose_bits(
                rows)
        try:
            with Timed(walls, hops, "bf_rows_from_merge"), \
                    Timed(walls, P, "_bft_transpose"), \
                    Timed(walls, P, "transpose_bits_device"), \
                    Timed(walls, P, "stage_format"):
                r = timed_run(counters, SE, fof_e2e, rds[-1], eng_rd,
                              mode_args("hash:bft:bin", BLOOM_FULL)
                              + ["--nb-partitions", str(nparts)])
        finally:
            P._bft_transpose = bft_transpose
        if bool(walls["transpose_bits_device"]) != (side == "device"):
            raise AssertionError(f"bft tail, {side} side: "
                                 f"{len(walls['transpose_bits_device'])} "
                                 "device transposes")
        # per-partition calls summed (the tail runs them on one thread)
        tails[side] = {"wall_s": r["wall_s"],
                       "engine_walls_s": r["engine"]["walls_s"],
                       "tail_split_s": {
                           "bf_rows": sum(walls["bf_rows_from_merge"]),
                           f"transpose_{side}": sum(walls["_bft_transpose"]),
                           "filters": sum(walls["stage_format"])}}
    tails["device_vs_host_files_bytes"] = compare_run_dirs(
        rds[0], rds[1], mode_subs("hash:bft:bin"))
    # one window's transpose on the card: device time and bytes bound
    window = HashWindow.load(os.path.join(rds[0], "hash.info"))
    rows = np.random.default_rng(16).integers(
        0, 256, (window.window_size_bits, (nsamp + 7) // 8), dtype=np.uint8)
    rows_d = torch.from_numpy(rows).to("cuda")
    t_ms = device_ms(lambda: bitmatrix.transpose_bits_device(rows_d))
    out = bitmatrix.transpose_bits_device(rows_d).cpu().numpy()
    if not np.array_equal(out, bitmatrix.transpose_bits(rows)):
        raise AssertionError("device transpose differs from the host's")
    tails["window_transpose"] = {
        "rows": int(rows.shape[0]), "bytes_per_row": int(rows.shape[1]),
        "device_ms_3_repeats": t_ms,
        "bound_ms": 2 * rows.nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    res["bft_tail_e2e"] = tails
    emit(res)
    return launches, per_stage_k


@contextlib.contextmanager
def kept_segment_stage(S):
    """While open, the largest K1 launch's inputs and parameters (cloned)
    and K2's parameters are kept as the path gives them (``seen``)."""
    seen = {}
    bwd, fwd = S.segscan_bwd_cuda, S.segscan_fwd_cuda

    def bwd_kept(*a, **kw):
        if a[0].numel() > seen.get("n", -1):
            seen.update(n=a[0].numel(), bwd=([t.clone() for t in a], kw))
        return bwd(*a, **kw)

    def fwd_kept(*a, **kw):
        seen.setdefault("fwd", kw)
        return fwd(*a, **kw)

    S.segscan_bwd_cuda, S.segscan_fwd_cuda = bwd_kept, fwd_kept
    try:
        yield seen
    finally:
        S.segscan_bwd_cuda, S.segscan_fwd_cuda = bwd, fwd


def segment_kernel_report(seen, S) -> dict:
    """K1 and K2 on kept segment-stage inputs (:func:`kept_segment_stage`):
    bit-equal against the plain versions (``REPEATS`` launches each),
    device and plain times, and the bytes bounds."""
    seg_in, kw = seen["bwd"]
    cmax = kw["count_max"]
    rmin, save_if = seen["fwd"]["rmin"], seen["fwd"]["save_if"]
    errs = check_kernels(seg_in, rmin, save_if, cmax, S)
    cnt, present, solid, suffix = S.segscan_bwd_torch(*seg_in,
                                                      count_max=cmax)
    fwd_args = (present, solid, suffix, seg_in[1], seg_in[2], cnt)
    k1 = lambda: S.segscan_bwd_cuda(*seg_in, count_max=cmax)  # noqa: E731
    k2 = lambda: S.segscan_fwd_cuda(  # noqa: E731
        *fwd_args, rmin=rmin, save_if=save_if)
    dev_ms = {"K1": device_ms(k1), "K2": device_ms(k2)}
    n = seg_in[0].numel()
    out = {
        "n": n, "valid": int(seg_in[2].sum()), "rmin": rmin,
        "save_if": save_if, "count_max": cmax, "repeats": REPEATS,
        "max_abs_err": {"K1": errs[0], "K2": errs[1]},
        "device_ms_3_repeats": dev_ms,
        "ms": {key: median(v) for key, v in dev_ms.items()},
        "call_ms": {"K1": cuda_ms(k1), "K2": cuda_ms(k2)},
        "plain_ms": {
            "K1": cuda_ms(lambda: S.segscan_bwd_torch(*seg_in,
                                                      count_max=cmax)),
            "K2": cuda_ms(lambda: S.segscan_fwd_torch(
                *fwd_args, rmin=rmin, save_if=save_if))},
        # each input read once, each output written once (B/element), as
        # phase 3
        "bound_ms": {"K1": n * (3 + 8 + 10) / HBM_BYTES_PER_S * 1e3,
                     "K2": n * (4 + 8 + 10) / HBM_BYTES_PER_S * 1e3}}
    seen.clear()
    del seg_in, fwd_args, cnt, present, solid, suffix
    torch.cuda.empty_cache()
    return out


def per_stage_kernels(fof_big, dev_opts, S) -> dict:
    """K1 and K2 on the per-stage path's own inputs: the largest sample's
    segment stage of one more ``-t 1`` run on the 8x bank (one sample,
    about 7.8M windows), its inputs and parameters kept as the path gave
    them (:func:`segment_kernel_report`)."""
    rd = os.path.join(WORK, "stage_full_kept")
    with kept_segment_stage(S) as seen:
        port_run(fof_big, rd, 31, None, dev_opts + ["-t", "1"])
    shutil.rmtree(rd)
    return segment_kernel_report(seen, S)


# ---------------------------------------------------------------------------
# Phases 17 (the chunked path) and 18 (the mesh)
# ---------------------------------------------------------------------------

CHUNKED_MEM = 1000   # MB: 20.8M windows a chunk, four on the 8x bank
E2E_MEM = 8192       # MB: phase 8's --max-memory (two chunks of the 30x)
# phase 17's item-G layouts (62- and 61-bit window hashes with ten
# samples): (tag, mode, --bloom-size, --nb-partitions)
ITEM_G = (("hash_count_2e62_4", "hash:count:bin", 2**62, 4),
          ("hash_pa_2e61_8", "hash:pa:bin", 2**61, 8))
# phase 18's configurations on the 8x bank: (tag, k, mode, --bloom-size,
# the host stages' run dir)
MESH_RUNS = (("k31", 31, "kmer:count:bin", None, "host_full"),
             ("k21", 21, "kmer:count:bin", None, "host_k21_full"),
             ("k63", 63, "kmer:count:bin", None, "host_k63_full"),
             ("hash_bf", 31, "hash:bf:bin", BLOOM_FULL, "host_full_hash_bf"))


def counted_run(counters, fn) -> dict:
    """``fn()`` with every launch counter set to 0 just before it: its
    wall, peak device bytes and launches."""
    reset(*counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {}
    for c in counters:
        launches.update(c)
    return {"wall_s": wall, "peak_device_bytes":
            torch.cuda.max_memory_allocated(), "launches": launches}


def e2e_opts(fof_e2e, run_dir, eng_rd, **kw):
    """Phase 8's options on the 30x bank (the default --max-memory), with
    its repartition; ``kw`` overrides them."""
    from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions

    nparts = len(os.listdir(os.path.join(eng_rd, "merge_infos")))
    return PipelineOptions(**{**dict(
        fof=fof_e2e, run_dir=run_dir, kmer_size=31, hard_min=2,
        soft_min="2", share_min=2, recurrence_min=1, repart_from=eng_rd,
        nb_partitions=nparts, max_memory_mb=E2E_MEM), **kw})


def chunked_phase(fof_big, fof_e2e, eng_rd, host_g, S, MR, smi):
    """Phase 17: the host-aggregated chunked path. Item G's writable
    layouts on the 8x bank through the command line at ``CHUNKED_MEM``
    (which streams them in chunks), routed to ``stage_mesh_chunked`` and
    byte-identical to the host stages, repartition included;
    ``stage_mesh_chunked`` called directly, streaming, on the 30x bank at
    k = 31 against phase 8's engine run directory, and with --hist and
    ``--soft-min 0.5`` against an engine run with the same options,
    histograms included; K1/K2 on the largest chunk's segment stage
    against their plain versions. Returns ({run: launches}, the K1/K2
    report)."""
    from kmtricks_tpu_torch.runtime import device_pipeline as DP
    from kmtricks_tpu_torch.runtime import pipeline as P

    dev = torch.device("cuda")
    counters = (S.LAUNCHES, MR.LAUNCHES)
    routed = []
    real = P.stage_mesh_chunked

    def recorded(*a, **kw):
        routed.append(kw.get("use_stream", False))
        return real(*a, **kw)

    runs = {}
    P.stage_mesh_chunked = recorded
    try:
        for tag, mode, bloom, nparts in ITEM_G:
            rd = os.path.join(WORK, f"chunked_{tag}")
            runs[tag] = counted_run(counters, lambda: port_run(
                fof_big, rd, 31, extra=mode_args(mode, bloom) + [
                    "--nb-partitions", str(nparts), "--max-memory",
                    str(CHUNKED_MEM)]))
            runs[tag]["host_stages_s"] = host_g[tag].result()
            runs[tag]["files_bytes"] = compare_run_dirs(
                os.path.join(WORK, f"host_{tag}"), rd)
            shutil.rmtree(rd)
    finally:
        P.stage_mesh_chunked = real
    if routed != [True] * len(ITEM_G):
        raise AssertionError(f"item G runs took the chunked path "
                             f"{routed}")

    def direct(rd, amin_resolved, **kw):
        """stage_mesh_chunked itself, streaming, on the 30x bank."""
        opts = e2e_opts(fof_e2e, rd, eng_rd, **kw)
        kmdir, config = P.stage_config(opts)
        rep = P.stage_repart(kmdir, config, opts, dev)
        amin = (P.resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
                if amin_resolved else None)
        DP.stage_mesh_chunked(
            kmdir, config, opts, rep, amin, mesh=(dev,),
            chunk_windows=int(opts.max_memory_mb * 1e6
                              / P.BYTES_PER_WINDOW), use_stream=True)

    rd = os.path.join(WORK, "chunked_e2e")
    with kept_segment_stage(S) as seen:
        runs["e2e_direct"] = counted_run(counters,
                                         lambda: direct(rd, True))
    runs["e2e_direct"]["files_bytes"] = compare_run_dirs(eng_rd, rd)
    shutil.rmtree(rd)
    seg = segment_kernel_report(seen, S)
    # --hist and a float soft-min: the engine's run, then the chunked one
    hist = dict(hist=True, soft_min="0.5")
    eng_h = os.path.join(WORK, "engine_e2e_hist")
    t0 = time.perf_counter()
    P.run_pipeline(e2e_opts(fof_e2e, eng_h, eng_rd, **hist), device="cuda")
    eng_h_s = time.perf_counter() - t0
    rd = os.path.join(WORK, "chunked_e2e_hist")
    runs["e2e_direct_hist"] = counted_run(
        counters, lambda: direct(rd, False, **hist))
    runs["e2e_direct_hist"]["files_bytes"] = compare_run_dirs(
        eng_h, rd, RUN_SUBS + ("histograms",))
    runs["e2e_direct_hist"]["engine_wall_s"] = eng_h_s
    shutil.rmtree(rd)
    shutil.rmtree(eng_h)
    for tag, r in runs.items():
        if not (r["launches"]["bwd"] > 0 and r["launches"]["fwd"] > 0):
            raise AssertionError(f"chunked run {tag} skipped K1/K2: {r}")
    emit({"phase": "chunked", "chunk_mem_mb": CHUNKED_MEM, "runs": runs,
          "segment_kernels_largest_chunk": seg, "gpu": smi})
    return {tag: r["launches"] for tag, r in runs.items()}, seg


@contextlib.contextmanager
def kept_receiver_runs(CM):
    """While open, the largest receiver's routed runs (cloned) of each
    word count are kept as the mesh's receivers get them (``seen``: {key
    words: [runs]})."""
    seen = {}
    real = CM.merge_routed

    def kept(runs):
        n = sum(int(r[0].numel()) for r in runs)
        nw = len(runs[0])
        if len(runs) > 1 and n > sum(int(r[0].numel())
                                     for r in seen.get(nw, [])):
            seen[nw] = [tuple(w.clone() for w in r) for r in runs]
        return real(runs)

    CM.merge_routed = kept
    try:
        yield seen
    finally:
        CM.merge_routed = real


def receiver_merge_report(runs, MR) -> dict:
    """K3 (one word) or K4 (more, no payload) on one receiver's routed
    runs against the plain version, ``REPEATS`` launches; device, plain
    and (one word) ``torch.sort`` times; the one-pass bytes bound."""
    runs = [(tuple(r), None) for r in runs]
    nw = len(runs[0][0])
    err = merge_err(runs, MR, REPEATS)
    fn = lambda: MR.merge_sorted_runs_cuda(runs)  # noqa: E731
    # two launches per pairwise merge, len(runs) - 1 merges a call
    dev_ms = device_ms(fn, max_calls=max(3, 300 // (2 * len(runs) - 2)))
    n = sum(int(w[0].numel()) for w, _p in runs)
    out = {"kernel": "K3" if nw == 1 else "K4", "key_words": nw,
           "runs": [int(w[0].numel()) for w, _p in runs], "entries": n,
           "repeats": REPEATS, "max_abs_err": err,
           "device_ms_3_repeats": dev_ms, "ms": median(dev_ms),
           "call_ms": cuda_ms(fn),
           "plain_ms": cuda_ms(lambda: MR.merge_sorted_runs_torch(runs)),
           # each word read once and written once (a one-pass merge; the
           # tree of pairwise merges moves them log2(runs) times)
           "bound_ms": n * 2 * 8 * nw / HBM_BYTES_PER_S * 1e3,
           "library_ms": None}
    if nw == 1:
        cat = torch.cat([w[0] for w, _p in runs])
        out["library_ms"] = median(device_ms(
            lambda: torch.sort(cat, stable=True), max_calls=30))
    return out


def mesh_phase(fof_big, fof_e2e, eng_rd, S, MR, smi):
    """Phase 18: the mesh. The 8x bank in one step over four shards on
    one card (and, with more than one card, one shard per card) at k =
    31 (k3: K4 receivers), 21 (k2: K3), 63 (kw, three words: K4) and
    ``hash:bf:bin --bloom-size 10000000`` (h1: K3), against the host
    stages and the one-shard run; the 30x bank through the engine over
    four shards against phase 8's run; K3 and K4 on the largest
    receiver's own routed runs against their plain versions. Returns
    ({run: launches}, {kernel: receiver report})."""
    from kmtricks_tpu_torch.ops import count_merge as CM
    from kmtricks_tpu_torch.runtime import pipeline as P
    from kmtricks_tpu_torch.runtime import stream_engine as SE

    counters = (S.LAUNCHES, MR.LAUNCHES)
    ncards = torch.cuda.device_count()
    meshes = {"1": ["cuda:0"], "4_on_cuda0": ["cuda:0"] * 4}
    if ncards > 1:
        meshes[f"{ncards}_cards"] = [f"cuda:{i}" for i in range(ncards)]
    runs = {}
    with kept_receiver_runs(CM) as kept:
        for tag, k, mode, bloom, host in MESH_RUNS:
            host_rd = os.path.join(WORK, host)
            nparts = len(os.listdir(os.path.join(host_rd, "merge_infos")))
            for mname, devices in meshes.items():
                rd = os.path.join(WORK, f"mesh_{tag}_{mname}")
                opts = P.PipelineOptions(
                    fof=fof_big, run_dir=rd, kmer_size=k, hard_min=2,
                    soft_min="2", share_min=2, recurrence_min=1, mode=mode,
                    bloom_size=bloom or 10_000_000, repart_from=host_rd,
                    nb_partitions=nparts)
                r = runs[f"{tag} {mname}"] = counted_run(
                    counters, lambda: P.run_pipeline(
                        opts, device="cuda", devices=devices))
                r.update(shards=len(devices), cards=len(set(devices)),
                         files_bytes=compare_run_dirs(host_rd, rd,
                                                      mode_subs(mode)))
                if mname != "1":
                    r["vs_one_shard_files_bytes"] = compare_run_dirs(
                        os.path.join(WORK, f"mesh_{tag}_1"), rd,
                        mode_subs(mode))
            for mname in meshes:
                shutil.rmtree(os.path.join(WORK, f"mesh_{tag}_{mname}"))
        for mname, devices in meshes.items():
            if mname == "1":
                continue
            rd = os.path.join(WORK, f"mesh_engine_{mname}")
            SE.last_run.clear()
            r = runs[f"engine_e2e {mname}"] = counted_run(
                counters, lambda: P.run_pipeline(
                    e2e_opts(fof_e2e, rd, eng_rd), device="cuda",
                    devices=devices))
            if SE.last_run.get("shards") != len(devices):
                raise AssertionError(f"the 30x bank over {mname} did not "
                                     f"take the engine: {SE.last_run}")
            r.update(shards=len(devices), cards=len(set(devices)),
                     engine=dict(SE.last_run),
                     files_bytes=compare_run_dirs(eng_rd, rd))
            shutil.rmtree(rd)
    for tag, r in runs.items():
        merges = sum(r["launches"][key] for key in ("K3", "K4"))
        if r["shards"] > 1 and not merges:
            raise AssertionError(f"mesh run {tag} merged no routed runs")
    receivers = {f"{nw}_words": receiver_merge_report(r, MR)
                 for nw, r in sorted(kept.items())}
    del kept
    torch.cuda.empty_cache()
    emit({"phase": "mesh", "device_count": ncards,
          "meshes": {m: {"shards": len(d), "cards": len(set(d))}
                     for m, d in meshes.items()},
          "runs": runs, "receiver_merges": receivers, "gpu": smi})
    return ({tag: r["launches"] for tag, r in runs.items()}, receivers)

# phase 19: two ranks of two shards each on one card (gloo), or one rank
# per card (nccl, where there are two); a rank that outlasts this fails
MP_WORLD = 2
MP_SHARDS = 2
MP_TIMEOUT_S = 420


def mp_jobs(fof_small, fof_e2e, eng_rd, table_cap):
    """Phase 19's engine runs: (tag, PipelineOptions fields, chunk
    windows, per-shard table budget or None). The 30x bank at phase 8's
    options and repartition; on the phase-4 bank (its repartition from
    phase 4's host run, about ten chunks) ``kmer:pa:bin``, ``--hist
    --soft-min 0.5``, ``hash:count:bin`` and a table budget that forces
    folds."""
    small = dict(fof=fof_small, kmer_size=31, hard_min=2, soft_min="2",
                 share_min=2, recurrence_min=1,
                 repart_from=os.path.join(WORK, "host_k31"),
                 bloom_size=BLOOM_SMALL, max_memory_mb=SMALL_MEM)
    nparts = len(os.listdir(os.path.join(eng_rd, "merge_infos")))
    e2e = dict(fof=fof_e2e, kmer_size=31, hard_min=2, soft_min="2",
               share_min=2, recurrence_min=1, repart_from=eng_rd,
               nb_partitions=nparts, max_memory_mb=E2E_MEM)
    jobs = [("e2e_30x", e2e, None),
            ("pa", dict(small, mode="kmer:pa:bin"), None),
            ("hist_soft_min_0.5", dict(small, hist=True, soft_min="0.5"),
             None),
            ("hash_count", dict(small, mode="hash:count:bin"), None),
            ("forced_folds", small, table_cap)]
    return [(tag, o, int(o["max_memory_mb"] * 1e6 / 48), cap)
            for tag, o, cap in jobs]


def engine_direct(P, SE, opts, mesh, chunk_windows, table_cap,
                  loaded=None):
    """The streaming engine itself on ``mesh``, streaming from the banks:
    config + repartition first, or ``loaded``'s (kmdir, config,
    repartition)."""
    from kmtricks_tpu_torch.runtime.device_pipeline import _is_float_quantile

    if loaded is None:
        kmdir, config = P.stage_config(opts)
        loaded = kmdir, config, P.stage_repart(kmdir, config, opts, mesh[0])
    kmdir, config, rep = loaded
    amin = (None if _is_float_quantile(opts.soft_min)
            else P.resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof)))
    SE.stage_mesh_stream(kmdir, config, opts, rep, amin, mesh=mesh,
                         chunk_windows=chunk_windows, table_cap=table_cap,
                         use_stream=True)


def mp_rank(rank, world, port, backend, jobs, out_dir):
    """One rank of phase 19 (``torch.multiprocessing.spawn``'s entry):
    a mesh of ``MP_SHARDS`` shards (on ``cuda:0``, or on the rank's card
    under nccl) in a global mesh over ``world`` ranks; for each job rank
    0 runs config + repartition, the others load them after a barrier,
    then every rank runs the engine with its launch counters and peak
    reset just before. Writes its report to ``out_dir/rank<rank>.json``."""
    sys.path.insert(0, ROOT)
    from kmtricks_tpu_torch.core.repartition import Repartition
    from kmtricks_tpu_torch.ops import merge_runs as MR
    from kmtricks_tpu_torch.ops import segscan as S
    from kmtricks_tpu_torch.parallel import multihost as mh
    from kmtricks_tpu_torch.runtime import pipeline as P
    from kmtricks_tpu_torch.runtime import stream_engine as SE
    from kmtricks_tpu_torch.runtime.config import Config
    from kmtricks_tpu_torch.runtime.kmdir import KmDir

    mh.initialize(f"tcp://localhost:{port}", world, rank, backend,
                  timeout_s=MP_TIMEOUT_S)
    card = rank if backend == "nccl" else 0
    mesh = mh.global_mesh([f"cuda:{card}"] * MP_SHARDS)
    report = {}
    for tag, fields, chunk_windows, table_cap in jobs:
        opts = P.PipelineOptions(**fields)
        if rank == 0:
            kmdir, config = P.stage_config(opts)
            rep = P.stage_repart(kmdir, config, opts, mesh[0])
        mh.barrier(mesh)
        if rank != 0:
            kmdir = KmDir.init(opts.run_dir)
            config = Config.load(kmdir.config_storage)
            rep = Repartition.load(kmdir.repart_path)
        r = counted_run((S.LAUNCHES, MR.LAUNCHES), lambda: engine_direct(
            P, SE, opts, mesh, chunk_windows, table_cap,
            (kmdir, config, rep)))
        report[tag] = dict(r, engine=dict(SE.last_run))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def spawn_ranks(backend, jobs, out_dir) -> list:
    """Phase 19's ranks as processes of their own (spawned: CUDA needs
    it), each joined within ``MP_TIMEOUT_S``; a rank that fails or hangs
    fails the phase. Returns each rank's report."""
    import socket

    import torch.multiprocessing as tmp

    os.makedirs(out_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = tmp.spawn(mp_rank, args=(MP_WORLD, port, backend, jobs, out_dir),
                    nprocs=MP_WORLD, join=False)
    deadline = time.monotonic() + MP_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise AssertionError(f"phase 19 ranks outlasted "
                                     f"{MP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    reports = []
    for r in range(MP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def multiprocess_phase(fof_small, fof_e2e, eng_rd, S, MR, smi):
    """Phase 19: the streaming engine over two processes (``torch.
    distributed``, gloo), each rank a mesh of two shards on the one card:
    every job of :func:`mp_jobs` against the same engine run on one
    process over four shards (the 30x bank also against phase 8's run),
    byte for byte. Prints each rank's walls and their split, the bytes
    and wall of the exchanges between the ranks, peaks, decode shares and
    launches. With two cards or more it also runs the forced-fold job over
    nccl, one rank per card; otherwise it says that it did not. Returns
    {run: launches summed over the ranks}."""
    from kmtricks_tpu_torch.runtime import pipeline as P
    from kmtricks_tpu_torch.runtime import stream_engine as SE

    counters = (S.LAUNCHES, MR.LAUNCHES)
    one = P.make_mesh(["cuda:0"] * (MP_WORLD * MP_SHARDS))
    mp_dir = os.path.join(WORK, "mp")
    os.makedirs(mp_dir)
    # the one-process runs first: the forced-fold budget comes from the
    # count run's largest shard table (the same shards on both)
    refs, fold_cap = {}, None
    for tag, fields, chunk_windows, _cap in mp_jobs(
            fof_small, fof_e2e, eng_rd, None):
        opts = P.PipelineOptions(**dict(
            fields, run_dir=os.path.join(mp_dir, f"one_{tag}")))
        refs[tag] = counted_run(counters, lambda: engine_direct(
            P, SE, opts, one, chunk_windows,
            fold_cap if tag == "forced_folds" else None))
        refs[tag]["engine"] = dict(SE.last_run)
        if tag == "pa":
            # k = 31 count tables: a budget just over the largest shard's
            fold_cap = int(max(SE.last_run["shard_table_entries"]) * 1.05)
    if refs["forced_folds"]["engine"]["folds"] < 2:
        raise AssertionError(f"expected two or more folds: "
                             f"{refs['forced_folds']['engine']}")
    jobs = [(tag, dict(fields, run_dir=os.path.join(mp_dir, f"mp_{tag}")),
             cw, cap) for tag, fields, cw, cap in mp_jobs(
                 fof_small, fof_e2e, eng_rd, fold_cap)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = spawn_ranks("gloo", jobs, os.path.join(mp_dir, "gloo"))
    spawn_s = time.perf_counter() - t0
    runs, launches = {}, {}
    for tag, fields, _cw, _cap in jobs:
        subs = mode_subs(fields.get("mode", "kmer:count:bin")) + (
            ("histograms",) if fields.get("hist") else ())
        one_rd = os.path.join(mp_dir, f"one_{tag}")
        run = {"files_bytes": compare_run_dirs(one_rd, fields["run_dir"],
                                               subs),
               "one_process": {key: refs[tag][key] for key in (
                   "wall_s", "peak_device_bytes", "launches")},
               "one_process_walls_s": refs[tag]["engine"]["walls_s"],
               "ranks": []}
        if tag == "e2e_30x":
            run["vs_phase8_files_bytes"] = compare_run_dirs(
                eng_rd, fields["run_dir"])
        if fields.get("hist"):
            with open(os.path.join(one_rd, "merge_amin.txt")) as a, \
                    open(os.path.join(fields["run_dir"],
                                      "merge_amin.txt")) as b:
                if a.read() != b.read():
                    raise AssertionError(f"{tag}: thresholds differ")
        for r, rep in enumerate(reports):
            e = rep[tag]["engine"]
            if (e["rank"], e["world"], e["shards"]) != (r, MP_WORLD,
                                                        MP_SHARDS):
                raise AssertionError(f"{tag} rank {r}: {e}")
            run["ranks"].append({
                "wall_s": rep[tag]["wall_s"], "walls_s": e["walls_s"],
                "exchange": e["exchange"], "local_rows": e["local_rows"],
                "chunks": e["chunks"], "folds": e["folds"],
                "tail": e["tail"],
                "peak_device_bytes": rep[tag]["peak_device_bytes"],
                "launches": rep[tag]["launches"]})
        rows = [x["local_rows"] for x in run["ranks"]]
        if min(rows) <= 0:
            raise AssertionError(f"{tag}: a rank decoded nothing: {rows}")
        if not all(x["exchange"]["bytes_sent"] > 0 for x in run["ranks"]):
            raise AssertionError(f"{tag}: no run crossed between ranks")
        if tag == "forced_folds" and min(
                x["folds"] for x in run["ranks"]) < 1:
            raise AssertionError(f"{tag}: a rank never folded")
        launches[tag] = {key: sum(x["launches"][key] for x in run["ranks"])
                         for key in run["ranks"][0]["launches"]}
        if not launches[tag]["K3"] + launches[tag]["K4"]:
            raise AssertionError(f"{tag}: no receiver merged its runs")
        runs[tag] = run
        shutil.rmtree(fields["run_dir"])
        if tag != "forced_folds":
            shutil.rmtree(one_rd)
    emit({"phase": "multiprocess", "backend": "gloo", "world": MP_WORLD,
          "shards_per_rank": MP_SHARDS, "cards": 1,
          "ranks_wall_s": spawn_s, "runs": runs, "gpu": smi})
    ncards = torch.cuda.device_count()
    if ncards < MP_WORLD:
        emit({"phase": "multiprocess_nccl", "run": False,
              "reason": f"{ncards} card"})
    else:
        nccl_jobs = [(tag, dict(f, run_dir=os.path.join(mp_dir, "nccl")),
                      cw, cap) for tag, f, cw, cap in jobs
                     if tag == "forced_folds"]
        (rep, *_rest) = spawn_ranks("nccl", nccl_jobs,
                                    os.path.join(mp_dir, "nccl_ranks"))
        emit({"phase": "multiprocess_nccl", "run": True, "cards": ncards,
              "files_bytes": compare_run_dirs(
                  os.path.join(mp_dir, "one_forced_folds"),
                  nccl_jobs[0][1]["run_dir"]),
              "rank0": rep["forced_folds"], "gpu": smi})
    shutil.rmtree(mp_dir)
    return launches


def reset(*counters) -> None:
    for c in counters:
        for key in c:
            c[key] = 0


def step_parity(fof_small, k, host_s) -> None:
    """Phase 4 at ``k``: the port's one step on the phase-4 bank against
    the host stages' run dir ``host_k<k>`` (``host_s`` its seconds)."""
    port_rd = os.path.join(WORK, f"port_k{k}")
    t1 = time.perf_counter()
    port_run(fof_small, port_rd, k)
    t2 = time.perf_counter()
    files, nbytes = compare_run_dirs(os.path.join(WORK, f"host_k{k}"),
                                     port_rd)
    emit({"phase": "parity", "k": k, "files_identical": files,
          "bytes": nbytes, "host_s": host_s, "port_s": t2 - t1})


def engine_parity(fof_small, SE) -> None:
    """Phase 7: the phase-4 bank through the engine in about ten chunks
    at k = 31 and 21 (against phase 4's host dirs) and with ``--hist
    --soft-min 0.5`` (the dense tail's raw-count fetch, histograms and
    float quantile before the merge on the card)."""
    small_mem = ["--max-memory", str(SMALL_MEM)]
    for k, hist in ((31, False), (21, False), (31, True)):
        tag = f"k{k}{'_hist' if hist else ''}"
        # the host stages' files do not depend on --max-memory: the
        # runs without histograms reuse phase 4's
        host_rd = os.path.join(WORK, f"host_engine_{tag}" if hist
                               else f"host_k{k}")
        t0 = time.perf_counter()
        if hist:
            host_run(fof_small, host_rd, k, max_memory=SMALL_MEM,
                     hist=True, soft_min="0.5")
        t1 = time.perf_counter()
        port_rd = os.path.join(WORK, f"port_engine_{tag}")
        port_run(fof_small, port_rd, k, extra=small_mem + (
            ["--hist", "--soft-min", "0.5"] if hist else []))
        t2 = time.perf_counter()
        stats = dict(SE.last_run)
        if stats.get("chunks", 0) < 5:
            raise AssertionError(f"engine took {stats} chunks")
        files, nbytes = compare_run_dirs(
            host_rd, port_rd, RUN_SUBS + (("histograms",) if hist
                                          else ()))
        emit({"phase": "engine_parity", "k": k, "hist_soft_min_0.5": hist,
              "files_identical": files, "bytes": nbytes,
              "chunks": stats["chunks"], "runs": stats["runs"],
              "host_s": t1 - t0, "port_s": t2 - t1})


def merge_tail_phase(dev, smi, rows: int = 6_000_000) -> None:
    """Phase 20: the dense tails' merge on the card
    (``parallel/pipeline.py::merge_finalize``) against the host's plain
    numpy version (the per-sample hard-min and the count_max clamp, then
    ``host/ops.py::merge_dense`` per partition), on a random 6,000,000 x
    10 count matrix in four partitions (the size of ``count31.isolates``'s
    tail) at 1-, 2- and 4-byte count types: final counts, keep flags and
    every statistic equal. At 4 bytes: the device time of both forms
    beside the bytes bound of the counts form, their extra device memory,
    the host merge's seconds, and the copy of the final counts to the
    host, pageable and through page-locked memory (``_to_host``)."""
    from kmtricks_tpu_torch.host import ops as hops
    from kmtricks_tpu_torch.parallel.pipeline import merge_finalize
    from kmtricks_tpu_torch.runtime.device_pipeline import _to_host

    nsamp, nparts, rmin, save_if = 10, 4, 2, 2
    rng = np.random.default_rng(20)
    pre = rng.integers(1, 8, (rows, nsamp), dtype=np.uint32)
    big = rng.random((rows, nsamp)) < 0.01
    pre[big] = rng.integers(0, 2**32, int(big.sum()), dtype=np.uint64)
    pre[rng.random((rows, nsamp)) < 0.8] = 0
    hard = rng.integers(0, 4, nsamp).astype(np.uint32)
    amin = rng.integers(1, 6, nsamp).astype(np.uint64)
    bounds = np.concatenate([[0], np.sort(rng.integers(0, rows, nparts - 1)),
                             [rows]]).astype(np.int64)
    pre_d = torch.from_numpy(pre.view(np.int32)).to(dev)
    hard_d, bounds_d = (torch.from_numpy(a.astype(np.int64)).to(dev)
                        for a in (hard, bounds))
    out = {"phase": "merge_tail", "rows": rows, "samples": nsamp,
           "partitions": nparts, "rmin": rmin, "save_if": save_if,
           "host_s": {}, "gpu": smi}
    for count_max in (255, 65535, 2**32 - 1):
        amin_c = amin.copy()
        amin_c[0] = count_max + 1          # never solid in sample 0
        amin_d = torch.from_numpy(amin_c.astype(np.int64)).to(dev)
        t0 = time.perf_counter()
        pre_m = np.where(pre >= hard[None, :], np.minimum(pre, count_max),
                         0)
        exp = [hops.merge_dense(np.zeros(hi - lo, np.uint64), pre_m[lo:hi],
                                amin_c, rmin, save_if)
               for lo, hi in zip(bounds[:-1], bounds[1:])]
        out["host_s"][str(count_max)] = time.perf_counter() - t0
        del pre_m
        fin = functools.partial(merge_finalize, pre_d, amin_d, hard_d,
                                bounds_d, rmin=rmin, save_if=save_if,
                                count_max=count_max)
        counts, keep, stats = fin(bits=False)
        counts, keep = counts.cpu().numpy().view(np.uint32), \
            keep.cpu().numpy()
        stats = stats.cpu().numpy()
        for p, res in enumerate(exp):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            if not (np.array_equal(counts[lo:hi], res.counts)
                    and np.array_equal(keep[lo:hi], res.keep)
                    and all(np.array_equal(stats[i, p].astype(np.uint64),
                                           getattr(res.stats, f.name))
                            for i, f in enumerate(dataclasses.fields(
                                res.stats)))):
                raise AssertionError(f"merge_finalize differs from "
                                     f"merge_dense: count_max {count_max},"
                                     f" partition {p}")
        del exp, counts, keep, stats
    # the cells' count type: device time, memory and the copy to the host
    for bits in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fin(bits=bits)
        torch.cuda.synchronize()
        form = "bits" if bits else "counts"
        out[f"extra_device_bytes_{form}"] = (torch.cuda.max_memory_allocated()
                                             - base)
        del res
        out[f"device_ms_{form}"] = device_ms(lambda: fin(bits=bits))
    # pre read once (4 B a count), the final counts written once (4 B)
    out["bound_ms_counts"] = rows * nsamp * 8 / HBM_BYTES_PER_S * 1e3
    counts = fin(bits=False)[0]
    for name, copy in (("pageable", lambda: counts.cpu().numpy()),
                       ("pinned", lambda: _to_host(counts))):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            copy()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"copy_ms_{name}"] = times
    out["copy_bytes"] = counts.numel() * 4
    emit(out)
    del counts, pre_d
    torch.cuda.empty_cache()


def no_jax() -> None:
    """Raise if jax or the JAX package was imported."""
    jax_mods = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "kmtricks_tpu")]
    if jax_mods:
        raise AssertionError(f"jax or the JAX package was imported: "
                             f"{jax_mods[:5]}")


def tail_main() -> int:
    """``--tail``: phases 1, 4, 7 and 20 alone (what the dense tail's
    merge on the card runs through): the probe, the one step and the
    engine on the phase-4 bank against the host stages (the engine also
    with --hist --soft-min 0.5), and the merge against the host's."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this test needs a GPU")
    sys.path.insert(0, ROOT)
    from kmtricks_tpu_torch.runtime import stream_engine as SE
    from scripts.gen_synth_bank import gen_bank

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "probe", "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu": smi,
          "device": torch.cuda.get_device_name(0)})
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        fof_small = gen_bank(os.path.join(WORK, "bank_small"), nsamp=10,
                             genome=200_000, coverage=8, read_len=1024)
        host_s = host_runs({f"host_k{k}": dict(
            fof=fof_small, run_dir=os.path.join(WORK, f"host_k{k}"), k=k)
            for k in (31, 21)})
        for k in (31, 21):
            step_parity(fof_small, k, host_s[f"host_k{k}"])
        engine_parity(fof_small, SE)
        merge_tail_phase(torch.device("cuda"), smi)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    no_jax()
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this test needs a GPU")
    sys.path.insert(0, ROOT)
    from kmtricks_tpu_torch import _build
    from kmtricks_tpu_torch.ops import merge_runs as MR
    from kmtricks_tpu_torch.ops import segscan as S
    from kmtricks_tpu_torch.runtime import stream_engine as SE
    from scripts.gen_synth_bank import gen_bank

    # 1. probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "probe", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.splitlines()[-1],
          "gpu": smi, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as ex:
        ptxas = ex.submit(ptxas_report, "merge_runs")
        for f in [ex.submit(_build.segscan_lib),
                  ex.submit(_build.merge_runs_lib)]:
            f.result()
        build_s = time.perf_counter() - t0
        ptxas = ptxas.result()
    emit({"phase": "build", "seconds": build_s,
          "sources": ["csrc/segscan.cu", "csrc/merge_runs.cu"],
          "merge_runs_ptxas": ptxas,
          # merge_tiles' dynamic shared memory as the library launches it,
          # by arrays staged (key words + payload)
          "merge_tiles_dynamic_smem_bytes": {
              arrays: _build.merge_runs_lib().km_merge_smem(arrays)
              for arrays in range(1, 7)}})

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    import multiprocessing

    host_pool = ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    try:
        # full-size bank first: phase 3 checks the kernels at its N
        t0 = time.perf_counter()
        fof_big = gen_bank(os.path.join(WORK, "bank_full"))
        gen_s = time.perf_counter() - t0
        dev = torch.device("cuda")
        walls, info, seg_in = staged_step(
            fof_big, os.path.join(WORK, "staged"), 31, dev)
        # the host references of phases 4 and 5 run in processes of their
        # own while phase 3 checks the kernels
        fof_small = gen_bank(os.path.join(WORK, "bank_small"), nsamp=10,
                             genome=200_000, coverage=8, read_len=1024)
        host_refs = {name: host_pool.submit(timed_host_run, dict(
            fof=fof, run_dir=os.path.join(WORK, name), k=k))
            for name, fof, k in (("host_full", fof_big, 31),
                                 ("host_k31", fof_small, 31),
                                 ("host_k21", fof_small, 21),
                                 ("host_k21_full", fof_big, 21),
                                 ("host_k63_full", fof_big, 63))}
        # phase 17's item-G references queue behind them
        host_g = {tag: host_pool.submit(timed_host_run, dict(
            fof=fof_big, run_dir=os.path.join(WORK, f"host_{tag}"), k=31,
            mode=mode, bloom_size=bloom, nb_partitions=nparts))
            for tag, mode, bloom, nparts in ITEM_G}

        # 3. kernels against their plain versions on the card: the Pallas
        # test cases, then cases at the CUDA kernels' own tile
        errs = [0, 0]
        ncases = 0
        for inputs, (rmin, save_if, cmax) in list(segscan_cases()) + list(
                single_pass_cases(_build.TILE)):
            e = check_kernels([torch.from_numpy(a).to(dev) for a in inputs],
                              rmin, save_if, cmax, S)
            errs = [max(a, b) for a, b in zip(errs, e)]
            ncases += 1
        e = check_kernels(seg_in, 1, 2, 2**32 - 1, S)
        errs = [max(a, b) for a, b in zip(errs, e)]
        ncases += 1
        n = seg_in[0].numel()
        cnt, present, solid, suffix = S.segscan_bwd_torch(
            *seg_in, count_max=2**32 - 1)
        fwd_args = (present, solid, suffix, seg_in[1], seg_in[2], cnt)
        k1 = lambda: S.segscan_bwd_cuda(*seg_in, count_max=2**32 - 1)
        k2 = lambda: S.segscan_fwd_cuda(*fwd_args, rmin=1, save_if=2)
        dev_ms = {"K1": device_ms(k1), "K2": device_ms(k2)}
        times = {
            "K1": median(dev_ms["K1"]), "K1_call": cuda_ms(k1),
            "K1_plain": cuda_ms(lambda: S.segscan_bwd_torch(
                *seg_in, count_max=2**32 - 1)),
            "K2": median(dev_ms["K2"]), "K2_call": cuda_ms(k2),
            "K2_plain": cuda_ms(lambda: S.segscan_fwd_torch(
                *fwd_args, rmin=1, save_if=2)),
        }
        # each input read once, each output written once (B/element)
        bound = {"K1": n * (3 + 8 + 10) / HBM_BYTES_PER_S * 1e3,
                 "K2": n * (4 + 8 + 10) / HBM_BYTES_PER_S * 1e3}
        emit({"phase": "kernels", "cases": ncases, "repeats": REPEATS,
              "tile": _build.TILE, "n_full": n,
              "max_abs_err": {"K1": errs[0], "K2": errs[1]},
              "device_ms_3_repeats": dev_ms,
              "ms": times, "bound_ms": bound, "gpu": smi})
        del seg_in, cnt, present, solid, suffix, fwd_args
        torch.cuda.empty_cache()

        # 4. byte parity with the host stages on a small bank
        for k in (31, 21):
            step_parity(fof_small, k, host_refs[f"host_k{k}"].result())

        # 5. full size through the CLI, counters reset just before
        host_rd = os.path.join(WORK, "host_full")
        host_s = host_refs["host_full"].result()
        nparts = len(os.listdir(os.path.join(host_rd, "merge_infos")))
        for key in S.LAUNCHES:
            S.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        port_run(fof_big, os.path.join(WORK, "port_full"), 31)
        torch.cuda.synchronize()
        port_s = time.perf_counter() - t0
        launches = dict(S.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if not (launches["bwd"] > 0 and launches["fwd"] > 0):
            raise AssertionError(f"main path skipped a kernel: {launches}")
        files, nbytes = compare_run_dirs(host_rd, os.path.join(WORK,
                                                               "port_full"))
        emit({"phase": "full_size", **info, "bank_gen_s": gen_s,
              "stage_walls_s": walls,
              "device_step_s": sum(v for s, v in walls.items()
                                   if not s.endswith("_host")),
              "main_path_wall_s": port_s, "host_stages_wall_s": host_s,
              "files_identical": files, "bytes": nbytes,
              "partitions_host": nparts,
              "peak_device_bytes": peak, "launches": launches, "gpu": smi})
        torch.cuda.empty_cache()

        # 6. merge kernels against their plain version, then at the
        # phase-A shape of the phase-8 bank
        t0 = time.perf_counter()
        fof_e2e = gen_bank(os.path.join(WORK, "bank_e2e"), nsamp=10,
                           genome=1_000_000, coverage=30, read_len=1024)
        e2e_gen_s = time.perf_counter() - t0
        merrs = {"K3": 0, "K4": 0}
        ncases = 0
        runs4 = phase_a_runs(fof_e2e, os.path.join(WORK, "runs_e2e"), 31,
                             dev)[0]
        runs3 = [((w[0],), None) for w, _c in runs4]
        for runs in list(merge_cases(dev)) + list(
                tile_edge_merge_cases(dev, _build.MERGE_TILE)) + [runs4,
                                                                  runs3]:
            kern = merge_kind(runs)
            merrs[kern] = max(merrs[kern], merge_err(runs, MR, REPEATS))
            ncases += 1
        # 8 interleaved runs of the same entries: three tree levels
        runs8 = split_runs(*MR.merge_sorted_runs_torch(runs4), 8, seed=8)
        merrs["K4"] = max(merrs["K4"], merge_err(runs8, MR, REPEATS))
        ncases += 1
        words0 = [w[0] for (w, _p) in runs3]
        k4 = lambda: MR.merge_sorted_runs_cuda(runs4)
        k3 = lambda: MR.merge_sorted_runs_cuda(runs3)
        k4_8 = lambda: MR.merge_sorted_runs_cuda(runs8)
        # K3's function as one PyTorch call (timed here only)
        lib3 = lambda: torch.sort(torch.cat(words0), stable=True)
        mdev_ms = {"K4": device_ms(k4), "K3": device_ms(k3),
                   "K3_library": device_ms(lib3), "K4_8_runs": device_ms(k4_8)}
        mtimes = {
            "K4": median(mdev_ms["K4"]), "K4_call": cuda_ms(k4),
            "K4_plain": cuda_ms(lambda: MR.merge_sorted_runs_torch(runs4)),
            "K3": median(mdev_ms["K3"]), "K3_call": cuda_ms(k3),
            "K3_plain": cuda_ms(lambda: MR.merge_sorted_runs_torch(runs3)),
            "K3_library": median(mdev_ms["K3_library"]),
            "K4_8_runs": median(mdev_ms["K4_8_runs"]),
        }
        entries = sum(int(c.shape[0]) for _w, c in runs4)
        nw = len(runs4[0][0])
        # int64 words (+ the count for K4), read once and written once; a
        # one-pass merge of the 8 runs moves K4's bytes once, the tree
        # three times
        mbound = {"K4": entries * 2 * 8 * (nw + 1) / HBM_BYTES_PER_S * 1e3,
                  "K3": entries * 2 * 8 / HBM_BYTES_PER_S * 1e3}
        mbound["K4_8_runs_one_pass"] = mbound["K4"]
        emit({"phase": "merge_kernels", "cases": ncases, "repeats": REPEATS,
              "tile": _build.MERGE_TILE,
              "phase_a_runs": [int(c.shape[0]) for _w, c in runs4],
              "runs8": [int(c.shape[0]) for _w, c in runs8],
              "phase_a_key_words": nw, "max_abs_err": merrs,
              "device_ms_3_repeats": mdev_ms,
              "profiled_kernel_ms": {"K4": profiled_kernel_ms(k4),
                                     "K3": profiled_kernel_ms(k3)},
              "ms": mtimes, "bound_ms": mbound, "gpu": smi})
        del runs, runs3, runs4, runs8, words0
        torch.cuda.empty_cache()

        # 7. engine parity on the phase-4 bank, about ten chunks
        engine_parity(fof_small, SE)

        # 8. the engine at full size through the CLI, counters reset
        # just before
        from kmtricks_tpu_torch.cli import main as main_cli
        from kmtricks_tpu_torch.runtime.pipeline import (
            BYTES_PER_WINDOW, PipelineOptions, run_pipeline)

        eng_rd = os.path.join(WORK, "engine_e2e")
        reset(S.LAUNCHES, MR.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        main_cli(["pipeline", "--file", fof_e2e, "--run-dir", eng_rd,
                  "--kmer-size", "31", "-v", "warning"] + OPTS)
        torch.cuda.synchronize()
        eng_s = time.perf_counter() - t0
        eng_launches = {**S.LAUNCHES, **MR.LAUNCHES}
        eng_peak = torch.cuda.max_memory_allocated()
        eng = dict(SE.last_run)
        if not eng_launches["K4"] > 0 \
                or eng_launches["K4_split"] != eng_launches["K4"]:
            raise AssertionError(f"engine skipped the merge or its "
                                 f"partition: {eng_launches}")
        nparts = len(os.listdir(os.path.join(eng_rd, "merge_infos")))
        # the one-step path on the same bank (K1/K2, ~291M windows)
        reset(S.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        one_rd = os.path.join(WORK, "one_step_e2e")
        t0 = time.perf_counter()
        port_run(fof_e2e, one_rd, 31, eng_rd, ["--max-memory", "65536",
                                              "--nb-partitions", str(nparts)])
        one_s = time.perf_counter() - t0
        one_peak = torch.cuda.max_memory_allocated()
        if not S.LAUNCHES["bwd"] > 0:
            raise AssertionError("the --max-memory 65536 run did not take "
                                 "the one-step path")
        one_files, one_bytes = compare_run_dirs(eng_rd, one_rd)
        # forced folds: 16x smaller chunks, a table budget just above the
        # final table
        reset(MR.LAUNCHES)
        fold_rd = os.path.join(WORK, "folds_e2e")
        budget = int(8192 * 1e6 / BYTES_PER_WINDOW)
        t0 = time.perf_counter()
        run_pipeline(PipelineOptions(
            fof=fof_e2e, run_dir=fold_rd, kmer_size=31, hard_min=2,
            soft_min="2", share_min=2, recurrence_min=1, repart_from=eng_rd,
            nb_partitions=nparts), device="cuda",
            chunk_windows=budget // 16,
            table_cap=int(eng["table_entries"] * 1.05))
        fold_s = time.perf_counter() - t0
        folds = dict(SE.last_run)
        if folds["folds"] < 2:
            raise AssertionError(f"expected two or more folds: {folds}")
        fold_files, fold_bytes = compare_run_dirs(eng_rd, fold_rd)
        shutil.rmtree(fold_rd)
        emit({"phase": "engine_full_size", "bank_gen_s": e2e_gen_s,
              "main_path_wall_s": eng_s, "phase_walls_s": eng["walls_s"],
              # config, repartition (host tally) and bank estimates
              "outside_engine_s": eng_s - sum(eng["walls_s"].values()),
              "chunks": eng["chunks"], "rows_per_chunk": eng["rows_per_chunk"],
              "runs": eng["runs"], "folds": eng["folds"],
              "run_entries": eng["run_entries"],
              "table_entries": eng["table_entries"], "rows": eng["rows"],
              "partitions": nparts, "peak_device_bytes": eng_peak,
              "launches": eng_launches,
              "one_step_wall_s": one_s, "one_step_peak_device_bytes":
              one_peak, "one_step_files_identical": one_files,
              "one_step_bytes": one_bytes,
              "forced_fold_wall_s": fold_s, "forced_fold_chunks":
              folds["chunks"], "forced_folds": folds["folds"],
              "forced_fold_k4_launches": MR.LAUNCHES["K4"],
              "forced_fold_k4_split_launches": MR.LAUNCHES["K4_split"],
              "forced_fold_files_identical": fold_files,
              "forced_fold_bytes": fold_bytes, "gpu": smi})

        # 9. every output mode on both branches, against the host stages
        output_parity(fof_small, os.path.join(WORK, "host_k31"), SE)

        # 10. the hash paths and the pa-bits tail at full size
        hash_launches, k4_hash = hash_full_size(
            fof_big, os.path.join(WORK, "host_full"), fof_e2e, eng_rd, S, MR,
            SE, dev, smi)

        # 11. the repartition tally on the card
        tally_phase(fof_small, fof_e2e, dev, smi)

        # 12-13. --static-repart and wide k against the host stages
        wide_launches = wide_parity(fof_small, SE, MR, S)

        # 14. k = 63 at full width; 15. K4 over 3-5 key words
        wide_runs, w63_rd = wide_full_size(fof_big, fof_e2e, S, MR, SE, smi)
        k4_wide_a = k4_wide(dev, fof_e2e, w63_rd, MR, smi)

        # 16. the per-stage device path and the module commands
        stage_launches, stage_k = per_stage_phase(
            fof_small, fof_big, fof_e2e, eng_rd, S, MR, SE, smi)

        # 17. the chunked path; 18. the mesh
        chunked_launches, chunk_k = chunked_phase(
            fof_big, fof_e2e, eng_rd, host_g, S, MR, smi)
        for name in ("host_k21_full", "host_k63_full"):
            host_refs[name].result()
        mesh_launches, receivers = mesh_phase(fof_big, fof_e2e, eng_rd, S,
                                              MR, smi)

        # 19. the engine over two processes
        mp_launches = multiprocess_phase(fof_small, fof_e2e, eng_rd, S, MR,
                                         smi)

        # 20. the dense tails' merge on the card against the host's
        merge_tail_phase(dev, smi)
    finally:
        host_pool.shutdown(cancel_futures=True)
        shutil.rmtree(WORK, ignore_errors=True)

    no_jax()
    src = "kmtricks_tpu_torch/csrc/segscan.cu"
    msrc = "kmtricks_tpu_torch/csrc/merge_runs.cu"
    # launches on each path that runs the kernel: phase 5 or 8, then 10
    by_path = {
        name: {"kmer:count:bin 8x one step": launches[name]}
        for name in ("bwd", "fwd")}
    for name in ("K3", "K4"):
        by_path[name] = {"kmer:count:bin 30x engine": eng_launches[name]}
    for path, counts in hash_launches.items():
        for name in ("bwd", "fwd") if "one step" in path else ("K3", "K4"):
            by_path[name][path] = counts[name]
    for path, r in wide_runs.items():
        for name in ("bwd", "fwd") if "one step" in path else ("K3", "K4"):
            by_path[name][path] = r["launches"][name]
    # the per-stage path: K1/K2 once per sample counted on the card, K3/K4
    # never
    for path, counts in stage_launches.items():
        for name in ("bwd", "fwd", "K3", "K4"):
            by_path[name][path] = counts[name]
    # the chunked path's runs (phase 17) and the mesh's runs of more than
    # one shard (phase 18), summed; the engine over two processes (19)
    for name in ("bwd", "fwd", "K3", "K4"):
        by_path[name]["chunked"] = sum(v[name] for v in
                                       chunked_launches.values())
        by_path[name]["mesh"] = sum(
            v[name] for tag, v in mesh_launches.items()
            if not tag.endswith(" 1"))
        # phase 19's runs, summed over the runs and the ranks
        by_path[name]["multiprocess"] = sum(v[name] for v in
                                            mp_launches.values())
    if not by_path["K3"]["mesh"] > 0:
        raise AssertionError("K3 never merged a receiver's runs on the "
                             "mesh path")
    k3_split_mesh = sum(v["K3_split"] for tag, v in mesh_launches.items()
                        if not tag.endswith(" 1"))
    k3_recv = receivers["1_words"]
    k4_recv = {key: r for key, r in receivers.items() if key != "1_words"}
    wide_k4 = {key: sum(v["K4"] for tag, v in wide_launches.items()
                        if key in tag and tag.endswith("engine"))
               for key in ("k=45", "k=63", "k=96", "k=128")}
    def per_stage(name):
        """The K1/K2 row's numbers on the per-stage path's own inputs."""
        return {"n": stage_k["n"], "rmin": stage_k["rmin"],
                "save_if": stage_k["save_if"],
                **{key: stage_k[key][name] for key in (
                    "max_abs_err", "ms", "call_ms", "plain_ms",
                    "bound_ms")}}

    def chunk_report(rep, name):
        """The K1/K2 row's numbers on the chunked path's own inputs."""
        return {"n": rep["n"], "rmin": rep["rmin"],
                "save_if": rep["save_if"],
                **{key: rep[key][name] for key in (
                    "max_abs_err", "ms", "call_ms", "plain_ms",
                    "bound_ms")}}

    emit({"kernels": [
        {"name": "segscan_bwd (K1)", "route": "cuda", "source": src,
         "replaces": "kmtricks_tpu/ops/pallas_segscan.py:123",
         "launches": launches["bwd"],
         "launches_by_path": by_path["bwd"],
         "max_abs_err": max(errs[0], stage_k["max_abs_err"]["K1"],
                            chunk_k["max_abs_err"]["K1"]),
         "ms": times["K1"], "call_ms": times["K1_call"],
         "plain_ms": times["K1_plain"],
         "bound_ms": bound["K1"], "bound_by": "bytes", "library_ms": None,
         # one sample's segment stage of the per-stage path (phase 16)
         "per_stage": per_stage("K1"),
         # the largest chunk's segment stage of the chunked path (17)
         "chunked": chunk_report(chunk_k, "K1")},
        {"name": "segscan_fwd (K2)", "route": "cuda", "source": src,
         "replaces": "kmtricks_tpu/ops/pallas_segscan.py:176",
         "launches": launches["fwd"],
         "launches_by_path": by_path["fwd"],
         "max_abs_err": max(errs[1], stage_k["max_abs_err"]["K2"],
                            chunk_k["max_abs_err"]["K2"]),
         "ms": times["K2"], "call_ms": times["K2_call"],
         "plain_ms": times["K2_plain"],
         "bound_ms": bound["K2"], "bound_by": "bytes", "library_ms": None,
         "per_stage": per_stage("K2"),
         "chunked": chunk_report(chunk_k, "K2")},
        # K3 (one word, no payload) merges the mesh's k2/h1/h2 receivers'
        # routed runs: its launches are the mesh path's (phase 18)
        {"name": "merge_runs one word (K3)", "route": "cuda",
         "source": msrc, "replaces": "kmtricks_tpu/ops/pallas_sort.py:136",
         "launches": by_path["K3"]["mesh"],
         "launches_by_path": by_path["K3"],
         "partition_launches": k3_split_mesh,
         "max_abs_err": max(merrs["K3"], k3_recv["max_abs_err"]),
         "ms": mtimes["K3"], "call_ms": mtimes["K3_call"],
         "plain_ms": mtimes["K3_plain"],
         "bound_ms": mbound["K3"], "bound_by": "bytes",
         "library_ms": mtimes["K3_library"],
         # the largest k2/h1/h2 receiver's routed runs (phase 18)
         "mesh_receiver": k3_recv},
        {"name": "merge_runs words + count (K4)", "route": "cuda",
         "source": msrc, "replaces": "kmtricks_tpu/ops/pallas_sort.py:318",
         "launches": eng_launches["K4"],
         "launches_by_path": by_path["K4"],
         "partition_launches": eng_launches["K4_split"],
         "max_abs_err": max([merrs["K4"], k4_hash["max_abs_err"],
                             k4_wide_a["max_abs_err"]]
                            + [r["max_abs_err"] for r in k4_recv.values()]),
         "ms": mtimes["K4"], "call_ms": mtimes["K4_call"],
         "plain_ms": mtimes["K4_plain"],
         "bound_ms": mbound["K4"], "bound_by": "bytes", "library_ms": None,
         # the hash engine's form: one key word + the count
         "hash_phase_a": {key: k4_hash[key] for key in (
             "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms")},
         # the wide form: the k = 63 engine's kw words + the count
         "wide_phase_a": {key: k4_wide_a[key] for key in (
             "key_words", "max_abs_err", "ms", "call_ms", "plain_ms",
             "bound_ms")},
         "wide_parity_engine_launches": wide_k4,
         # the largest k3 and kw receivers' routed runs (phase 18)
         "mesh_receivers": k4_recv},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(tail_main() if sys.argv[1:] == ["--tail"] else main())
