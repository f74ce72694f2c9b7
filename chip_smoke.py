#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (kmtricks_tpu_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It drives the port's main path (``pipeline --mode kmer:count:bin``) and
checks it, in phases that each print one JSON line:

1. probe: torch, CUDA and nvcc versions, the card's name and power limit;
2. build: compiles the CUDA kernels from ``kmtricks_tpu_torch/csrc``;
3. kernels: K1/K2 against their plain PyTorch versions on the card, bit
   for bit, on the cases of tests/test_pallas_segscan.py and at the
   full-size step's N, with the kernel and plain times there;
4. parity: the port's run directory against the JAX package's host
   stages (numpy, no jax), byte for byte, on a 10-sample synthetic bank at
   k = 31 (k3 sort layout) and k = 21 (k2 layout);
5. full size: the 10-sample 1 Mbp 8x bank (~77.6M k-mer occurrences in one
   step) through the CLI, with the wall of each stage, peak device memory
   and the kernels' launch counts, and its matrices against the host
   stages byte for byte;
6. merge kernels: K4 (one and two key words, count payload) and K3 (one
   word, no payload) against their plain PyTorch version, bit for bit, on
   the cases of tests/test_routed_merge.py and on the phase-A runs of the
   phase-8 bank, with the kernel and plain times there;
7. engine parity: the phase-4 bank through the streaming engine (about
   ten chunks at a low --max-memory) at k = 31 and k = 21, and with
   --hist --soft-min 0.5, against the host stages byte for byte,
   histograms included;
8. engine at full size: the 10-sample 1 Mbp 30x bank (~291M windows)
   through the CLI at the default --max-memory, which streams it from the
   banks, with the wall of each phase, chunk/run/fold counts, peak device
   memory and the launch counts; its matrices against the one-step path
   (--max-memory 65536) and against an engine run whose small table
   budget forces two or more folds through K4.

Then one JSON line of kernel results and, last, the device line. Any
failure raises and exits non-zero; without CUDA it exits non-zero before
printing a result. Nothing here imports jax. Scratch data lives in
``.smoke_work/`` under the repository and is removed at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke_work")
OPTS = ["--hard-min", "2", "--soft-min", "2", "--share-min", "2",
        "--recurrence-min", "1"]
TPU_TILE = 8192           # the Pallas kernels' tile (pallas_segscan.TILE)
SMALL_MEM = 75            # MB: about ten engine chunks of the phase-4 bank


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, after a
    warm-up run and a synchronize."""
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


def check_kernels(inputs, rmin, save_if, cmax, S):
    """K1 and K2 against their plain versions on the same CUDA tensors;
    returns (K1 error, K2 error), both 0 or raises."""
    occ, kd, valid, amin, hmin = inputs
    bwd_k = S.segscan_bwd_cuda(occ, kd, valid, amin, hmin, count_max=cmax)
    bwd_p = S.segscan_bwd_torch(occ, kd, valid, amin, hmin, count_max=cmax)
    e1 = max_err(bwd_k, bwd_p)
    cnt, present, solid, suffix = bwd_p
    fwd_k = S.segscan_fwd_cuda(present, solid, suffix, kd, valid, cnt,
                               rmin=rmin, save_if=save_if)
    fwd_p = S.segscan_fwd_torch(present, solid, suffix, kd, valid, cnt,
                                rmin=rmin, save_if=save_if)
    torch.cuda.synchronize()
    return e1, max_err(fwd_k, fwd_p)


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

def host_run(fof, run_dir, k, repart_from=None, max_memory=8192,
             hist=False, soft_min="2"):
    """The JAX package's host stages one by one (numpy; no jax):
    repartition (host tally), per-sample count (with histograms under
    ``hist``), soft-min, per-partition merge. The config stage is the
    port's twin, whose only difference is a build_infos.txt written
    without asking jax for its version."""
    from kmtricks_tpu.runtime.pipeline import (
        PipelineOptions, resolve_soft_min, stage_count, stage_merge,
        stage_repart)
    from kmtricks_tpu_torch.runtime.pipeline import stage_config

    os.environ["KMTRICKS_REPART_SAMPLER"] = "host"
    opts = PipelineOptions(fof=fof, run_dir=run_dir, kmer_size=k,
                           hard_min=2, soft_min=soft_min, share_min=2,
                           recurrence_min=1, backend="host",
                           repart_from=repart_from, max_memory_mb=max_memory,
                           hist=hist)
    kmdir, config = stage_config(opts)
    rep = stage_repart(kmdir, config, opts)
    for s in range(len(kmdir.fof)):
        stage_count(kmdir, config, rep, s, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    for p in range(config.nb_partitions):
        stage_merge(kmdir, config, opts, p, amin)
    return config.nb_partitions


def port_run(fof, run_dir, k, repart_from, extra=()):
    """The port's main path through its command line."""
    from kmtricks_tpu_torch.cli import main

    main(["pipeline", "--file", fof, "--run-dir", run_dir, "--kmer-size",
          str(k), "--repart-from", repart_from, "-v", "warning"] + OPTS
         + list(extra))


def compare_run_dirs(a, b, subs=("matrices", "merge_infos")):
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
    from kmtricks_tpu.host import ops as hops
    from kmtricks_tpu.runtime.pipeline import (
        PipelineOptions, resolve_soft_min, write_merge_outputs)
    from kmtricks_tpu_torch.convert import from_jax_inputs
    from kmtricks_tpu_torch.ops import count_merge as CM
    from kmtricks_tpu_torch.ops.compact import compact_count_rows
    from kmtricks_tpu_torch.ops.encode import encode_batch
    from kmtricks_tpu_torch.ops.segscan import segment_stage
    from kmtricks_tpu_torch.runtime.device_pipeline import (
        _load_global_batch, rows_budget)
    from kmtricks_tpu_torch.runtime.pipeline import (
        _repart_on_host, stage_config)

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
    rep = _repart_on_host(kmdir, config, opts)
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
    """(runs, kernel) on the grids of tests/test_routed_merge.py: 2 to 8
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
                yield (sorted_runs(rng, lens, nw, payload, span, dev),
                       "K4" if payload else "K3")


def merge_err(runs, MR) -> int:
    """The merge kernel against its plain version on the same runs; 0 or
    raises."""
    def flat(res):
        words, payload = res
        return tuple(words) + (() if payload is None else (payload,))

    got = flat(MR.merge_sorted_runs_cuda(runs))
    exp = flat(MR.merge_sorted_runs_torch(runs))
    torch.cuda.synchronize()
    if len(got) != len(exp):
        raise AssertionError("merge kernel output has the wrong arity")
    return max_err(got, exp)


def phase_a_runs(fof, run_dir, k, dev):
    """The sorted pair runs that phase A of the engine merges for ``fof``
    at the default --max-memory (no fold: one run per chunk), made with
    the engine's own chunk source and chunk step."""
    from kmtricks_tpu.runtime.pipeline import PipelineOptions
    from kmtricks_tpu_torch.parallel.pipeline import build_chunk_pairs_step
    from kmtricks_tpu_torch.runtime.pipeline import (
        BYTES_PER_WINDOW, _repart_on_host, stage_config)
    from kmtricks_tpu_torch.runtime.stream_engine import _chunk_source

    opts = PipelineOptions(fof=fof, run_dir=run_dir, kmer_size=k)
    kmdir, config = stage_config(opts)
    rep = _repart_on_host(kmdir, config, opts)
    gen, _rows = _chunk_source(
        kmdir, opts, k, int(opts.max_memory_mb * 1e6 / BYTES_PER_WINDOW),
        None, None, None, True)
    step = build_chunk_pairs_step(k=k, m=config.minim_size,
                                  nsamp=len(kmdir.fof),
                                  nb_parts=config.nb_partitions)
    table = torch.from_numpy(rep.table.astype(np.int32)).to(dev)
    return [step(*(torch.from_numpy(a).to(dev) for a in chunk), table)
            for chunk in gen]


def reset(*counters) -> None:
    for c in counters:
        for key in c:
            c[key] = 0


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
    with ThreadPoolExecutor(max_workers=2) as ex:
        for f in [ex.submit(_build.segscan_lib),
                  ex.submit(_build.merge_runs_lib)]:
            f.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": ["csrc/segscan.cu", "csrc/merge_runs.cu"]})

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        # full-size bank first: phase 3 checks the kernels at its N
        t0 = time.perf_counter()
        fof_big = gen_bank(os.path.join(WORK, "bank_full"))
        gen_s = time.perf_counter() - t0
        dev = torch.device("cuda")
        walls, info, seg_in = staged_step(
            fof_big, os.path.join(WORK, "staged"), 31, dev)

        # 3. kernels against their plain versions on the card
        errs = [0, 0]
        ncases = 0
        for inputs, (rmin, save_if, cmax) in segscan_cases():
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
        times = {
            "K1": cuda_ms(lambda: S.segscan_bwd_cuda(
                *seg_in, count_max=2**32 - 1)),
            "K1_plain": cuda_ms(lambda: S.segscan_bwd_torch(
                *seg_in, count_max=2**32 - 1)),
            "K2": cuda_ms(lambda: S.segscan_fwd_cuda(
                *fwd_args, rmin=1, save_if=2)),
            "K2_plain": cuda_ms(lambda: S.segscan_fwd_torch(
                *fwd_args, rmin=1, save_if=2)),
        }
        emit({"phase": "kernels", "cases": ncases, "n_full": n,
              "max_abs_err": {"K1": errs[0], "K2": errs[1]},
              "ms_median_of_5": times, "gpu": smi})
        del seg_in, cnt, present, solid, suffix, fwd_args
        torch.cuda.empty_cache()

        # 4. byte parity with the host stages on a small bank
        fof_small = gen_bank(os.path.join(WORK, "bank_small"), nsamp=10,
                             genome=200_000, coverage=8, read_len=1024)
        for k in (31, 21):
            host_rd = os.path.join(WORK, f"host_k{k}")
            t0 = time.perf_counter()
            host_run(fof_small, host_rd, k)
            t1 = time.perf_counter()
            port_rd = os.path.join(WORK, f"port_k{k}")
            port_run(fof_small, port_rd, k, host_rd)
            t2 = time.perf_counter()
            files, nbytes = compare_run_dirs(host_rd, port_rd)
            emit({"phase": "parity", "k": k, "files_identical": files,
                  "bytes": nbytes, "host_s": t1 - t0, "port_s": t2 - t1})

        # 5. full size through the CLI, counters reset just before
        host_rd = os.path.join(WORK, "host_full")
        t0 = time.perf_counter()
        nparts = host_run(fof_big, host_rd, 31)
        host_s = time.perf_counter() - t0
        for key in S.LAUNCHES:
            S.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        port_run(fof_big, os.path.join(WORK, "port_full"), 31, host_rd)
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
        for runs, kern in merge_cases(dev):
            merrs[kern] = max(merrs[kern], merge_err(runs, MR))
            ncases += 1
        runs4 = phase_a_runs(fof_e2e, os.path.join(WORK, "runs_e2e"), 31,
                             dev)
        runs3 = [((w[0],), None) for w, _c in runs4]
        for runs, kern in ((runs4, "K4"), (runs3, "K3")):
            merrs[kern] = max(merrs[kern], merge_err(runs, MR))
        ncases += 2
        mtimes = {
            "K4": cuda_ms(lambda: MR.merge_sorted_runs_cuda(runs4)),
            "K4_plain": cuda_ms(lambda: MR.merge_sorted_runs_torch(runs4)),
            "K3": cuda_ms(lambda: MR.merge_sorted_runs_cuda(runs3)),
            "K3_plain": cuda_ms(lambda: MR.merge_sorted_runs_torch(runs3)),
        }
        emit({"phase": "merge_kernels", "cases": ncases,
              "phase_a_runs": [int(c.shape[0]) for _w, c in runs4],
              "phase_a_key_words": len(runs4[0][0]),
              "max_abs_err": merrs, "ms_median_of_5": mtimes, "gpu": smi})
        del runs, runs3, runs4
        torch.cuda.empty_cache()

        # 7. engine parity on the phase-4 bank, about ten chunks
        small_mem = ["--max-memory", str(SMALL_MEM)]
        for k, hist in ((31, False), (21, False), (31, True)):
            tag = f"k{k}{'_hist' if hist else ''}"
            host_rd = os.path.join(WORK, f"host_engine_{tag}")
            t0 = time.perf_counter()
            host_run(fof_small, host_rd, k, max_memory=SMALL_MEM, hist=hist,
                     soft_min="0.5" if hist else "2")
            t1 = time.perf_counter()
            port_rd = os.path.join(WORK, f"port_engine_{tag}")
            port_run(fof_small, port_rd, k, host_rd, small_mem + (
                ["--hist", "--soft-min", "0.5"] if hist else []))
            t2 = time.perf_counter()
            stats = dict(SE.last_run)
            if stats.get("chunks", 0) < 5:
                raise AssertionError(f"engine took {stats} chunks")
            files, nbytes = compare_run_dirs(
                host_rd, port_rd, ("matrices", "merge_infos")
                + (("histograms",) if hist else ()))
            emit({"phase": "engine_parity", "k": k, "hist_soft_min_0.5": hist,
                  "files_identical": files, "bytes": nbytes,
                  "chunks": stats["chunks"], "runs": stats["runs"],
                  "host_s": t1 - t0, "port_s": t2 - t1})

        # 8. the engine at full size through the CLI, counters reset
        # just before
        from kmtricks_tpu.runtime.pipeline import PipelineOptions
        from kmtricks_tpu_torch.cli import main as main_cli
        from kmtricks_tpu_torch.runtime.pipeline import (
            BYTES_PER_WINDOW, run_pipeline)

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
        if not eng_launches["K4"] > 0:
            raise AssertionError(f"engine skipped the merge: {eng_launches}")
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
              "forced_fold_files_identical": fold_files,
              "forced_fold_bytes": fold_bytes, "gpu": smi})
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    jax_mods = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                              "jaxlib")]
    if jax_mods:
        raise AssertionError(f"jax was imported: {jax_mods[:5]}")
    src = "kmtricks_tpu_torch/csrc/segscan.cu"
    msrc = "kmtricks_tpu_torch/csrc/merge_runs.cu"
    emit({"kernels": [
        {"name": "segscan_bwd (K1)", "route": "cuda", "source": src,
         "replaces": "kmtricks_tpu/ops/pallas_segscan.py:123",
         "launches": launches["bwd"], "max_abs_err": errs[0],
         "ms": times["K1"], "plain_ms": times["K1_plain"]},
        {"name": "segscan_fwd (K2)", "route": "cuda", "source": src,
         "replaces": "kmtricks_tpu/ops/pallas_segscan.py:176",
         "launches": launches["fwd"], "max_abs_err": errs[1],
         "ms": times["K2"], "plain_ms": times["K2_plain"]},
        # K3 is not on this slice's path (the one-word, payload-free form
        # merges multi-GPU receivers' runs): its launches are 0 here
        {"name": "merge_runs one word (K3)", "route": "cuda",
         "source": msrc, "replaces": "kmtricks_tpu/ops/pallas_sort.py:136",
         "launches": eng_launches["K3"], "max_abs_err": merrs["K3"],
         "ms": mtimes["K3"], "plain_ms": mtimes["K3_plain"]},
        {"name": "merge_runs words + count (K4)", "route": "cuda",
         "source": msrc, "replaces": "kmtricks_tpu/ops/pallas_sort.py:318",
         "launches": eng_launches["K4"], "max_abs_err": merrs["K4"],
         "ms": mtimes["K4"], "plain_ms": mtimes["K4_plain"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
