"""One run of one benchmark cell.

    python -m kmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: check for the card, write the cell's read collection from the
seed under ``TMPDIR`` (in a child process), start CUDA and import the
program, and run one whole pipeline as a warm-up. The window then runs
whole pipelines back to back through the program's ``pipeline`` command
(its CLI parser and ``run_pipeline`` on the card), each into a fresh run
directory, and ends with the first run that ends at or after
``--seconds``. With ``--trace 1`` the window's runs carry the
benchmark's spans and one more run is profiled after it. Once the window
has closed, the last run's files are judged against the plain reference
(:mod:`kmbench.reference`) and every other run's against the last run's.

Standard error carries the set-up split, the runs, the bytes written and,
as its last lines, each number compared with its limit; the last line of
standard output is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import filecmp
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

from kmbench import cells
from kmbench.gen import check_format, valid_windows
from kmbench.memory import HostPeak, process_age_s
from kmbench.window import rate, run_window

FORBIDDEN = ("jax", "jaxlib", "flax", "kmtricks_tpu")
# what a run writes that every run must write alike (run_infos.txt and
# options.txt name the run's wall and directory)
OUTPUTS = ("repartition", "minimizers", "matrices", "filters",
           "merge_infos", "fpr", "hash.info")
# every number compared (a reference's ``judge`` and ``runs_differing``)
# counts differences, so every limit is 0
LIMIT = 0


def log(msg: str) -> None:
    print(f"kmbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load
    (compared whole: ``kmtricks_tpu_torch`` is not ``kmtricks_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def work_root(cell: str) -> str:
    """The cell's scratch directory under TMPDIR, or inside the checkout
    where TMPDIR's path holds characters a fof path may not."""
    import tempfile

    d = os.path.join(os.environ.get("TMPDIR") or tempfile.gettempdir(),
                     "kmbench", cell)
    if not re.fullmatch(r"[.A-Za-z0-9/_\-]+", d):
        d = os.path.join(cells.ROOT, ".kmbench_work", cell)
    return d


def make_bank(cell: dict, seed: int, out: str) -> dict:
    """Write the collection in a child process; returns its manifest."""
    workers = max(1, min(4, cell["traffic_spec"]["samples"],
                         os.cpu_count() or 1))
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    subprocess.run([sys.executable, "-m", "kmbench.gen", "--traffic",
                    cell["traffic_path"], "--seed", str(seed), "--out", out,
                    "--workers", str(workers)],
                   check=True, cwd=cells.ROOT, env=env,
                   stdout=subprocess.DEVNULL)
    with open(os.path.join(out, "manifest.json")) as f:
        return json.load(f)


def tree_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total


def same_outputs(a: str, b: str) -> bool:
    """Whether two run directories hold byte-identical outputs."""
    for name in OUTPUTS:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isfile(pa) or os.path.isfile(pb):
            if not (os.path.isfile(pa) and os.path.isfile(pb)
                    and filecmp.cmp(pa, pb, shallow=False)):
                return False
            continue
        fa = sorted(os.listdir(pa)) if os.path.isdir(pa) else []
        fb = sorted(os.listdir(pb)) if os.path.isdir(pb) else []
        if fa != fb:
            return False
        _m, mismatch, errors = filecmp.cmpfiles(pa, pb, fa, shallow=False)
        if mismatch or errors:
            return False
    return True


class Context:
    """What a per-layer metric reader reads: the spans' records of the
    window's runs and of the profiled run, the profiled run's device
    activity, and the window's rate (valid k-mer windows a second)."""

    def __init__(self, spans, profile, kmers_per_s=None):
        self.spans = spans
        self.profile = profile
        self.kmers_per_s = kmers_per_s


def judge_runs(cell: dict, manifest: dict, run_dirs: list[str],
               device) -> dict:
    """Every number compared, from the last run directory against the
    reference and the others against the last."""
    ref = cells.reference(cell)
    opts, coll = ref.setup(cells.pipeline_args(cell), manifest["samples"],
                           device)
    checks = ref.judge(ref.read_file(run_dirs[-1]), coll, opts)
    checks["runs_differing"] = sum(not same_outputs(d, run_dirs[-1])
                                   for d in run_dirs[:-1])
    return checks


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", chips: int = 1) -> dict:
    """Set up, measure and judge one run of ``cell``; returns the result
    (its ``checks`` key last)."""
    import torch

    # a configuration its reference cannot judge, or a format the generator
    # does not write, fails before any work
    cells.reference(cell).options(cells.pipeline_args(cell))
    check_format(cell["traffic_spec"])
    parts = {}
    t = time.perf_counter()
    work = work_root(cell["name"])
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    manifest = make_bank(cell, seed, os.path.join(work, "bank"))
    parts["bank_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from kmtricks_tpu_torch.cli import _options_from_args, build_parser
    from kmtricks_tpu_torch.ops import merge_runs, segscan
    from kmtricks_tpu_torch.runtime.pipeline import run_pipeline

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    parts["cuda_init_s"] = time.perf_counter() - t

    args = cells.pipeline_args(cell)
    k = int(cells.option(args, "--kmer-size", "31"))
    windows = valid_windows(manifest, k)
    runs_dir = os.path.join(work, "runs")

    def pipeline(name: str) -> str:
        rd = os.path.join(runs_dir, name)
        argv = ["pipeline", "--file", manifest["fof"], "--run-dir", rd,
                *args]
        run_pipeline(_options_from_args(build_parser().parse_args(argv)),
                     device=device)
        return rd

    t = time.perf_counter()
    shutil.rmtree(pipeline("warmup"))
    # the collection's and the warm-up's writes reach the disk before the
    # window, not during it
    os.sync()
    parts["warmup_s"] = time.perf_counter() - t

    from kmbench.trace import Spans, profile_run

    bench = cells.benchmark()
    readers = [(m, cells.reader(m["name"]))
               for m in cells.per_layer(bench, cell["name"])]
    spans = Spans(dev) if trace else None
    if spans:
        spans.install([target for _m, r in readers
                       for target in getattr(r, "SPANS", ())])
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    host = HostPeak()
    host.start()
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{n} {v:.3f} s" for n, v in parts.items()) + " (the rest: "
        "interpreter start and imports)")

    run_dirs, cpu_s = [], []

    def once(i: int) -> None:
        if spans:
            spans.begin_run()
        c = os.times()
        run_dirs.append(pipeline(f"run_{i}"))
        d = os.times()
        cpu_s.append((d.user - c.user, d.system - c.system))

    win = run_window(once, seconds)
    host_peak = host.stop()
    # the spans reset the allocator's peak inside the window
    dev_peak = (spans.device_peak() if spans else
                torch.cuda.max_memory_allocated(dev)) if cuda else 0
    log(f"window {win.elapsed:.3f} s, {len(win.runs)} runs: " + ", ".join(
        f"{e - s:.3f}" for s, e in win.runs) + " s; the process's CPU, "
        "user/system: " + ", ".join(f"{u:.2f}/{y:.2f}" for u, y in cpu_s)
        + f" s; host peak by {host.mode}")
    if win.error is not None:
        log(f"run {len(win.runs)} failed: {win.error!r}")

    profile = None
    if spans and win.error is None:
        spans.begin_profile()
        before = {**segscan.LAUNCHES, **merge_runs.LAUNCHES}
        profile = profile_run(lambda: run_dirs.append(pipeline("profiled")),
                              dev, work)
        after = {**segscan.LAUNCHES, **merge_runs.LAUNCHES}
        log("launches in the profiled run: " + json.dumps(
            {n: after[n] - before.get(n, 0) for n in after}))
        log(f"profiled run {profile.window_s:.3f} s, device busy "
            f"{profile.busy_s:.3f} s")
    if spans:
        spans.uninstall()

    bank = tree_bytes(os.path.dirname(manifest["fof"]))
    log(f"bytes written: {tree_bytes(work)} (bank {bank}, "
        f"{len(run_dirs)} run directories kept, the warm-up's deleted)")

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = judge_runs(cell, manifest, run_dirs, dev) if run_dirs else {
        name: 1 for name in ("repart_bad", "runs_differing")}
    log(f"reference and comparison {time.perf_counter() - t:.3f} s")
    shutil.rmtree(work, ignore_errors=True)

    bad = {n: v for n, v in checks.items() if v > LIMIT}
    failed = int(win.error is not None) + checks.get("runs_differing", 0) \
        + int(any(n != "runs_differing" for n in bad))
    correct = not bad and win.error is None

    metrics = {}
    if not trace:
        values = {"kmers_per_s": rate(windows, win),
                  "peak_device_gib": dev_peak / 2**30,
                  "peak_host_gib": host_peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cells.end_to_end(bench, cell["name"])}
    else:
        ctx = Context(spans, profile, rate(windows, win))
        for m, r in readers:
            value = r.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct,
              "attempted": len(run_dirs) + int(win.error is not None),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": torch.cuda.get_device_name(dev)
                         if cuda else dev.type,
                         "count": chips, "memory_peak_bytes": dev_peak}}
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown()
    result["checks"] = {n: {"value": v, "limit": LIMIT}
                        for n, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kmbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cells.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", chips=cell["chips"])
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    for n, c in result["checks"].items():
        print(f"check {n} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
