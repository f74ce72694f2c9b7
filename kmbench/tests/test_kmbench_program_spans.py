"""The program's spans as the benchmark reads them (``kmbench/program.py``
and the readers that use it): the record's readers, with and without the
program's ``trace`` module, and the benchmark's reading of a synthetic
chrome trace with and without the program's ``km.`` spans."""

import copy
import glob
import os

import pytest

from kmbench import cells, program
from kmbench.trace import Profile, Record, Spans

NEW = {"engine.decode_wait_s": "engine.decode_wait",
       "engine.decode_s": "engine.decode",
       "engine.chunk_step_s": "engine.chunk_step",
       "tail.fetch_s": "tail.fetch", "tail.merge_dense_s": "tail.merge",
       "tail.write_s": "tail.write",
       "repart.tally_wait_s": "repart.tally_wait",
       "repart.parse_s": "repart.parse", "repart.pack_s": "repart.pack",
       "repart.upload_s": "repart.upload", "step.load_s": "step.load"}


def _ev(cat, name, ts_us, dur_us, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """A pipeline on thread 1 with the benchmark's spans, the program's
    spans on thread 1 and on a decode thread 2, launches on both threads
    and the kernels they launched."""
    return [
        _ev("user_annotation", "kmbench.pipeline", 0, 1_000_000),
        _ev("user_annotation", "kmbench.repart", 0, 300_000),
        _ev("user_annotation", "kmbench.engine", 300_000, 700_000),
        _ev("user_annotation", "km.repart.tally_wait", 20_000, 60_000),
        _ev("user_annotation", "km.engine.chunk_loop", 300_000, 500_000),
        _ev("user_annotation", "km.engine.decode_wait", 320_000, 100_000),
        _ev("user_annotation", "km.hash.window", 450_000, 20_000),
        # the decode thread's span covers a gap: not a candidate
        _ev("user_annotation", "km.engine.decode", 850_000, 100_000,
            tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 455_000, 5, corr=7),
        _ev("cuda_runtime", "cudaLaunchKernel", 460_000, 5, corr=8),
        # launched by the decode thread inside hash.window's interval
        _ev("cuda_runtime", "cudaMemcpyAsync", 455_000, 5, tid=2, corr=9),
        _ev("cuda_runtime", "cudaLaunchKernel", 480_000, 5, corr=10),
        _ev("kernel", "k_repart", 100_000, 100_000, tid=7, corr=1),
        _ev("kernel", "k_hash_a", 456_000, 10_000, tid=7, corr=7),
        # runs after the hash span has closed: still the span's
        _ev("kernel", "k_hash_b", 600_000, 30_000, tid=7, corr=8),
        _ev("gpu_memcpy", "Memcpy HtoD", 640_000, 10_000, tid=7, corr=9),
        _ev("kernel", "k_later", 700_000, 50_000, tid=7, corr=10),
        _ev("cpu_op", "aten::add", 0, 10),
    ]


def _strip(events):
    return [e for e in events if not e["name"].startswith("km.")]


def test_program_spans_leave_the_benchmarks_readings_as_they_were():
    """With or without the program's ``km.`` events, the benchmark's own
    reading of the trace and every existing trace reader's value are the
    same."""
    events = _trace()
    with_km, without = Profile(copy.deepcopy(events)), Profile(
        _strip(events))
    assert with_km.breakdown() == without.breakdown()
    assert (with_km.busy_s, with_km.window_s, with_km.spans) == \
        (without.busy_s, without.window_s, without.spans)
    for m in ("device.idle_share", "kernel.merge_roofline",
              "kernel.segscan_roofline"):
        r = cells.reader(m)

        class Ctx:
            spans = Spans("cpu")
            kmers_per_s = None
        a, b = Ctx(), Ctx()
        a.profile, b.profile = with_km, without
        assert r.read(a) == r.read(b)


class _Ctx:
    """A reader's context: the window runs' and the profiled run's
    records, and a profile."""

    def __init__(self, records, profiled=(), profile=None):
        self.spans = Spans("cpu")
        for rec in records:
            self.spans.runs.append(Record())
            if rec is not None:
                self.spans.runs[-1].after[program.NAME].append(rec)
        self.spans.profiled = Record()
        for rec in profiled:
            self.spans.profiled.after[program.NAME].append(rec)
        self.profile = profile
        self.kmers_per_s = None


def _rec(**spans):
    return {n.replace("__", "."): {"s": s, "calls": 1, "n": n_}
            for n, (s, n_) in spans.items()}


@pytest.mark.parametrize("metric", sorted(NEW))
def test_new_readers_read_the_window_means(metric):
    span = NEW[metric]
    r = cells.reader(metric)
    assert r.SPANS == program.SPANS
    key = span.replace(".", "__")
    ctx = _Ctx([_rec(**{key: (1.0, 0)}), _rec(**{key: (3.0, 0)}),
                _rec(other__span=(5.0, 0))])
    assert r.read(ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_new_readers_stay_out_without_the_programs_record(metric):
    """The parent commit has no ``trace`` module: no record is read, and
    each new metric stays out of the line."""
    r = cells.reader(metric)
    events = _trace()
    ctx = _Ctx([None, None], profile=Profile(_strip(events)))
    assert r.read(ctx) is None
    ctx = _Ctx([_rec(unrelated=(1.0, 0))], [_rec(unrelated=(1.0, 5))],
               profile=Profile(_strip(events)))
    assert r.read(ctx) is None


def test_every_program_reader_names_one_target():
    """Spans.install wraps a function once: every reader of the program's
    record names the same target, so each sees the record."""
    targets = {}
    for path in glob.glob(os.path.join(cells.HERE, "metrics", "*.py")):
        name = os.path.basename(path)[:-3]
        for t in getattr(cells.reader(name), "SPANS", ()):
            targets.setdefault(t[:2], set()).add((t[2], t[4]))
    assert program.SPANS, "the program's trace module is importable here"
    mod_attr = program.SPANS[0][:2]
    assert targets[mod_attr] == {(program.NAME, program.SPANS[0][4])}


def test_without_the_trace_module_spans_are_empty(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec

    def find(name, *a):
        if name == program.TRACE:
            return None
        return real(name, *a)
    monkeypatch.setattr(importlib.util, "find_spec", find)
    assert not program._has_trace()


def test_traced_cpu_run_reports_the_new_metrics(tiny_cell):
    """A whole traced run on the CPU through the engine: the readers of
    the program's record report in the count cell."""
    from kmbench import run

    r = run.run_cell(tiny_cell(), 2**31 + 141, 0.3, True, device="cpu")
    assert r["correct"]
    engine = {"engine.decode_wait_s", "engine.decode_s",
              "engine.chunk_step_s", "tail.fetch_s", "tail.merge_dense_s",
              "tail.write_s", "repart.tally_wait_s", "repart.parse_s",
              "repart.pack_s", "repart.upload_s"}
    assert engine <= set(r["metrics"])
    for m in engine:
        assert r["metrics"][m]["value"] >= 0
    assert r["metrics"]["engine.decode_wait_s"]["value"] + \
        r["metrics"]["engine.chunk_step_s"]["value"] <= \
        r["metrics"]["engine.chunk_loop_s"]["value"]
