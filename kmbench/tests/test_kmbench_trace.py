"""The union of device intervals, the idle share and the span readings."""

import numpy as np
import pytest

from kmbench.trace import Profile, covered, union


def test_union_merges_overlaps_and_keeps_gaps():
    iv = np.array([[5, 7], [0, 2], [1, 3], [6, 9], [10, 11], [11, 12]],
                  dtype=float)
    assert union(iv).tolist() == [[0, 3], [5, 9], [10, 12]]
    assert union(np.zeros((0, 2))).shape == (0, 2)


def test_covered_clips_to_the_interval():
    m = np.array([[0, 3], [5, 9]], dtype=float)
    assert covered(m, 2, 6) == 2.0
    assert covered(m, 9, 12) == 0.0


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def test_profile_busy_idle_spans_and_gaps():
    events = [
        _ev("user_annotation", "kmbench.pipeline", 0, 1_000_000),
        _ev("user_annotation", "kmbench.repart", 0, 400_000),
        _ev("user_annotation", "kmbench.engine", 400_000, 600_000),
        _ev("user_annotation", "kmbench.merge_runs", 800_000, 100_000),
        _ev("kernel", "k_a", 100_000, 100_000),
        _ev("kernel", "k_b", 150_000, 100_000),     # overlaps k_a
        _ev("gpu_memcpy", "Memcpy HtoD", 500_000, 100_000),
        _ev("kernel", "k_merge", 820_000, 50_000),
        _ev("cpu_op", "aten::add", 0, 10),          # not device time
    ]
    p = Profile(events)
    assert p.window_s == pytest.approx(1.0)
    assert p.busy_s == pytest.approx(0.15 + 0.1 + 0.05)
    assert p.span_device_s("merge_runs") == pytest.approx(0.05)
    b = p.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.1)]
    idle = dict(b["idle_gaps"])
    # each gap goes to the innermost span open at its middle: 0-0.1 and
    # 0.25-0.5 (middle 0.375) to repart; 0.6-0.82 (middle 0.71) and
    # 0.87-1.0 (middle 0.935) to engine
    assert idle == {"repart": pytest.approx(0.35),
                    "engine": pytest.approx(0.35)}
    assert sum(idle.values()) == pytest.approx(1.0 - p.busy_s)


def test_window_means_leave_out_the_profiled_run(monkeypatch):
    """A window of N runs and a profiled run after it: the means and the
    ``after`` readings are the window's alone, the bytes the profiled
    run's alone."""
    import sys
    import types

    from kmbench import trace

    clock = [0.0]
    monkeypatch.setattr(trace.time, "perf_counter", lambda: clock[0])
    mod = types.ModuleType("kmbench_fake_layer")

    def stage(seconds):
        clock[0] += seconds
    mod.stage = stage
    monkeypatch.setitem(sys.modules, mod.__name__, mod)

    spans = trace.Spans("cpu")
    spans.install([(mod.__name__, "stage", "stage",
                    lambda seconds: int(100 * seconds),
                    lambda: clock[0])])
    mod.stage(7.0)                  # before the window: recorded nowhere
    for _ in range(4):
        spans.begin_run()
        mod.stage(1.0)
        mod.stage(0.5)
    spans.begin_profile()
    mod.stage(9.0)
    spans.uninstall()
    assert mod.stage is stage
    assert spans.mean("stage") == pytest.approx(1.5)
    assert len(spans.after_readings("stage")) == 8
    assert max(spans.after_readings("stage")) == pytest.approx(13.0)
    assert spans.profiled_bytes("stage") == 900
    assert spans.profiled.seconds["stage"] == pytest.approx(9.0)


def test_traced_run_reads_the_window_runs_only(tiny_cell, monkeypatch):
    """Through a whole traced run on the CPU: the readers see one record
    per window run, and the profiled run's record apart."""
    from kmbench import run

    seen = []
    real = run.Context

    def keep(spans, profile, *rest):
        seen.append(spans)
        return real(spans, profile, *rest)
    monkeypatch.setattr(run, "Context", keep)
    r = run.run_cell(tiny_cell(), 2**31 + 91, 0.5, True, device="cpu")
    spans = seen[0]
    window_runs = r["attempted"] - 1      # the profiled run is attempted
    assert r["correct"] and len(spans.runs) == window_runs >= 1
    assert len(spans.after_readings("engine")) == window_runs
    assert "engine" in spans.profiled.seconds
    assert r["metrics"]["repart.wall_s"]["value"] == pytest.approx(
        spans.mean("config", "repart"))


def test_span_peaks_nest_and_keep_the_process_peak(monkeypatch):
    """With an allocator whose peak resets: each span reads the most
    allocated inside it, nested spans included, and ``device_peak`` the
    most since the spans were made, outside any span too."""
    import sys
    import types

    from kmbench import trace

    alloc = {"now": 0, "peak": 0}

    def allocate(n):
        alloc["now"] += n
        alloc["peak"] = max(alloc["peak"], alloc["now"])

    def reset(_device=None):
        alloc["peak"] = alloc["now"]
    monkeypatch.setattr(trace.torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(trace.torch.cuda, "max_memory_allocated",
                        lambda *_: alloc["peak"])
    monkeypatch.setattr(trace.torch.cuda, "reset_peak_memory_stats", reset)
    mod = types.ModuleType("kmbench_fake_alloc")

    def inner():
        allocate(50)
        allocate(-50)

    def outer():
        allocate(10)
        mod.inner()
        allocate(20)
        allocate(-30)
    mod.inner, mod.outer = inner, outer
    monkeypatch.setitem(sys.modules, mod.__name__, mod)

    spans = trace.Spans("cuda")
    spans.install([(mod.__name__, "outer", "outer", None, None),
                   (mod.__name__, "inner", "inner", None, None)])
    spans.begin_run()
    mod.outer()                     # outer: 10, inner on top: 60; 30 after
    allocate(100)                   # outside every span
    allocate(-100)
    spans.begin_run()
    mod.inner()
    spans.uninstall()
    assert [dict(r.peak) for r in spans.runs] == [
        {"outer": 60, "inner": 60}, {"inner": 50}]
    assert spans.peak("outer") == 60 and spans.peak("inner", "outer") == 60
    assert spans.peak("absent") is None
    assert spans.device_peak() == 100
    assert trace.Spans("cpu").device_peak() == 0
