"""Spans around the program's layers, and the reading of one profiled run.

The benchmark opens its own spans around the calls into each layer of
the program (:class:`Spans` wraps the module attributes the program calls
through; each per-layer metric's reader names the spans it reads in its
``SPANS``), times them on the host clock between two device
synchronisations, and names them in the profiler's trace with
``record_function``; the window's runs and the profiled run after it
keep separate records. :func:`profile_run` traces one pipeline run with
``torch.profiler`` and :class:`Profile` reads device time from it.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "kmbench."


@dataclass
class Record:
    """What the spans read in one pipeline run: each span's host seconds,
    the ``after`` readings, the bytes of the calls' work and the device
    bytes allocated at most inside it, by span."""

    seconds: dict = field(default_factory=lambda: defaultdict(float))
    after: dict = field(default_factory=lambda: defaultdict(list))
    bytes: dict = field(default_factory=lambda: defaultdict(int))
    peak: dict = field(default_factory=lambda: defaultdict(int))


class Spans:
    """Wraps the program's layer entry points while installed.

    A target is (module, attribute, span name, work, after): the function
    ``module.attribute`` is replaced by one that times each call; ``work``
    (or None) gives the bytes of a call's work from its arguments, and
    ``after`` (or None) takes a reading once the call has returned. Each
    call goes to the record opened last: a window run's
    (:meth:`begin_run`, kept in ``runs``) or the profiled run's
    (:meth:`begin_profile`, kept in ``profiled`` and apart from the
    window's); a call before either is timed and recorded nowhere.

    On a card each span's peak comes from the allocator's
    ``max_memory_allocated``, reset as a span opens and as it closes
    (spans may nest): :meth:`device_peak` is the process's peak since
    the spans were made, which the reset hides from the allocator."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.runs: list[Record] = []
        self.profiled: Record | None = None
        self._current: Record | None = None
        self._saved = []
        self._open: list[int] = []      # the peak of each open span
        self._peak = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fold(self) -> None:
        """Fold the allocator's peak since its last reset into every open
        span's and the process's, and reset it."""
        if self.device.type != "cuda":
            return
        p = torch.cuda.max_memory_allocated(self.device)
        self._open = [max(x, p) for x in self._open]
        self._peak = max(self._peak, p)
        torch.cuda.reset_peak_memory_stats(self.device)

    def device_peak(self) -> int:
        """Device bytes allocated at most since the spans were made (the
        caller resets the allocator's peak before the first span)."""
        if self.device.type != "cuda":
            return 0
        return max(self._peak, torch.cuda.max_memory_allocated(self.device))

    def _wrap(self, fn, name: str, work, after):
        spans = self

        def wrapped(*args, **kwargs):
            spans._sync()
            spans._fold()
            spans._open.append(0)
            t = time.perf_counter()
            try:
                with torch.profiler.record_function(PREFIX + name):
                    out = fn(*args, **kwargs)
                    spans._sync()
            finally:
                dt = time.perf_counter() - t
                spans._fold()
                peak = spans._open.pop()
            rec = spans._current
            if rec is not None:
                rec.seconds[name] += dt
                rec.peak[name] = max(rec.peak[name], peak)
                if work is not None:
                    rec.bytes[name] += work(*args, **kwargs)
                if after is not None:
                    rec.after[name].append(after())
            return out
        return wrapped

    def install(self, targets) -> None:
        """Wrap each target once (the first of several naming one
        function wins)."""
        import importlib

        seen = set()
        for mod_name, attr, name, work, after in targets:
            if (mod_name, attr) in seen:
                continue
            seen.add((mod_name, attr))
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, name, work, after))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def begin_run(self) -> None:
        """Open the record of the next window run."""
        self.runs.append(Record())
        self._current = self.runs[-1]

    def begin_profile(self) -> None:
        """Open the profiled run's record; the window's stay as they are."""
        self.profiled = Record()
        self._current = self.profiled

    def mean(self, *names: str) -> float | None:
        """Mean over the window runs that entered any of ``names`` of
        their summed seconds."""
        vals = [sum(r.seconds.get(n, 0.0) for n in names) for r in self.runs
                if any(n in r.seconds for n in names)]
        return sum(vals) / len(vals) if vals else None

    def after_readings(self, name: str) -> list:
        """The ``after`` readings of span ``name`` over the window runs."""
        return [x for r in self.runs for x in r.after.get(name, [])]

    def peak(self, *names: str) -> int | None:
        """Device bytes allocated at most inside any of ``names`` over the
        window runs, or None where none ran or there is no card."""
        vals = [r.peak[n] for r in self.runs for n in names if n in r.peak]
        if self.device.type != "cuda" or not vals:
            return None
        return max(vals)

    def profiled_bytes(self, name: str) -> int:
        """Bytes of the work of span ``name`` in the profiled run."""
        return self.profiled.bytes.get(name, 0) if self.profiled else 0


def union(intervals: np.ndarray) -> np.ndarray:
    """(n, 2) [start, end) intervals -> their disjoint union, sorted."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def covered(merged: np.ndarray, lo: float, hi: float) -> float:
    """Length of ``merged`` (a disjoint union) inside [lo, hi)."""
    if not len(merged) or hi <= lo:
        return 0.0
    s = np.clip(merged[:, 0], lo, hi)
    e = np.clip(merged[:, 1], lo, hi)
    return float((e - s).sum())


class Profile:
    """Device activity of one traced pipeline run (times in seconds)."""

    def __init__(self, events: list[dict]):
        dev, self.ops, self.spans = [], defaultdict(float), []
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            if e.get("cat") in DEVICE_CATS:
                dev.append((ts, ts + dur))
                self.ops[e["name"]] += dur
            elif e.get("cat") == "user_annotation" and \
                    e["name"].startswith(PREFIX):
                self.spans.append((e["name"][len(PREFIX):], ts, ts + dur))
        self.device = union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
        win = [s for s in self.spans if s[0] == "pipeline"]
        self.window = (win[0][1], win[0][2]) if win else (
            (self.device[0, 0], self.device[-1, 1]) if len(self.device)
            else (0.0, 0.0))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return covered(self.device, *self.window)

    def span_device_s(self, name: str) -> float:
        """Device busy time inside the spans called ``name``."""
        return sum(covered(self.device, lo, hi)
                   for n, lo, hi in self.spans if n == name)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        inside the window summed by the innermost span open at each
        gap's middle (what the host was doing)."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        lo, hi = self.window
        d = self.device[(self.device[:, 1] > lo) & (self.device[:, 0] < hi)]
        edges = np.concatenate([[lo], np.clip(d.ravel(), lo, hi), [hi]])
        gaps = edges.reshape(-1, 2)
        idle = defaultdict(float)
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            mid = 0.5 * (g0 + g1)
            inner = [(s1 - s0, n) for n, s0, s1 in self.spans
                     if s0 <= mid < s1]
            idle[min(inner)[1] if inner else "outside"] += g1 - g0
        gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gap_list]}


def profile_run(fn, device, scratch_dir: str) -> Profile:
    """Run ``fn()`` under ``torch.profiler`` (CPU and, on a card, CUDA
    activity) inside a ``kmbench.pipeline`` span; returns its Profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(PREFIX + "pipeline"):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    path = os.path.join(scratch_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return Profile(events)
