"""Spans of one pipeline run.

A span times one interval of the program on the host clock
(``time.perf_counter``) and adds its seconds, one call and ``n`` units of
work (rows, bytes, windows) to the run's record under its name; a
counter (:func:`count`) adds one call and its units and no seconds. The
record is one per process, shared by every thread (the prefetch,
tally-producer and ``-t`` pool threads open spans too), and :func:`begin_run` / :func:`end_run` bracket it around one
``run_pipeline``: ``end_run`` freezes it as :data:`last_run`, a dict of
``name -> {"s", "calls", "n"}``, and logs it as one debug line.

While a ``torch.profiler`` profile is active a span also opens
``record_function("km." + name)``, which puts it into the trace on the
profiler's own clock beside the kernels it launched (a background
thread's spans may not appear there: their host totals are in the record
alone). Off the profiler a span costs two clock reads and a locked add.
Spans never synchronise the device and allocate nothing on it; they sit
at per-run, per-chunk, per-block and per-partition boundaries only.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

log = logging.getLogger("kmtricks_tpu")

PREFIX = "km."

_lock = threading.Lock()
_record: dict = {}

# the record of the most recent run_pipeline, frozen by end_run
last_run: dict = {}


def _add(name: str, seconds: float, calls: int, n: int) -> None:
    with _lock:
        entry = _record.get(name)
        if entry is None:
            _record[name] = {"s": seconds, "calls": calls, "n": n}
        else:
            entry["s"] += seconds
            entry["calls"] += calls
            entry["n"] += n


class span:
    """``with span(name, n):`` times the block into the run's record.
    ``n`` may also be set on the span inside the block, once the work is
    known; after the block ``s`` holds the block's seconds."""

    __slots__ = ("name", "n", "s", "_t", "_rf")

    def __init__(self, name: str, n: int = 0):
        self.name, self.n, self.s = name, n, 0.0
        self._rf = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.s = time.perf_counter() - self._t
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _add(self.name, self.s, 1, int(self.n))
        return False


def count(name: str, n: int) -> None:
    """Add ``n`` units of work and one call, and no seconds, to the run's
    record under ``name``: a counter, read like a span's ``n``."""
    _add(name, 0.0, 1, int(n))


def begin_run() -> None:
    """Start a run's record (what spans added before it is dropped)."""
    with _lock:
        _record.clear()


def end_run() -> dict:
    """Freeze the run's record as :data:`last_run`, log it at debug level,
    and return it."""
    global last_run
    with _lock:
        frozen = {name: dict(e) for name, e in _record.items()}
        _record.clear()
    last_run = frozen
    if log.isEnabledFor(logging.DEBUG):
        log.debug("spans: %s", "; ".join(
            f"{name} {e['s']:.6f} s x{e['calls']} n={e['n']}"
            for name, e in sorted(frozen.items())))
    return frozen
