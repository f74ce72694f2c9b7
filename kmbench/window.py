"""The measured window and the rate taken over it.

The window runs whole pipelines back to back and ends with the first one
that ends at or after ``seconds``; a rate divides all the work completed
by all of that time, so a run that overruns the nominal length counts in
full, work and time alike.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    runs: list = field(default_factory=list)     # (start, end) per run
    error: BaseException | None = None

    @property
    def elapsed(self) -> float:
        return self.end - self.start


def run_window(run_once, seconds: float, clock=time.perf_counter) -> Window:
    """Call ``run_once(i)`` for i = 0, 1, ... until a call ends at or
    after ``seconds`` past the first call's start. An exception ends the
    window; it is kept in ``error`` and its run does not count."""
    w = Window(start=clock())
    i = 0
    while True:
        t = clock()
        try:
            run_once(i)
        except Exception as e:  # noqa: BLE001 - reported as a failed run
            w.error = e
            w.end = clock()
            return w
        w.end = clock()
        w.runs.append((t, w.end))
        i += 1
        if w.end - w.start >= seconds:
            return w


def rate(work_per_run: float, window: Window) -> float:
    """Work of every completed run over the window's elapsed time."""
    if window.elapsed <= 0:
        return 0.0
    return work_per_run * len(window.runs) / window.elapsed
