"""The program's own spans, as the benchmark reads them.

``kmtricks_tpu_torch.runtime.trace`` keeps one record per pipeline run,
``name -> {"s", "calls", "n"}`` (each span's summed host seconds, its
calls and its units of work), and ``run_pipeline`` freezes it with
``trace.end_run()`` as it returns. :data:`SPANS` opens the benchmark's
span ``program`` around that ``end_run``, with an ``after`` that copies
the frozen record, so each window run keeps its record (:func:`mean_s`).
Every reader of the record names this one target:
:class:`kmbench.trace.Spans` wraps a function once, for the first reader
that names it. A program without the module (before it had spans) gives
an empty ``SPANS`` and every reading None, so those metrics stay out of
the line.
"""

from __future__ import annotations

import importlib.util

TRACE = "kmtricks_tpu_torch.runtime.trace"
NAME = "program"            # the benchmark's span around trace.end_run


def _has_trace() -> bool:
    try:
        return importlib.util.find_spec(TRACE) is not None
    except ImportError:
        return False


def _frozen() -> dict:
    from kmtricks_tpu_torch.runtime import trace
    return {name: dict(e) for name, e in trace.last_run.items()}


SPANS = ((TRACE, "end_run", NAME, None, _frozen),) if _has_trace() else ()


def mean_s(ctx, *names: str) -> float | None:
    """Mean over the window runs whose record holds any of ``names`` of
    their summed seconds; None where no run's does."""
    vals = [sum(r[n]["s"] for n in names if n in r)
            for r in ctx.spans.after_readings(NAME)
            if any(n in r for n in names)]
    return sum(vals) / len(vals) if vals else None
