"""The benchmark's data files, found by name.

A cell is ``kmbench/workloads/<cell>.json`` (its configuration, its
traffic mix and any options of its own); a configuration is
``kmbench/configs/<name>.json`` (the ``pipeline`` options of a
deployment, with its source, what was assumed and what was reduced); a
traffic mix is ``kmbench/traffic/<name>.json`` (the read collection's
parameters and file format, see :mod:`kmbench.gen`); a per-layer metric is
a reader ``kmbench/metrics/<name>.py``, which also names the spans it
reads. A configuration may name its own reference module (see
:func:`reference`).
``BENCHMARK.json`` at the root of the checkout says which per-layer
metrics each cell reports.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REFERENCE = "kmbench.reference"


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """A cell with its configuration and traffic mix read in."""
    cell = load("workloads", name)
    cell["name"] = name
    cell["config_spec"] = load("configs", cell["config"])
    cell["traffic_path"] = os.path.join(HERE, "traffic",
                                        f"{cell['traffic']}.json")
    cell["traffic_spec"] = load("traffic", cell["traffic"])
    return cell


def pipeline_args(cell: dict) -> list[str]:
    """The ``pipeline`` options of a cell: its configuration's, then its
    own (a later option overrides an earlier one)."""
    return list(cell["config_spec"]["options"]) + list(cell.get("args", []))


def option(args: list[str], name: str, default: str) -> str:
    """The last value given to ``name`` in ``args``."""
    value = default
    for i, a in enumerate(args[:-1]):
        if a == name:
            value = args[i + 1]
    return value


def reference(cell: dict):
    """The reference module that judges ``cell``: the one its
    configuration names under ``"reference"``, else :mod:`kmbench.reference`.
    Raises ``ValueError`` on a name outside that package and on a module
    that lacks one of :data:`kmbench.reference.INTERFACE`; an import error
    of a module that is not there propagates."""
    name = cell["config_spec"].get("reference", REFERENCE)
    if not re.fullmatch(re.escape(REFERENCE) + r"(\.[A-Za-z_][A-Za-z0-9_]*)*",
                        name):
        raise ValueError(f"a configuration's reference is a module inside "
                         f"{REFERENCE}, not {name!r}")
    from kmbench.reference import INTERFACE

    mod = importlib.import_module(name)
    missing = [f for f in INTERFACE if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"reference {name} lacks {', '.join(missing)}")
    return mod


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def end_to_end(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics that ``cell`` reports."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics that ``cell`` reports."""
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """``kmbench/metrics/<metric>.py``: its ``read(ctx)``, and its
    ``SPANS``, the spans it reads (see :class:`kmbench.trace.Spans`)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "kmbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
