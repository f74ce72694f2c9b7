"""BENCHMARK.json against the benchmark's files, and the result line."""

import json
import os
import re

import pytest

from kmbench import cells, run

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@pytest.fixture(scope="module")
def bench():
    return cells.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "-m", "kmbench.run"]
    assert bench["paths"] == ["kmbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_cells_match_their_files(bench):
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        spec = cells.load("configs", c["name"])
        assert c["file"] == f"kmbench/configs/{c['name']}.json"
        assert c["source"] == spec["source"]
        assert c["reduced"] == spec["reduced"]
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert w["config"] in names and len(w["why"]) <= 200
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(names)


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"kmers_per_s", "peak_device_gib", "peak_host_gib",
            "setup_s"} <= e2e
    cellnames = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cellnames
        assert os.path.exists(os.path.join(cells.HERE, "metrics",
                                           m["name"] + ".py"))
        cells.reader(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in cellnames:
        assert cells.per_layer(bench, c)
        # every cell reports set-up and one more end-to-end metric, and
        # a per-layer metric moves one that its cells report
        reported = {m["name"] for m in bench["end_to_end"]
                    if c in m.get("workloads", [c])}
        assert "setup_s" in reported and len(reported) >= 2
        for m in cells.per_layer(bench, c):
            assert m["moves"] in reported, (c, m["name"])


def test_result_line(tiny_cell):
    r = run.run_cell(tiny_cell(), 5, 0.2, False, device="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"kmers_per_s", "peak_device_gib",
                                 "peak_host_gib", "setup_s"}
    assert r["metrics"]["kmers_per_s"]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_traced_result_line(tiny_cell):
    r = run.run_cell(tiny_cell(), 6, 0.2, True, device="cpu")
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # BENCHMARK.json's per-layer metrics of the cell, less two that need a
    # card: kernel.merge_roofline (no kernel runs on the CPU, so its reader
    # finds no device time) and device.idle_share (the profiled run's
    # device is busy 0 s on the CPU)
    assert set(r["metrics"]) == {
        "repart.wall_s", "repart.tally_wait_s", "repart.parse_s",
        "repart.pack_s", "repart.upload_s", "engine.chunk_loop_s",
        "engine.decode_wait_s", "engine.decode_s", "engine.chunk_step_s",
        "engine.tail_s", "tail.fetch_s", "tail.merge_dense_s",
        "tail.write_s"}


def test_howde_line_leaves_out_the_rate(tiny_cell):
    """An end-to-end metric is reported only in the cells it lists."""
    r = run.run_cell(tiny_cell("howde31.isolates", "isolates-howde-k31"),
                     8, 0.2, False, device="cpu")
    assert r["correct"]
    assert set(r["metrics"]) == {"peak_device_gib", "peak_host_gib",
                                 "setup_s"}


def test_traced_howde_line(tiny_cell):
    """The HowDe-SBT cell reports the window's rate per layer (its runs
    spread too widely for it end to end); on the CPU its device peaks
    stay out."""
    r = run.run_cell(tiny_cell("howde31.isolates", "isolates-howde-k31"),
                     7, 0.2, True, device="cpu")
    assert r["correct"]
    assert set(r["metrics"]) == {"kmers_per_s.window", "format.wall_s"}
    assert r["metrics"]["kmers_per_s.window"]["value"] > 0
