"""The gzipped-FASTQ cell (``count31.isolates.fastqgz``): the count
configuration over a ``fastq.gz`` collection, judged by the default
reference. Its rate spreads too widely between runs to be gated, so, as
in ``howde31.isolates``, it is reported per layer as
``kmers_per_s.window`` in traced runs only."""

import json

from kmbench import cells, run


def _cell(tiny_traffic, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    _path, traffic = tiny_traffic
    traffic = dict(traffic, format="fastq.gz")
    path = tmp_path / "tiny-fastqgz.json"
    path.write_text(json.dumps(traffic))
    cell = cells.load_cell("count31.isolates.fastqgz")
    assert cell["traffic_spec"]["format"] == "fastq.gz"
    cell.update(traffic_path=str(path), traffic_spec=traffic,
                args=["--max-memory", "1"])
    return cell


def test_fastqgz_line_leaves_out_the_rate(tiny_traffic, tmp_path,
                                          monkeypatch):
    r = run.run_cell(_cell(tiny_traffic, tmp_path, monkeypatch), 2**31 + 5,
                     0.2, False, device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"peak_device_gib", "peak_host_gib",
                                 "setup_s"}


def test_traced_fastqgz_line_reports_the_rate_per_layer(
        tiny_traffic, tmp_path, monkeypatch):
    r = run.run_cell(_cell(tiny_traffic, tmp_path, monkeypatch), 2**31 + 6,
                     0.2, True, device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"kmers_per_s.window"}
    assert r["metrics"]["kmers_per_s.window"]["value"] > 0
