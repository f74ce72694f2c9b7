"""Tests of the benchmark itself. Those that need the card carry the
``chip`` marker and skip, from inside the ``cuda_device`` fixture, where
there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips elsewhere)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_traffic(tmp_path):
    """A small collection's traffic mix, written to a file."""
    import json

    t = {"genome_bp": 20000, "samples": 3, "read_len": 150, "coverage": 20,
         "snp_rate": 0.001, "error_rate": 0.002, "reverse_share": 0.5,
         "format": "fasta"}
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(t))
    return str(path), t


@pytest.fixture
def tiny_cell(tiny_traffic, tmp_path, monkeypatch):
    """A cell of a named configuration on the small collection, its
    scratch under ``tmp_path``; ``args`` force the streaming engine;
    ``fmt`` is the collection's file format and ``reference`` a reference
    module for the configuration to name."""
    import json

    from kmbench import cells

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    path, traffic = tiny_traffic

    def make(name="count31.isolates", config="isolates-count-k31",
             args=("--max-memory", "1"), fmt="fasta", reference=None):
        spec = cells.load("configs", config)
        if reference is not None:
            spec["reference"] = reference
        t, p = traffic, path
        if fmt != traffic["format"]:
            t = dict(traffic, format=fmt)
            p = str(tmp_path / f"tiny-{fmt}.json")
            with open(p, "w") as f:
                json.dump(t, f)
        return {"name": name, "config": config, "config_spec": spec,
                "traffic_path": p, "traffic_spec": t, "chips": 1,
                "args": list(args)}
    return make
