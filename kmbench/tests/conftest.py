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
    scratch under ``tmp_path``; ``args`` force the streaming engine."""
    from kmbench import cells

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    path, traffic = tiny_traffic

    def make(name="count31.isolates", config="isolates-count-k31",
             args=("--max-memory", "1")):
        return {"name": name, "config": config,
                "config_spec": cells.load("configs", config),
                "traffic_path": path, "traffic_spec": traffic, "chips": 1,
                "args": list(args)}
    return make
