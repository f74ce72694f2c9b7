"""On the card: the reference agrees with a sound run and the control
fails, at a size a test run holds (the cells' own sizes run through
``python -m kmbench.run`` and ``python -m kmbench.control``).

    python -m pytest kmbench/tests -o addopts="" -m chip -p no:randomly
"""

import json

import pytest

from kmbench import cells, run

pytestmark = pytest.mark.chip

MID = {"genome_bp": 1_000_000, "samples": 3, "read_len": 150,
       "coverage": 30, "snp_rate": 0.001, "error_rate": 0.001,
       "reverse_share": 0.5, "format": "fasta"}


def _cell(name, tmp_path, args):
    path = tmp_path / "mid.json"
    path.write_text(json.dumps(MID))
    cell = cells.load_cell(name)
    cell.update(traffic_path=str(path), traffic_spec=MID, args=list(args))
    return cell


@pytest.mark.parametrize("name,args", [
    ("count31.isolates", ["--max-memory", "100"]),
    ("howde31.isolates", ["--max-memory", "100"]),
    ("count31.isolates.onestep", []),
])
def test_sound_run_on_the_card(cuda_device, tmp_path, monkeypatch, name,
                               args):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    r = run.run_cell(_cell(name, tmp_path, args), 4242, 1.0, False,
                     device=cuda_device)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name,number", [("count31.isolates", "rows_bad"),
                                         ("howde31.isolates",
                                          "bloom_bytes_bad")])
def test_control_fails_on_the_card(cuda_device, tmp_path, name, number):
    from kmbench.control import control_checks
    from kmbench.gen import make_bank

    manifest = make_bank(MID, 99, str(tmp_path / "bank"))
    checks = control_checks(_cell(name, tmp_path, []), manifest, cuda_device)
    assert checks[number] > 0
