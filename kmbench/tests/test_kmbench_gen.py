"""The collection generator: determinism from the seed, shapes, and the
valid-window count against a direct count."""

import numpy as np

from kmbench.gen import make_bank, n_reads, valid_windows
from kmbench.reference.kmers import read_fasta


def _bytes(manifest):
    return [open(s["path"], "rb").read() for s in manifest["samples"]]


def test_same_seed_same_bytes(tiny_traffic, tmp_path):
    _p, t = tiny_traffic
    seed = 2**31 + 12345
    a = make_bank(t, seed, str(tmp_path / "a"))
    b = make_bank(t, seed, str(tmp_path / "b"), workers=2)
    c = make_bank(t, seed + 1, str(tmp_path / "c"))
    assert _bytes(a) == _bytes(b)
    assert _bytes(a) != _bytes(c)


def test_shapes_and_valid_windows(tiny_traffic, tmp_path):
    _p, t = tiny_traffic
    m = make_bank(t, 7, str(tmp_path / "a"))
    assert [s["id"] for s in m["samples"]] == ["S0", "S1", "S2"]
    direct = 0
    for s in m["samples"]:
        codes, lengths = read_fasta(s["path"])
        assert len(lengths) == n_reads(t) == 20 * 20000 // 150
        assert bool((lengths == 150).all()) and bool((codes >= 0).all())
        direct += sum(max(0, int(n) - 31 + 1) for n in lengths.tolist())
    assert valid_windows(m, 31) == direct
    assert valid_windows(m, 151) == 0


def test_isolates_counts():
    import json

    from kmbench import cells

    t = json.load(open(cells.load_cell("count31.isolates")["traffic_path"]))
    m = {"samples": [{"reads": n_reads(t), "read_len": t["read_len"]}]
         * t["samples"]}
    assert n_reads(t) == 928_330
    assert valid_windows(m, 31) == 1_113_996_000


def test_strands_and_errors():
    t = {"genome_bp": 50000, "samples": 2, "read_len": 100, "coverage": 10,
         "snp_rate": 0.0, "error_rate": 0.0, "reverse_share": 0.5,
         "format": "fasta"}
    from kmbench.gen import genome, sample_reads

    g = genome(5, t["genome_bp"])
    rows = sample_reads(t, 5, 0, g)
    text = g.tobytes()
    rc = (3 - g[::-1]).tobytes()
    fwd = sum(r.tobytes() in text for r in rows[:200])
    rev = sum(r.tobytes() in rc for r in rows[:200])
    # about half of the reads on each strand
    assert fwd + rev == 200 and 70 < fwd < 130
    t2 = dict(t, error_rate=0.05)
    noisy = sample_reads(t2, 5, 0, g)
    assert (noisy != rows).mean() > 0.04
