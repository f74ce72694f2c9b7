"""The collection generator: determinism from the seed, shapes, the
valid-window count against a direct count, and the file formats."""

import gzip
import hashlib
import os

import pytest
import torch

from kmbench.gen import make_bank, n_reads, valid_windows
from kmbench.reference.kmers import read_reads


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
        codes, lengths = read_reads(s["path"])
        assert len(lengths) == n_reads(t) == 20 * 20000 // 150
        assert bool((lengths == 150).all()) and bool((codes >= 0).all())
        direct += sum(max(0, int(n) - 31 + 1) for n in lengths.tolist())
    assert valid_windows(m, 31) == direct
    assert valid_windows(m, 151) == 0


# sha256 of each sample's file of the tiny traffic at seed 2**31 + 12345,
# as the generator wrote them before it wrote any other format
FASTA_SHA256 = [
    "4b9300f0453a082965985f2cb77a061832139cf8f63be16965b4084d73434f91",
    "a65d369025a7981e0f41315c3d14f9ca0d57abd948be39b7ac358a0ce0012d73",
    "4e58af31023d6b3698b62ef897045d6b88ac652521cf528805f11929fdaa1d8d"]


def test_fasta_bank_is_unchanged(tiny_traffic, tmp_path):
    _p, t = tiny_traffic
    m = make_bank(t, 2**31 + 12345, str(tmp_path / "a"))
    assert [hashlib.sha256(b).hexdigest() for b in _bytes(m)] == FASTA_SHA256
    assert [os.path.basename(s["path"]) for s in m["samples"]] == [
        "S0.fasta", "S1.fasta", "S2.fasta"]
    assert m["format"] == "fasta"
    assert m["bytes"] == sum(s["bytes"] for s in m["samples"]) == 3 * 426560


@pytest.mark.parametrize("fmt", ["fastq", "fasta.gz", "fastq.gz"])
def test_formats_parse_as_the_fasta(tiny_traffic, tmp_path, fmt):
    _p, t = tiny_traffic
    seed = 2**31 + 12345
    plain = make_bank(t, seed, str(tmp_path / "fasta"))
    m = make_bank(dict(t, format=fmt), seed, str(tmp_path / "x"))
    assert m["format"] == fmt
    assert valid_windows(m, 31) == valid_windows(plain, 31)
    for a, b in zip(plain["samples"], m["samples"]):
        assert b["path"].endswith(f"{b['id']}.{fmt}")
        assert b["bytes"] == os.path.getsize(b["path"])
        ca, la = read_reads(a["path"])
        cb, lb = read_reads(b["path"])
        assert torch.equal(ca, cb) and torch.equal(la, lb)
    raw = open(m["samples"][0]["path"], "rb").read()
    if fmt.endswith(".gz"):
        # gzip at its default level 6, with no time stamp, so that one
        # seed gives the same bytes
        inner = gzip.decompress(raw)
        assert raw == gzip.compress(inner, compresslevel=6, mtime=0)
        assert raw[4:8] == bytes(4)
        raw = inner
    if fmt.startswith("fastq"):
        head, bases, sep, qual = raw.split(b"\n")[:4]
        assert head == b"@S0_" + b"0" * len(str(n_reads(t) - 1))
        assert sep == b"+" and qual == b"I" * len(bases) == b"I" * 150
    else:
        assert raw == open(plain["samples"][0]["path"], "rb").read()


def test_unknown_format_is_refused_before_anything_is_written(
        tiny_traffic, tmp_path):
    _p, t = tiny_traffic
    out = tmp_path / "bank"
    for fmt in ("bam", "fasta.bz2", None):
        with pytest.raises(ValueError, match="format"):
            make_bank(dict(t, format=fmt), 3, str(out), workers=2)
        assert not out.exists()


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
