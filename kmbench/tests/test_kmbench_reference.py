"""The reference against hand-checked values and plain-Python models."""

import random

import numpy as np
import pytest
import torch

from kmbench.reference import layout, rows_differing
from kmbench.reference.kmers import (
    Collection, key_minimizers, kx_tally, lpt_table, lpt_violations,
    read_reads, umod, window_minimizers, windows, xxh64_word)

CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
COMP = {"A": "T", "T": "A", "C": "G", "G": "C"}


def val(s):
    v = 0
    for ch in s:
        v = 4 * v + CODE[ch]
    return v


def rc(s):
    return "".join(COMP[c] for c in reversed(s))


def dec(v, n):
    return "".join("ACTG"[(v >> (2 * (n - 1 - i))) & 3] for i in range(n))


def minimizer(kmer, m):
    best = 4 ** m - 1
    for i in range(len(kmer) - m + 1):
        mm = kmer[i:i + m]
        c = min(val(mm), val(rc(mm)))
        if "AA" in dec(c, m)[1:]:
            c = 4 ** m - 1
        best = min(best, c)
    return best


def _fasta(tmp_path, reads, name="s.fasta"):
    p = tmp_path / name
    p.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    return str(p)


def test_hand_checked_counts(tmp_path):
    # k = 5: ACGTA's reverse complement is TACGT; A=0 C=1 T=2 G=3 gives
    # ACGTA = 0b00_01_11_10_00 = 120 and TACGT = 0b10_00_01_11_10 = 542
    assert val("ACGTA") == 120 and val("TACGT") == 542
    reads = ["ACGTACGTA", "TACGTACGT", "ACGNACGTA"]
    path = _fasta(tmp_path, reads)
    coll = Collection([("s", path)], 5, 3, "cpu")
    keys, counts = coll.sample_counts(path)
    want = {}
    for r in reads:
        for i in range(len(r) - 4):
            w = r[i:i + 5]
            if "N" not in w:
                c = min(val(w), val(rc(w)))
                want[c] = want.get(c, 0) + 1
    assert dict(zip(keys.tolist(), counts.tolist())) == want
    # ACGTA and its reverse complement TACGT are one canonical k-mer (120):
    # three times in each of the first two reads, once in the third
    assert want[120] == 7


def test_minimizers_match_the_plain_rule():
    rng = random.Random(3)
    k, m = 11, 4
    lut = torch.from_numpy(layout.masked_minimizer_lut(m))
    seqs = ["".join(rng.choice("ACGT") for _ in range(40)) for _ in range(30)]
    seqs.append("AAAAAAAAAAAAAAAACAAAAAA")
    L = max(map(len, seqs))
    codes = np.full((len(seqs), L), -1, np.int8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = [CODE[c] for c in s]
    t = torch.from_numpy(codes)
    minim = window_minimizers(t, k, m, lut)
    fwd, rcv, valid = windows(t, k)
    for i, s in enumerate(seqs):
        for j in range(len(s) - k + 1):
            w = s[j:j + k]
            assert bool(valid[i, j])
            assert int(fwd[i, j]) == val(w) and int(rcv[i, j]) == val(rc(w))
            assert int(minim[i, j]) == minimizer(w, m)
            key = torch.tensor([min(val(w), val(rc(w)))])
            assert int(key_minimizers(key, k, m, lut)[0]) == minimizer(w, m)
        assert not valid[i, len(s) - k + 1:].any()


def test_kx_tally_matches_a_loop():
    rng = random.Random(5)
    k, m = 9, 3
    lut = torch.from_numpy(layout.masked_minimizer_lut(m))
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(5, 60)))
            for _ in range(50)]
    want = np.zeros(4 ** m, np.int64)
    for s in seqs:
        prev = None
        run_len = 0
        for j in range(len(s) - k + 1):
            w = s[j:j + k]
            mz, fw = minimizer(w, m), val(w) <= val(rc(w))
            if prev is None or prev != (mz, fw):
                run_len = 0
            if run_len % 4 == 0:
                want[mz] += 1
            run_len += 1
            prev = (mz, fw)
    L = max(map(len, seqs))
    codes = np.full((len(seqs), L), -1, np.int8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = [CODE[c] for c in s]
    bins = torch.zeros(4 ** m, dtype=torch.int64)
    kx_tally(torch.from_numpy(codes), k, m, lut, bins)
    assert bins.numpy().tolist() == want.tolist()


def test_xxh64_matches_xxhash():
    xxhash = pytest.importorskip("xxhash")
    vals = [0, 1, 2**62 + 12345, 2**63 - 1, -1, -(2**63), 0x0123456789ABCDEF]
    h = xxh64_word(torch.tensor(vals, dtype=torch.int64))
    for v, got in zip(vals, h.tolist()):
        want = xxhash.xxh64_intdigest((v % 2**64).to_bytes(8, "little"))
        assert got % 2**64 == want
        assert int(umod(torch.tensor([got]), 2_500_032)[0]) == want % 2_500_032


def test_lpt_accepts_any_tie_order_and_rejects_a_swap():
    rng = np.random.default_rng(1)
    bins = rng.integers(0, 6, 500)
    assert lpt_violations(bins, lpt_table(bins, 4), 4) == 0
    for trial in range(5):
        # greedy with ties broken at random: any such table passes
        order = np.lexsort((rng.random(len(bins)), -bins))
        loads = np.zeros(4, np.int64)
        table = np.zeros(len(bins), np.uint16)
        for i in order:
            low = np.flatnonzero(loads == loads.min())
            p = rng.choice(low)
            table[i] = p
            loads[p] += bins[i]
        assert lpt_violations(bins, table, 4) == 0
    bins = np.array([10, 1, 1, 1])
    assert lpt_violations(bins, np.array([0, 1, 1, 1], np.uint16), 2) == 0
    assert lpt_violations(bins, np.array([0, 0, 1, 1], np.uint16), 2) == 1
    assert lpt_violations(bins, np.array([0, 2, 1, 1], np.uint16), 2) > 0


def test_partition_count_rule():
    # under about 7.2 billion 31-mers at 8192 MB the floor of 4 holds
    assert layout.nb_partitions(1_113_996_000, 31, 8192) == 4
    assert layout.nb_partitions(7_000_000_000, 31, 8192) == 4
    assert layout.nb_partitions(8_000_000_000, 31, 8192) == 5
    assert layout.window_bits(10_000_000, 4) == 2_500_032


def test_read_fasta_refuses_multiline_records(tmp_path):
    p = tmp_path / "m.fasta"
    p.write_text(">a\nACGT\nACGT\n>b\nAC\n")
    with pytest.raises(ValueError):
        read_reads(str(p))


@pytest.mark.parametrize("text", [
    "@a\nACGT\n-\nIIII\n",             # separator not '+'
    "@a\nACGT\n+\nIII\n",              # quality shorter than the bases
    "@a\nACGT\n+\nIIIII\n",            # longer
    "@a\nACGT\n+\nIIII\n@b\nAC\n+\n",  # a record cut short
    "@a\nACGT\nACGT\n+\nIIIIIIII\n",    # two sequence lines
])
@pytest.mark.parametrize("gz", [False, True])
def test_read_fastq_refuses_malformed_records(tmp_path, text, gz):
    import gzip

    p = tmp_path / "m.fastq"
    data = text.encode()
    p.write_bytes(gzip.compress(data) if gz else data)
    with pytest.raises(ValueError):
        read_reads(str(p))


def test_read_fastq_and_gzip_as_fasta(tmp_path):
    import gzip

    reads = ["ACGTNACG", "TTGCA", "GGGGCCCCAAAATTTT"]
    fa = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads))
    fq = "".join(f"@r{i}\n{r}\n+r{i}\n{'@' * len(r)}\n"
                 for i, r in enumerate(reads))
    want_codes, want_lengths = read_reads(_fasta(tmp_path, reads))
    assert want_lengths.tolist() == [8, 5, 16]
    for name, data in [("a.fastq", fq.encode()),
                       ("a.fasta.gz", gzip.compress(fa.encode())),
                       ("a.fastq.gz", gzip.compress(fq.encode()))]:
        p = tmp_path / name
        p.write_bytes(data)
        codes, lengths = read_reads(str(p))
        assert torch.equal(codes, want_codes)
        assert torch.equal(lengths, want_lengths)


def test_rows_differing():
    ek = np.array([1, 5, 9], np.uint64)
    ec = np.array([[1, 0], [2, 2], [0, 3]], np.int64)
    assert rows_differing(ek, ec, ek, ec) == 0
    assert rows_differing(ek, ec, ek[:2], ec[:2]) == 1
    bad = ec.copy()
    bad[1, 1] = 7
    assert rows_differing(ek, ec, ek, bad) == 2
    assert rows_differing(ek, ec, np.array([1, 5, 5, 9], np.uint64),
                          np.array([[1, 0], [2, 2], [2, 2], [0, 3]])) == 1


def test_options_of_every_cell():
    from kmbench import cells
    from kmbench.reference import options

    for w in cells.benchmark()["workloads"]:
        opts = options(cells.pipeline_args(cells.load_cell(w["name"])))
        assert opts["k"] == 31 and opts["m"] == 10 and opts["hard_min"] == 2


@pytest.mark.parametrize("args", [
    ["--soft-min", "3"], ["--share-min", "2"], ["--recurrence-min", "2"],
    ["--minimizer-type", "1"], ["--repartition-type", "1"],
    ["--nb-partitions", "8"], ["--bitw", "4"], ["--mmer-scheme", "forward"],
    ["--cpr"], ["--static-repart"], ["--kff-output"], ["--hist"],
    ["--restrict-to", "0.5"], ["--repart-from", "x"],
    ["--mode", "kmer:pa:bin"], ["--mode", "hash:count:bin"],
    ["--kmer-size", "63"], ["--minimizer-size", "31"],
])
def test_options_the_reference_does_not_model_are_refused(args):
    from kmbench.reference import options

    with pytest.raises(ValueError):
        options(["--kmer-size", "31", *args])


def test_options_that_leave_the_outputs_alone_pass():
    from kmbench.reference import options

    o = options(["--soft-min", "1", "--threads", "4", "--backend", "device",
                 "--mode", "hash:bft:bin", "--bloom-size", "8000",
                 "--max-memory", "100", "--hard-min", "3"])
    assert o == {"mode": "hash:bft:bin", "k": 31, "m": 10, "hard_min": 3,
                 "bloom_size": 8000, "max_memory": 100}


def test_a_run_refuses_a_configuration_it_cannot_judge(tiny_cell):
    from kmbench import run

    with pytest.raises(ValueError, match="--soft-min"):
        run.run_cell(tiny_cell(args=("--max-memory", "1", "--soft-min", "3")),
                     2**31 + 5, 0.5, False, device="cpu")


def _gatb_loop(path, threshold=50_000, chunk=256 * 1024):
    """GATB's estimate as a loop: lines from chunks of the inflated stream,
    records counted until one more than ``threshold`` is consumed, then
    scaled by the file's size (four times where the path ends in its first
    "gz") over the bytes fetched."""
    import gzip
    import os

    gz = open(path, "rb").read(2) == b"\x1f\x8b"
    f = gzip.open(path, "rb") if gz else open(path, "rb")
    fetched, buf, lines_out = 0, b"", []

    def lines():
        nonlocal fetched, buf
        while True:
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                yield line
            c = f.read(chunk)
            fetched += len(c)
            if not c:
                return
            buf += c

    def records(it):
        first = next(it)
        if first.startswith(b">"):
            n = 0
            for line in it:
                if line.startswith(b">"):
                    yield n
                    n = 0
                else:
                    n += len(line)
            yield n
        else:
            while True:
                yield len(next(it))
                next(it)
                next(it)
                try:
                    next(it)
                except StopIteration:
                    return

    number = total = 0
    with f:
        for n in records(lines()):
            if number > threshold:
                break
            number += 1
            total += n
    size = os.path.getsize(path) * (4 if path.find("gz") == len(path) - 2
                                    else 1)
    ratio = np.float32(np.float32(size) / np.float32(fetched))
    return number * size // fetched, int(np.float32(total) * ratio)


@pytest.mark.parametrize("reads", [3, 50_001, 50_002, 50_003, 61_234])
@pytest.mark.parametrize("name", ["s.fasta", "s.fastq", "s.fasta.gz",
                                  "s.fastq.gz", "gz_s.fastq.gz"])
def test_estimate_matches_the_gatb_loop(tmp_path, reads, name):
    import gzip

    from kmbench.reference.kmers import estimate, read_bytes

    rng = np.random.default_rng(reads)
    lens = rng.integers(20, 60, reads)
    seqs = ["ACGT"[int(rng.integers(4))] * int(n) for n in lens]
    if ".fastq" in name:
        text = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                       for i, s in enumerate(seqs))
    else:
        text = "".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs))
    data = text.encode()
    p = tmp_path / name
    p.write_bytes(gzip.compress(data) if name.endswith(".gz") else data)
    got = estimate(read_bytes(str(p)), str(p))
    assert got == _gatb_loop(str(p))
    if reads <= 50_001 and not name.endswith(".gz"):
        assert got == (reads, int(lens.sum()))
