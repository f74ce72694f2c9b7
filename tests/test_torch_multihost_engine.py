"""Several processes, the engine's tails and decode: the port's streaming
engine over two gloo ranks (each a mesh of 4 CPU shards) against
tests/test_multihost.py's single-process 8-device JAX engine, run
directories byte for byte: histograms summed over the ranks with a float
soft-min (the ``.hist`` files and ``merge_amin.txt``), ``kmer:pa:bin``
through the pa-bits tail, heterogeneous banks (one rank decodes the big
bank while the other runs dry and feeds empty chunks) and
``hash:count:bin``. Helpers and the step and count cases are in
tests/test_torch_multihost.py."""

import numpy as np

from test_multihost import _gen_bank, _single_proc_engine
from test_torch_multihost import (assert_decode_shares,
                                  assert_same_run_dirs, run_ranks)


def test_two_rank_hist_and_float_soft_min(tmp_path):
    """Each rank histograms its partitions' rows, the planes are summed
    over the ranks, rank 0 writes the histograms and the quantile
    thresholds, and every rank merges with the same thresholds."""
    fof = _gen_bank(tmp_path)
    last = run_ranks(tmp_path, fof, 2, soft_min="0.6", hist="1")
    assert_decode_shares(last, 600)
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:count:bin", "0.6",
                        "1")
    assert_same_run_dirs(tmp_path / "run_mp", tmp_path / "run_sp",
                         hists=True)


def test_two_rank_pa_bits_tail(tmp_path):
    """``kmer:pa:bin`` takes the pa-bits tail on each rank's shards, each
    partition's statistics from its owner shard."""
    fof = _gen_bank(tmp_path)
    last = run_ranks(tmp_path, fof, 2, mode="kmer:pa:bin")
    assert [r["tail"] for r in last] == ["pa_bits", "pa_bits"]
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:pa:bin", "2", "0")
    assert_same_run_dirs(tmp_path / "run_mp", tmp_path / "run_sp",
                         mode="kmer:pa:bin")
    assert any(len((tmp_path / "run_mp" / "matrices" /
                    f"matrix_{p}.pa").read_bytes()) > 64 for p in range(8))


def test_two_rank_heterogeneous_banks(tmp_path):
    """Banks of 500, 60 and 40 reads (interior 'N' in the second): the
    sample owners give one rank the big bank and the other the two small
    ones, which runs dry first and feeds empty chunks until the has-data
    agreement ends the stream."""
    rng = np.random.default_rng(123)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=9000)
    lines = []
    for s, nreads in enumerate((500, 60, 40)):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for r in range(nreads):
                start = int(rng.integers(0, len(genome) - 130))
                seq = bytearray(genome[start:start + 130].tobytes())
                if s == 1 and r % 3 == 0:
                    seq[50] = ord("N")
                f.write(b">r%d\n" % r + bytes(seq) + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "s.fof"
    fof.write_text("\n".join(lines) + "\n")
    last = run_ranks(tmp_path, fof, 2)
    assert sorted(assert_decode_shares(last, 600)) == [100, 500]
    assert last[0]["chunks"] == last[1]["chunks"]
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:count:bin", "2",
                        "0")
    assert_same_run_dirs(tmp_path / "run_mp", tmp_path / "run_sp")


def test_two_rank_hash_mode(tmp_path):
    """``hash:count:bin`` (window hashes in the h2 layout) over two
    ranks."""
    fof = _gen_bank(tmp_path, seed=303)
    last = run_ranks(tmp_path, fof, 2, mode="hash:count:bin")
    assert_decode_shares(last, 600)
    _single_proc_engine(fof, tmp_path / "run_sp", "hash:count:bin", "2",
                        "0")
    assert_same_run_dirs(tmp_path / "run_mp", tmp_path / "run_sp",
                         mode="hash:count:bin")
