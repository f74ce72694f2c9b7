"""The port's repartition tally (``ops/repart_sample.py``, driven by
``runtime/pipeline.py::_sample_minimizer_bins_device``) against the JAX
package's ``tally_step`` and against the host numpy tally, on the cases of
tests/test_repart_sampler.py; ``stage_repart``'s table against the JAX
package's; and ``--static-repart``'s partitions against the JAX package's
``static_partitions`` and ``Repartition.from_xxh``. Every output is an
integer: exact equality."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmtricks_tpu.core.repartition import Repartition as JaxRepartition
from kmtricks_tpu.ops import repart_sample as jrs
from kmtricks_tpu.ops.encode import pack_2bit_host
from kmtricks_tpu.ops import xxh64 as jxx
from kmtricks_tpu.runtime import pipeline as JP
from kmtricks_tpu_torch.core.kmer import ASCII_CODE_TABLE, ASCII_VALID_TABLE
from kmtricks_tpu_torch.core.repartition import Repartition
from kmtricks_tpu_torch.ops import repart_sample as rs
from kmtricks_tpu_torch.ops.xxh64 import static_partitions, xxh64_u32
from kmtricks_tpu_torch.runtime import pipeline as P

torch.set_num_threads(2)


def random_reads(rng, n, lmin, lmax, n_frac=0.05):
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        s = rng.choice(alphabet, size=ln)
        s[rng.random(ln) < n_frac] = ord("N")
        reads.append(bytes(s))
    return reads


def fake_run(tmp_path, reads, k, m):
    """A kmdir and config with just what the samplers read."""
    p = tmp_path / "s.fasta"
    p.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in
                         enumerate(reads)))
    kmdir = types.SimpleNamespace(fof=[types.SimpleNamespace(paths=[str(p)])])
    config = types.SimpleNamespace(kmer_size=k, minim_size=m,
                                   seq_number=len(reads))
    return kmdir, config


def one_block(reads, width=128):
    """All reads as one 'N'-padded (B, L) block, L the longest read
    rounded up to a multiple of ``width`` (at least ``width``)."""
    L = max(width, -(-max(len(r) for r in reads) // width) * width)
    batch = np.full((len(reads), L), ord("N"), np.uint8)
    for i, r in enumerate(reads):
        batch[i, :len(r)] = np.frombuffer(r, np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    return batch, lengths


def host_tally(batch, k, m, freq=None):
    """The host numpy tally of one block, rows cut by an 'N' column, as
    ``sample_minimizer_bins`` tallies a parsed batch."""
    flat = np.hstack([batch, np.full((len(batch), 1), ord("N"),
                                     np.uint8)]).ravel()
    bins = np.zeros(4 ** m, np.int64)
    P._tally_kxmer_starts(bins, ASCII_CODE_TABLE[flat],
                          ASCII_VALID_TABLE[flat], k, m, freq)
    return bins


def tally_both(reads, k, m, freq=None, width=8):
    """One block through the JAX package's tally_step ((L, B) layout, 2-bit
    packed by its ``pack_2bit_host``, L a multiple of 128) and the port's
    (raw bytes (B, L), L the longest read rounded up to ``width``); returns
    both (4^m,) tallies as int64."""
    batch, lengths = one_block(reads)
    packed, vbits = pack_2bit_host(batch)
    use_freq = freq is not None
    fj = (np.asarray(freq, np.int64).astype(np.int32) if use_freq
          else np.zeros(1, np.int32))
    exp = jrs.tally_step(jrs.make_bins(m), jnp.asarray(packed.T.copy()),
                         jnp.asarray(vbits.T.copy()), jnp.asarray(lengths),
                         jnp.asarray(fj), k=k, m=m, L=batch.shape[1],
                         use_freq=use_freq)
    raw, _ = one_block(reads, width)
    got = rs.tally_step(
        rs.make_bins(m, "cpu"), torch.from_numpy(raw),
        torch.from_numpy(lengths), k=k, m=m,
        freq_table=None if freq is None else torch.from_numpy(
            np.asarray(freq, np.int64)))
    return got.numpy(), np.asarray(exp).astype(np.int64)


@pytest.mark.parametrize("k,m", [(17, 6), (31, 8), (31, 6), (32, 6),
                                 (45, 6), (65, 6), (128, 7)])
def test_tally_matches_jax_and_host(tmp_path, k, m):
    rng = np.random.default_rng(k * 100 + m)
    reads = random_reads(rng, 400, k - 3, 3 * k)     # incl. too-short reads
    got, exp = tally_both(reads, k, m)
    np.testing.assert_array_equal(got, exp)
    kmdir, config = fake_run(tmp_path, reads, k, m)
    host = P.sample_minimizer_bins(kmdir, config)
    np.testing.assert_array_equal(host, JP.sample_minimizer_bins(kmdir,
                                                                 config))
    np.testing.assert_array_equal(
        P.sample_minimizer_bins(kmdir, config, device="cpu"), host)
    np.testing.assert_array_equal(got, host)
    assert host.sum() > 0


def test_tally_homopolymer_strand_flips(tmp_path):
    """Palindromes and homopolymers stress the strand-flip run breaks."""
    k, m = 21, 4
    reads = [b"A" * 60, b"ACGT" * 20, b"AT" * 40,
             b"ACGTACGTNNACGTACGTACGTAC" * 3]
    got, exp = tally_both(reads, k, m)
    np.testing.assert_array_equal(got, exp)
    kmdir, config = fake_run(tmp_path, reads, k, m)
    np.testing.assert_array_equal(
        P.sample_minimizer_bins(kmdir, config, device="cpu"),
        P.sample_minimizer_bins(kmdir, config))


def test_tally_freq_order(tmp_path):
    """--minimizer-type 1's frequency-ranked minimizers, at function level
    (the pipeline refuses that option)."""
    k, m = 31, 6
    rng = np.random.default_rng(6)
    reads = random_reads(rng, 300, 40, 120)
    rg = 4 ** m
    freq = np.full(rg, rg, dtype=np.uint64)
    seen = rng.choice(rg, size=rg // 2, replace=False)
    freq[seen] = rng.permutation(len(seen)).astype(np.uint64)
    freq[rg - 1] = rg - 1
    got, exp = tally_both(reads, k, m, freq)
    np.testing.assert_array_equal(got, exp)
    kmdir, config = fake_run(tmp_path, reads, k, m)
    host = P.sample_minimizer_bins(kmdir, config, freq_order=freq)
    np.testing.assert_array_equal(
        P.sample_minimizer_bins(kmdir, config, freq_order=freq,
                                device="cpu"), host)
    np.testing.assert_array_equal(got, host)
    assert not np.array_equal(host, P.sample_minimizer_bins(kmdir, config))


def odd_reads(rng, k):
    """Reads of widths that are multiples of neither 8 nor 128 (150, 151,
    37, 1, k - 1, and random ones), with lowercase bases, 'N' runs and
    bytes other than ACGTN."""
    lens = [150, 151, 37, 1, k - 1, 150, 151] + list(
        rng.integers(1, 3 * k, 40))
    other = np.frombuffer(b"RYKMSWBDHVUn-.*acgtZz", np.uint8)
    reads = []
    for ln in lens:
        s = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=ln)
        s[rng.random(ln) < 0.03] = ord("N")
        if ln > 20:
            at = int(rng.integers(0, ln - 8))
            s[at:at + int(rng.integers(1, 8))] = ord("N")
        hit = rng.random(ln) < 0.02
        s[hit] = rng.choice(other, size=int(hit.sum()))
        reads.append(bytes(s))
    return reads


@pytest.mark.parametrize("width", [1, 8], ids=["exact", "round8"])
@pytest.mark.parametrize("k,m", [(17, 6), (31, 10), (32, 6), (45, 6)])
def test_tally_raw_bytes_odd_widths(tmp_path, k, m, width):
    """The tally of raw bytes in a block as wide as its longest read
    (``exact``) or rounded up to 8 (the producer's width) against the
    JAX package's tally of the 2-bit packed, 128-wide block and the host
    numpy tally; then through the samplers from a FASTA file."""
    rng = np.random.default_rng(k * 10 + width)
    reads = odd_reads(rng, k)
    got, exp = tally_both(reads, k, m, width=width)
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, host_tally(one_block(reads)[0], k,
                                                  m))
    assert got.sum() > 0
    kmdir, config = fake_run(tmp_path, reads, k, m)
    np.testing.assert_array_equal(
        P.sample_minimizer_bins(kmdir, config, device="cpu"),
        P.sample_minimizer_bins(kmdir, config))


def test_tally_block_narrower_than_k_adds_nothing():
    """A block whose longest read is under k holds no window."""
    k, m = 31, 6
    batch, lengths = one_block([b"ACGT" * 7, b"A"], width=8)   # L = 32 > 28
    bins = rs.make_bins(m, "cpu")
    rs.tally_step(bins, torch.from_numpy(batch[:, :28].copy()),
                  torch.from_numpy(lengths), k=k, m=m)
    assert int(bins.sum()) == 0


@pytest.mark.parametrize("block", [128, 512])
def test_tally_multi_block_variable_lengths(tmp_path, monkeypatch, block):
    """Blocks whose width changes between them, so blocks flush at
    different (B, L) shapes and split batches, through more blocks than
    the producer's ring has buffers. Each block is the rows gathered,
    as wide as its longest read rounded up to 8, and ``cap_rows`` bounds
    B x L (rows halve as the width grows past 512 reads' budget)."""
    k, m = 31, 6
    rng = np.random.default_rng(7)
    reads = (random_reads(rng, 700, 40, 100) + random_reads(rng, 3, 700, 900)
             + random_reads(rng, 600, 40, 151)
             + random_reads(rng, 2, 1200, 1500)
             + random_reads(rng, 400, 40, 100))
    reads = [reads[i] for i in rng.permutation(len(reads))]
    kmdir, config = fake_run(tmp_path, reads, k, m)
    host = P.sample_minimizer_bins(kmdir, config)
    monkeypatch.setattr(P, "REPART_BLOCK", block)
    shapes = []
    step = rs.tally_step

    def recording(bins, blk, lens, **kw):
        longest = int(lens.max())
        shapes.append((blk.shape, longest))
        assert blk.dtype == torch.uint8 and lens.shape == blk.shape[:1]
        assert blk.shape[1] == -(-longest // 8) * 8
        assert (blk.numpy()[np.arange(blk.shape[1])[None, :]
                            >= lens.numpy()[:, None]] == ord("N")).all()
        return step(bins, blk, lens, **kw)

    monkeypatch.setattr(rs, "tally_step", recording)
    got = P.sample_minimizer_bins(kmdir, config, device="cpu")
    np.testing.assert_array_equal(got, host)
    assert host.sum() > 0
    assert len(shapes) > P.REPART_RING
    assert sum(s[0][0] for s in shapes) == len(reads)
    assert len({s[0][1] for s in shapes}) >= 3
    for (B, L), _ in shapes:
        cap = block
        while cap > 128 and cap * L > block * 512:
            cap //= 2
        assert B <= cap
        assert B * L <= block * 512 or B <= 128
    if block == 512:
        assert min(s[0][0] for s in shapes[:-1]) < block   # halved


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_stage_repart_matches_jax(tmp_path, sampler, monkeypatch):
    """The port's stage_repart on the CPU device writes the JAX package's
    repartition.minimRepart byte for byte (its host or its device
    sampler)."""
    from kmtricks_tpu.runtime.pipeline import PipelineOptions as JaxOptions

    rng = np.random.default_rng(8)
    fasta = tmp_path / "b.fasta"
    fasta.write_text("".join(f">r{i}\n{r.decode()}\n" for i, r in
                             enumerate(random_reads(rng, 500, 60, 140))))
    fof = tmp_path / "b.fof"
    fof.write_text(f"D1 : {fasta}\n")
    monkeypatch.setenv("KMTRICKS_REPART_SAMPLER", sampler)
    kw = dict(fof=str(fof), kmer_size=25, minim_size=6, nb_partitions=8)
    jopts = JaxOptions(run_dir=str(tmp_path / "jax"), **kw)
    jdir, jconf = JP.stage_config(jopts)
    JP.stage_repart(jdir, jconf, jopts)
    opts = P.PipelineOptions(run_dir=str(tmp_path / "port"), **kw)
    kmdir, config = P.stage_config(opts)
    P.stage_repart(kmdir, config, opts, device="cpu")
    with open(jdir.repart_path, "rb") as a, open(kmdir.repart_path,
                                                  "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("m,nb_parts", [(6, 4), (6, 37), (8, 16),
                                        (8, 1000)])
def test_static_partitions_match_jax_and_table(m, nb_parts):
    """Every minimizer's --static-repart partition: the port's
    static_partitions against the JAX package's and against the table
    that Repartition.from_xxh writes (both packages')."""
    minim = np.arange(4 ** m, dtype=np.int64)
    got = static_partitions(torch.from_numpy(minim), nb_parts).numpy()
    exp = np.asarray(jxx.static_partitions(jnp.asarray(minim.astype(
        np.int32)), nb_parts))
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, Repartition.from_xxh(nb_parts,
                                                            m).table)
    np.testing.assert_array_equal(got, JaxRepartition.from_xxh(nb_parts,
                                                               m).table)
    assert len(np.unique(got)) == nb_parts


def test_xxh64_u32_matches_jax():
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.integers(0, 2**32, 5000, dtype=np.uint64),
                        [0, 1, 2**31, 2**32 - 1]]).astype(np.uint64)
    got = xxh64_u32(torch.from_numpy(v.astype(np.int64))).numpy()
    hi, lo = jxx.xxh64_u32(jnp.asarray(v.astype(np.uint32)))
    exp = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
           | np.asarray(lo).astype(np.uint64))
    np.testing.assert_array_equal(got.view(np.uint64), exp)
