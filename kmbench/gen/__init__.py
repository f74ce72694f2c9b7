"""Read collections for the benchmark, made from a seed with numpy alone.

One traffic mix (``kmbench/traffic/<name>.json``) describes a collection
of bacterial isolates: one random genome of ``genome_bp`` bases, and per
sample ``snp_rate`` substitutions of it, sequenced as single-end reads of
``read_len`` bases at ``coverage``-fold depth, each read from either
strand (``reverse_share`` of them reverse-complemented) with uniform
substitution errors at ``error_rate`` per base, written in the mix's
``format``: ``fasta`` (one sequence line per record), ``fastq`` (four
lines a record, one constant quality character per base), or either of
them through gzip at its default level 6 (``fasta.gz``, ``fastq.gz``).
The reads, and so the valid windows, do not depend on the format.

Everything is drawn from ``numpy.random.default_rng`` seeded with the run's
seed and the sample index, so one seed gives the same bytes. The writer
builds each sample's file as one (reads, record bytes) array: no Python
loop runs per read.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)   # generator codes 0..3
# format -> (record kind, gzip or not); a file's name ends in ".<format>"
FORMATS = {"fasta": ("fasta", False), "fastq": ("fastq", False),
           "fasta.gz": ("fasta", True), "fastq.gz": ("fastq", True)}
QUALITY = ord("I")      # the quality character of every FASTQ base
GZIP_LEVEL = 6          # gzip's own default level
MASK64 = (1 << 64) - 1


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & MASK64, *stream])


def genome(seed: int, length: int) -> np.ndarray:
    """The collection's shared genome as codes 0..3 (A, C, G, T)."""
    return _rng(seed, 0).integers(0, 4, length, dtype=np.uint8)


def n_reads(traffic: dict) -> int:
    """Reads per sample: ``coverage`` times the genome over the read
    length, rounded down."""
    return int(traffic["coverage"] * traffic["genome_bp"]
               // traffic["read_len"])


def sample_reads(traffic: dict, seed: int, sample: int,
                 base: np.ndarray | None = None) -> np.ndarray:
    """One sample's reads as a (reads, read_len) array of codes 0..3."""
    g = genome(seed, traffic["genome_bp"]) if base is None else base
    rng = _rng(seed, 1, sample)
    g = g.copy()
    n_snp = int(round(traffic["snp_rate"] * len(g)))
    pos = rng.choice(len(g), n_snp, replace=False)
    g[pos] = (g[pos] + rng.integers(1, 4, n_snp, dtype=np.uint8)) % 4
    L, n = traffic["read_len"], n_reads(traffic)
    starts = rng.integers(0, len(g) - L + 1, n)
    rows = np.lib.stride_tricks.sliding_window_view(g, L)[starts]
    rev = rng.random(n) < traffic["reverse_share"]
    rows[rev] = 3 - rows[rev, ::-1]
    flat = rows.reshape(-1)
    n_err = int(rng.binomial(flat.size, traffic["error_rate"]))
    epos = rng.integers(0, flat.size, n_err)
    flat[epos] = (flat[epos] + rng.integers(1, 4, n_err, dtype=np.uint8)) % 4
    return rows


def record_bytes(rows: np.ndarray, sample_id: str, kind: str) -> np.ndarray:
    """(reads, record) uint8 array of one record per read. FASTA:
    ``>{sample_id}_{index}`` (fixed-width index), newline, bases, newline.
    FASTQ: ``@{sample_id}_{index}``, newline, bases, newline, ``+``,
    newline, one quality character per base, newline."""
    n, L = rows.shape
    width = max(1, len(str(max(n - 1, 0))))
    mark = ">" if kind == "fasta" else "@"
    prefix = np.frombuffer(f"{mark}{sample_id}_".encode(), dtype=np.uint8)
    hw = len(prefix) + width + 1
    tail = 0 if kind == "fasta" else 2 + L + 1
    out = np.empty((n, hw + L + 1 + tail), dtype=np.uint8)
    out[:, :len(prefix)] = prefix
    idx = np.arange(n, dtype=np.int64)[:, None]
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    out[:, len(prefix):len(prefix) + width] = (idx // powers) % 10 + 48
    out[:, hw - 1] = ord("\n")
    out[:, hw:hw + L] = ASCII[rows]
    out[:, hw + L] = ord("\n")
    if tail:
        q = hw + L + 1
        out[:, q] = ord("+")
        out[:, q + 1] = ord("\n")
        out[:, q + 2:q + 2 + L] = QUALITY
        out[:, -1] = ord("\n")
    return out


def check_format(traffic: dict) -> str:
    """The traffic mix's ``format``; raises ``ValueError`` on one the
    generator does not write."""
    fmt = traffic.get("format")
    if fmt not in FORMATS:
        raise ValueError(f"the generator writes format {sorted(FORMATS)}, "
                         f"not {fmt!r}")
    return fmt


def sample_id(i: int, samples: int) -> str:
    return f"S{i:0{len(str(max(samples - 1, 0)))}d}"


def write_sample(traffic: dict, seed: int, sample: int, out_dir: str) -> dict:
    """Write one sample's file in the mix's format; returns its manifest
    entry (``bytes`` as on disk)."""
    fmt = check_format(traffic)
    kind, gz = FORMATS[fmt]
    sid = sample_id(sample, traffic["samples"])
    rows = sample_reads(traffic, seed, sample)
    path = os.path.join(out_dir, f"{sid}.{fmt}")
    data = record_bytes(rows, sid, kind)
    if gz:
        # mtime 0: one seed gives the same bytes
        with open(path, "wb") as f:
            f.write(gzip.compress(data, compresslevel=GZIP_LEVEL, mtime=0))
    else:
        data.tofile(path)
    return {"id": sid, "path": path, "reads": int(rows.shape[0]),
            "read_len": int(rows.shape[1]),
            "bytes": int(os.path.getsize(path))}


def _write_sample_args(args):
    return write_sample(*args)


def make_bank(traffic: dict, seed: int, out_dir: str,
              workers: int = 1) -> dict:
    """Write the collection under ``out_dir`` (its sequence files,
    ``bank.fof`` and ``manifest.json``); ``workers`` processes write the
    samples. Returns the manifest. A format the generator does not write
    is refused before anything is written."""
    fmt = check_format(traffic)
    os.makedirs(out_dir, exist_ok=True)
    jobs = [(traffic, seed, s, out_dir) for s in range(traffic["samples"])]
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(workers, len(jobs))) as pool:
            samples = pool.map(_write_sample_args, jobs)
    else:
        samples = [write_sample(*j) for j in jobs]
    fof = os.path.join(out_dir, "bank.fof")
    with open(fof, "w") as f:
        f.write("".join(f"{s['id']} : {s['path']}\n" for s in samples))
    manifest = {"seed": seed, "traffic": traffic, "format": fmt, "fof": fof,
                "bytes": sum(s["bytes"] for s in samples),
                "samples": samples}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def valid_windows(manifest: dict, k: int) -> int:
    """Valid k-mer windows of the collection: the sum over reads of
    max(0, length - k + 1). Reads hold only A, C, G and T."""
    return sum(s["reads"] * max(0, s["read_len"] - k + 1)
               for s in manifest["samples"])
