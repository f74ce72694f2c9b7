"""Plain-torch reference of a kmtricks run, from the sequence files on.

It reads the files the program reads (FASTA or FASTQ, plain or gzip) and
works out again, on any torch device and in blocks of reads: kmtricks'
estimate of the collection's size, the sampled minimizer tally behind the
repartition, each sample's canonical k-mer counts with the hard-min, the
merged count matrix of every partition, and in hash mode each sample's
window hashes and Bloom bits. It imports nothing of the program; the
conventions it needs are in :mod:`kmbench.reference.layout`.
"""

from __future__ import annotations

import gzip
import os

import numpy as np
import torch

from kmbench.reference import layout

READ_BLOCK = 1 << 18        # reads per block of window arithmetic


EST_RECORDS = 50_000        # GATB's estimate counts one record more
EST_CHUNK = 256 * 1024      # and reads the inflated stream in these chunks


def read_bytes(path: str) -> np.ndarray:
    """A sequence file's bytes, inflated with Python's ``gzip`` where they
    start with the gzip magic."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw[:2].tobytes() == b"\x1f\x8b":
        raw = np.frombuffer(gzip.decompress(raw.tobytes()),
                            dtype=np.uint8).copy()
    return raw


def read_reads(path: str, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`parse_reads` of :func:`read_bytes`."""
    return parse_reads(read_bytes(path), device, path)


def parse_reads(raw: np.ndarray, device="cpu",
                name: str = "") -> tuple[torch.Tensor, torch.Tensor]:
    """(reads, max length) int8 codes (-1 for any other byte and for the
    padding) and (reads,) int64 lengths of a sequence file's (inflated)
    bytes, parsed on ``device``. The first byte says the format: ``@`` for
    FASTQ whose records hold four lines, the third starting with ``+`` and
    the fourth as long as the bases, else FASTA whose records hold one
    sequence line each. Anything else is refused."""
    data = torch.from_numpy(raw).to(device)
    nl = torch.nonzero(data == 10).squeeze(1)
    starts = torch.cat([nl.new_zeros(1), nl[:-1] + 1])
    first = data[starts]
    lines = 4 if raw[:1].tobytes() == b"@" else 2
    mark = ord("@" if lines == 4 else ">")
    if len(starts) % lines or not bool((first[0::lines] == mark).all()) \
            or bool((first[1::lines] == mark).any()):
        raise ValueError(f"{name}: not one sequence line per FASTA record "
                         f"nor four lines per FASTQ record")
    s0, lengths = starts[1::lines], nl[1::lines] - starts[1::lines]
    if lines == 4 and not (bool((first[2::4] == ord("+")).all()) and bool(
            ((nl[3::4] - starts[3::4]) == lengths).all())):
        raise ValueError(f"{name}: a FASTQ record's separator does not "
                         f"start with '+' or its quality is not as long "
                         f"as its bases")
    L = int(lengths.max()) if len(lengths) else 0
    pos = torch.arange(L, device=data.device)
    idx = (s0[:, None] + pos).clamp(max=data.shape[0] - 1)
    code = torch.from_numpy(layout.CODE).to(data.device)
    codes = code[data[idx].long()]
    codes[pos[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def estimate(raw: np.ndarray, path: str) -> tuple[int, int]:
    """GATB's estimate of one sequence file, by which kmtricks sizes a run
    (its partition count, the reads its repartition samples): (sequences,
    bases). It counts the first 50,001 records and their bases, reading
    the inflated stream in chunks of 256 KiB, and stops on reading the
    line that ends the next record (a FASTA record ends at the next
    header, a FASTQ record at its sequence line) or at the end. Both
    counts are scaled by the file's size over the bytes fetched, the bases
    in float32; a file whose path holds its first "gz" at its very end
    counts four times its size on disk (GATB assumes gzip inflates
    fourfold). ``raw`` is the file's inflated bytes (:func:`read_bytes`)."""
    lines = 4 if raw[:1].tobytes() == b"@" else 2
    # the line whose reading yields record EST_RECORDS + 1 (0-based)
    stop = lines * (EST_RECORDS + 2) if lines == 2 else \
        lines * (EST_RECORDS + 1) + 1
    n = EST_CHUNK * 64
    while True:
        nl = np.flatnonzero(raw[:n] == 10)
        if len(nl) > stop or n >= len(raw):
            break
        n *= 2
    starts = np.concatenate([[0], nl[:-1] + 1])
    bases = (nl - starts)[1::lines][:EST_RECORDS + 1]
    if len(nl) > stop:
        fetched = min(-(-(int(nl[stop]) + 1) // EST_CHUNK) * EST_CHUNK,
                      len(raw))
    else:
        fetched = len(raw)
    size = os.path.getsize(path)
    if path.find("gz") == len(path) - 2:
        size *= 4
    ratio = np.float32(np.float32(size) / np.float32(fetched))
    return (len(bases) * size // fetched,
            int(np.float32(int(bases.sum())) * ratio))


def window_values(codes: torch.Tensor, w: int) -> torch.Tensor:
    """(n, L) int64 codes in 0..3 -> (n, L - w + 1) values of every
    width-``w`` window, first base in the highest bits (doubling: one
    shift-or pass per bit of ``w``)."""
    ladder, v, p = {1: codes}, codes, 1
    while 2 * p <= w:
        v = (v[:, :-p] << (2 * p)) | v[:, p:]
        p *= 2
        ladder[p] = v
    n_out = codes.shape[1] - w + 1
    acc, done = None, 0
    for p in sorted(ladder, reverse=True):
        if w & p:
            part = ladder[p][:, done:done + n_out]
            acc = part if acc is None else (acc << (2 * p)) | part
            done += p
    return acc


def windows(codes: torch.Tensor, k: int):
    """(n, L) int8 codes -> (forward, reverse complement, valid), each
    (n, L - k + 1): the two strands' k-mer values and whether the window
    holds k bases."""
    valid_base = codes >= 0
    c = codes.clamp(min=0).to(torch.int64)
    fwd = window_values(c, k)
    rc = window_values((c ^ 2).flip(1), k).flip(1)
    bad = torch.cumsum(torch.cat([torch.zeros_like(valid_base[:, :1],
                                                   dtype=torch.int32),
                                  (~valid_base).to(torch.int32)], 1), 1)
    valid = (bad[:, k:] - bad[:, :-k]) == 0
    return fwd, rc, valid


def sliding_min(a: torch.Tensor, w: int) -> torch.Tensor:
    """Minimum of every width-``w`` window along dim 1."""
    g, p = a, 1
    while 2 * p <= w:
        g = torch.minimum(g[:, :-p], g[:, p:])
        p *= 2
    n = a.shape[1] - w + 1
    return torch.minimum(g[:, :n], g[:, w - p:w - p + n])


def window_minimizers(codes: torch.Tensor, k: int, m: int,
                      lut: torch.Tensor) -> torch.Tensor:
    """(n, L - k + 1) minimizer of every window (see
    :func:`layout.masked_minimizer_lut`)."""
    mm = window_values(codes.clamp(min=0).to(torch.int64), m)
    return sliding_min(lut[mm], k - m + 1)


def key_minimizers(keys: torch.Tensor, k: int, m: int,
                   lut: torch.Tensor) -> torch.Tensor:
    """Minimizer of each k-mer value (either strand gives the same: the
    canonical m-mers of a k-mer and of its reverse complement agree)."""
    mask = (1 << (2 * m)) - 1
    out = None
    for i in range(k - m + 1):
        v = lut[(keys >> (2 * (k - m - i))) & mask]
        out = v if out is None else torch.minimum(out, v)
    return out


def kx_tally(codes: torch.Tensor, k: int, m: int, lut: torch.Tensor,
             bins: torch.Tensor) -> None:
    """Add one block of reads to the sampled tally: within each
    super-k-mer (consecutive valid windows of one minimizer) a kx-mer
    starts where the canonical strand flips and every fourth k-mer
    after; each start counts for its minimizer."""
    fwd, rc, valid = windows(codes, k)
    minim = window_minimizers(codes, k, m, lut)
    forward = fwd <= rc
    n, W = valid.shape
    brk = torch.ones_like(valid)
    brk[:, 1:] = ~valid[:, 1:] | ~valid[:, :-1] | (minim[:, 1:]
                                                  != minim[:, :-1])
    brk[:, 1:] |= forward[:, 1:] != forward[:, :-1]
    pos = torch.arange(W, device=codes.device).expand(n, W)
    run_start = torch.cummax(torch.where(brk, pos, 0), dim=1).values
    start = (brk | ((pos - run_start) % 4 == 0)) & valid
    bins += torch.bincount(minim[start], minlength=bins.shape[0])


def lpt_table(bins: np.ndarray, nb_partitions: int) -> np.ndarray:
    """A greedy table of the bins: largest bin first (ties by minimizer),
    each to the least-loaded partition (ties by partition)."""
    import heapq

    order = np.lexsort((np.arange(len(bins)), -bins))
    table = np.zeros(len(bins), dtype=np.uint16)
    heap = [(0, p) for p in range(nb_partitions)]
    for i in order:
        load, p = heapq.heappop(heap)
        table[i] = p
        heapq.heappush(heap, (load + int(bins[i]), p))
    return table


def lpt_violations(bins: np.ndarray, table: np.ndarray,
                   nb_partitions: int) -> int:
    """How many bin sizes the table does not place greedily. Bins are
    placed largest first, each on a least-loaded partition, and bins of
    one size may come in any order: the c bins of size s, n_p of them on
    partition p, are a greedy placement from loads L exactly when every
    p with n_p > 0 has L_p + (n_p - 1) s <= min_q (L_q + n_q s)."""
    if len(table) != len(bins) or (len(table) and
                                   int(table.max()) >= nb_partitions):
        return max(1, len(bins))
    sizes = np.unique(bins)[::-1]
    cls = len(sizes) - 1 - np.searchsorted(sizes[::-1], bins)
    per = np.bincount(cls * nb_partitions + table.astype(np.int64),
                      minlength=len(sizes) * nb_partitions
                      ).reshape(len(sizes), nb_partitions)
    loads = [0] * nb_partitions
    bad = 0
    for c, s in enumerate(sizes.tolist()):
        n = per[c].tolist()
        after = [loads[p] + n[p] * s for p in range(nb_partitions)]
        low = min(after)
        if any(n[p] and loads[p] + (n[p] - 1) * s > low
               for p in range(nb_partitions)):
            bad += 1
        loads = after
    return bad


# -- XXH64 of one 8-byte word, in int64 with wrapping products ------------

def _s64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def xxh64_word(x: torch.Tensor) -> torch.Tensor:
    """XXH64 (seed 0) of each int64 as 8 little-endian bytes, as the bits
    of an int64."""
    p1, p2, p3, p4 = (_s64(layout.P1), _s64(layout.P2), _s64(layout.P3),
                      _s64(layout.P4))
    h = torch.full_like(x, _s64((layout.P5 + 8) % (1 << 64)))
    h = h ^ (_rotl(x * p2, 31) * p1)
    h = _rotl(h, 27) * p1 + p4
    h = h ^ _lsr(h, 33)
    h = h * p2
    h = h ^ _lsr(h, 29)
    h = h * p3
    return h ^ _lsr(h, 32)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """x mod m, reading the int64 ``x`` as unsigned (m < 2^31)."""
    hi, lo = _lsr(x, 32), x & 0xFFFFFFFF
    return ((hi % m) * ((1 << 32) % m) + lo) % m


class Collection:
    """The reads of one run's samples, in the order of its fof, with the
    k-mer arithmetic the reference needs."""

    def __init__(self, samples: list[tuple[str, str]], k: int, m: int,
                 device):
        self.ids = [sid for sid, _p in samples]
        self.paths = [p for _sid, p in samples]
        self.k, self.m = k, m
        self.device = torch.device(device)
        self.lut = torch.from_numpy(layout.masked_minimizer_lut(m)).to(
            self.device)
        self._reads, self._estimates = {}, {}
        self._counts, self._bins = {}, None

    def reads(self, path: str) -> tuple[torch.Tensor, torch.Tensor]:
        """One sample's codes and lengths (parsed once)."""
        if path not in self._reads:
            raw = read_bytes(path)
            self._reads[path] = parse_reads(raw, self.device, path)
            self._estimates[path] = estimate(raw, path)
        return self._reads[path]

    def _blocks(self, path: str, max_reads: int | None = None):
        codes, _lengths = self.reads(path)
        if max_reads is not None:
            codes = codes[:max_reads]
        for i in range(0, codes.shape[0], READ_BLOCK):
            yield codes[i:i + READ_BLOCK]

    def estimated(self) -> tuple[int, int]:
        """(sequences, bases) of the whole collection as kmtricks
        estimates them (:func:`estimate`, summed over the files)."""
        seqs = bases = 0
        for p in self.paths:
            self.reads(p)           # parses and estimates the file once
            seqs += self._estimates[p][0]
            bases += self._estimates[p][1]
        return seqs, bases

    def nb_partitions(self, max_memory_mb: int) -> int:
        reads, bases = self.estimated()
        mean = max(bases // max(reads, 1), self.k)
        kmers = max(1, (mean - self.k + 1) * max(reads, 1))
        return layout.nb_partitions(kmers, self.k, max_memory_mb)

    def tally(self) -> np.ndarray:
        """The sampled kx-mer tally per minimizer over the first reads of
        the collection: 5% of its estimated sequences, and at least a
        million."""
        if self._bins is not None:
            return self._bins
        reads, _bases = self.estimated()
        left = max(int(0.05 * reads), 1_000_000)
        bins = torch.zeros(4 ** self.m, dtype=torch.int64,
                           device=self.device)
        for p in self.paths:
            if left <= 0:
                break
            for blk in self._blocks(p, left):
                kx_tally(blk, self.k, self.m, self.lut, bins)
                left -= blk.shape[0]
        self._bins = bins.cpu().numpy()
        return self._bins

    def sample_counts(self, path: str) -> tuple[torch.Tensor, torch.Tensor]:
        """Sorted distinct canonical k-mers of one sample, with counts."""
        if path not in self._counts:
            keys = []
            for blk in self._blocks(path):
                fwd, rc, valid = windows(blk, self.k)
                keys.append(torch.minimum(fwd, rc)[valid])
            self._counts[path] = torch.unique(torch.cat(keys),
                                              return_counts=True)
        return self._counts[path]

    def partitions(self, keys: torch.Tensor, table: torch.Tensor):
        return table[key_minimizers(keys, self.k, self.m, self.lut)]

    def hash_counts(self, keys, counts, table, window: int):
        """A sample's window hashes, XXH64(k-mer) mod window plus window
        times its partition, with the counts of the k-mers that share
        one summed."""
        h = umod(xxh64_word(keys), window) + window * self.partitions(
            keys, table).to(torch.int64)
        uh, inv = torch.unique(h, return_inverse=True)
        return uh, torch.zeros_like(uh).index_add_(0, inv, counts)
