"""``pipeline`` command: config -> repartition -> device count+merge.

Counterpart of ``kmtricks_tpu/runtime/device_pipeline.py::
run_mesh_pipeline`` on one device, for the slices this package ports:
every ``--mode`` (k-mer and hash count formats; count, pa, bf, bft and
bfc; bin and text outputs), k <= 128, the repartition tally on the
device and ``--static-repart``. It routes as the JAX package does: a
collection that fits one device step takes the fused step
(:mod:`kmtricks_tpu_torch.runtime.device_pipeline`); a larger one, or a
run that wants histograms or a float soft-min, takes the streaming engine
(:mod:`kmtricks_tpu_torch.runtime.stream_engine`). Anything outside the
slice raises NotImplementedError; nothing falls back to another path.

The host stages are copies of those of ``kmtricks_tpu/runtime/
pipeline.py`` (numpy): the options and mode grammar, config, the
repartition with its host minimizer tally, the per-sample count and
per-partition merge on the host, the soft-min, the writers and the run
summary. Their branches into the JAX package's device code raise
NotImplementedError and name the ROADMAP slice that ports them.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kmtricks_tpu_torch import constants as C
from kmtricks_tpu_torch.core.bitmatrix import transpose_bits
from kmtricks_tpu_torch.core.hashers import HashWindow, bloom_fp, round_up
from kmtricks_tpu_torch.core.histogram import KHist, compute_merge_thresholds
from kmtricks_tpu_torch.core.kmer import kmers_to_strings
from kmtricks_tpu_torch.core.repartition import Repartition
from kmtricks_tpu_torch.host import ops as hops
from kmtricks_tpu_torch.io import formats as F
from kmtricks_tpu_torch.io import sequences as seqio
from kmtricks_tpu_torch.io.fof import Fof
from kmtricks_tpu_torch.ops.count_merge import stream_layout
from kmtricks_tpu_torch.runtime.config import (
    Config, configure, save_gatb_config)
from kmtricks_tpu_torch.runtime.device_pipeline import (
    _is_float_quantile, _load_global_batch, _needs_host_aggregation,
    stage_count_merge)
from kmtricks_tpu_torch.runtime.kmdir import KmDir
from kmtricks_tpu_torch.runtime.stream_engine import stage_mesh_stream

log = logging.getLogger("kmtricks_tpu")

_KFF = "KFF outputs (--kff-output, count --mode kff) are not ported"

VALID_MODES = {
    ("kmer", "count", "bin"), ("kmer", "count", "text"),
    ("kmer", "pa", "bin"), ("kmer", "pa", "text"),
    ("hash", "count", "bin"), ("hash", "count", "text"),
    ("hash", "pa", "bin"), ("hash", "pa", "text"),
    ("hash", "bf", "bin"), ("hash", "bft", "bin"), ("hash", "bfc", "bin"),
}


def parse_mode(s: str) -> tuple[str, str, str]:
    """``<count_format:mode:out>`` grammar + constraints (cli.cpp:150-199)."""
    parts = s.split(":")
    if len(parts) != 3:
        raise ValueError(f"Invalid mode: {s}")
    cf, mode, out = parts
    if (cf, mode, out) not in VALID_MODES:
        raise ValueError(f"Invalid mode: {s} (bf/bft/bfc require hash + bin)")
    return cf, mode, out


@dataclass
class PipelineOptions:
    fof: str = ""
    run_dir: str = ""
    kmer_size: int = C.DEFAULT_KMER_SIZE
    minim_size: int = C.DEFAULT_MINIM_SIZE
    mode: str = "kmer:count:bin"
    hard_min: int = C.DEFAULT_HARD_MIN
    soft_min: str = str(C.DEFAULT_SOFT_MIN)   # int | float(0,1) | path
    share_min: int = C.DEFAULT_SHARE_MIN      # save_if
    recurrence_min: int = C.DEFAULT_RECURRENCE_MIN
    nb_partitions: int = 0
    bloom_size: int = C.DEFAULT_BLOOM_SIZE
    bitw: int = C.DEFAULT_BITW
    until: str = "all"            # repart|superk|count|merge|all
    hist: bool = False
    cpr: bool = False
    kff: bool = False
    keep_tmp: bool = False
    repart_from: str | None = None
    static_repart: bool = False
    restrict_to: float = 1.0
    restrict_to_list: list[int] | None = None
    minim_type: int = 0
    repart_type: int = 0
    max_memory_mb: int = 8192
    backend: str = "host"         # auto | host | device | mesh
                                  # (library default stays "host" — the
                                  # exact golden path; the CLI passes
                                  # "auto": mesh on TPU, host on CPU)
    bf_format: str = "howdesbt"
    focus: float = 0.5   # host-decode prefetch depth knob (mesh streaming)
    verbose: str = "info"
    bam_require_flags: int = 0
    bam_exclude_flags: int = 0
    bam_excluded_refs: list[str] = field(default_factory=list)
    plugin: str | None = None       # file.py[:Class] (reference --plugin)
    plugin_config: str = ""
    threads: int = 1                # host thread pool (reference -t)
    mmer_scheme: str = "canonical"  # canonical (reference behavior) |
                                    # forward (its dead-NONCANONICAL intent)

    def bam_filter(self) -> seqio.BamFilter:
        return seqio.BamFilter(self.bam_require_flags,
                               self.bam_exclude_flags,
                               frozenset(self.bam_excluded_refs))

    def display(self) -> str:
        keys = ["fof", "run_dir", "kmer_size", "minim_size", "mode",
                "hard_min", "soft_min", "share_min", "recurrence_min",
                "nb_partitions", "bloom_size", "bitw", "until", "hist",
                "cpr", "kff", "repart_from", "static_repart", "minim_type",
                "repart_type", "backend", "bf_format", "mmer_scheme"]
        return "".join(f"{k}: {getattr(self, k)}\n" for k in keys)


# ---------------------------------------------------------------------------
# Host stages (copies of kmtricks_tpu/runtime/pipeline.py, host path)
# ---------------------------------------------------------------------------

def stage_config(opts: PipelineOptions) -> tuple[KmDir, Config]:
    """Configuration, its GATB twin, hash.info, partition dirs and
    options.txt (``KmDir.init(first=True)`` writes the port's
    build_infos.txt)."""
    kmdir = KmDir.init(opts.run_dir, opts.fof, first=True)
    config = configure(kmdir.fof, opts.kmer_size, opts.minim_size,
                       opts.nb_partitions, opts.bloom_size,
                       opts.max_memory_mb, opts.mode, opts.hard_min,
                       opts.minim_type, opts.repart_type)
    config.mmer_scheme = opts.mmer_scheme
    config.save(kmdir.config_storage)
    save_gatb_config(config, kmdir.root)   # GATB twin for reference tools
    hw = HashWindow(config.bloom_size, config.nb_partitions,
                    config.minim_size)
    hw.serialize(kmdir.hash_win)          # task.hpp:120-121
    kmdir.init_parts(config.nb_partitions)
    with open(kmdir.options_path, "w") as f:
        f.write(opts.display())
    return kmdir, config


def _tally_kxmer_starts(bins: np.ndarray, codes: np.ndarray,
                        valid: np.ndarray, k: int, m: int,
                        freq_order) -> None:
    """Tally kx-mer starts per minimizer over one flat code stream
    (invalid positions separate sequences — no run crosses them)."""
    from kmtricks_tpu_torch.core import kmer as kops

    if len(codes) < k:
        return
    wv = kops.window_validity(valid, k)
    if not wv.any():
        return
    # one shared shift-or ladder feeds the minimizer scan (width m) and
    # both strand half-mers (widths 16 and k-16) — the ladder passes are
    # the tally's dominant memory traffic
    ladder = (kops._u32_ladder(codes, min(16, max(m, k if k <= 32 else m)))
              if k <= 32 and m <= 16 else None)
    minim = kops.window_minimizers(codes, k, m, freq_order=freq_order,
                                   ladder=ladder)
    if m <= 16:
        minim = minim.astype(np.uint32)   # 64-bit compares are slow
    which = kops.strand_is_forward(codes, k, ladder=ladder)
    n = len(minim)
    idx = np.arange(n, dtype=np.int32)
    sk_break = np.ones(n, dtype=bool)     # superkmer boundaries
    sk_break[1:] = (~wv[1:]) | (~wv[:-1]) | (minim[1:] != minim[:-1])
    wb = sk_break.copy()                  # which-run boundaries
    wb[1:] |= which[1:] != which[:-1]
    run_start = np.maximum.accumulate(np.where(wb, idx, 0))
    kx_start = (wb | ((idx - run_start) % 4 == 0)) & wv
    bins += np.bincount(minim[kx_start].astype(np.int64),
                        minlength=len(bins))


def _sample_batches(kmdir: KmDir, config: Config, bam_filter):
    """First-N sampled read batches (the reference's CancellableIterator
    cutoff, RepartitionAlgorithm.cpp:444-475) — shared by both sampler
    backends."""
    total_cutoff = max(int(0.05 * max(config.seq_number, 1)), 1_000_000)
    seen = 0
    for entry in kmdir.fof:
        if seen >= total_cutoff:
            return
        for batch, lengths in seqio.iter_batches(entry.paths, bam_filter):
            take = min(len(lengths), total_cutoff - seen)
            if take <= 0:
                return
            seen += take
            yield batch[:take], lengths[:take]


# reads per block of the device tally; a block holds at most 512 times as
# many cells (reads x padded length): rows halve as the width bucket
# grows, so a long-read bank never forces a REPART_BLOCK x max_len block
# (the JAX package's CELL_BUDGET)
REPART_BLOCK = 65536


def _sample_minimizer_bins_device(kmdir: KmDir, config: Config, device,
                                  bam_filter=None,
                                  freq_order=None) -> np.ndarray:
    """Device SampleRepart (counterpart of the JAX package's
    ``_sample_minimizer_bins_device``): the first-N sampled reads are
    gathered into quantized (B, L) blocks on a producer thread, packed to
    2 bits a base (``pack_2bit_host``) and uploaded (pinned,
    ``non_blocking``); each block's tally (``ops/repart_sample.py::
    tally_step``) adds into a (4^m,) int64 table that stays on
    ``device`` until the end. Bit-equal to the host tally."""
    import queue as queue_mod
    import threading

    from kmtricks_tpu_torch.ops import repart_sample as rs
    from kmtricks_tpu_torch.ops.encode import pack_2bit_host

    k, m = config.kmer_size, config.minim_size
    device = torch.device(device)
    block = REPART_BLOCK
    freq = (None if freq_order is None else torch.from_numpy(
        np.asarray(freq_order, np.int64)).to(device))

    def bucket_len(maxlen: int) -> int:
        return max(((maxlen + 127) // 128) * 128, 128)

    def cap_rows(L: int) -> int:
        B = block
        while B > 128 and B * L > block * 512:
            B //= 2
        return B

    def upload(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    q: queue_mod.Queue = queue_mod.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> None:
        """put() that gives up once the consumer has failed (stop set)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return
            except queue_mod.Full:
                continue

    def emit(pieces, nrows, L):
        """The buffered ``nrows`` reads as one padded (B, L) block: B is
        the width bucket's cap, or for a last, partial block the power of
        two that holds its rows (eager torch compiles nothing per shape,
        so the JAX package's full-cap padding would only add work).
        Zero-length all-'N' rows tally nothing."""
        B = min(cap_rows(L), 1 << max(7, (nrows - 1).bit_length()))
        blk = np.full((B, L), ord("N"), np.uint8)
        lens = np.zeros(B, np.int32)
        r = 0
        for batch, lengths in pieces:
            n = len(lengths)
            w = min(batch.shape[1], L)
            blk[r:r + n, :w] = batch[:, :w]
            lens[r:r + n] = lengths
            r += n
        packed, vbits = pack_2bit_host(blk)
        put((upload(packed), upload(vbits), upload(lens)))

    def producer():
        try:
            pieces, nrows, L = [], 0, 128
            for batch, lengths in _sample_batches(kmdir, config, bam_filter):
                bL = bucket_len(batch.shape[1])
                while len(lengths):
                    newL = max(L, bL)
                    cap = cap_rows(newL)
                    if nrows >= cap:
                        # widening would overflow this block: flush it at
                        # the current (narrower) width and start again
                        emit(pieces, nrows, L)
                        pieces, nrows, L = [], 0, 128
                        continue
                    take = min(len(lengths), cap - nrows)
                    pieces.append((batch[:take], lengths[:take]))
                    batch, lengths = batch[take:], lengths[take:]
                    nrows += take
                    L = newL
                    if nrows >= cap_rows(L):
                        emit(pieces, nrows, L)
                        pieces, nrows, L = [], 0, 128
            if nrows:
                emit(pieces, nrows, L)
        except BaseException as e:  # noqa: BLE001 - raised by the consumer
            put(e)
            return
        put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    bins = rs.make_bins(m, device)
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            packed, vbits, lens = item
            rs.tally_step(bins, packed, vbits, lens, k=k, m=m,
                          freq_table=freq)
    finally:
        stop.set()
    t.join()
    return bins.cpu().numpy()


def sample_minimizer_bins(kmdir: KmDir, config: Config, bam_filter=None,
                          freq_order=None, device=None) -> np.ndarray:
    """Tally sampled KX-MERS per minimizer — the reference's exact LPT
    weights (SampleRepart, RepartitionAlgorithm.cpp:158-243): within each
    superkmer (run of consecutive valid windows sharing a minimizer), a
    new kxmer starts when the canonical strand flips or after 4 k-mers.
    Deterministic: first-N sampling, like the reference's
    CancellableIterator cutoff.

    With a ``device`` and m <= 12, the tally runs there
    (:func:`_sample_minimizer_bins_device`; plain torch on a CPU device),
    as the JAX package's does on its accelerator; otherwise the host numpy
    tally below. Sampled reads stream through the native batch parser
    and the batched host kernels as ONE flat code stream per batch — each
    row gets an appended invalid separator byte, so windows never span
    reads and the tally is identical to per-sequence processing (the
    reference fans SampleRepart over a thread pool for the same reason,
    RepartitionAlgorithm.cpp:444-475)."""
    from concurrent.futures import ThreadPoolExecutor

    from kmtricks_tpu_torch.core.kmer import (
        ASCII_CODE_TABLE, ASCII_VALID_TABLE)

    k, m = config.kmer_size, config.minim_size
    if device is not None and m <= 12:
        return _sample_minimizer_bins_device(kmdir, config, device,
                                             bam_filter, freq_order)

    nthreads = 4

    def batches():
        for batch, _lengths in _sample_batches(kmdir, config, bam_filter):
            yield batch

    def tally(batch):
        # append one invalid separator column; row padding is already
        # invalid ('N'), so no k-window crosses a read boundary
        flat = np.hstack([batch, np.full((batch.shape[0], 1), ord("N"),
                                         np.uint8)]).ravel()
        b = np.zeros(4 ** m, dtype=np.int64)
        _tally_kxmer_starts(b, ASCII_CODE_TABLE[flat],
                            ASCII_VALID_TABLE[flat], k, m, freq_order)
        return b

    # batch tallies commute and numpy releases the GIL on the big
    # kernels; bounded submission keeps RSS at ~2*threads batches
    # (Executor.map would buffer the whole bank)
    bins = np.zeros(4 ** m, dtype=np.int64)
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        pending = []
        for batch in batches():
            pending.append(ex.submit(tally, batch))
            if len(pending) >= 2 * nthreads:
                bins += pending.pop(0).result()
        for f in pending:
            bins += f.result()
    return bins


def compute_mmer_frequencies(kmdir: KmDir, config: Config, bam_filter=None):
    """--minimizer-type 1: sample canonical m-mer frequencies
    (RepartitorAlgorithm::computeFrequencies / MmersFrequency,
    RepartitionAlgorithm.cpp:100-151, 300-384). Returns ([(count, mmer)]
    ascending, freq_order rank table with unseen = 4^m and the top
    minimizer pinned to rank 4^m - 1 — exactly the reference's table:
    it too leaves unseen m-mers at rank 4^m and overwrites only the top
    value, RepartitionAlgorithm.cpp:369-381)."""
    from kmtricks_tpu_torch.core import kmer as kops
    from kmtricks_tpu_torch.core.kmer import ASCII_CODE_TABLE, ASCII_VALID_TABLE

    m = config.minim_size
    rg = 4 ** m
    counts = np.zeros(rg, dtype=np.uint32)
    cutoff = min(int(0.05 * max(config.seq_number, 1)), 50_000_000) or 1
    seen = 0
    for entry in kmdir.fof:
        if seen >= cutoff:
            break
        for batch, lengths in seqio.iter_batches(entry.paths, bam_filter):
            take = min(len(lengths), cutoff - seen)
            if take <= 0:
                break
            batch = batch[:take]
            seen += take
            # flat stream with an invalid separator per row (see
            # sample_minimizer_bins)
            flat = np.hstack([batch, np.full((take, 1), ord("N"),
                                             np.uint8)]).ravel()
            codes, valid = ASCII_CODE_TABLE[flat], ASCII_VALID_TABLE[flat]
            if len(codes) < m:
                continue
            wv = kops.window_validity(valid, m)
            vals = kops.mmers_from_codes(codes, m)[wv]
            vals = np.minimum(vals, kops.mmer_revcomp_values(vals, m))
            np.add.at(counts, vals.astype(np.int64), 1)
    pairs = sorted((int(c), i) for i, c in enumerate(counts) if c > 0)
    freq_order = np.full(rg, rg, dtype=np.uint64)
    for rank, (_c, mmer) in enumerate(pairs):
        freq_order[mmer] = rank
    freq_order[rg - 1] = rg - 1
    return [(c, i) for c, i in pairs], freq_order


def stage_repart(kmdir: KmDir, config: Config, opts: PipelineOptions,
                 device=None) -> Repartition:
    """The run's repartition: reused (--repart-from), static
    (--static-repart), or from the sampled tally, on ``device`` when one
    is given (:func:`sample_minimizer_bins`)."""
    if opts.repart_from:
        src = os.path.join(opts.repart_from, "repartition",
                           "repartition.minimRepart")
        rep = Repartition.load(src)
        # compatibility check (task.hpp:209-222)
        if rep.nb_partitions != config.nb_partitions or \
                rep.nb_minimizers != 4 ** config.minim_size:
            raise ValueError("--repart-from: incompatible repartition "
                             f"({rep.nb_partitions} partitions, "
                             f"{rep.nb_minimizers} minimizers)")
    elif opts.static_repart:
        rep = Repartition.from_xxh(config.nb_partitions, config.minim_size)
    elif config.minim_type == 1:
        pairs, freq_order = compute_mmer_frequencies(kmdir, config,
                                                     opts.bam_filter())
        bins = sample_minimizer_bins(kmdir, config, opts.bam_filter(),
                                     freq_order, device)
        rep = Repartition.from_freq_groups(pairs, bins,
                                           config.nb_partitions)
        rep.freq = freq_order.astype(np.uint32)
    else:
        bins = sample_minimizer_bins(kmdir, config, opts.bam_filter(),
                                     device=device)
        if config.repart_type == 1:
            # computeDistrib is computed then overwritten in the reference
            # (RepartitionAlgorithm.cpp:483-488) — net effect is lexi only
            rep = Repartition.from_bin_sizes_lexi(bins,
                                                  config.nb_partitions)
        else:
            rep = Repartition.from_bin_sizes(bins, config.nb_partitions)
    rep.save(kmdir.repart_path)
    if config.minim_size <= 12:   # task.hpp:160-168
        rep.write_minimizers(kmdir.get_minim_paths(config.nb_partitions),
                             config.minim_size)
    return rep


def _count_backend(opts: PipelineOptions):
    """The host counter; the per-stage device backend (``--backend
    device``) is ROADMAP slice 4 of the port."""
    if opts.backend == "device":
        raise NotImplementedError(
            "the per-stage device count (--backend device) is ROADMAP "
            "slice 4 of the port")
    return hops.count_sequences


def _merge_backend(opts: PipelineOptions):
    """The host merge; the per-stage device backend is ROADMAP slice 4."""
    if opts.backend == "device":
        raise NotImplementedError(
            "the per-stage device merge (--backend device) is ROADMAP "
            "slice 4 of the port")
    return hops.merge_partition


def stage_count(kmdir: KmDir, config: Config, repart: Repartition,
                sample_idx: int, opts: PipelineOptions,
                partitions: list[int] | None = None,
                count_mode: str | None = None) -> KHist | None:
    """Count one sample into per-partition files.

    count_mode: "kmer" -> .kmer files, "hash" -> .hash files,
    "vector" -> dense per-partition window bit vectors (.vector),
    "kff" -> counted k-mers in KFF format only (KffCountProcessor).
    """
    entry = kmdir.fof.entries[sample_idx]
    # opts.mode is the <cf:mode:out> triple from the pipeline; the count
    # MODULE passes a bare count_mode token instead (cli.cpp count --mode)
    count_mode = count_mode or parse_mode(opts.mode)[0]
    hw = (HashWindow.load(kmdir.hash_win)
          if count_mode in ("hash", "vector") else None)
    hard_min = entry.abundance_min or opts.hard_min
    count_max = (1 << (8 * config.count_bytes)) - 1

    hist = KHist(sample_idx, config.kmer_size) if opts.hist else None
    freq = (repart.freq.astype(np.uint64)
            if getattr(repart, "freq", None) is not None else None)
    counter = _count_backend(opts)
    kwargs = {} if freq is None else {"freq_order": freq}
    if config.mmer_scheme == "forward":
        kwargs["mmer_canonical"] = False
    cmode = "kmer" if count_mode in ("kmer", "kff") else "hash"
    wbits = hw.window_size_bits if hw else None
    if counter is hops.count_sequences:
        # bounded-RSS path: stream read batches through a StreamCounter
        # instead of materializing the whole sample (BankFasta-style
        # streaming; budget ~an eighth of --max-memory)
        budget = max(1_000_000,
                     int(opts.max_memory_mb * 1e6 / 8
                         / (8 * config.kmer_slots + 8)))
        stc = hops.StreamCounter(
            config.kmer_size, config.minim_size, repart.table, mode=cmode,
            window_bits=wbits, budget_entries=budget,
            freq_order=kwargs.get("freq_order"),
            mmer_canonical=kwargs.get("mmer_canonical", True))
        for batch, lengths in seqio.iter_batches(entry.paths,
                                                 opts.bam_filter()):
            stc.add_batch(batch, lengths)
        sc = stc.finish(hard_min, count_max, hist=hist)
    else:
        seqs = list(seqio.iter_sequences(entry.paths, opts.bam_filter()))
        sc = counter(seqs, config.kmer_size, config.minim_size,
                     repart.table, hard_min=hard_min, mode=cmode,
                     window_bits=wbits, count_max=count_max, hist=hist,
                     **kwargs)

    parts = partitions if partitions is not None \
        else range(config.nb_partitions)
    for p in parts:
        keys, counts = sc.partitions.get(
            p, (np.zeros((0, config.kmer_slots), dtype=np.uint64)
                if count_mode == "kmer" else np.zeros(0, dtype=np.uint64),
                np.zeros(0, dtype=np.uint32)))
        if count_mode == "kmer":
            path = kmdir.get_count_part_path(entry.id, p, opts.cpr, "kmer")
            F.write_kmer_file(path, keys, counts, config.kmer_size,
                              config.count_bytes, sample_idx, p,
                              compressed=opts.cpr)
            if opts.kff:   # KffCountProcessor (count_processor.hpp:158-191)
                raise NotImplementedError(_KFF)
        elif count_mode == "hash":
            path = kmdir.get_count_part_path(entry.id, p, opts.cpr, "hash")
            F.write_hash_file(path, keys, counts, config.count_bytes,
                              sample_idx, p, compressed=opts.cpr)
        elif count_mode == "kff":
            raise NotImplementedError(_KFF)
        elif count_mode == "vector":
            w = hw.window_size_bits
            vec = np.zeros(F.nbytes(w), dtype=np.uint8)
            rel = (np.asarray(keys, dtype=np.uint64)
                   - np.uint64(w) * np.uint64(p)).astype(np.int64)
            byte, bit = rel >> 3, rel & 7
            np.bitwise_or.at(vec, byte, (1 << bit).astype(np.uint8))
            path = kmdir.get_count_part_path(entry.id, p, opts.cpr, "vector")
            F.write_bit_vector_file(path, vec, w, sample_idx, p,
                                    compressed=opts.cpr)
    if hist is not None:
        F.write_hist_file(kmdir.get_hist_path(entry.id), hist)
    return hist


def resolve_soft_min(spec: str, kmdir: KmDir, nsamp: int) -> np.ndarray:
    """--soft-min polymorphism (cli.cpp:556-575 + cmd.hpp:237-245):
    an int (same threshold for all), a float in (0,1) (per-sample quantile
    thresholds from histograms), or a file of per-sample ints."""
    try:
        v = int(spec)
        return np.full(nsamp, v, dtype=np.uint32)
    except ValueError:
        pass
    try:
        p = float(spec)
    except ValueError:
        p = None
    if p is not None:
        if not 0 < p < 1:
            raise ValueError("--soft-min float must be in (0, 1)")
        hists = []
        for e in kmdir.fof:
            info, hu, hn = F.read_hist_file(kmdir.get_hist_path(e.id))
            h = KHist(info.id, info.kmer_size, info.lower, info.upper)
            h.hist_u, h.hist_n = hu, hn
            h.uniq, h.total = info.uniq, info.total
            hists.append(h)
        thr = compute_merge_thresholds(hists, p, kmdir.get_merge_th_path())
        return np.asarray(thr, dtype=np.uint32)
    with open(spec) as f:
        vals = [int(line) for line in f if line.strip()]
    if len(vals) != nsamp:
        raise ValueError(f"soft-min file: {len(vals)} values, "
                         f"expected {nsamp}")
    return np.asarray(vals, dtype=np.uint32)


def stage_merge(kmdir: KmDir, config: Config, opts: PipelineOptions,
                partition: int, amin_vec: np.ndarray) -> None:
    cf, mode, out = parse_mode(opts.mode)
    nsamp = len(kmdir.fof)
    keys_list, counts_list = [], []
    cpr_in = opts.cpr
    for path in kmdir.get_files_to_merge(partition, cpr_in, cf):
        if cf == "kmer":
            _, kk, cc = F.read_kmer_file(path)
        else:
            _, kk, cc = F.read_hash_file(path)
        keys_list.append(kk)
        counts_list.append(cc)

    merger = _merge_backend(opts)
    res = merger(keys_list, counts_list, amin_vec,
                 opts.recurrence_min, opts.share_min)
    write_merge_outputs(kmdir, config, opts, partition, res)


def write_merge_outputs(kmdir: KmDir, config: Config, opts: PipelineOptions,
                        partition: int, res) -> None:
    """Write one partition's merged outputs (matrix / pa / bf / bfc / bft,
    merge_infos, fpr) from a MergeResult — shared by the file-merge stage
    and the fused mesh pipeline."""
    cf, mode, out = parse_mode(opts.mode)
    nsamp = len(kmdir.fof)
    out_path = kmdir.get_matrix_path(partition, mode, out, cf,
                                     opts.cpr and mode in ("count", "pa"))
    kept = res.keep
    if opts.plugin:
        from kmtricks_tpu_torch.runtime.plugin import (
            apply_plugin, load_plugin)
        plugin = load_plugin(opts.plugin, opts.plugin_config)
        plugin.set_out_dir(kmdir.plugin_storage)
        plugin.set_kmer_size(0 if cf == "hash" else config.kmer_size)
        plugin.set_partition(partition)
        # the plugin verdict REPLACES the recurrence one (merge.hpp:252-257)
        kept = apply_plugin(plugin, res.keys, res.counts, cf == "hash")
        res.keep = kept
    keys = res.keys[kept] if len(res.keys) else res.keys
    counts = res.counts[kept] if len(res.counts) else res.counts
    cb = config.count_bytes

    if mode == "count" and out == "bin":
        if cf == "kmer":
            F.write_matrix_file(out_path, keys, counts, config.kmer_size,
                                cb, 0, partition, compressed=opts.cpr)
        else:
            F.write_matrix_hash_file(out_path, keys, counts, cb, 0,
                                     partition, compressed=opts.cpr)
    elif mode == "count" and out == "text":
        _write_matrix_text(out_path, keys, counts, cf, config.kmer_size,
                           pa=False)
    elif mode == "pa" and out == "bin":
        rows = F.pack_pa_bits(counts > 0)
        if cf == "kmer":
            F.write_pa_matrix_file(out_path, keys, rows, config.kmer_size,
                                   nsamp, 0, partition, compressed=opts.cpr)
        else:
            F.write_pa_hash_matrix_file(out_path, keys, rows, nsamp, 0,
                                        partition, compressed=opts.cpr)
    elif mode == "pa" and out == "text":
        _write_matrix_text(out_path, keys, counts, cf, config.kmer_size,
                           pa=True)
    elif mode in ("bf", "bfc", "bft"):
        hw = HashWindow.load(kmdir.hash_win)
        lower, upper = hw.lower(partition), hw.upper(partition)
        window = upper - lower + 1
        if mode == "bfc":
            rows = np.zeros((window, F.nbytes(nsamp * opts.bitw)),
                            dtype=np.uint8)
            if kept.any():
                rel = (res.keys[kept].astype(np.int64) - lower)
                rows[rel] = hops.pack_counting_bf(counts, opts.bitw)
            F.write_vector_matrix_file(out_path, rows, nsamp * opts.bitw,
                                       0, partition, lower, window)
        else:
            rows = hops.bf_rows_from_merge(
                res, lower, upper, nsamp,
                threads=max(1, getattr(opts, 'threads', 1) or 1))
            if mode == "bft":
                # merge.hpp:631-644. KMTRICKS_TPU_BFT=device routes the
                # JAX package's bit transpose to the device
                if os.environ.get("KMTRICKS_TPU_BFT") == "device":
                    raise NotImplementedError(
                        "the device bit transpose (KMTRICKS_TPU_BFT=device) "
                        "is ROADMAP slice 4 of the port")
                rows = transpose_bits(rows)
            F.write_vector_matrix_file(out_path, rows, nsamp, 0,
                                       partition, lower, window)

    res.stats.serialize(kmdir.get_merge_info_path(partition))
    if mode == "bf":   # task.hpp:849-860
        hw = HashWindow.load(kmdir.hash_win)
        with open(kmdir.get_fpr_path(partition), "w") as f:
            for n in res.stats.uniq_w_rescue:
                f.write(f"{bloom_fp(hw.window_size_bits, int(n)):.6f}\n")


def stage_format(kmdir: KmDir, config: Config, opts: PipelineOptions) -> None:
    """Assemble per-sample HowDe-SBT BFs by gathering each sample's window
    slice across all partitions (BloomBuilderFromHash/Vec semantics,
    howde_utils.hpp:133-214; requires mode hash:bft or vector counts)."""
    from kmtricks_tpu_torch.io.howde import write_bf_file

    hw = HashWindow.load(kmdir.hash_win)
    nsamp = len(kmdir.fof)
    nb = F.nbytes(hw.window_size_bits)
    slices = [[] for _ in range(nsamp)]
    for p in range(config.nb_partitions):
        path = kmdir.get_matrix_path(p, "bft", "bin", "hash", False)
        info, payload = F.read_vector_matrix_payload(path)
        # bft payload: transposed rows — ROUND_UP(nsamp,8) rows of
        # ROUND_UP(window,8)/8 bytes (merge.hpp:631-644)
        rows = payload.reshape(round_up(nsamp, 8),
                               round_up(info.window, 8) // 8)
        for s in range(nsamp):
            slices[s].append(rows[s, :nb])
    for s, entry in enumerate(kmdir.fof):
        bits = np.concatenate(slices[s])
        write_bf_file(kmdir.get_filter_path(entry.id, opts.bf_format),
                      bits, hw.bloom_size, config.kmer_size,
                      fmt=opts.bf_format)


def _write_matrix_text(path: str, keys, counts, cf: str, k: int,
                       pa: bool) -> None:
    """Text matrix rows (merge.hpp:288-316 / 531-573)."""
    with open(path, "w") as f:
        if cf == "kmer":
            names = kmers_to_strings(keys, k)
        else:
            names = [str(int(h)) for h in np.asarray(keys).ravel()]
        for i, name in enumerate(names):
            row = counts[i]
            if pa:
                vals = " ".join("1" if c > 0 else "0" for c in row)
            else:
                vals = " ".join(str(int(c)) for c in row)
            f.write(f"{name} {vals}\n")


def _finish(kmdir: KmDir, t0: float) -> KmDir:
    import resource

    wall = time.time() - t0
    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    with open(kmdir.run_infos, "w") as f:   # task_scheduler.hpp:448-457
        f.write(f"Done in {wall:.2f}s - Peak RSS -> {peak_mb} MB\n")
    return kmdir


# ---------------------------------------------------------------------------
# The device pipeline
# ---------------------------------------------------------------------------

# bytes of device sort operands per window: the JAX package's single-step
# budget (--max-memory / 48 windows)
BYTES_PER_WINDOW = 48


def _packs(opts: PipelineOptions) -> bool:
    """The sort layout packs (k2, k3 or kw; h1/h2 in hash mode), where
    the JAX package's ``stream_layout`` gives a layout, for an explicit
    --nb-partitions; an automatic count is checked once the config has set
    it."""
    if opts.nb_partitions <= 0:
        return True
    nsamp, nparts = len(Fof.parse(opts.fof)), opts.nb_partitions
    window = HashWindow(opts.bloom_size, nparts,
                        opts.minim_size).window_size_bits
    try:
        stream_layout(opts.kmer_size, nparts, nsamp,
                      parse_mode(opts.mode)[0], window)
    except NotImplementedError:
        return False
    return True


def check_slice(opts: PipelineOptions) -> None:
    """Raise NotImplementedError for options outside the ported slices."""
    parse_mode(opts.mode)
    unported = [
        (opts.until not in ("merge", "all"), f"--until {opts.until}"),
        (opts.minim_type == 1, "--minimizer-type 1"),
        (opts.restrict_to < 1.0 or bool(opts.restrict_to_list),
         "--restrict-to / --restrict-to-list"),
        (opts.kff, "--kff-output"),
        (not _packs(opts),
         f"{opts.nb_partitions} partitions at k = {opts.kmer_size} with "
         f"--mode {opts.mode} (no packed sort layout; the JAX package's "
         "stage_mesh_chunked is not ported)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(
                f"kmtricks_tpu_torch does not port {what} yet; run "
                "kmtricks_tpu instead")


def run_pipeline(opts: PipelineOptions, device="cuda", *,
                 chunk_windows: int | None = None,
                 table_cap: int | None = None):
    """Run ``pipeline`` for the ported slices on ``device`` (a CUDA
    device; "cpu" runs the kernels' plain versions). ``chunk_windows`` and
    ``table_cap`` set the streaming engine's chunk size and table budget
    (defaults: the one-step budget and the JAX engine's). ``bft`` outputs
    end with the per-sample filters (:func:`stage_format`) on both
    branches. Returns the KmDir."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if _is_float_quantile(opts.soft_min) and not opts.hist:
        # the quantile thresholds are read from the histogram files
        log.info("float --soft-min: enabling histograms")
        opts.hist = True
    check_slice(opts)
    t0 = time.time()
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts, device)
    if getattr(repart, "freq", None) is not None:
        raise NotImplementedError("frequency-ordered minimizers")
    budget_windows = int(opts.max_memory_mb * 1e6 / BYTES_PER_WINDOW)

    def engine(**kw):
        stage_mesh_stream(kmdir, config, opts, repart, None, device=device,
                          chunk_windows=chunk_windows or budget_windows,
                          table_cap=table_cap, **kw)

    # an upper bound on the bases (gz sized x4): beyond the one-step
    # budget the collection streams from the banks and is never loaded
    est_bytes = sum(os.path.getsize(p) * (4 if p.endswith("gz") else 1)
                    for e in kmdir.fof for p in e.paths)
    if est_bytes > budget_windows:
        engine(use_stream=True)
    else:
        batch, lengths, sarr = _load_global_batch(kmdir, opts)
        n_windows = batch.shape[0] * (batch.shape[1] - config.kmer_size + 1)
        if n_windows > budget_windows or _needs_host_aggregation(opts):
            engine(batch=batch, lengths=lengths, sarr=sarr)
        else:
            amin_vec = resolve_soft_min(opts.soft_min, kmdir,
                                        len(kmdir.fof))
            stage_count_merge(kmdir, config, opts, repart, amin_vec, batch,
                              lengths, sarr, device)
        del batch, lengths, sarr
    if parse_mode(opts.mode)[1] == "bft":
        stage_format(kmdir, config, opts)
    return _finish(kmdir, t0)
