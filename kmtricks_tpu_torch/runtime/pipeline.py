"""``pipeline`` command: config -> repartition -> count -> merge.

Counterpart of ``kmtricks_tpu/runtime/pipeline.py`` and, for the fused
branch, of ``kmtricks_tpu/runtime/device_pipeline.py::run_mesh_pipeline``
over a mesh of devices (every visible GPU by default).
:func:`run_pipeline` routes as the JAX package's ``_resolve_backend``
does (:func:`_resolve_backend`):

* ``mesh`` (what ``auto`` takes for ``--until merge|all`` without
  ``--minimizer-type 1``, ``--restrict-to[-list]`` or ``--kff-output``):
  a collection that fits one device step takes the fused step
  (:mod:`kmtricks_tpu_torch.runtime.device_pipeline`); a larger one, or a
  run that wants histograms or a float soft-min, takes the streaming
  engine (:mod:`kmtricks_tpu_torch.runtime.stream_engine`), or, for the
  sort layouts no packed word takes, the host-aggregated
  ``stage_mesh_chunked``;
* ``device`` (what ``auto`` takes otherwise): the per-stage path, one
  sample's count (``ops/pipeline.py::count_sample_device``, kernels K1/K2)
  and one partition's merge (``ops/merge.py::merge_partition_device``) at
  a time on the device, through the run directory, as the module
  commands (``runtime/modules.py``) run them;
* ``host``, only when asked for: the same stages in numpy.

Every --mode (k-mer and hash count formats; count, pa, bf, bft and bfc;
bin and text outputs), k <= 128, the repartition tally on the device and
``--static-repart`` run on each. Nothing falls back to another path.

The stages are copies of those of ``kmtricks_tpu/runtime/pipeline.py``:
the options and mode grammar, config, the repartition (numpy tally on the
host, :mod:`kmtricks_tpu_torch.ops.repart_sample` on a device), the
per-sample count, the per-partition merge, the soft-min, the writers
(bft windows are bit-transposed on the run's device; numpy on the host
backend) and the run summary.
"""

from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from kmtricks_tpu_torch import constants as C
from kmtricks_tpu_torch.core.bitmatrix import (
    transpose_bits, transpose_bits_device)
from kmtricks_tpu_torch.core.hashers import HashWindow, bloom_fp, round_up
from kmtricks_tpu_torch.core.histogram import KHist, compute_merge_thresholds
from kmtricks_tpu_torch.core.kmer import kmers_to_strings
from kmtricks_tpu_torch.core.repartition import Repartition
from kmtricks_tpu_torch.host import ops as hops
from kmtricks_tpu_torch.io import formats as F
from kmtricks_tpu_torch.io import sequences as seqio
from kmtricks_tpu_torch.ops.count_merge import stream_layout
from kmtricks_tpu_torch.runtime.config import (
    Config, configure, save_gatb_config)
from kmtricks_tpu_torch.parallel.pipeline import make_mesh
from kmtricks_tpu_torch.runtime.device_pipeline import (
    _is_float_quantile, _load_global_batch, _needs_host_aggregation,
    hash_window_bits, stage_mesh_chunked, stage_mesh_count_merge)
from kmtricks_tpu_torch.runtime import trace
from kmtricks_tpu_torch.runtime.kmdir import KmDir
from kmtricks_tpu_torch.runtime.stream_engine import stage_mesh_stream

log = logging.getLogger("kmtricks_tpu")

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
    backend: str = "auto"         # auto | host | device | mesh (auto:
                                  # mesh or device on the run's device;
                                  # host numpy only when asked for)
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
# Stages (copies of kmtricks_tpu/runtime/pipeline.py)
# ---------------------------------------------------------------------------

def require_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and
    CUDA is not available (no path falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    return device


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
# many cells (reads x width): rows halve as the width grows, so a
# long-read bank never forces a REPART_BLOCK x max_len block (the JAX
# package's CELL_BUDGET)
REPART_BLOCK = 65536
# host buffers the producer fills blocks into, in turn
REPART_RING = 4


def _read_width(lengths: np.ndarray) -> int:
    """The longest of ``lengths`` rounded up to 8: a tally block's width."""
    return -(-int(lengths.max(initial=0)) // 8) * 8


class _BlockRing:
    """The producer's host buffers: ``REPART_RING`` slots of block bytes
    and lengths, page-locked on a CUDA device and reused in turn. A slot
    is refilled only after the event recorded on its last host-to-device
    copy has completed; on another device the upload copies the block
    (``clone``), so the slot is free at once."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pin = device.type == "cuda"
        self.slots: list = [None] * REPART_RING
        self.taken = 0

    def take(self, B: int, L: int):
        """The next slot in turn once its last copy has ended, grown to
        hold a (B, L) block: (slot, block (B, L) uint8, lengths (B,)
        int32), the last two numpy views to fill."""
        s = self.taken % len(self.slots)
        self.taken += 1
        slot = self.slots[s]
        if slot is not None and slot[2] is not None:
            slot[2].synchronize()
        if slot is None or slot[0].numel() < B * L or slot[1].numel() < B:
            slot = [torch.empty(B * L, dtype=torch.uint8, pin_memory=self.pin),
                    torch.empty(B, dtype=torch.int32, pin_memory=self.pin),
                    None]
            self.slots[s] = slot
        return (slot, slot[0].numpy()[:B * L].reshape(B, L),
                slot[1].numpy()[:B])

    def upload(self, slot, B: int, L: int):
        """The slot's (B, L) block and (B,) lengths on the device."""
        blk, lens = slot[0][:B * L].view(B, L), slot[1][:B]
        if not self.pin:
            return blk.clone(), lens.clone()
        out = (blk.to(self.device, non_blocking=True),
               lens.to(self.device, non_blocking=True))
        slot[2] = torch.cuda.Event()
        slot[2].record(torch.cuda.current_stream(self.device))
        return out


def _sample_minimizer_bins_device(kmdir: KmDir, config: Config, device,
                                  bam_filter=None,
                                  freq_order=None) -> np.ndarray:
    """Device SampleRepart (counterpart of the JAX package's
    ``_sample_minimizer_bins_device``): a producer thread gathers the
    first-N sampled reads into (B, L) blocks of raw ASCII bytes, B the
    rows gathered and L the longest read rounded up to 8, filled into a
    ring of page-locked buffers (:class:`_BlockRing`) and uploaded
    ``non_blocking``; each block's tally (``ops/repart_sample.py::
    tally_step``, which encodes the bytes on the device) adds into a
    (4^m,) int64 table that stays on ``device`` until the end. Bit-equal
    to the host tally."""
    import queue as queue_mod
    import threading

    from kmtricks_tpu_torch.ops import repart_sample as rs

    k, m = config.kmer_size, config.minim_size
    device = torch.device(device)
    block = REPART_BLOCK
    freq = (None if freq_order is None else torch.from_numpy(
        np.asarray(freq_order, np.int64)).to(device))

    def cap_rows(L: int) -> int:
        B = block
        while B > 128 and B * L > block * 512:
            B //= 2
        return B

    ring = _BlockRing(device)
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

    def emit(pieces, nrows):
        """The buffered ``nrows`` reads as one block: (nrows, L), L the
        longest of them rounded up to 8, each row 'N' past its read.
        Eager torch compiles nothing per shape, so neither rows nor width
        are padded further."""
        L = max(_read_width(lengths) for _, lengths in pieces)
        slot, blk, lens = ring.take(nrows, L)
        with trace.span("repart.pack", blk.nbytes):
            r = 0
            for batch, lengths in pieces:
                n, w = len(lengths), min(batch.shape[1], L)
                blk[r:r + n, :w] = batch[:, :w]
                blk[r:r + n, w:] = ord("N")
                lens[r:r + n] = lengths
                r += n
        trace.count("repart.bases", int(lens.sum()))
        with trace.span("repart.upload", blk.nbytes + lens.nbytes):
            item = ring.upload(slot, nrows, L)
        put(item)

    def producer():
        try:
            pieces, nrows, L = [], 0, 0
            batches = _sample_batches(kmdir, config, bam_filter)
            while True:
                with trace.span("repart.parse") as parse:
                    got = next(batches, None)
                    if got is not None:
                        parse.n = got[0].nbytes
                if got is None:
                    break
                batch, lengths = got
                while len(lengths):
                    newL = max(L, _read_width(lengths))
                    cap = cap_rows(newL)
                    if nrows >= cap:
                        # widening would overflow this block: flush it at
                        # the current (narrower) width and start again
                        emit(pieces, nrows)
                        pieces, nrows, L = [], 0, 0
                        continue
                    take = min(len(lengths), cap - nrows)
                    pieces.append((batch[:take], lengths[:take]))
                    batch, lengths = batch[take:], lengths[take:]
                    nrows += take
                    L = newL
                    if nrows >= cap_rows(L):
                        emit(pieces, nrows)
                        pieces, nrows, L = [], 0, 0
            if nrows:
                emit(pieces, nrows)
        except BaseException as e:  # noqa: BLE001 - raised by the consumer
            put(e)
            return
        put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    bins = rs.make_bins(m, device)
    try:
        while True:
            with trace.span("repart.tally_wait"):
                item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            blk, lens = item
            with trace.span("repart.tally_step", int(lens.shape[0])):
                rs.tally_step(bins, blk, lens, k=k, m=m, freq_table=freq)
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
        with trace.span("repart.place", len(bins)):
            if config.repart_type == 1:
                # computeDistrib is computed then overwritten in the
                # reference (RepartitionAlgorithm.cpp:483-488) — net effect
                # is lexi only
                rep = Repartition.from_bin_sizes_lexi(bins,
                                                      config.nb_partitions)
            else:
                rep = Repartition.from_bin_sizes(bins, config.nb_partitions)
    with trace.span("repart.write"):
        rep.save(kmdir.repart_path)
        if config.minim_size <= 12:   # task.hpp:160-168
            rep.write_minimizers(
                kmdir.get_minim_paths(config.nb_partitions),
                config.minim_size)
    return rep


def _stage_backend(opts: PipelineOptions) -> str:
    """The backend of one stage (``device`` or ``host``): the module
    commands skip run_pipeline, so each stage resolves ``auto`` itself; a
    stage of ``mesh`` runs per sample or partition on the device."""
    backend = _resolve_backend(opts)
    return "device" if backend == "mesh" else backend


def _count_backend(opts: PipelineOptions, config: Config, device,
                   has_freq: bool = False):
    """The counter of one sample: on ``device`` for k <= 128 without a
    frequency-ordered minimizer table (which counts on the host, as in
    the JAX package), else the host's."""
    if _stage_backend(opts) == "device" and config.kmer_size <= 128 \
            and not has_freq:
        from kmtricks_tpu_torch.ops.pipeline import count_sample_device
        return partial(count_sample_device, device=require_device(device))
    return hops.count_sequences


def _merge_backend(opts: PipelineOptions, config: Config, cf: str, device):
    """The merge of one partition: on ``device`` for hashes and k <= 64
    (two u64 slots), else the host's, as in the JAX package."""
    if _stage_backend(opts) == "device" and (cf == "hash"
                                             or config.kmer_size <= 64):
        from kmtricks_tpu_torch.ops.merge import merge_partition_device
        return partial(merge_partition_device,
                       device=require_device(device))
    return hops.merge_partition


def stage_count(kmdir: KmDir, config: Config, repart: Repartition,
                sample_idx: int, opts: PipelineOptions,
                partitions: list[int] | None = None,
                count_mode: str | None = None,
                device="cuda") -> KHist | None:
    """Count one sample into per-partition files (on ``device`` under the
    device backend, see :func:`_count_backend`).

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
    counter = _count_backend(opts, config, device, freq is not None)
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
                from kmtricks_tpu_torch.io.kff import write_kff_file
                write_kff_file(
                    kmdir.get_count_part_path(entry.id, p, False, "kff"),
                    keys, counts, config.kmer_size, config.count_bytes)
        elif count_mode == "hash":
            path = kmdir.get_count_part_path(entry.id, p, opts.cpr, "hash")
            F.write_hash_file(path, keys, counts, config.count_bytes,
                              sample_idx, p, compressed=opts.cpr)
        elif count_mode == "kff":
            from kmtricks_tpu_torch.io.kff import write_kff_file
            write_kff_file(
                kmdir.get_count_part_path(entry.id, p, False, "kff"),
                keys, counts, config.kmer_size, config.count_bytes)
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
                partition: int, amin_vec: np.ndarray, device="cuda") -> None:
    """Merge one partition's count files and write its outputs (on
    ``device`` under the device backend, see :func:`_merge_backend`)."""
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

    merger = _merge_backend(opts, config, cf, device)
    res = merger(keys_list, counts_list, amin_vec,
                 opts.recurrence_min, opts.share_min)
    write_merge_outputs(kmdir, config, opts, partition, res,
                        None if _stage_backend(opts) == "host" else device)


def write_merge_outputs(kmdir: KmDir, config: Config, opts: PipelineOptions,
                        partition: int, res, device=None) -> None:
    """Write one partition's merged outputs (matrix / pa / bf / bfc / bft,
    merge_infos, fpr) from a MergeResult — shared by the file-merge stage
    and the fused mesh pipeline. ``device``: the run's device, which
    transposes the bft window (None on the host backend: numpy)."""
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
                rows = _bft_transpose(rows, device)
            F.write_vector_matrix_file(out_path, rows, nsamp, 0,
                                       partition, lower, window)

    res.stats.serialize(kmdir.get_merge_info_path(partition))
    if mode == "bf":   # task.hpp:849-860
        hw = HashWindow.load(kmdir.hash_win)
        with open(kmdir.get_fpr_path(partition), "w") as f:
            for n in res.stats.uniq_w_rescue:
                f.write(f"{bloom_fp(hw.window_size_bits, int(n)):.6f}\n")


def _bft_transpose(rows: np.ndarray, device) -> np.ndarray:
    """The bft window's bit transpose (merge.hpp:631-644) on the run's
    ``device`` (upload, transpose, download), or in numpy when the run has
    none (``--backend host``). The JAX package's ``KMTRICKS_TPU_BFT``
    switch is not read: the bytes are the same either way."""
    if device is None:
        return transpose_bits(rows)
    return transpose_bits_device(torch.from_numpy(rows).to(
        device)).cpu().numpy()


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


def build_bf_from_vectors(kmdir: KmDir, config: Config, sample_id: str,
                          bf_format: str = "howdesbt") -> str:
    """Assemble one sample's full Bloom filter by concatenating its
    per-partition window bit vectors (``count --mode vector`` output) —
    BloomBuilderFromVec (howde_utils.hpp:187-214)."""
    from kmtricks_tpu_torch.io.howde import write_bf_file

    hw = HashWindow.load(kmdir.hash_win)
    parts = []
    for p in range(config.nb_partitions):
        path = kmdir.get_count_part_path(sample_id, p, False, "vector")
        if not os.path.exists(path):
            path = kmdir.get_count_part_path(sample_id, p, True, "vector")
        (bits, _sid, _part), vec = F.read_bit_vector_file(path)
        parts.append(vec[:F.nbytes(hw.window_size_bits)])
    out = kmdir.get_filter_path(sample_id, bf_format)
    write_bf_file(out, np.concatenate(parts), hw.bloom_size,
                  config.kmer_size, fmt=bf_format)
    return out


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
# Full pipeline
# ---------------------------------------------------------------------------

# bytes of device sort operands per window: the JAX package's single-step
# budget (--max-memory / 48 windows)
BYTES_PER_WINDOW = 48


def _resolve_backend(opts: PipelineOptions) -> str:
    """``auto`` -> ``mesh`` (the fused step or the streaming engine) where
    the JAX package's ``_resolve_backend`` takes ``mesh`` on an
    accelerator, else ``device`` (the per-stage path). Every run of the
    port has a device (CUDA, or the CPU for the kernels' plain versions),
    so ``auto`` never takes ``host``; the numpy stages run only when asked
    for."""
    if opts.backend != "auto":
        return opts.backend
    if (opts.until in ("merge", "all") and opts.minim_type != 1
            and opts.restrict_to >= 1.0 and not opts.restrict_to_list
            and not opts.kff):
        return "mesh"
    return "device"


def run_pipeline(opts: PipelineOptions, device="cuda", *,
                 devices=None, chunk_windows: int | None = None,
                 table_cap: int | None = None):
    """Run ``pipeline`` on ``device`` (a CUDA device; "cpu" runs the
    kernels' plain versions), by the backend :func:`_resolve_backend`
    picks: the fused branch (:func:`_run_fused`), the per-stage path
    (:func:`_run_stages`), or with ``--backend host`` the numpy stages
    (which need no device). The fused branch runs over a mesh
    (``parallel/pipeline.py::make_mesh``): ``devices``, one per shard (a
    device may repeat), else every visible CUDA device for "cuda", else
    ``device`` alone. ``chunk_windows`` and ``table_cap`` set the
    streaming engine's chunk size and (per shard) table budget. Returns
    the KmDir. The run's spans (:mod:`~kmtricks_tpu_torch.runtime.trace`)
    are in ``trace.last_run`` once it returns or fails."""
    trace.begin_run()
    try:
        return _run_backend(opts, device, devices, chunk_windows,
                            table_cap)
    finally:
        # through the module: a wrapper put on trace.end_run takes effect
        trace.end_run()


def _run_backend(opts: PipelineOptions, device, devices, chunk_windows,
                 table_cap):
    """:func:`run_pipeline` on the backend :func:`_resolve_backend`
    picks."""
    if _is_float_quantile(opts.soft_min) and not opts.hist:
        # the quantile thresholds are read from the histogram files
        log.info("float --soft-min: enabling histograms")
        opts.hist = True
    backend = _resolve_backend(opts)
    if backend == "host":
        return _run_stages(opts, None)
    if backend == "mesh":
        if opts.until not in ("merge", "all"):
            raise ValueError("--backend mesh runs the fused count+merge "
                             "step; --until repart/superk/count need "
                             "--backend host/device")
        parse_mode(opts.mode)
        return _run_fused(opts, _fused_mesh(require_device(device), devices),
                          chunk_windows, table_cap)
    return _run_stages(opts, require_device(device))


def _run_stages(opts: PipelineOptions, device):
    """The per-stage pipeline (the non-mesh branch of the JAX package's
    ``run_pipeline``): config, repartition, then ``superk``, or each
    sample's count and each partition's merge (up to ``opts.threads`` at
    a time), then the per-sample filters of bft. ``device`` None runs the
    host stages."""
    t0 = time.time()
    cf, mode, out = parse_mode(opts.mode)
    if opts.kff and (opts.until != "count" or cf != "kmer"):
        raise ValueError("--kff-output requires --until count and kmer mode")
    if mode in ("bf", "bft", "bfc") and (opts.restrict_to < 1.0
                                         or opts.restrict_to_list):
        raise ValueError("bf modes require all partitions")

    kmdir, config = stage_config(opts)
    log.info("config: k=%d m=%d partitions=%d (estimated %d k-mers)",
             config.kmer_size, config.minim_size, config.nb_partitions,
             config.kmers_estimated)
    repart = stage_repart(kmdir, config, opts, device)
    log.info("repartition ready (%d minimizers -> %d partitions)",
             repart.nb_minimizers, repart.nb_partitions)
    if opts.until == "repart":
        return _finish(kmdir, t0)

    partitions = _selected_partitions(opts, config)
    from kmtricks_tpu_torch.runtime.progress import ProgressBar

    if opts.until == "superk":
        # superkmer files are a disk-era shuffle artifact; module parity is
        # provided by the `superk` command (see runtime/superk.py)
        from kmtricks_tpu_torch.runtime.superk import stage_superk
        with ProgressBar("superk", len(kmdir.fof)) as bar:
            for s in range(len(kmdir.fof)):
                log.info("superk [%s]", kmdir.fof.entries[s].id)
                stage_superk(kmdir, config, repart, s, opts)
                bar.tick()
        return _finish(kmdir, t0)

    with ProgressBar("count", len(kmdir.fof)) as bar:
        _pmap(opts.threads,
              lambda s: (log.info("count [%s]", kmdir.fof.entries[s].id),
                         stage_count(kmdir, config, repart, s, opts,
                                     partitions=partitions, device=device),
                         bar.tick()),
              range(len(kmdir.fof)))
    if opts.until == "count":
        return _finish(kmdir, t0)

    amin_vec = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    merge_parts = (partitions if partitions is not None
                   else range(config.nb_partitions))
    with ProgressBar("merge", len(list(merge_parts))) as bar:
        _pmap(opts.threads,
              lambda p: (log.info("merge [partition %d]", p),
                         stage_merge(kmdir, config, opts, p, amin_vec,
                                     device=device),
                         bar.tick()),
              merge_parts)

    if mode == "bft":
        log.info("format: per-sample Bloom filters")
        stage_format(kmdir, config, opts)
    return _finish(kmdir, t0)


def _pmap(threads: int, fn, items) -> None:
    """Run ``fn`` over ``items`` on a host thread pool (the reference's
    TaskPool, task_pool.hpp:36-120; each item writes independent files, and
    numpy/zlib release the GIL in the heavy ops)."""
    items = list(items)
    if threads <= 1 or len(items) <= 1:
        for it in items:
            fn(it)
        return
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(fn, items))


def _selected_partitions(opts: PipelineOptions,
                         config: Config) -> list[int] | None:
    if opts.restrict_to_list:
        return sorted(opts.restrict_to_list)
    if opts.restrict_to < 1.0:   # random fraction (cli.cpp --restrict-to)
        n = max(1, int(config.nb_partitions * opts.restrict_to))
        return sorted(random.sample(range(config.nb_partitions), n))
    return None


def _fused_mesh(device, devices) -> tuple:
    """The fused branch's mesh: ``devices`` (each checked), or every
    visible CUDA device for an unindexed "cuda", or ``device`` alone."""
    if devices is not None:
        return make_mesh([require_device(d) for d in devices])
    if device == torch.device("cuda"):
        return make_mesh()
    return (device,)


def _run_fused(opts: PipelineOptions, mesh, chunk_windows, table_cap):
    """The fused branch over ``mesh`` (counterpart of
    ``run_mesh_pipeline``): the one-step path, the streaming engine, or,
    for sort layouts no packed word takes (``stream_layout`` None), the
    host-aggregated chunked path where the engine would run; ``bft``
    outputs end with the per-sample filters (:func:`stage_format`) on
    every branch."""
    t0 = time.time()
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts, mesh[0])
    if getattr(repart, "freq", None) is not None:
        raise ValueError("--backend mesh does not support frequency-ordered "
                         "minimizers yet")
    budget_windows = int(opts.max_memory_mb * 1e6 / BYTES_PER_WINDOW)
    cf = parse_mode(opts.mode)[0]
    streamable = stream_layout(config.kmer_size, config.nb_partitions,
                               len(kmdir.fof), cf,
                               hash_window_bits(kmdir, cf)) is not None

    def engine(**kw):
        if streamable:
            stage_mesh_stream(kmdir, config, opts, repart, None, mesh=mesh,
                              chunk_windows=chunk_windows or budget_windows,
                              table_cap=table_cap, **kw)
        else:
            stage_mesh_chunked(kmdir, config, opts, repart, None, mesh=mesh,
                               chunk_windows=chunk_windows or budget_windows,
                               **kw)

    # an upper bound on the bases (gz sized x4): beyond the one-step
    # budget the collection streams from the banks and is never loaded
    est_bytes = sum(os.path.getsize(p) * (4 if p.endswith("gz") else 1)
                    for e in kmdir.fof for p in e.paths)
    if est_bytes > budget_windows:
        engine(use_stream=True)
    else:
        with trace.span("step.load"):
            batch, lengths, sarr = _load_global_batch(kmdir, opts,
                                                      len(mesh))
        n_windows = batch.shape[0] * (batch.shape[1] - config.kmer_size + 1)
        if n_windows > budget_windows or _needs_host_aggregation(opts):
            engine(batch=batch, lengths=lengths, sarr=sarr)
        else:
            amin_vec = resolve_soft_min(opts.soft_min, kmdir,
                                        len(kmdir.fof))
            stage_mesh_count_merge(kmdir, config, opts, repart, amin_vec,
                                   batch, lengths, sarr, mesh)
        del batch, lengths, sarr
    if parse_mode(opts.mode)[1] == "bft":
        stage_format(kmdir, config, opts)
    return _finish(kmdir, t0)
