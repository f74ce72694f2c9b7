"""``pipeline`` command: config -> repartition -> device count+merge.

Counterpart of ``kmtricks_tpu/runtime/device_pipeline.py::
run_mesh_pipeline`` on one device, for the slice this package ports:
``kmer:count:bin``, k <= 32. It routes as the JAX package does: a
collection that fits one device step takes the fused step
(:mod:`kmtricks_tpu_torch.runtime.device_pipeline`); a larger one, or a
run that wants histograms or a float soft-min, takes the streaming engine
(:mod:`kmtricks_tpu_torch.runtime.stream_engine`). The repartition,
soft-min and run-directory code is the JAX package's own host code
(numpy); the config stage is a twin whose build_infos.txt does not ask
jax for its version. Anything outside the slice raises
NotImplementedError; nothing falls back to another path.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from kmtricks_tpu.core.hashers import HashWindow
from kmtricks_tpu.io.fof import Fof
from kmtricks_tpu.runtime.config import configure, save_gatb_config
from kmtricks_tpu.runtime.kmdir import _SUBDIRS, KmDir
from kmtricks_tpu.runtime.pipeline import (
    PipelineOptions, _finish, parse_mode, resolve_soft_min, stage_repart)

from kmtricks_tpu_torch import build_infos
from kmtricks_tpu_torch.ops.count_merge import packed_layout
from kmtricks_tpu_torch.runtime.device_pipeline import (
    _is_float_quantile, _load_global_batch, _needs_host_aggregation,
    stage_count_merge)
from kmtricks_tpu_torch.runtime.stream_engine import stage_mesh_stream

log = logging.getLogger("kmtricks_tpu")

# bytes of device sort operands per window: the JAX package's single-step
# budget (--max-memory / 48 windows)
BYTES_PER_WINDOW = 48


def _packs(opts: PipelineOptions) -> bool:
    """The sort layout packs (k2 or k3) for an explicit --nb-partitions;
    an automatic count is checked once the config has set it."""
    if opts.nb_partitions <= 0 or not 0 < opts.kmer_size <= 32:
        return True
    try:
        packed_layout(len(Fof.parse(opts.fof)), 2 * opts.kmer_size,
                      (opts.nb_partitions - 1).bit_length())
    except NotImplementedError:
        return False
    return True


def check_slice(opts: PipelineOptions) -> None:
    """Raise NotImplementedError for options outside the ported slice."""
    cf, mode, out = parse_mode(opts.mode)
    unported = [
        ((cf, mode, out) != ("kmer", "count", "bin"),
         f"--mode {opts.mode} (only kmer:count:bin)"),
        (not 0 < opts.kmer_size <= 32, f"k = {opts.kmer_size} (only k <= 32)"),
        (opts.until not in ("merge", "all"), f"--until {opts.until}"),
        (opts.static_repart, "--static-repart"),
        (opts.minim_type == 1, "--minimizer-type 1"),
        (opts.restrict_to < 1.0 or bool(opts.restrict_to_list),
         "--restrict-to / --restrict-to-list"),
        (opts.kff, "--kff-output"),
        (not _packs(opts),
         f"{opts.nb_partitions} partitions at k = {opts.kmer_size} (no "
         "packed sort layout; the JAX package's stage_mesh_chunked)"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(
                f"kmtricks_tpu_torch does not port {what} yet; run "
                "kmtricks_tpu instead")


def _init_run_dir(opts: PipelineOptions) -> KmDir:
    """``KmDir.init(first=True)`` with the port's build_infos.txt (the JAX
    package's own asks jax for its version)."""
    kmdir = KmDir(opts.run_dir)
    os.makedirs(kmdir.root, exist_ok=True)
    Fof.parse(opts.fof).copy(kmdir.fof_path)
    kmdir.fof = Fof.parse(kmdir.fof_path)
    for sub in _SUBDIRS:
        os.makedirs(f"{kmdir.root}/{sub}", exist_ok=True)
    os.makedirs(kmdir.config_storage, exist_ok=True)
    os.makedirs(kmdir.repart_storage, exist_ok=True)
    with open(f"{kmdir.root}/build_infos.txt", "w") as f:
        f.write(build_infos())
    return kmdir


def stage_config(opts: PipelineOptions):
    """``kmtricks_tpu.runtime.pipeline.stage_config`` on the port's run
    directory: configuration, its GATB twin, hash.info, partition dirs and
    options.txt."""
    kmdir = _init_run_dir(opts)
    config = configure(kmdir.fof, opts.kmer_size, opts.minim_size,
                       opts.nb_partitions, opts.bloom_size,
                       opts.max_memory_mb, opts.mode, opts.hard_min,
                       opts.minim_type, opts.repart_type)
    config.mmer_scheme = opts.mmer_scheme
    config.save(kmdir.config_storage)
    save_gatb_config(config, kmdir.root)
    HashWindow(config.bloom_size, config.nb_partitions,
               config.minim_size).serialize(kmdir.hash_win)
    kmdir.init_parts(config.nb_partitions)
    with open(kmdir.options_path, "w") as f:
        f.write(opts.display())
    return kmdir, config


def _repart_on_host(kmdir, config, opts):
    """stage_repart with the host minimizer tally (the device tally is
    JAX)."""
    key = "KMTRICKS_REPART_SAMPLER"
    prev = os.environ.get(key)
    os.environ[key] = "host"
    try:
        return stage_repart(kmdir, config, opts)
    finally:
        if prev is None:
            del os.environ[key]
        else:
            os.environ[key] = prev


def run_pipeline(opts: PipelineOptions, device="cuda", *,
                 chunk_windows: int | None = None,
                 table_cap: int | None = None):
    """Run ``pipeline`` for the ported slice on ``device`` (a CUDA device;
    "cpu" runs the kernels' plain versions). ``chunk_windows`` and
    ``table_cap`` set the streaming engine's chunk size and table budget
    (defaults: the one-step budget and the JAX engine's). Returns the
    KmDir."""
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
    repart = _repart_on_host(kmdir, config, opts)
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
        return _finish(kmdir, t0)
    batch, lengths, sarr = _load_global_batch(kmdir, opts)
    n_windows = batch.shape[0] * (batch.shape[1] - config.kmer_size + 1)
    if n_windows > budget_windows or _needs_host_aggregation(opts):
        engine(batch=batch, lengths=lengths, sarr=sarr)
    else:
        amin_vec = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
        stage_count_merge(kmdir, config, opts, repart, amin_vec, batch,
                          lengths, sarr, device)
    return _finish(kmdir, t0)
