"""The host-aggregated chunked path (``stage_mesh_chunked``) against the
JAX package's: called directly on the cases of tests/test_mesh_chunked.py
(k-mer and hash, four samples, many chunks, histograms, a float soft-min
and a per-sample hard-min), over meshes of CPU shards, run directories
byte for byte; and the sort layouts only it takes, through
``run_pipeline`` against ``kmtricks_tpu --backend host``."""

import os

import numpy as np
import pytest
import torch

from kmtricks_tpu.runtime import device_pipeline as jdp
from kmtricks_tpu.runtime import pipeline as JP
from kmtricks_tpu_torch.runtime import device_pipeline as DP
from kmtricks_tpu_torch.runtime import pipeline as P
from test_torch_pipeline import run_dir_files, write_fof

torch.set_num_threads(2)

BUDGET_1MB = int(1e6 / P.BYTES_PER_WINDOW)   # windows at --max-memory 1


@pytest.fixture(scope="module")
def fof_path(tmp_path_factory):
    """tests/test_mesh_chunked.py's bank: four samples of 200 reads of
    120 bp from one 8 kbp genome."""
    root = tmp_path_factory.mktemp("chunks")
    rng = np.random.default_rng(77)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=8000)
    lines = []
    for s in range(4):
        p = root / f"S{s}.fasta"
        with open(p, "w") as f:
            for r in range(200):
                start = int(rng.integers(0, len(genome) - 120))
                f.write(f">r{r}\n"
                        f"{bytes(genome[start:start + 120]).decode()}\n")
        lines.append(f"S{s} : {p}")
    (root / "c.fof").write_text("\n".join(lines) + "\n")
    return str(root / "c.fof")


def chunked_run(side, run_dir, kw, *, use_stream, resolve, mesh=None):
    """config and repartition, then the package's stage_mesh_chunked at
    --max-memory 1's chunk size (JAX over its 8-device CPU mesh).
    ``resolve`` passes the soft-min resolved, else None (resolved after
    the histograms). Returns the KmDir."""
    mod, dp = (JP, jdp) if side == "jax" else (P, DP)
    opts = mod.PipelineOptions(run_dir=str(run_dir), backend="mesh", **kw)
    kmdir, config = mod.stage_config(opts)
    repart = (mod.stage_repart(kmdir, config, opts) if side == "jax"
              else mod.stage_repart(kmdir, config, opts, "cpu"))
    amin = (mod.resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
            if resolve else None)
    extra = {} if side == "jax" else dict(mesh=mesh)
    if use_stream:
        extra["use_stream"] = True
    else:
        batch, lengths, sarr = (
            jdp._load_global_batch(kmdir, opts, config.kmer_size, 8)
            if side == "jax" else
            DP._load_global_batch(kmdir, opts, len(mesh)))
        extra.update(batch=batch, lengths=lengths, sarr=sarr)
    dp.stage_mesh_chunked(kmdir, config, opts, repart, amin,
                          chunk_windows=BUDGET_1MB, **extra)
    return kmdir


def chunked_files(root):
    out = run_dir_files(root)
    hist = os.path.join(root, "histograms")
    for name in sorted(os.listdir(hist)) if os.path.isdir(hist) else ():
        with open(os.path.join(hist, name), "rb") as f:
            out[f"histograms/{name}"] = f.read()
    return out


@pytest.mark.parametrize("mode", ["kmer:count:bin", "hash:bf:bin"])
@pytest.mark.parametrize("nshards,use_stream", [(1, True), (3, False)])
def test_chunked_matches_jax(tmp_path, fof_path, mode, nshards, use_stream,
                             monkeypatch):
    """tests/test_mesh_chunked.py's single-step case, chunked: many
    chunks, the soft-min resolved before the call (the JAX package's
    streaming merge), run directories byte-equal."""
    kw = dict(fof=fof_path, kmer_size=31, hard_min=2, soft_min="2",
              share_min=2, mode=mode, static_repart=True, nb_partitions=8,
              bloom_size=1_000_000, max_memory_mb=1)
    calls = []
    step = DP.build_sharded_pipeline
    monkeypatch.setattr(DP, "build_sharded_pipeline",
                        lambda *a, **k: calls.append(k) or step(*a, **k))
    chunk_steps = []
    real_step = DP.prefetched

    def counting(gen, depth):
        for item in real_step(gen, depth):
            chunk_steps.append(1)
            yield item

    monkeypatch.setattr(DP, "prefetched", counting)
    jax_dir = chunked_run("jax", tmp_path / "jax", kw,
                          use_stream=use_stream, resolve=True)
    port_dir = chunked_run("port", tmp_path / "port", kw,
                           use_stream=use_stream, resolve=True,
                           mesh=(torch.device("cpu"),) * nshards)
    # a pure counter, over many chunks
    assert [(c["hard_min"], c["rmin"], c["save_if"], c["count_max"])
            for c in calls] == [(1, 1, 0, 0xFFFFFFFF)]
    assert len(chunk_steps) >= 3
    a, b = chunked_files(jax_dir.root), chunked_files(port_dir.root)
    assert sorted(a) == sorted(b) and len(a) >= 16
    for name in a:
        assert a[name] == b[name], name
    assert sum(len(v) for n, v in a.items() if n.startswith("mat")) > 1000


@pytest.mark.parametrize("nshards,use_stream", [(1, False), (4, True)])
def test_chunked_hist_softmin_and_per_sample_hardmin(tmp_path, fof_path,
                                                     nshards, use_stream):
    """tests/test_mesh_chunked.py's host-aggregation features:
    histograms, a float soft-min quantile (resolved from the histogram
    files) and a per-sample hard-min override (`! 3`), against the JAX
    package's stage_mesh_chunked, histograms and merge thresholds
    included."""
    lines = open(fof_path).read().splitlines()
    fof2 = tmp_path / "o.fof"
    fof2.write_text("\n".join([lines[0] + " ! 3"] + lines[1:]) + "\n")
    kw = dict(fof=str(fof2), kmer_size=31, hard_min=2, soft_min="0.95",
              mode="kmer:count:bin", static_repart=True, nb_partitions=8,
              hist=True, max_memory_mb=1)
    jax_dir = chunked_run("jax", tmp_path / "jax", kw,
                          use_stream=use_stream, resolve=False)
    port_dir = chunked_run("port", tmp_path / "port", kw,
                           use_stream=use_stream, resolve=False,
                           mesh=(torch.device("cpu"),) * nshards)
    a, b = chunked_files(jax_dir.root), chunked_files(port_dir.root)
    assert sum(n.startswith("histograms/") for n in a) == 4
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    th = [open(d.get_merge_th_path(), "rb").read()
          for d in (jax_dir, port_dir)]
    assert th[0] == th[1] and th[0]


# the writable layouts that only the chunked path takes: 62 and 61-bit
# window hashes with ten samples (4 sample bits)
UNPACKED_RUNS = {
    "hash_count_2e62_4": dict(mode="hash:count:bin", bloom_size=2**62,
                              nb_partitions=4),
    "hash_pa_2e61_8": dict(mode="hash:pa:bin", bloom_size=2**61,
                           nb_partitions=8),
}


@pytest.mark.parametrize("max_memory_mb,branch", [
    (1, "stage_mesh_chunked"), (8192, "stage_mesh_count_merge")])
@pytest.mark.parametrize("case", sorted(UNPACKED_RUNS))
def test_unpacked_run_matches_host_backend(tmp_path, monkeypatch, case,
                                           max_memory_mb, branch):
    """``run_pipeline`` takes the chunked path past the one-step budget
    (the one-step path's generic sort below it, as the JAX package's
    run_mesh_pipeline does), byte-identical to ``kmtricks_tpu --backend
    host``."""
    kw = dict(UNPACKED_RUNS[case], kmer_size=31, hard_min=1, soft_min="2",
              share_min=1, max_memory_mb=max_memory_mb)
    fof = write_fof(tmp_path / "c.fof")
    from kmtricks_tpu_torch.ops.count_merge import stream_layout

    assert stream_layout(31, kw["nb_partitions"], 10, "hash",
                         kw["bloom_size"] // kw["nb_partitions"]) is None
    seen = []
    for name in ("stage_mesh_chunked", "stage_mesh_count_merge"):
        real = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, _n=name, _r=real, **k: (
            seen.append(_n), _r(*a, **k))[1])
    host = JP.run_pipeline(JP.PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "host"), backend="host", **kw))
    port = P.run_pipeline(P.PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "port"), **kw), device="cpu",
        devices=["cpu", "cpu"])
    assert seen == [branch]
    a, b = run_dir_files(host.root), run_dir_files(port.root)
    assert sorted(a) == sorted(b) and len(a) == 2 * kw["nb_partitions"]
    for name in a:
        assert a[name] == b[name], name
    assert sum(len(v) for n, v in a.items() if n.startswith("mat")) > 1000
