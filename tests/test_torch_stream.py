"""The port's streaming engine as a whole: ``run_pipeline(device="cpu")``
through the engine against ``kmtricks_tpu --backend host``, byte for byte
(matrices, merge infos and histograms); the routing against the JAX
package's ``run_mesh_pipeline``; and the prefetch thread's errors."""

import os

import numpy as np
import pytest
import torch

import kmtricks_tpu.runtime.device_pipeline as jdp
import kmtricks_tpu.runtime.stream_engine as jse
from kmtricks_tpu.runtime.pipeline import PipelineOptions
from kmtricks_tpu.runtime.pipeline import run_pipeline as jax_run_pipeline
from kmtricks_tpu_torch.runtime import pipeline as P
from kmtricks_tpu_torch.runtime import stream_engine as SE
from kmtricks_tpu_torch.runtime.device_pipeline import prefetched
from kmtricks_tpu_torch.runtime.pipeline import run_pipeline
from test_torch_pipeline import write_fof

torch.set_num_threads(2)


def write_odd_fof(tmp_path):
    """Three samples of reads from one genome: reads longer than the
    engine's 4096-base rows (split with k - 1 overlap), reads with 'N',
    reads shorter than k, and duplicates (counts >= 2)."""
    rng = np.random.default_rng(11)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 20000)
    lines = []
    for s in range(3):
        reads = []
        for _ in range(40):
            n = int(rng.choice([15, 80, 300, 1500]))
            st = int(rng.integers(0, len(genome) - n))
            r = genome[st:st + n].copy()
            if rng.random() < 0.3:
                r[rng.integers(0, n, 2)] = ord("N")
            reads.append(r)
        reads += [genome[s * 100:s * 100 + 9000], genome[5000:11000]]
        reads += reads[:10]
        path = tmp_path / f"S{s}.fasta"
        path.write_bytes(b"".join(b">r%d\n%s\n" % (i, r.tobytes())
                                  for i, r in enumerate(reads)))
        lines.append(f"S{s} : {path}")
    fof = tmp_path / "odd.fof"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


def run_dir_files(root):
    out = {}
    for sub in ("matrices", "merge_infos", "histograms"):
        d = os.path.join(root, sub)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, name), "rb") as f:
                out[f"{sub}/{name}"] = f.read()
    return out


# kw: PipelineOptions; engine: run_pipeline's engine keywords; fof: "ref"
# (the ten data_ref_exec samples) or "odd" (write_odd_fof); stream: the
# chunks come from the banks (est_bytes over the one-step budget)
ENGINE_CASES = {
    "k31_banks_many_chunks": dict(
        kw=dict(kmer_size=31, hard_min=1, soft_min="1", max_memory_mb=1),
        stream=True),
    "k21_banks_amin_threads": dict(
        kw=dict(kmer_size=21, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1, threads=4), amin=True, stream=True),
    "k31_batch_folds_hist": dict(
        kw=dict(kmer_size=31, hard_min=2, soft_min="1", hist=True),
        engine=dict(chunk_windows=3000, table_cap=95_000), folds=True),
    "k21_batch_soft_min_float": dict(
        kw=dict(kmer_size=21, hard_min=1, soft_min="0.5", share_min=1,
                recurrence_min=2), engine=dict(chunk_windows=20_000)),
    "k21_banks_long_reads_n": dict(
        kw=dict(kmer_size=21, hard_min=1, soft_min="1", max_memory_mb=1,
                hist=True), fof="odd", stream=True),
    "k31_banks_long_reads_folds": dict(
        kw=dict(kmer_size=31, hard_min=2, soft_min="1", max_memory_mb=1),
        engine=dict(table_cap=55_000), fof="odd", stream=True, folds=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_host_backend(tmp_path, case, monkeypatch):
    c = ENGINE_CASES[case]
    kw = dict(c["kw"], nb_partitions=4)
    if c.get("fof") == "odd":
        fof = write_odd_fof(tmp_path)
    else:
        fof = write_fof(tmp_path / "c.fof", [1, 2, 1, 3, 1, 2, 2, 1, 1, 2]
                        if c.get("amin") else None)
    host = jax_run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "host"), backend="host", **kw))
    calls = []
    engine = P.stage_mesh_stream

    def recorded(*a, **k):
        calls.append(k.get("use_stream", False))
        return engine(*a, **k)

    monkeypatch.setattr(P, "stage_mesh_stream", recorded)
    port = run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "port"), **kw), device="cpu",
        **c.get("engine", {}))
    assert calls == [c.get("stream", False)]
    stats = SE.last_run
    assert stats["chunks"] >= 3
    if c.get("folds"):
        assert stats["folds"] >= 2
    a, b = run_dir_files(host.root), run_dir_files(port.root)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    assert any(n.startswith("histograms/") for n in a) == bool(
        kw.get("hist") or kw["soft_min"] == "0.5")
    assert sum(len(v) for n, v in a.items() if n.startswith("mat")) > 1000


def test_engine_table_overflow_raises(tmp_path):
    fof = write_fof(tmp_path / "c.fof")
    with pytest.raises(ValueError, match="device table overflow"):
        run_pipeline(PipelineOptions(
            fof=fof, run_dir=str(tmp_path / "rd"), kmer_size=31,
            nb_partitions=4, hist=True), device="cpu", chunk_windows=3000,
            table_cap=3000)


def write_mixed_fof(tmp_path):
    """One long read among short ones: few bases, many padded windows."""
    rng = np.random.default_rng(3)
    reads = [rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
             for n in [3000] + [60] * 100]
    p = tmp_path / "mixed.fasta"
    p.write_bytes(b"".join(b">r%d\n%s\n" % (i, r)
                           for i, r in enumerate(reads)))
    fof = tmp_path / "mixed.fof"
    fof.write_text(f"M0 : {p}\nM1 : {p}\n")
    return str(fof)


# route: (fof, options, the branch: (stage, chunks from the banks))
ROUTES = {
    "one_step": ("ref", dict(), ("step", False)),
    "banks_by_est_bytes": ("ref", dict(max_memory_mb=1), ("engine", True)),
    "batch_by_padded_windows": ("mixed", dict(max_memory_mb=1),
                                ("engine", False)),
    "batch_for_hist": ("ref", dict(hist=True), ("engine", False)),
    "batch_for_float_soft_min": ("ref", dict(soft_min="0.5"),
                                 ("engine", False)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_matches_run_mesh_pipeline(tmp_path, route, monkeypatch):
    """The port takes the branch the JAX package's run_mesh_pipeline takes:
    the fused step, the engine from the banks, or the engine over the
    loaded batch (both sides' stages are replaced by recorders)."""
    fof_kind, kw, branch = ROUTES[route]
    fof = (write_mixed_fof(tmp_path) if fof_kind == "mixed"
           else write_fof(tmp_path / "c.fof"))
    seen = {"jax": [], "port": []}

    def rec(side, name):
        def f(*a, **k):
            seen[side].append((name, bool(k.get("use_stream"))))
        return f

    monkeypatch.setattr(jse, "stage_mesh_stream", rec("jax", "engine"))
    monkeypatch.setattr(jdp, "stage_mesh_count_merge", rec("jax", "step"))
    monkeypatch.setattr(jdp, "stage_mesh_chunked", rec("jax", "chunked"))
    monkeypatch.setattr(P, "stage_mesh_stream", rec("port", "engine"))
    monkeypatch.setattr(P, "stage_count_merge", rec("port", "step"))
    opts = dict(fof=fof, kmer_size=31, nb_partitions=4, **kw)
    jopts = PipelineOptions(run_dir=str(tmp_path / "jax"), backend="mesh",
                            **opts)
    jax_run_pipeline(jopts)
    popts = PipelineOptions(run_dir=str(tmp_path / "port"), **opts)
    run_pipeline(popts, device="cpu")
    assert seen["jax"] == [branch]
    assert seen["port"] == [branch]
    assert popts.hist == jopts.hist


def test_prefetched_propagates_generator_errors():
    """An error on the prefetch thread fails the run; it does not end the
    stream early."""
    def boom():
        yield 1
        yield 2
        raise OSError("truncated gzip")

    got = []
    with pytest.raises(OSError, match="truncated gzip"):
        for x in prefetched(boom(), depth=1):
            got.append(x)
    assert got == [1, 2]
