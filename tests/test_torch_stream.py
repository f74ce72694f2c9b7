"""The port's streaming engine as a whole: ``run_pipeline(device="cpu")``
through the engine against ``kmtricks_tpu --backend host``, byte for byte
(matrices, merge infos, histograms, fpr files and filters; k-mer and hash
keys, wide k in the kw layouts, --static-repart, the dense tail and the
pa-bits tail); the device pa finalize against
the JAX package's; the routing against the JAX package's
``run_mesh_pipeline``; and the prefetch thread's errors."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import kmtricks_tpu.runtime.device_pipeline as jdp
import kmtricks_tpu.runtime.pipeline as JP
import kmtricks_tpu.runtime.stream_engine as jse
from kmtricks_tpu.parallel.pipeline import build_merge_finalize_bits
from kmtricks_tpu_torch.parallel.pipeline import merge_finalize
from kmtricks_tpu.runtime.pipeline import PipelineOptions as JaxOptions
from kmtricks_tpu.runtime.pipeline import run_pipeline as jax_run_pipeline
from kmtricks_tpu_torch.runtime import pipeline as P
from kmtricks_tpu_torch.runtime import stream_engine as SE
from kmtricks_tpu_torch.runtime.device_pipeline import prefetched
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions, run_pipeline
from test_torch_pipeline import write_fof

torch.set_num_threads(2)


def write_odd_fof(tmp_path, deep=False):
    """Three samples of reads from one genome: reads longer than the
    engine's 4096-base rows (split with k - 1 overlap), reads with 'N',
    reads shorter than k, and duplicates (counts >= 2). ``deep``: sample 0
    also holds one 300-base read 300 times (counts >= 300)."""
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
        if deep and s == 0:
            reads += [genome[:300]] * 300
        path = tmp_path / f"S{s}.fasta"
        path.write_bytes(b"".join(b">r%d\n%s\n" % (i, r.tobytes())
                                  for i, r in enumerate(reads)))
        lines.append(f"S{s} : {path}")
    fof = tmp_path / "odd.fof"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


def run_dir_files(root):
    out = {}
    for sub in ("matrices", "merge_infos", "histograms", "fpr", "filters"):
        d = os.path.join(root, sub)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            with open(os.path.join(d, name), "rb") as f:
                out[f"{sub}/{name}"] = f.read()
    return out


# kw: PipelineOptions; engine: run_pipeline's engine keywords; fof: "ref"
# (the ten data_ref_exec samples), "odd" or "deep" (write_odd_fof);
# stream: the chunks come from the banks (est_bytes over the one-step
# budget); soft_mins: a per-sample --soft-min file; count_bytes: the
# configured count type of both runs
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
    "hash_bf_banks": dict(
        kw=dict(kmer_size=31, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1, mode="hash:bf:bin", bloom_size=800_000),
        stream=True),
    "hash_bft_banks_folds": dict(
        kw=dict(kmer_size=31, hard_min=1, soft_min="1", max_memory_mb=1,
                mode="hash:bft:bin", bloom_size=1_000_000),
        engine=dict(table_cap=92_000), stream=True, folds=True),
    "kmer_pa_banks_pa_tail": dict(
        kw=dict(kmer_size=31, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1, mode="kmer:pa:bin"), amin=True,
        stream=True, tail="pa_bits"),
    "hash_pa_banks_pa_tail": dict(
        kw=dict(kmer_size=21, hard_min=2, soft_min="1", recurrence_min=2,
                max_memory_mb=1, mode="hash:pa:bin", bloom_size=600_000),
        stream=True, tail="pa_bits"),
    # a soft-min above a 1-byte count type's 255: the host merge compares
    # the saturated counts with it as given, so sample 0 is never solid
    # (the JAX device tail clamps the soft-min to 255 first)
    "kmer_pa_soft_min_over_count_max_pa_tail": dict(
        kw=dict(kmer_size=21, hard_min=1, share_min=1, max_memory_mb=1,
                mode="kmer:pa:bin"), soft_mins=[300, 1, 1], count_bytes=1,
        fof="deep", stream=True, tail="pa_bits"),
    # wide k: kw tables of 2 (k = 45), 3 (k = 63) and 4 (k = 96) int64
    # words through the chunk step, K4's plain version and the tails
    "k45_banks_wide": dict(
        kw=dict(kmer_size=45, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1), stream=True),
    "k63_batch_folds_hist_wide": dict(
        kw=dict(kmer_size=63, hard_min=2, soft_min="1", hist=True),
        engine=dict(chunk_windows=3000, table_cap=78_000), folds=True),
    "k96_banks_long_reads_wide": dict(
        kw=dict(kmer_size=96, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1), fof="odd", stream=True),
    "k63_kmer_pa_banks_pa_tail_wide": dict(
        kw=dict(kmer_size=63, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1, mode="kmer:pa:bin"), amin=True,
        stream=True, tail="pa_bits"),
    "k45_hash_bf_banks": dict(
        kw=dict(kmer_size=45, hard_min=1, soft_min="2", share_min=1,
                max_memory_mb=1, mode="hash:bf:bin", bloom_size=800_000),
        stream=True),
    "k45_static_repart_banks": dict(
        kw=dict(kmer_size=45, hard_min=1, soft_min="1", max_memory_mb=1,
                static_repart=True), stream=True),
    # the dense tail's histogram branch (raw counts fetched for the
    # histograms and the quantile, then the device merge) with per-sample
    # hard-mins, over two shards
    "k31_banks_hist_soft_min_float_amin_two_shards": dict(
        kw=dict(kmer_size=31, hard_min=1, soft_min="0.5", share_min=1,
                max_memory_mb=1, hist=True), amin=True, stream=True,
        engine=dict(devices=["cpu", "cpu"])),
    "k31_static_repart_banks": dict(
        kw=dict(kmer_size=31, hard_min=2, soft_min="1", max_memory_mb=1,
                static_repart=True), stream=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_host_backend(tmp_path, case, monkeypatch):
    c = ENGINE_CASES[case]
    kw = dict(c["kw"], nb_partitions=4)
    if "soft_mins" in c:
        path = tmp_path / "soft_min.txt"
        path.write_text("".join(f"{v}\n" for v in c["soft_mins"]))
        kw["soft_min"] = str(path)
    if "count_bytes" in c:
        for mod in (P, JP):
            monkeypatch.setattr(
                mod, "configure", lambda *a, _real=mod.configure, **k:
                dataclasses.replace(_real(*a, **k),
                                    count_bytes=c["count_bytes"]))
    if c.get("fof") in ("odd", "deep"):
        fof = write_odd_fof(tmp_path, deep=c["fof"] == "deep")
    else:
        fof = write_fof(tmp_path / "c.fof", [1, 2, 1, 3, 1, 2, 2, 1, 1, 2]
                        if c.get("amin") else None)
    host = jax_run_pipeline(JaxOptions(
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
    assert stats["tail"] == c.get("tail", "dense")
    a, b = run_dir_files(host.root), run_dir_files(port.root)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    assert any(n.startswith("histograms/") for n in a) == bool(
        kw.get("hist") or kw["soft_min"] == "0.5")
    assert sum(len(v) for n, v in a.items() if n.startswith("mat")) > 1000
    if "soft_mins" in c:
        # the bank tells that rule from the clamped one
        cmax = (1 << (8 * c["count_bytes"])) - 1
        path = tmp_path / "soft_min_clamped.txt"
        path.write_text("".join(f"{min(v, cmax)}\n" for v in c["soft_mins"]))
        clamped = jax_run_pipeline(JaxOptions(
            fof=fof, run_dir=str(tmp_path / "clamped"), backend="host",
            **dict(kw, soft_min=str(path))))
        assert run_dir_files(clamped.root) != a


@pytest.mark.parametrize("count_bytes", [1, 2, 4])
@pytest.mark.parametrize("save_if", [0, 2])
def test_merge_finalize_bits_matches_jax(count_bytes, save_if):
    """The device pa finalize against the JAX package's
    build_merge_finalize_bits on a one-device CPU mesh: pa bits, keep
    flags, and the statistics (the JAX byte planes recombined)."""
    nsamp, rows, nb_parts = 11, 3000, 5
    count_max = (1 << (8 * count_bytes)) - 1
    rng = np.random.default_rng(count_bytes * 10 + save_if)
    top = min(count_max * 2, 2**32 - 1)
    pre = np.where(rng.random((rows, nsamp)) < 0.4,
                   rng.integers(1, 8, (rows, nsamp)),
                   rng.integers(0, top, (rows, nsamp),
                                dtype=np.uint64)).astype(np.uint32)
    pre[rng.random((rows, nsamp)) < 0.3] = 0
    amin = rng.integers(1, min(count_max, 6), nsamp).astype(np.uint32)
    hmv = rng.integers(1, 3, nsamp).astype(np.uint32)
    bounds = np.concatenate([[0], np.sort(rng.integers(0, rows, nb_parts - 1)),
                             [rows]]).astype(np.int32)
    rmin = 6
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("d",))
    packed_j, keep_j, planes = build_merge_finalize_bits(
        mesh, nsamp=nsamp, rows_cap=rows, rmin=rmin, save_if=save_if,
        count_max=count_max, nb_parts=nb_parts, count_bytes=count_bytes)(
        pre, amin, hmv, bounds)
    planes = np.asarray(planes).astype(np.uint64)
    cb = count_bytes
    tot_wo = sum(planes[4 + i] << np.uint64(8 * i) for i in range(cb))
    tot_rs = sum(planes[4 + cb + i] << np.uint64(8 * i) for i in range(cb))
    exp_stats = np.stack(list(planes[:4]) + [tot_wo, tot_wo + tot_rs])

    packed, keep, stats = merge_finalize(
        torch.from_numpy(pre.view(np.int32)),
        torch.from_numpy(amin.astype(np.int64)),
        torch.from_numpy(hmv.astype(np.int64)),
        torch.from_numpy(bounds.astype(np.int64)), rmin=rmin,
        save_if=save_if, count_max=count_max, bits=True)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j) > 0)
    np.testing.assert_array_equal(stats.numpy().astype(np.uint64),
                                  exp_stats)
    # in blocks of 63 rows, across the partitions' bounds
    blocked = merge_finalize(
        torch.from_numpy(pre.view(np.int32)),
        torch.from_numpy(amin.astype(np.int64)),
        torch.from_numpy(hmv.astype(np.int64)),
        torch.from_numpy(bounds.astype(np.int64)), rmin=rmin,
        save_if=save_if, count_max=count_max, bits=True, block=63 * nsamp)
    for x, y in zip(blocked, (packed, keep, stats)):
        assert torch.equal(x, y)
    assert keep.any() and not keep.all() and (stats[1].sum() > 0) == (
        save_if > 0)


def test_engine_table_overflow_raises(tmp_path):
    fof = write_fof(tmp_path / "c.fof")
    with pytest.raises(ValueError, match="device table overflow"):
        run_pipeline(PipelineOptions(
            fof=fof, run_dir=str(tmp_path / "rd"), kmer_size=31,
            nb_partitions=4, hist=True), device="cpu", chunk_windows=3000,
            table_cap=3000)


def test_engine_table_overflow_names_the_memory_that_holds_it(tmp_path):
    """The refusal names the --max-memory at which ``table_budget`` holds
    the entries that overflowed: the least such value past the budget's
    floor of 2^25 entries (a 40-sample k3 table of 211M entries, as a
    5x collection of 40 isolates gives, needs 12885 MB)."""
    import re

    from kmtricks_tpu_torch.ops.count_merge import stream_layout
    from kmtricks_tpu_torch.runtime.stream_engine import (
        memory_for, table_budget)

    fof = write_fof(tmp_path / "c.fof")
    with pytest.raises(ValueError, match="device table overflow") as err:
        run_pipeline(PipelineOptions(
            fof=fof, run_dir=str(tmp_path / "rd"), kmer_size=31,
            nb_partitions=4, hist=True), device="cpu", chunk_windows=3000,
            table_cap=3000)
    got = re.search(r"\((\d+) entries > .* holds them at --max-memory "
                    r"(\d+) MB", str(err.value))
    assert got and int(got.group(2)) == memory_for(
        int(got.group(1)), stream_layout(31, 4, 10, "kmer", 0), 10) == 1
    layout = stream_layout(31, 4, 40, "kmer", 0)
    assert table_budget(8192, layout, 40) < 211_000_000
    for entries in (2**25 + 1, 134_217_729, 211_000_000, 2**30):
        mb = memory_for(entries, layout, 40)
        assert table_budget(mb, layout, 40) >= entries > table_budget(
            mb - 1, layout, 40)
    assert memory_for(211_000_000, layout, 40) == 12885


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


UNPACKED_HASH = dict(mode="hash:count:bin", bloom_size=2**62)

# route: (fof, options, the branch: (stage, chunks from the banks))
ROUTES = {
    "one_step": ("ref", dict(), ("step", False)),
    "banks_by_est_bytes": ("ref", dict(max_memory_mb=1), ("engine", True)),
    "batch_by_padded_windows": ("mixed", dict(max_memory_mb=1),
                                ("engine", False)),
    "batch_for_hist": ("ref", dict(hist=True), ("engine", False)),
    "batch_for_float_soft_min": ("ref", dict(soft_min="0.5"),
                                 ("engine", False)),
    "wide_static_one_step": ("ref", dict(kmer_size=96, static_repart=True),
                             ("step", False)),
    "wide_banks_by_est_bytes": ("ref", dict(kmer_size=63, max_memory_mb=1),
                                ("engine", True)),
    # 62-bit window hashes with the sample: no packed layout
    "unpacked_one_step": ("ref", dict(UNPACKED_HASH), ("step", False)),
    "unpacked_banks_by_est_bytes": (
        "ref", dict(UNPACKED_HASH, max_memory_mb=1), ("chunked", True)),
    "unpacked_batch_by_padded_windows": (   # two samples: 63-bit hashes
        "mixed", dict(UNPACKED_HASH, bloom_size=2**63, max_memory_mb=1),
        ("chunked", False)),
    "unpacked_batch_for_hist": ("ref", dict(UNPACKED_HASH, hist=True),
                                ("chunked", False)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_matches_run_mesh_pipeline(tmp_path, route, monkeypatch):
    """The port takes the branch the JAX package's run_mesh_pipeline takes:
    the fused step, the engine (or, for layouts no packed word takes, the
    chunked path) from the banks, or over the loaded batch (both sides'
    stages are replaced by recorders)."""
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
    monkeypatch.setattr(P, "stage_mesh_count_merge", rec("port", "step"))
    monkeypatch.setattr(P, "stage_mesh_chunked", rec("port", "chunked"))
    opts = dict(dict(fof=fof, kmer_size=31, nb_partitions=4), **kw)
    jopts = JaxOptions(run_dir=str(tmp_path / "jax"), backend="mesh", **opts)
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
