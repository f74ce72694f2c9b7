"""The port's slices as a whole: the fused step on one device (the
sharded step over a mesh of one CPU shard; k-mer and hash keys, k <= 32
and wide k) against the JAX package's build_single_chip_step, and ``run_pipeline`` on the CPU against
``kmtricks_tpu --backend host``, byte for byte, for every count format,
mode and output, wide k (the kw sort layouts) and --static-repart."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmtricks_tpu.parallel.pipeline import build_single_chip_step as jax_step
from kmtricks_tpu.runtime.pipeline import PipelineOptions as JaxOptions
from kmtricks_tpu.runtime.pipeline import run_pipeline as jax_run_pipeline
from kmtricks_tpu_torch import cli
from kmtricks_tpu_torch.convert import from_jax_inputs, keys_from_msb_words
from kmtricks_tpu_torch.parallel.pipeline import build_sharded_pipeline
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions, run_pipeline

torch.set_num_threads(2)


def build_single_chip_step(**kw):
    """The port's one-device step: the sharded step over a mesh of one
    CPU shard, its only output."""
    step = build_sharded_pipeline((torch.device("cpu"),), **kw)
    return lambda *args: step(*args)[0]

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data_ref_exec"


def synthetic_batch(seed, nsamp=4, B=24, L=256, m=8, nparts=4):
    """Reads sampled from one small genome with per-read errors, so
    k-mers repeat within and across samples."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 600)
    starts = rng.integers(0, 600 - L, B)
    batch = genome[starts[:, None] + np.arange(L)]
    err = rng.random(batch.shape) < 0.01
    batch[err] = rng.choice(np.frombuffer(b"ACGTN", np.uint8), err.sum())
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    for r in range(B):
        batch[r, lengths[r]:] = ord("N")
    samp = rng.integers(0, nsamp, B).astype(np.int32)
    table = rng.integers(0, nparts, 4 ** m).astype(np.int32)
    amin = rng.integers(1, 4, nsamp).astype(np.uint32)
    return batch, lengths, samp, table, amin


@pytest.mark.parametrize("k,params", [(31, (2, 1, 2)), (21, (1, 2, 0))])
def test_single_chip_step_matches_jax(k, params):
    hard_min, rmin, save_if = params
    nsamp, m, nparts = 4, 8, 4
    batch, lengths, samp, table, amin = synthetic_batch(k, nsamp, m=m,
                                                        nparts=nparts)
    step = jax.jit(jax_step(k=k, m=m, nsamp=nsamp, hard_min=hard_min,
                            rmin=rmin, save_if=save_if, count_max=255,
                            nb_parts=nparts, with_stats=False,
                            compact_rows=8192))
    rows_j, pre_j, nrows_j, maxc_j, npres_j = step(batch, lengths, samp,
                                                   table, amin)
    args = from_jax_inputs(batch, lengths, samp, table, amin, None, "cpu")
    rows, pre, nrows, maxc, npres = build_single_chip_step(
        k=k, m=m, nsamp=nsamp, nb_parts=nparts, hard_min=hard_min,
        rmin=rmin, save_if=save_if, count_max=255)(*args[:5])
    assert (nrows, maxc, npres) == (int(nrows_j), int(maxc_j), int(npres_j))
    assert nrows > 100
    rows_j = np.asarray(rows_j)[:nrows]
    np.testing.assert_array_equal(
        rows[:, 0].numpy(),
        keys_from_msb_words(rows_j[:, 0], rows_j[:, 1]).numpy())
    np.testing.assert_array_equal(rows[:, 1].numpy(), rows_j[:, 2])
    np.testing.assert_array_equal(pre.numpy(),
                                  np.asarray(pre_j)[:nrows].astype(np.int64))


def test_single_chip_hash_step_matches_jax():
    """mode="hash": the window hashes, their partitions (hash // window)
    and the counts of the compacted rows, against the JAX hash step."""
    nsamp, m, nparts, k, w = 4, 8, 4, 31, 250_048
    batch, lengths, samp, table, amin = synthetic_batch(5, nsamp, m=m,
                                                        nparts=nparts)
    step = jax.jit(jax_step(k=k, m=m, nsamp=nsamp, hard_min=2, rmin=2,
                            save_if=1, count_max=255, nb_parts=nparts,
                            mode="hash", window_bits=w, with_stats=False,
                            compact_rows=8192))
    rows_j, pre_j, nrows_j, maxc_j, npres_j = step(batch, lengths, samp,
                                                   table, amin)
    args = from_jax_inputs(batch, lengths, samp, table, amin, None, "cpu")
    rows, pre, nrows, maxc, npres = build_single_chip_step(
        k=k, m=m, nsamp=nsamp, nb_parts=nparts, hard_min=2, rmin=2,
        save_if=1, count_max=255, mode="hash", window_bits=w)(*args[:5])
    assert (nrows, maxc, npres) == (int(nrows_j), int(maxc_j), int(npres_j))
    assert nrows > 100
    rows_j = np.asarray(rows_j)[:nrows]
    hashes = keys_from_msb_words(rows_j[:, 0], rows_j[:, 1]).numpy()
    np.testing.assert_array_equal(rows[:, 0].numpy(), hashes)
    np.testing.assert_array_equal(rows[:, 1].numpy(), hashes // w)
    assert len(np.unique(hashes // w)) == nparts
    np.testing.assert_array_equal(pre.numpy(),
                                  np.asarray(pre_j)[:nrows].astype(np.int64))


def write_fof(path, amin=None):
    """Ten multi-file samples over the data_ref_exec collections: sample c
    reads collection c, its first file once more (counts >= 2) and the
    first file of collection c + 1 (k-mers shared with the next sample at
    count 1), so soft-min, rescue and recurrence all decide rows.
    Optional per-sample `! amin`."""
    lines = []
    for c in range(10):
        files = sorted(str(p) for p in DATA.glob(f"c{c}_*.fasta"))
        files += [str(DATA / f"c{c}_0.fasta"),
                  str(DATA / f"c{(c + 1) % 10}_0.fasta")]
        line = f"S{c} : {' ; '.join(files)}"
        if amin is not None:
            line += f" ! {amin[c]}"
        lines.append(line)
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def run_dir_files(root):
    """The run dir's outputs: matrices, merge infos, the bf fpr files and
    the per-sample filters of bft."""
    out = {}
    for sub in ("matrices", "merge_infos", "fpr", "filters"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, name), "rb") as f:
                out[f"{sub}/{name}"] = f.read()
    return out


PIPELINE_CASES = {
    "k31_default": dict(kmer_size=31, hard_min=1, soft_min="1"),
    "k21_rescue": dict(kmer_size=21, hard_min=1, soft_min="2", share_min=1),
    "k31_softmin_file": dict(kmer_size=31, hard_min=1, soft_min="FILE",
                             share_min=2, recurrence_min=2),
    "k31_per_sample_hard_min": dict(kmer_size=31, hard_min=1, soft_min="2",
                                    share_min=1, amin=True),
    "k21_forward_mmers": dict(kmer_size=21, hard_min=1, soft_min="1",
                              recurrence_min=2, mmer_scheme="forward"),
    "hash_count_bin": dict(kmer_size=31, hard_min=1, soft_min="2",
                           share_min=1, mode="hash:count:bin",
                           bloom_size=500_000),
    "hash_count_text": dict(kmer_size=21, hard_min=1, soft_min="1",
                            recurrence_min=2, mode="hash:count:text",
                            bloom_size=1_000_000),
    "hash_pa_bin": dict(kmer_size=31, hard_min=1, soft_min="2",
                        share_min=2, mode="hash:pa:bin",
                        bloom_size=600_000),
    "hash_bf_bin": dict(kmer_size=31, hard_min=1, soft_min="2",
                        share_min=1, mode="hash:bf:bin", bloom_size=800_000),
    "hash_bft_bin": dict(kmer_size=31, hard_min=1, soft_min="1",
                         mode="hash:bft:bin", bloom_size=1_000_000),
    "hash_bfc_bin_bitw2": dict(kmer_size=31, hard_min=1, soft_min="2",
                               share_min=1, mode="hash:bfc:bin", bitw=2,
                               bloom_size=700_000),
    "kmer_pa_bin": dict(kmer_size=31, hard_min=1, soft_min="2", share_min=1,
                        mode="kmer:pa:bin", amin=True),
    "kmer_pa_text": dict(kmer_size=21, hard_min=1, soft_min="1",
                         recurrence_min=2, mode="kmer:pa:text"),
    "kmer_count_text": dict(kmer_size=31, hard_min=1, soft_min="1",
                            recurrence_min=2, mode="kmer:count:text"),
    # wide k: kw layouts of 2 (k = 41, 45), 3 (k = 63) and 4 (k = 96)
    # int64 sort words
    "k41_count_bin": dict(kmer_size=41, hard_min=1, soft_min="2",
                          share_min=1),
    "k45_count_bin": dict(kmer_size=45, hard_min=1, soft_min="2",
                          share_min=2),
    "k63_count_bin": dict(kmer_size=63, hard_min=1, soft_min="1",
                          recurrence_min=2),
    "k96_count_bin": dict(kmer_size=96, hard_min=1, soft_min="2",
                          share_min=1, amin=True),
    "k45_hash_bf_bin": dict(kmer_size=45, hard_min=1, soft_min="2",
                            share_min=1, mode="hash:bf:bin",
                            bloom_size=800_000),
    "k63_kmer_pa_bin": dict(kmer_size=63, hard_min=1, soft_min="2",
                            share_min=1, mode="kmer:pa:bin", amin=True),
    "k64_kmer_count_text": dict(kmer_size=64, hard_min=1, soft_min="1",
                                recurrence_min=2, mode="kmer:count:text"),
    "k31_static_repart": dict(kmer_size=31, hard_min=1, soft_min="2",
                              share_min=1, static_repart=True),
    "k45_static_repart": dict(kmer_size=45, hard_min=1, soft_min="1",
                              static_repart=True, nb_partitions=4),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_run_pipeline_matches_host_backend(tmp_path, case):
    kw = dict(PIPELINE_CASES[case])
    amin = [1, 2, 1, 3, 1, 2, 2, 1, 1, 2] if kw.pop("amin", False) else None
    fof = write_fof(tmp_path / "c.fof", amin)
    if kw["soft_min"] == "FILE":
        p = tmp_path / "soft_min.txt"
        p.write_text("".join(f"{v}\n" for v in (1, 2, 2, 1, 3, 1, 2, 1, 1,
                                                 2)))
        kw["soft_min"] = str(p)
    host = jax_run_pipeline(JaxOptions(
        fof=fof, run_dir=str(tmp_path / "host"), backend="host", **kw))
    port = run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "port"), **kw), device="cpu")
    a, b = run_dir_files(host.root), run_dir_files(port.root)
    assert sorted(a) == sorted(b) and len(a) >= 2
    for name in a:
        assert a[name] == b[name], name
    assert any(len(v) > 100 for k, v in a.items() if k.startswith("mat"))
    mode = kw.get("mode", "kmer:count:bin").split(":")[1]
    assert any(n.startswith("fpr/") for n in a) == (mode == "bf")
    assert sum(n.startswith("filters/") for n in a) == (
        10 if mode == "bft" else 0)
    reps = [open(os.path.join(r, "repartition", "repartition.minimRepart"),
                 "rb").read() for r in (host.root, port.root)]
    assert reps[0] == reps[1]


def test_port_never_imports_jax(tmp_path):
    """Importing every port module and chip_smoke, and running the CPU
    pipeline through the one-step path and through the streaming engine
    (chunks decoded from the banks, histograms, a float soft-min; hash
    keys with the per-sample filters; the pa-bits tail; k = 63 with
    --static-repart) and the per-stage device path, with the port's own
    options and the tally on the device, leaves jax and the JAX package
    out of sys.modules (run in a fresh interpreter)."""
    fof = write_fof(tmp_path / "c.fof")
    code = f"""
import sys
import kmtricks_tpu_torch, kmtricks_tpu_torch.cli, kmtricks_tpu_torch._build
import kmtricks_tpu_torch.convert, kmtricks_tpu_torch.ops.segscan
import kmtricks_tpu_torch.ops.merge_runs, kmtricks_tpu_torch.ops.table
import kmtricks_tpu_torch.ops.xxh64, kmtricks_tpu_torch.io.howde
import kmtricks_tpu_torch.ops.repart_sample, kmtricks_tpu_torch.ops.pipeline
import kmtricks_tpu_torch.ops.merge, kmtricks_tpu_torch.runtime.modules
import kmtricks_tpu_torch.runtime.filter, kmtricks_tpu_torch.runtime.combine
import kmtricks_tpu_torch.io.dump, kmtricks_tpu_torch.io.kff
import chip_smoke
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions, run_pipeline
from kmtricks_tpu_torch.runtime import stream_engine
run_pipeline(PipelineOptions(fof={fof!r}, run_dir={str(tmp_path / 'rd')!r},
                             kmer_size=31), device="cpu")
run_pipeline(PipelineOptions(fof={fof!r}, run_dir={str(tmp_path / 'se')!r},
                             kmer_size=31, max_memory_mb=1, soft_min="0.5",
                             threads=2), device="cpu")
assert stream_engine.last_run["chunks"] > 1
for mode in ("hash:bft:bin", "kmer:pa:bin"):
    run_pipeline(PipelineOptions(fof={fof!r}, mode=mode, kmer_size=31,
                                 run_dir={str(tmp_path / 'h')!r} + mode[:4],
                                 max_memory_mb=1, bloom_size=500_000),
                 device="cpu")
assert stream_engine.last_run["tail"] == "pa_bits"
run_pipeline(PipelineOptions(fof={fof!r}, run_dir={str(tmp_path / 'w')!r},
                             kmer_size=63, static_repart=True,
                             max_memory_mb=1), device="cpu")
run_pipeline(PipelineOptions(fof={fof!r}, run_dir={str(tmp_path / 'd')!r},
                             kmer_size=31, backend="device", threads=2,
                             mode="hash:bft:bin", bloom_size=500_000),
             device="cpu")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "kmtricks_tpu")]
assert not bad, bad
print("jax-free")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "jax-free" in res.stdout


def test_cli_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fof = write_fof(tmp_path / "c.fof")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["pipeline", "--file", fof, "--run-dir",
                  str(tmp_path / "rd")])
    assert not (tmp_path / "rd").exists()


def test_hash_mode_raises_without_cuda(tmp_path, monkeypatch):
    """The flagship hash:bf:bin run has no CPU fallback on the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fof = write_fof(tmp_path / "c.fof")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["pipeline", "--file", fof, "--run-dir",
                  str(tmp_path / "rd"), "--mode", "hash:bf:bin",
                  "--bloom-size", "1000000"])
    assert not (tmp_path / "rd").exists()


# sort layouts that only the JAX package's stage_mesh_chunked takes
# (ROADMAP item G): hashes over 63 bits with the sample, k-mer partition
# bits over 31 or past the kw bound
UNPACKED = [
    dict(mode="hash:bf:bin", bloom_size=2**62, nb_partitions=16),
    dict(kmer_size=128, nb_partitions=1 << 28),
    dict(mode="hash:count:bin", bloom_size=2**62, nb_partitions=4),
    dict(mode="hash:pa:bin", bloom_size=2**61, nb_partitions=8),
    dict(kmer_size=96, nb_partitions=1 << 28),
    dict(kmer_size=31, nb_partitions=1 << 32),
    dict(backend="mesh", mode="hash:bft:bin", bloom_size=2**62,
         nb_partitions=16),
    dict(backend="mesh", kmer_size=64, nb_partitions=1 << 32),
]


def stub_unwritable(monkeypatch):
    """Stubs for runs whose files cannot be written (2^28 and more
    partition directories, or 2^58-bit Bloom filter windows): the
    partition directories, the GATB config twin (its u32 field cannot
    hold 2^32 partitions, in either package), the repartition, the fused
    branch's stages (recorded) and the filters. Returns the record."""
    from types import SimpleNamespace

    from kmtricks_tpu_torch.runtime import pipeline as P
    from kmtricks_tpu_torch.runtime.kmdir import KmDir

    seen = []

    def rec(name):
        return lambda *a, **k: seen.append((name, k.get("use_stream",
                                                        False)))

    monkeypatch.setattr(KmDir, "init_parts", lambda self, n: None)
    monkeypatch.setattr(P, "save_gatb_config", lambda config, root: None)
    monkeypatch.setattr(P, "stage_repart", lambda kmdir, config, opts,
                        device=None: SimpleNamespace(freq=None))
    for name in ("stage_mesh_chunked", "stage_mesh_stream",
                 "stage_mesh_count_merge", "stage_format"):
        monkeypatch.setattr(P, name, rec(name))
    return seen


@pytest.mark.parametrize("argv", [
    ["pipeline", "--mode", "hash:bf:bin", "--bloom-size", str(2**62),
     "--nb-partitions", "16"],
    ["pipeline", "--backend", "mesh", "--kmer-size", "128",
     "--nb-partitions", str(1 << 28)],
])
def test_cli_refuses_unported_commands(tmp_path, monkeypatch, argv):
    """The command line refuses none of the sort layouts of the JAX
    package's stage_mesh_chunked: past the one-step budget the run
    reaches the chunked path (stubbed, with the repartition and the
    partition directories: these runs would write 2^28 directories or
    2^58-bit filters; the card is replaced by the CPU)."""
    from kmtricks_tpu_torch.runtime import pipeline as P

    seen = stub_unwritable(monkeypatch)
    real = P.run_pipeline
    monkeypatch.setattr(P, "run_pipeline",
                        lambda opts, device: real(opts, device="cpu"))
    fof = write_fof(tmp_path / "c.fof")
    assert cli.main(argv + ["--file", fof, "--run-dir", str(tmp_path / "rd"),
                            "--max-memory", "1"]) == 0
    assert seen == [("stage_mesh_chunked", True)]


@pytest.mark.parametrize("opt", UNPACKED)
def test_run_pipeline_refuses_outside_the_slice(tmp_path, monkeypatch, opt):
    """The fused path (``auto`` or ``mesh``) refuses none of the layouts
    the JAX package's stream_layout returns None for (hashes over 63 bits
    with the sample; k-mers whose partition, key and sample bits pass its
    kw bound): past the one-step budget they reach the chunked path
    (stubbed, see :func:`stub_unwritable`); bft runs then build their
    filters."""
    from kmtricks_tpu.parallel.pipeline import stream_layout as jax_layout
    from kmtricks_tpu_torch.core.hashers import HashWindow
    from kmtricks_tpu_torch.ops.count_merge import stream_layout

    seen = stub_unwritable(monkeypatch)
    fof = write_fof(tmp_path / "c.fof")
    opts = PipelineOptions(fof=fof, run_dir=str(tmp_path / "rd"),
                           max_memory_mb=1, **opt)
    window = HashWindow(opts.bloom_size, opts.nb_partitions, 10)
    cf = opts.mode.split(":")[0]
    assert jax_layout(opts.kmer_size, 10, opts.nb_partitions, 10, cf,
                      window.window_size_bits) is None
    assert stream_layout(opts.kmer_size, opts.nb_partitions, 10, cf,
                         window.window_size_bits) is None
    run_pipeline(opts, device="cpu")
    assert seen[0] == ("stage_mesh_chunked", True)
    assert seen[1:] == ([("stage_format", False)] if "bft" in opts.mode
                        else [])


def test_wide_partition_count_routes_to_kw(tmp_path, monkeypatch):
    """2^17 partitions at k = 31 (a case that used to be refused) take
    the JAX package's kw layout, so the fused path streams them through
    the engine (stubbed, see :func:`stub_unwritable`: a run would write
    131,072 files per run directory)."""
    from kmtricks_tpu.parallel.pipeline import stream_layout as jax_layout
    from kmtricks_tpu_torch.ops.count_merge import stream_layout

    seen = stub_unwritable(monkeypatch)
    fof = write_fof(tmp_path / "c.fof")
    for k, static in ((31, False), (31, True), (41, False), (127, True)):
        run_pipeline(PipelineOptions(
            fof=fof, run_dir=str(tmp_path / f"rd{k}{static}"), kmer_size=k,
            nb_partitions=1 << 17, static_repart=static, max_memory_mb=1),
            device="cpu")
        assert seen.pop() == ("stage_mesh_stream", True)
        layout = stream_layout(k, 1 << 17, 10)
        assert layout == jax_layout(k, 8, 1 << 17, 10, "kmer", None)
        assert layout.startswith("kw.17.")


@pytest.mark.parametrize("k,static", [(45, False), (96, True)])
def test_single_chip_wide_step_matches_jax(k, static):
    """The fused step at k > 32 (kw layout) against the JAX step: the
    rows' key words (the span, least significant first) and partition, and
    the counts."""
    from kmtricks_tpu_torch.convert import words_from_msb_u32

    nsamp, m, nparts = 4, 8, 4
    batch, lengths, samp, table, amin = synthetic_batch(k, nsamp, m=m,
                                                        nparts=nparts)
    step = jax.jit(jax_step(k=k, m=m, nsamp=nsamp, hard_min=1, rmin=1,
                            save_if=2, count_max=255, nb_parts=nparts,
                            with_stats=False, compact_rows=8192,
                            static_repart_parts=nparts if static else None))
    rows_j, pre_j, nrows_j, maxc_j, npres_j = step(batch, lengths, samp,
                                                   table, amin)
    args = from_jax_inputs(batch, lengths, samp, table, amin, None, "cpu")
    rows, pre, nrows, maxc, npres = build_single_chip_step(
        k=k, m=m, nsamp=nsamp, nb_parts=nparts, hard_min=1, rmin=1,
        save_if=2, count_max=255,
        static_parts=nparts if static else None)(*args[:5])
    assert (nrows, maxc, npres) == (int(nrows_j), int(maxc_j), int(npres_j))
    assert nrows > 100
    rows_j = np.asarray(rows_j)[:nrows]
    nw = rows_j.shape[1] - 1
    exp = words_from_msb_u32([rows_j[:, j] for j in range(nw)])
    assert rows.shape == (nrows, len(exp) + 1)
    for j, e in enumerate(exp):
        np.testing.assert_array_equal(rows[:, j].numpy(), e.numpy())
    np.testing.assert_array_equal(rows[:, -1].numpy(), rows_j[:, -1])
    np.testing.assert_array_equal(pre.numpy(),
                                  np.asarray(pre_j)[:nrows].astype(np.int64))
