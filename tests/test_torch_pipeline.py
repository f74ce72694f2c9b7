"""The port's slice as a whole: the fused single-device step against the
JAX package's build_single_chip_step, and ``run_pipeline`` on the CPU
against ``kmtricks_tpu --backend host``, byte for byte."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kmtricks_tpu.parallel.pipeline import build_single_chip_step as jax_step
from kmtricks_tpu.runtime.pipeline import PipelineOptions
from kmtricks_tpu.runtime.pipeline import run_pipeline as jax_run_pipeline
from kmtricks_tpu_torch import cli
from kmtricks_tpu_torch.convert import from_jax_inputs, keys_from_msb_words
from kmtricks_tpu_torch.parallel.pipeline import build_single_chip_step
from kmtricks_tpu_torch.runtime.pipeline import run_pipeline

torch.set_num_threads(2)

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
    out = {}
    for sub in ("matrices", "merge_infos"):
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
    host = jax_run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "host"), backend="host", **kw))
    port = run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "port"), **kw), device="cpu")
    a, b = run_dir_files(host.root), run_dir_files(port.root)
    assert sorted(a) == sorted(b) and len(a) >= 2
    for name in a:
        assert a[name] == b[name], name
    assert any(len(v) > 100 for k, v in a.items() if k.startswith("mat"))


def test_port_never_imports_jax(tmp_path):
    """Importing every port module and running the CPU pipeline, through
    the one-step path and through the streaming engine (chunks decoded
    from the banks, histograms, a float soft-min), leaves jax out of
    sys.modules (run in a fresh interpreter)."""
    fof = write_fof(tmp_path / "c.fof")
    code = f"""
import sys
import kmtricks_tpu_torch, kmtricks_tpu_torch.cli, kmtricks_tpu_torch._build
import kmtricks_tpu_torch.convert, kmtricks_tpu_torch.ops.segscan
import kmtricks_tpu_torch.ops.merge_runs, kmtricks_tpu_torch.ops.table
from kmtricks_tpu.runtime.pipeline import PipelineOptions
from kmtricks_tpu_torch.runtime.pipeline import run_pipeline
from kmtricks_tpu_torch.runtime import stream_engine
run_pipeline(PipelineOptions(fof={fof!r}, run_dir={str(tmp_path / 'rd')!r},
                             kmer_size=31), device="cpu")
run_pipeline(PipelineOptions(fof={fof!r}, run_dir={str(tmp_path / 'se')!r},
                             kmer_size=31, max_memory_mb=1, soft_min="0.5",
                             threads=2), device="cpu")
assert stream_engine.last_run["chunks"] > 1
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]
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


@pytest.mark.parametrize("argv", [
    ["count", "--run-dir", "x", "--id", "S0"],
    ["pipeline", "--file", "f", "--run-dir", "x", "--backend", "host"],
])
def test_cli_refuses_unported_commands(argv):
    with pytest.raises(NotImplementedError):
        cli.main(argv)


@pytest.mark.parametrize("opt", [
    dict(mode="hash:count:bin"), dict(mode="kmer:pa:bin"),
    dict(kmer_size=41), dict(static_repart=True), dict(restrict_to=0.5),
    dict(until="count"), dict(nb_partitions=1 << 17),
])
def test_run_pipeline_refuses_outside_the_slice(tmp_path, opt):
    fof = write_fof(tmp_path / "c.fof")
    with pytest.raises(NotImplementedError):
        run_pipeline(PipelineOptions(fof=fof, run_dir=str(tmp_path / "rd"),
                                     **opt), device="cpu")
    assert not (tmp_path / "rd").exists()
