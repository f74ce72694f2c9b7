"""Options the port accepts beyond the k-mer count run, each against
``kmtricks_tpu --backend host``, byte for byte, through the fused one-step
path and through the streaming engine: ``--repartition-type 1`` and
``--repart-from`` (the repartition stage before the device tally), gz,
FASTQ and BAM inputs (which feed the tally's sampler and the counts),
``--cpr``, ``--plugin`` and ``--bf-format sdsl``; and the command line's
crash log. The cases follow tests/test_features.py and
tests/test_cli_options.py."""

import gzip
import os
import subprocess
import sys

import pytest
import torch

from kmtricks_tpu.runtime.pipeline import PipelineOptions as JaxOptions
from kmtricks_tpu.runtime.pipeline import run_pipeline as jax_run_pipeline
from kmtricks_tpu_torch.runtime import stream_engine as SE
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions, run_pipeline
from test_features import _bam_bytes
from test_torch_pipeline import DATA, ROOT, run_dir_files, write_fof

torch.set_num_threads(2)

PLUGIN = '''
from {module}.runtime.plugin import MergePlugin


class MinTwo(MergePlugin):
    """Keep rows with a count >= threshold in two samples or more (the
    verdict replaces the recurrence one, merge.hpp:252-257)."""
    def configure(self, s):
        self.threshold = int(s)

    def process_kmer(self, kmer_data, counts):
        return bool((counts >= self.threshold).sum() >= 2)
'''


def sample_reads(c):
    """Sample c of ``write_fof``: collection c, its first file once more
    and the first file of collection c + 1."""
    paths = sorted(DATA.glob(f"c{c}_*.fasta"))
    paths += [DATA / f"c{c}_0.fasta", DATA / f"c{(c + 1) % 10}_0.fasta"]
    return [line.strip() for p in paths for line in p.read_text().split("\n")
            if line.strip() and not line.startswith(">")]


def write_bank(tmp_path, fmt):
    """``write_fof``'s ten samples, each as one gz FASTA, FASTQ or BAM
    file."""
    lines = []
    for c in range(10):
        reads = sample_reads(c)
        path = tmp_path / f"S{c}.{fmt}"
        if fmt == "fa.gz":
            path.write_bytes(gzip.compress("".join(
                f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()))
        elif fmt == "fastq":
            path.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                                    for i, r in enumerate(reads)))
        else:
            path.write_bytes(_bam_bytes(["chr1"], [
                (b"r%d" % i, r.encode(), 0, 0) for i, r in enumerate(reads)]))
        lines.append(f"S{c} : {path}")
    fof = tmp_path / f"{fmt}.fof"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


BASE = dict(kmer_size=31, hard_min=1, soft_min="2", share_min=1)
CASES = {
    "repartition_type_1": dict(repart_type=1),
    "repart_from": dict(repart_from=True),
    "gz_input": dict(bank="fa.gz"),
    "fastq_input": dict(bank="fastq"),
    "bam_input": dict(bank="bam"),
    "cpr": dict(cpr=True),
    "plugin": dict(plugin=True, plugin_config="1"),
    "bf_format_sdsl": dict(mode="hash:bft:bin", bloom_size=1_000_000,
                           bf_format="sdsl", soft_min="1"),
}


@pytest.mark.parametrize("branch", ["one_step", "engine"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_option_matches_host_backend(tmp_path, case, branch):
    kw = dict(BASE, **CASES[case])
    bank = kw.pop("bank", None)
    fof = write_bank(tmp_path, bank) if bank else write_fof(tmp_path / "c.fof")
    side = {}
    if kw.pop("plugin", False):
        for name, module in (("jax", "kmtricks_tpu"),
                             ("port", "kmtricks_tpu_torch")):
            path = tmp_path / f"plugin_{name}.py"
            path.write_text(PLUGIN.format(module=module))
            side[name] = dict(plugin=f"{path}:MinTwo")
    if kw.pop("repart_from", False):
        src = jax_run_pipeline(JaxOptions(
            fof=fof, run_dir=str(tmp_path / "src"), backend="host",
            kmer_size=31, minim_size=8))
        kw.update(repart_from=src.root, minim_size=8)
    if branch == "engine":
        kw["max_memory_mb"] = 1
    host = jax_run_pipeline(JaxOptions(
        fof=fof, run_dir=str(tmp_path / "host"), backend="host",
        **kw, **side.get("jax", {})))
    SE.last_run.clear()
    port = run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "port"), **kw,
        **side.get("port", {})), device="cpu")
    if branch == "engine":
        assert SE.last_run["chunks"] >= 3
    else:
        assert not SE.last_run
    a, b = run_dir_files(host.root), run_dir_files(port.root)
    assert sorted(a) == sorted(b) and len(a) >= 8
    for name in a:
        assert a[name] == b[name], name
    with open(os.path.join(host.root, "repartition",
                           "repartition.minimRepart"), "rb") as f:
        rep = f.read()
    with open(os.path.join(port.root, "repartition",
                           "repartition.minimRepart"), "rb") as f:
        assert f.read() == rep
    assert any(len(v) > 100 for n, v in a.items() if n.startswith("mat"))


def test_cli_writes_backtrace_log(tmp_path):
    """``python -m kmtricks_tpu_torch pipeline -f missing.fof -d rd``
    writes kmtricks_backtrace.log to the working directory and exits 1, as
    ``python -m kmtricks_tpu`` does (the reference's SignalHandler)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for pkg in ("kmtricks_tpu", "kmtricks_tpu_torch"):
        cwd = tmp_path / pkg
        cwd.mkdir()
        res = subprocess.run(
            [sys.executable, "-m", pkg, "pipeline", "-f", "missing.fof",
             "-d", "rd"], cwd=str(cwd), env=env, capture_output=True,
            text=True, timeout=120)
        assert res.returncode == 1, (pkg, res.stderr[-2000:])
        log = (cwd / "kmtricks_backtrace.log").read_text()
        assert log.startswith("Traceback") and "Error" in log, pkg
