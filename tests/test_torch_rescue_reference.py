"""Low-abundance rescue through the port's ``pipeline`` on the CPU,
against the benchmark's plain reference of it
(``kmbench.reference.rescue``: kmtricks' soft-min, share-min and
recurrence-min at the merge, and the merge statistics): a small
low-coverage collection written by ``kmbench.gen``, run through the
streaming engine and through the one step, must give the matrix
partitions and the ``merge_infos`` files the reference expects."""

import numpy as np
import pytest
import torch

from kmbench.gen import make_bank
from kmbench.reference import rescue
from kmtricks_tpu_torch.cli import _options_from_args, build_parser
from kmtricks_tpu_torch.runtime import stream_engine
from kmtricks_tpu_torch.runtime.pipeline import run_pipeline

torch.set_num_threads(2)

# six isolates at 5x (k-mer coverage 4): many true k-mers are seen once
# or twice in a sample, so rescue decides cells
LOWCOV = {"genome_bp": 12000, "samples": 6, "read_len": 150,
          "coverage": 5, "snp_rate": 0.002, "error_rate": 0.002,
          "reverse_share": 0.5, "format": "fasta"}
# the path's --max-memory: 1 MB streams the banks through the engine in
# many chunks; the configuration's 24000 loads them for the one step
PATHS = {"engine": "1", "one_step": "24000"}


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    return make_bank(LOWCOV, 2**31 + 1717,
                     str(tmp_path_factory.mktemp("lowcov")))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("soft_min,share_min", [(3, 2), (2, 1), (3, 0)])
def test_rescue_matches_the_reference(bank, tmp_path, path, soft_min,
                                      share_min):
    args = ["--kmer-size", "31", "--minimizer-size", "10", "--hard-min",
            "1", "--soft-min", str(soft_min), "--share-min", str(share_min),
            "--recurrence-min", "1", "--mode", "kmer:count:bin",
            "--max-memory", PATHS[path]]
    rd = str(tmp_path / "rd")
    stream_engine.last_run.clear()
    run_pipeline(_options_from_args(build_parser().parse_args(
        ["pipeline", "--file", bank["fof"], "--run-dir", rd, *args])),
        device="cpu")
    assert bool(stream_engine.last_run) == (path == "engine")
    opts, coll = rescue.setup(args, bank["samples"], "cpu")
    checks = rescue.judge(rescue.read_file(rd), coll, opts)
    assert checks == {"repart_bad": 0, "rows_bad": 0, "merge_info_bad": 0}
    # rescue decided cells where it is on, and none where it is off
    rescued = 0
    for p in range(coll.nb_partitions(opts["max_memory"])):
        with open(f"{rd}/merge_infos/partition{p}.merge_info") as f:
            lines = dict(line.rstrip("\t\n").split("\t", 1) for line in f)
        rescued += int(np.sum(np.array(lines["RESCUED"].split("\t"),
                                       dtype=np.int64)))
    assert (rescued > 0) == (share_min > 0)
