"""Several processes: the port's ranks over ``torch.distributed`` (gloo over
localhost, each rank a mesh of 4 CPU shards) against the JAX package's
single-process 8-device runs, exactly. The fused sharded step over two
ranks shard by shard against JAX's ``build_sharded_pipeline`` on
``make_mesh(8)`` (the k3 layout of tests/multihost_worker.py, k2, and
the generic route of unpacked keys, whose runs cross as (partition,
keys, sample) tuples); the streaming engine over two ranks
with forced folds and over three ranks (12 shards over 8 partitions),
run directories byte for byte against tests/test_multihost.py's
single-process engine, with its decode shares. The histogram, pa-bits,
heterogeneous and hash cases are in tests/test_torch_multihost_engine.py.
Ranks run as subprocesses (tests/torch_multihost_worker.py,
tests/torch_multihost_stream_worker.py); a rank that fails or hangs
fails the test, and every rank is killed."""

import json
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmtricks_tpu.parallel import pipeline as jpipe
from kmtricks_tpu_torch.convert import words_from_msb_u32
from kmtricks_tpu_torch.parallel import multihost as mh
from kmtricks_tpu_torch.parallel.pipeline import partition_to_device
from kmtricks_tpu_torch.runtime import device_pipeline as DP
from kmtricks_tpu_torch.runtime import stream_engine as SE
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions
from test_multihost import _gen_bank, _single_proc_engine
from test_torch_mesh import jax_shards
from torch_multihost_worker import CASES, LOCAL_SHARDS, inputs, step_kw

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS_TIMEOUT_S = 240
# each shard's table budget: over every shard's final table on these
# banks, under the entries of its runs, so the engine folds
TABLE_CAP = 4500


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(script: str, world: int, args) -> list:
    """Run ``world`` ranks of a worker script, each with ``rank world port
    *args``; fail (killing every rank) if one exits non-zero or the ranks
    outlast RANKS_TIMEOUT_S. Returns their outputs."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, script), str(r), str(world),
         str(port)] + [str(a) for a in args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"ranks of {script} outlasted {RANKS_TIMEOUT_S} s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-3000:]}"
    return outs


def run_ranks(tmp_path, fof, world, mode="kmer:count:bin", soft_min="2",
              hist="0", table_cap=TABLE_CAP):
    """The port's engine over ``world`` ranks on ``fof`` into
    tmp_path/run_mp; returns each rank's ``last_run``."""
    run_mp = tmp_path / "run_mp"
    spawn_ranks("torch_multihost_stream_worker.py", world,
                [fof, run_mp, mode, soft_min, hist, table_cap])
    return [json.loads((run_mp / f"last_run_{r}.json").read_text())
            for r in range(world)]


def assert_same_run_dirs(a, b, mode="kmer:count:bin", nb_parts=8,
                         hists=False):
    """Matrices and merge_infos (histograms and thresholds with
    ``hists``) of two run directories, byte for byte."""
    cf, m = mode.split(":")[:2]
    ext = {"count": "count", "pa": "pa"}[m] + ("_hash" if cf == "hash"
                                               else "")
    for p in range(nb_parts):
        for sub, name in (("matrices", f"matrix_{p}.{ext}"),
                          ("merge_infos", f"partition{p}.merge_info")):
            assert (a / sub / name).read_bytes() == \
                (b / sub / name).read_bytes(), f"{sub}/{name}"
    if hists:
        for s in range(3):
            assert (a / "histograms" / f"S{s}.hist").read_bytes() == \
                (b / "histograms" / f"S{s}.hist").read_bytes(), s
        assert (a / "merge_amin.txt").read_text() == \
            (b / "merge_amin.txt").read_text()


def assert_decode_shares(last, total):
    """Each rank decoded only its samples, and every read exactly once."""
    shares = [r["local_rows"] for r in last]
    assert all(0 < s < total for s in shares), shares
    assert sum(shares) == total, shares
    return shares


@pytest.fixture(scope="module")
def step_dir(tmp_path_factory):
    """Two ranks' per-shard outputs of every case of the step worker."""
    out = tmp_path_factory.mktemp("mp_step")
    spawn_ranks("torch_multihost_worker.py", 2, [out])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_step_matches_jax(step_dir, case):
    """Each of the 8 global shards' rows (key words, partition), pre-merge
    counts and counts of rows equal JAX's device of the same index on a
    single-process 8-device mesh."""
    c = CASES[case]
    batch, lengths, samp, table, amin = inputs(case)
    rc = batch.shape[0] * (batch.shape[1] - c["k"] + 1)
    exp = jax_shards(
        jpipe.make_mesh(8), dict(step_kw(case), cap=rc,
                                 static_repart=c["static"]),
        tuple(jnp.asarray(a) for a in (batch, lengths, samp, table, amin)),
        rc)
    got = {}
    for r in range(2):
        with np.load(step_dir / f"{case}_rank{r}.npz") as z:
            got.update({key: z[key] for key in z.files})
    nkw = 1 if c["mode"] == "hash" or c["k"] <= 32 else -(-c["k"] // 32)
    nw = 2 if c["mode"] == "hash" else 2 * nkw
    owner = partition_to_device(c["nb_parts"], 8)
    for g, (rows_j, pre_j, npres_j) in enumerate(exp):
        rows, pre = got[f"rows_{g}"], got[f"pre_{g}"]
        assert tuple(got[f"n_{g}"]) == (len(rows_j), npres_j), g
        keys = words_from_msb_u32([rows_j[:, j] for j in range(nw)])
        for j in range(nkw):
            np.testing.assert_array_equal(rows[:, j], keys[j].numpy())
        part = (keys[0].numpy() // c["window_bits"] if c["mode"] == "hash"
                else rows_j[:, nw].astype(np.int64))
        np.testing.assert_array_equal(rows[:, -1], part)
        np.testing.assert_array_equal(pre.view(np.uint32), pre_j)
        assert (owner[part] == g).all()
    assert sum(len(e[0]) for e in exp) > (10 if c["amin"] > 1 else 1000)


def test_two_rank_engine_folds_matches_jax(tmp_path):
    """The engine over two ranks (8 global shards, a table budget that
    forces folds) writes the single-process JAX engine's matrices and
    merge_infos; each rank decoded only its samples."""
    fof = _gen_bank(tmp_path)
    last = run_ranks(tmp_path, fof, 2)
    assert_decode_shares(last, 600)
    assert all(r["folds"] > 0 for r in last), last
    assert [(r["rank"], r["world"], r["shards"]) for r in last] == \
        [(0, 2, 4), (1, 2, 4)]
    # the runs for the other rank's shards crossed, both ways
    ex = [r["exchange"] for r in last]
    assert ex[0]["calls"] == last[0]["chunks"] > 0
    assert ex[0]["bytes_sent"] == ex[1]["bytes_received"] > 0
    assert ex[1]["bytes_sent"] == ex[0]["bytes_received"] > 0
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:count:bin", "2",
                        "0")
    assert_same_run_dirs(tmp_path / "run_mp", tmp_path / "run_sp")


def test_three_rank_engine_matches_jax(tmp_path):
    """Three ranks (12 global shards over 8 partitions: some own none):
    the has-data agreement, the sample owners and the shared run
    directory hold for a world that is no power of two."""
    fof = _gen_bank(tmp_path, seed=201)
    last = run_ranks(tmp_path, fof, 3)
    assert sorted(assert_decode_shares(last, 600)) == [200, 200, 200]
    assert len({r["chunks"] for r in last}) == 1
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:count:bin", "2",
                        "0")
    assert_same_run_dirs(tmp_path / "run_mp", tmp_path / "run_sp")


class _Est:
    def __init__(self, sequences):
        self.sequences = sequences


@pytest.mark.parametrize("sizes, world, owners", [
    ([500, 60, 40], 2, [0, 1, 1]),
    ([200, 200, 200], 3, [0, 1, 2]),
    ([10, 30, 20, 40], 2, [0, 1, 1, 0]),
    ([0, 0, 5], 2, [1, 1, 0]),
])
def test_lpt_owners(sizes, world, owners):
    """Largest bank first to the least loaded rank, ties to the lower
    index (the JAX engine's sample owners)."""
    assert DP.lpt_owners([_Est(s) for s in sizes], world) == owners


def _process_mesh(rank=0, world=2):
    return mh.ProcessMesh([torch.device("cpu")] * LOCAL_SHARDS, rank=rank,
                          world=world, backend="gloo", host_group=None)


@pytest.mark.parametrize("total, bounds", [
    (64, [(0, 32), (32, 64)]), (65, [(0, 32), (32, 65)])])
def test_host_shard_bounds(total, bounds):
    assert [mh.host_shard_bounds(total, _process_mesh(r)) for r in
            range(2)] == bounds


@pytest.mark.parametrize("stage", ["count_merge", "chunked", "engine"])
def test_one_process_paths_refuse_a_process_mesh(tmp_path, stage):
    """The paths that load the whole collection refuse a mesh that spans
    processes before any work (as JAX refuses non-streamed input
    there)."""
    opts = PipelineOptions(fof="unused", run_dir=str(tmp_path))
    calls = {
        "count_merge": lambda mesh: DP.stage_mesh_count_merge(
            None, None, opts, None, None, None, None, None, mesh),
        "chunked": lambda mesh: DP.stage_mesh_chunked(
            None, None, opts, None, None, mesh=mesh, chunk_windows=1),
        "engine": lambda mesh: SE.stage_mesh_stream(
            None, None, opts, None, None, mesh=mesh, chunk_windows=1),
    }
    with pytest.raises(ValueError, match="spans processes"):
        calls[stage](_process_mesh())
