"""The rescue configuration's reference (``kmbench.reference.rescue``):
it meets the harness's interface, refuses thresholds it does not model,
judges a sound run correct with every check at 0, and judges not correct
its control (the rescue turned off in the program's place) and runs with
a fault planted in the program's merge: the rescued counts zeroed, or
``--share-min`` read as 0."""

import json

import numpy as np
import pytest
import torch

from kmbench import cells, run
from kmbench.reference import INTERFACE, rescue

# a small low-coverage collection: six isolates at 5x
LOWCOV = {"genome_bp": 12000, "samples": 6, "read_len": 150,
          "coverage": 5, "snp_rate": 0.002, "error_rate": 0.002,
          "reverse_share": 0.5, "format": "fasta"}


@pytest.fixture
def rescue_cell(tmp_path, monkeypatch):
    """``count31.rescue`` on the small collection, through the streaming
    engine (``--max-memory 1``), its scratch under ``tmp_path``."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    path = tmp_path / "lowcov.json"
    path.write_text(json.dumps(LOWCOV))
    cell = cells.load_cell("count31.rescue")
    cell.update(traffic_path=str(path), traffic_spec=dict(LOWCOV),
                args=["--max-memory", "1"])
    return cell


def _run(cell):
    return run.run_cell(cell, 2**31 + 171, 0.3, False, device="cpu")


def test_the_configuration_names_the_rescue_reference():
    cell = cells.load_cell("count31.rescue")
    assert cells.reference(cell) is rescue
    assert all(callable(getattr(rescue, f)) for f in INTERFACE)
    opts = rescue.options(cells.pipeline_args(cell))
    assert (opts["hard_min"], opts["soft_min"], opts["share_min"],
            opts["recurrence_min"], opts["max_memory"]) == (1, 3, 2, 1,
                                                            24000)
    assert rescue.control_options(opts) == dict(opts, share_min=0)


def test_every_cell_is_judged_by_the_reference_its_configuration_names():
    """A cell whose configuration names no reference takes the default
    one; every cell's options are read by its own reference (the rescue
    configuration states --hard-min 1, every other one 2)."""
    from kmbench import reference as default

    hard_min = {default: 2, rescue: 1}
    for w in cells.benchmark()["workloads"]:
        cell = cells.load_cell(w["name"])
        ref = cells.reference(cell)
        assert (ref is default) == ("reference" not in cell["config_spec"])
        opts = ref.options(cells.pipeline_args(cell))
        assert opts["k"] == 31 and opts["m"] == 10
        assert opts["hard_min"] == hard_min[ref]


@pytest.mark.parametrize("option,value", [
    ("--soft-min", "0.5"), ("--soft-min", "3.0"), ("--soft-min", "a.txt"),
    ("--share-min", "-1"), ("--mode", "kmer:pa:bin"),
    ("--mode", "hash:count:bin"), ("--bloom-size", "1000"),
    ("--nb-partitions", "8")])
def test_options_it_does_not_model_are_refused(option, value):
    with pytest.raises(ValueError, match="reference"):
        rescue.options(["--hard-min", "1", option, value])


def test_merge_follows_the_rescue_rule():
    """One row per case, three samples at soft-min 3, share-min 2:
    counts 0 are absent, 1-2 held back, 3+ solid."""
    mat = torch.tensor([[3, 3, 1],      # solid in 2: the 1 is rescued
                        [3, 1, 2],      # solid in 1: 1 and 2 zeroed
                        [1, 0, 0],      # solid nowhere: not kept
                        [5, 4, 2]])     # solid in 2: the 2 is rescued
    opts = {"soft_min": 3, "share_min": 2, "recurrence_min": 1}
    final, keep, stats = rescue.merge(mat, opts)
    assert final.tolist() == [[3, 3, 1], [3, 0, 0], [0, 0, 0], [5, 4, 2]]
    assert keep.tolist() == [True, True, False, True]
    assert stats.tolist() == [
        [1, 1, 3],      # NON_SOLID: held back
        [0, 0, 2],      # RESCUED
        [3, 2, 0],      # UNIQUE_WO_RESCUE
        [3, 2, 2],      # UNIQUE_W_RESCUE
        [11, 7, 0],     # TOTAL_WO_RESCUE
        [11, 7, 3]]     # TOTAL_W_RESCUE
    off, _keep, off_stats = rescue.merge(mat, dict(opts, share_min=0))
    assert off.tolist() == [[3, 3, 0], [3, 0, 0], [0, 0, 0], [5, 4, 0]]
    assert off_stats[1].tolist() == [0, 0, 0]
    text = rescue.merge_info_bytes(stats.numpy()).tobytes().decode()
    assert text.splitlines()[1] == "RESCUED\t0\t0\t2\t"
    assert text.endswith("TOTAL_W_RESCUE\t11\t7\t3\t\n")


def test_sound_run_is_correct(rescue_cell):
    r = _run(rescue_cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert set(r["checks"]) == {"repart_bad", "rows_bad", "merge_info_bad",
                                "runs_differing"}
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_control_fails(rescue_cell, tmp_path):
    from kmbench.control import control_checks
    from kmbench.gen import make_bank

    manifest = make_bank(LOWCOV, 11, str(tmp_path / "bank"))
    checks = control_checks(rescue_cell, manifest, torch.device("cpu"))
    assert checks["repart_bad"] == 0
    assert checks["rows_bad"] > 0 and checks["merge_info_bad"] > 0


@pytest.fixture
def broken_merge(monkeypatch):
    """Put ``fault(merge, *args, **kw)`` in place of the dense tail's
    device merge (``merge_finalize`` as the engine's tail calls it)."""
    from kmtricks_tpu_torch.runtime import device_pipeline

    merge = device_pipeline.merge_finalize

    def plant(fault):
        monkeypatch.setattr(device_pipeline, "merge_finalize",
                            lambda *a, **kw: fault(merge, *a, **kw))
    return plant


def test_rescued_counts_zeroed(rescue_cell, broken_merge):
    def zeroed(merge, pre, amin, *a, **kw):
        counts, keep, stats = merge(pre, amin, *a, **kw)
        under = (counts > 0) & (counts < amin[None, :])
        assert bool(under.any())
        return counts.masked_fill(under, 0), keep, stats
    broken_merge(zeroed)
    r = _run(rescue_cell)
    assert not r["correct"] and r["checks"]["rows_bad"]["value"] > 0


def test_share_min_read_as_zero(rescue_cell, broken_merge):
    def no_rescue(merge, *a, **kw):
        return merge(*a, **dict(kw, save_if=0))
    broken_merge(no_rescue)
    r = _run(rescue_cell)
    assert not r["correct"]
    assert r["checks"]["rows_bad"]["value"] > 0
    assert r["checks"]["merge_info_bad"]["value"] > 0


def test_the_reference_holds_one_partition_at_a_time(rescue_cell,
                                                     tmp_path):
    """``partition_outputs`` yields each partition's files alone, and
    together they are ``expected_outputs``."""
    from kmbench.gen import make_bank
    from kmbench.reference.kmers import lpt_table

    manifest = make_bank(LOWCOV, 5, str(tmp_path / "bank"))
    opts, coll = rescue.setup(cells.pipeline_args(rescue_cell),
                              manifest["samples"], "cpu")
    nb = coll.nb_partitions(opts["max_memory"])
    table = lpt_table(coll.tally(), nb)
    parts = list(rescue.partition_outputs(coll, table, nb, opts))
    assert [sorted(f) for f in parts] == [
        [f"matrices/matrix_{p}.count", f"merge_infos/partition{p}.merge_info"]
        for p in range(nb)]
    whole = rescue.expected_outputs(coll, table, nb, opts)
    for files in parts:
        for rel, exp in files.items():
            if rel.endswith(".count"):
                assert all(np.array_equal(x, y) if isinstance(x, np.ndarray)
                           else x == y for x, y in zip(exp, whole[rel]))
            else:
                assert np.array_equal(exp, whole[rel])
