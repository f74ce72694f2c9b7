"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole of a run (bank, warm-up, window, reference)
on the CPU, past the harness's look for a card, with one fault planted in
the program: the chunk step returning the table unchanged, half of each
batch left out (of the engine's chunks, of the one step's batch, of the
repartition's sampled reads), an answer altered where it is written, one
run of the window writing other bytes than the last. The control, the
reference with the hard-min broken in the program's place, must fail too.
A cell on one card has no exchange between chips to leave out.
"""

import pytest

from kmbench import run


def _empty(out):
    return [(tuple(w[:0] for w in ws), cnt[:0]) for ws, cnt in out]


@pytest.fixture
def broken_step(monkeypatch):
    """Put ``fault(n, step, cb, cl, cs, table)`` (``n`` counts the calls,
    ``step`` is the real chunk step) in place of the engine's chunk step."""
    from kmtricks_tpu_torch.runtime import stream_engine

    build = stream_engine.build_chunk_pairs_step

    def plant(fault):
        def make_step(*a, **kw):
            step = build(*a, **kw)
            calls = []

            def broken(cb, cl, cs, table):
                calls.append(1)
                return fault(len(calls), step, cb, cl, cs, table)
            return broken
        monkeypatch.setattr(stream_engine, "build_chunk_pairs_step",
                            make_step)
    return plant


def _run(cell):
    return run.run_cell(cell, 2**31 + 77, 0.5, False, device="cpu")


def test_sound_run_is_correct(tiny_cell):
    r = _run(tiny_cell())
    assert r["correct"] and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_step_that_returns_the_state_unchanged(tiny_cell, broken_step):
    def unchanged(n, step, cb, cl, cs, table):
        out = step(cb, cl, cs, table)
        return out if n == 1 else _empty(out)
    broken_step(unchanged)
    r = _run(tiny_cell())
    assert not r["correct"] and r["checks"]["rows_bad"]["value"] > 0


def test_half_of_the_batch_left_out(tiny_cell, broken_step):
    def half(n, step, cb, cl, cs, table):
        cl = cl.clone()
        cl[cl.shape[0] // 2:] = 0
        return step(cb, cl, cs, table)
    broken_step(half)
    r = _run(tiny_cell())
    assert not r["correct"] and r["checks"]["rows_bad"]["value"] > 0


def test_half_of_the_one_step_batch_left_out(tiny_cell, monkeypatch):
    from kmtricks_tpu_torch.runtime import pipeline

    step = pipeline.stage_mesh_count_merge

    def half(kmdir, config, opts, repart, amin_vec, batch, lengths, sarr,
             mesh):
        lengths = lengths.copy()
        lengths[len(lengths) // 2:] = 0
        return step(kmdir, config, opts, repart, amin_vec, batch, lengths,
                    sarr, mesh)
    monkeypatch.setattr(pipeline, "stage_mesh_count_merge", half)
    r = _run(tiny_cell("count31.isolates.onestep", args=()))
    assert not r["correct"] and r["checks"]["rows_bad"]["value"] > 0


def test_count_altered_where_written(tiny_cell, monkeypatch):
    from kmtricks_tpu_torch.io import formats

    write = formats.write_matrix_file

    def altered(path, kmers, counts, *a, **kw):
        counts = counts.copy()
        if len(counts):
            counts[len(counts) // 2, 0] += 1
        return write(path, kmers, counts, *a, **kw)
    monkeypatch.setattr(formats, "write_matrix_file", altered)
    r = _run(tiny_cell())
    assert not r["correct"] and r["checks"]["rows_bad"]["value"] > 0


def test_bloom_bit_altered_where_written(tiny_cell, monkeypatch):
    from kmtricks_tpu_torch.runtime import pipeline

    transpose = pipeline._bft_transpose

    def altered(rows, device):
        out = transpose(rows, device).copy()
        out[0, 0] ^= 1
        return out
    monkeypatch.setattr(pipeline, "_bft_transpose", altered)
    r = _run(tiny_cell("howde31.isolates", "isolates-howde-k31",
                       ("--max-memory", "1", "--bloom-size", "100000")))
    assert not r["correct"]
    assert r["checks"]["bloom_bytes_bad"]["value"] > 0
    assert r["checks"]["filter_bytes_bad"]["value"] > 0


@pytest.mark.parametrize("name,config,args,number", [
    ("count31.isolates", "isolates-count-k31", (), "rows_bad"),
    ("howde31.isolates", "isolates-howde-k31", ("--bloom-size", "100000"),
     "bloom_bytes_bad"),
])
def test_control_fails(tiny_cell, tmp_path, name, config, args, number):
    import torch

    from kmbench.control import control_checks
    from kmbench.gen import make_bank

    cell = tiny_cell(name, config, args)
    manifest = make_bank(cell["traffic_spec"], 11, str(tmp_path / "bank"))
    checks = control_checks(cell, manifest, torch.device("cpu"))
    assert checks["repart_bad"] == 0 and checks[number] > 0


def test_tally_with_half_its_reads_left_out(tiny_cell, monkeypatch):
    from kmtricks_tpu_torch.runtime import pipeline

    sample = pipeline._sample_batches

    def half(*a, **kw):
        for batch, lengths in sample(*a, **kw):
            yield batch[: len(lengths) // 2], lengths[: len(lengths) // 2]
    monkeypatch.setattr(pipeline, "_sample_batches", half)
    r = _run(tiny_cell())
    assert not r["correct"] and r["checks"]["repart_bad"]["value"] > 0


def test_one_run_of_the_window_altered(tiny_cell, monkeypatch):
    import itertools

    from kmtricks_tpu_torch.io import formats

    write = formats.write_matrix_file

    def altered(path, kmers, counts, *a, **kw):
        if "run_0" in path and len(counts):
            counts = counts.copy()
            counts[0, 0] += 1
        return write(path, kmers, counts, *a, **kw)
    monkeypatch.setattr(formats, "write_matrix_file", altered)
    # a clock that ends the window after exactly two runs
    window = run.run_window
    monkeypatch.setattr(run, "run_window", lambda once, seconds: window(
        once, 1.6, clock=itertools.count(0, 0.5).__next__))
    r = _run(tiny_cell())
    assert r["attempted"] == 2 and not r["correct"]
    assert r["checks"]["runs_differing"]["value"] == 1
    assert r["checks"]["rows_bad"]["value"] == 0
