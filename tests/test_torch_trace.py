"""The port's spans (``runtime/trace.py``): the record's
nesting, threads, reset and freeze; the spans of a whole CPU run through
the streaming engine and the one step against the engine's ``last_run``
and walls, and the device merge's span absent from the chunked path and
the host stages; ``record_function`` only under an active profiler, and the
spans in a CPU profiler trace on the main thread; and the prefetch
worker's exit when its consumer abandons the stream."""

import json
import logging
import threading
import time

import pytest
import torch

from kmtricks_tpu_torch.runtime import stream_engine as SE
from kmtricks_tpu_torch.runtime import trace
from kmtricks_tpu_torch.runtime.device_pipeline import prefetched
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions, run_pipeline
from test_torch_pipeline import write_fof

torch.set_num_threads(2)


class CountingRecordFunction:
    """Stands in for ``torch.profiler.record_function``: counts entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def counting_rf(monkeypatch):
    CountingRecordFunction.entered = 0
    monkeypatch.setattr(torch.profiler, "record_function",
                        CountingRecordFunction)
    return CountingRecordFunction


def test_spans_nest_and_add_from_threads():
    trace.begin_run()
    with trace.span("outer") as outer:
        with trace.span("inner", 3) as inner:
            time.sleep(0.002)
        inner_s = inner.s

    def work():
        for _ in range(200):
            with trace.span("threaded", 1):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rec = trace.end_run()
    assert rec is trace.last_run
    assert rec["outer"]["calls"] == 1 and rec["inner"]["calls"] == 1
    assert rec["inner"]["n"] == 3
    assert rec["inner"]["s"] == inner_s
    assert 0 < rec["inner"]["s"] <= rec["outer"]["s"] == outer.s
    assert rec["threaded"]["calls"] == rec["threaded"]["n"] == 1600


def test_begin_run_resets_and_end_run_freezes():
    with trace.span("before"):
        pass
    trace.begin_run()
    with trace.span("during") as sp:
        sp.n = 7            # the work may be known only inside the block
    frozen = trace.end_run()
    with trace.span("after"):
        pass
    assert set(frozen) == {"during"}
    assert frozen["during"]["n"] == 7
    assert trace.last_run is frozen and set(frozen) == {"during"}
    trace.begin_run()
    assert trace.end_run() == {}
    assert frozen["during"]["calls"] == 1


def test_spans_record_even_when_the_block_raises():
    trace.begin_run()
    with pytest.raises(KeyError):
        with trace.span("fails"):
            raise KeyError("x")
    assert trace.end_run()["fails"]["calls"] == 1


# case: PipelineOptions beyond the fof and run dir, the spans expected,
# the spans that must not run
RUNS = {
    "engine_banks": (dict(max_memory_mb=1),
                     ("engine.chunk_loop", "engine.decode",
                      "engine.decode_wait", "engine.chunk_step",
                      "engine.fold", "engine.phase_a", "engine.phase_b",
                      "engine.tail", "tail.fetch", "tail.merge_write"),
                     ("step.load", "hash.window", "tail.hists")),
    "engine_hash_bft": (dict(max_memory_mb=1, mode="hash:bft:bin",
                             bloom_size=1_000_000),
                        ("engine.chunk_step", "hash.window", "tail.fetch"),
                        ("step.load", "tail.hists")),
    "engine_hists_soft_min_float": (
        dict(max_memory_mb=1, hist=True, soft_min="0.5"),
        ("engine.chunk_loop", "engine.tail", "tail.fetch", "tail.hists",
         "tail.merge_write"), ("step.load",)),
    "one_step": (dict(), ("step.load", "tail.fetch"),
                 ("engine.chunk_loop", "engine.decode_wait", "tail.hists")),
}
REPART = ("repart.parse", "repart.pack", "repart.upload",
          "repart.tally_wait", "repart.tally_step", "repart.place",
          "repart.write", "repart.bases")


@pytest.mark.parametrize("case", sorted(RUNS))
def test_pipeline_spans_match_the_run(tmp_path, case, counting_rf, caplog):
    """Spans of a whole CPU run: each chunk one ``engine.chunk_step``,
    each partition one ``tail.merge`` and ``tail.write``, every row merged
    on the device (``tail.merge.device``, one call a partition, inside
    ``tail.merge``), the engine's walls its phase spans, and each span
    family inside the wall that encloses it; no ``record_function``
    without a profiler."""
    kw, present, absent = RUNS[case]
    fof = write_fof(tmp_path / "c.fof")
    SE.last_run.clear()
    with caplog.at_level(logging.DEBUG, logger="kmtricks_tpu"):
        run_pipeline(PipelineOptions(fof=fof, run_dir=str(tmp_path / "rd"),
                                     kmer_size=31, nb_partitions=4, **kw),
                     device="cpu")
    rec = trace.last_run
    assert counting_rf.entered == 0
    for name in present + REPART + ("tail.merge", "tail.write",
                                    "tail.merge.device"):
        assert rec[name]["calls"] >= 1, name
    for name in absent:
        assert name not in rec, name
    assert rec["tail.merge"]["calls"] == rec["tail.write"]["calls"] == \
        rec["tail.merge.device"]["calls"] == 4
    assert rec["tail.merge"]["n"] == rec["tail.write"]["n"] == \
        rec["tail.merge.device"]["n"] > 0
    assert rec["tail.merge.device"]["s"] <= rec["tail.merge"]["s"]
    assert rec["tail.fetch"]["n"] > 0
    assert rec["repart.tally_step"]["calls"] == \
        rec["repart.upload"]["calls"] == rec["repart.pack"]["calls"] == \
        rec["repart.bases"]["calls"]
    assert rec["repart.bases"]["s"] == 0
    # one wait per block, and one for the end of the stream
    assert rec["repart.tally_wait"]["calls"] == \
        rec["repart.tally_step"]["calls"] + 1
    assert any(r.getMessage().startswith("spans: ") and "repart.place"
               in r.getMessage() for r in caplog.records)
    if "engine.chunk_loop" not in present:
        return
    last = SE.last_run
    walls = last["walls_s"]
    assert last["chunks"] >= 3
    assert rec["engine.chunk_step"]["calls"] == last["chunks"]
    assert rec["engine.fold"]["calls"] == last["chunks"]
    # the decode worker and its consumer see each chunk and the end
    assert rec["engine.decode"]["calls"] == last["chunks"] + 1
    assert rec["engine.decode_wait"]["calls"] == last["chunks"] + 1
    for phase in ("chunk_loop", "phase_a", "phase_b", "tail"):
        assert rec[f"engine.{phase}"] == {"s": walls[phase], "calls": 1,
                                          "n": 0}
    assert rec["engine.decode_wait"]["s"] + rec["engine.chunk_step"]["s"] \
        + rec["engine.fold"]["s"] <= walls["chunk_loop"]
    assert rec["tail.fetch"]["s"] + rec.get("tail.hists", {"s": 0})["s"] \
        + rec["tail.merge_write"]["s"] <= walls["tail"]
    # the pool's threads run the merges and writes inside its wall
    assert rec["tail.merge"]["s"] + rec["tail.write"]["s"] \
        <= rec["tail.merge_write"]["s"]
    if "hash.window" in present:
        assert rec["hash.window"]["calls"] == last["chunks"]
        assert rec["hash.window"]["n"] > 0
        assert rec["hash.window"]["s"] <= rec["engine.chunk_step"]["s"]


# the paths whose merge stays on the host: the chunked path (a sort
# layout no packed word takes) and the host stages
HOST_MERGES = {
    "chunked": dict(mode="hash:count:bin", bloom_size=2**62,
                    max_memory_mb=1),
    "host": dict(backend="host"),
}


@pytest.mark.parametrize("case", sorted(HOST_MERGES))
def test_host_merge_paths_record_no_device_merge(tmp_path, case,
                                                 monkeypatch):
    """The chunked path merges each partition on the host (one
    ``tail.merge`` a partition, no ``tail.merge.device``); the host
    stages open neither."""
    from kmtricks_tpu_torch.runtime import pipeline as P

    seen = []
    real = P.stage_mesh_chunked
    monkeypatch.setattr(P, "stage_mesh_chunked",
                        lambda *a, **k: (seen.append(1), real(*a, **k))[1])
    fof = write_fof(tmp_path / "c.fof")
    run_pipeline(PipelineOptions(fof=fof, run_dir=str(tmp_path / "rd"),
                                 kmer_size=31, nb_partitions=4,
                                 **HOST_MERGES[case]), device="cpu")
    rec = trace.last_run
    assert "tail.merge.device" not in rec
    if case == "chunked":
        assert seen == [1]
        assert rec["tail.merge"]["calls"] == rec["tail.write"]["calls"] == 4
        assert rec["tail.merge"]["n"] > 0
    else:
        assert not seen and "tail.merge" not in rec


def test_repart_blocks_pad_150bp_reads_by_under_6_percent(tmp_path,
                                                          monkeypatch):
    """On 150 bp reads each block's ``repart.pack`` bytes (B x L, as
    uploaded) over its ``repart.bases`` (the reads' bases) read 152/150:
    the block is as wide as its longest read rounded up to 8. One
    ``repart.pack``, ``repart.upload``, ``repart.tally_step`` and
    ``repart.bases`` a block, one more ``repart.tally_wait``."""
    import types

    import numpy as np

    from kmtricks_tpu_torch.runtime import pipeline as P

    rng = np.random.default_rng(18)
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(3000, 150))
    fasta = tmp_path / "r.fasta"
    fasta.write_text("".join(f">r{i}\n{r.tobytes().decode()}\n"
                             for i, r in enumerate(reads)))
    kmdir = types.SimpleNamespace(fof=[types.SimpleNamespace(
        paths=[str(fasta)])])
    config = types.SimpleNamespace(kmer_size=31, minim_size=8,
                                   seq_number=len(reads))
    monkeypatch.setattr(P, "REPART_BLOCK", 512)
    trace.begin_run()
    P.sample_minimizer_bins(kmdir, config, device="cpu")
    rec = trace.end_run()
    blocks = rec["repart.tally_step"]["calls"]
    assert blocks == -(-len(reads) // 512)
    for name in ("repart.pack", "repart.upload", "repart.bases"):
        assert rec[name]["calls"] == blocks, name
    assert rec["repart.tally_wait"]["calls"] == blocks + 1
    assert rec["repart.bases"]["n"] == reads.size
    assert rec["repart.pack"]["n"] == len(reads) * 152
    assert rec["repart.pack"]["n"] / rec["repart.bases"]["n"] < 1.06


@pytest.mark.parametrize("kw", [dict(max_memory_mb=1), dict()],
                         ids=["engine", "one_step"])
def test_merge_copy_span_and_counters_match_the_outputs(tmp_path, kw):
    """With rescue on, each partition's ``tail.merge`` holds one
    ``tail.merge.copy`` (its ``n`` the bytes of the final counts and keep
    flags) and adds the rows it keeps and the cells it rescues and keeps
    solid or rescued: the rows of the matrix files and the RESCUED and
    UNIQUE_W_RESCUE lines of the merge_info files."""
    import glob

    from kmtricks_tpu_torch.io.formats import read_matrix_file

    fof = write_fof(tmp_path / "c.fof")
    run_pipeline(PipelineOptions(fof=fof, run_dir=str(tmp_path / "rd"),
                                 kmer_size=31, nb_partitions=4, hard_min=1,
                                 soft_min="2", share_min=1, **kw),
                 device="cpu")
    rec = trace.last_run
    rows, nsamp = rec["tail.merge"]["n"], 10
    assert rec["tail.merge.copy"]["calls"] == 4
    assert rec["tail.merge.copy"]["n"] == rows * (4 * nsamp + 1)
    assert rec["tail.merge.copy"]["s"] <= rec["tail.merge"]["s"]
    for name in ("tail.merge.kept", "tail.merge.rescued",
                 "tail.merge.final"):
        assert rec[name]["calls"] == 4 and rec[name]["s"] == 0.0
    stats = {}
    for path in glob.glob(str(tmp_path / "rd" / "merge_infos" / "*")):
        for line in open(path):
            name, *vals = line.rstrip("\t\n").split("\t")
            stats[name] = stats.get(name, 0) + sum(map(int, vals))
    kept = sum(len(read_matrix_file(p)[1]) for p in glob.glob(
        str(tmp_path / "rd" / "matrices" / "*.count")))
    assert 0 < rec["tail.merge.kept"]["n"] == kept < rows
    assert 0 < rec["tail.merge.rescued"]["n"] == stats["RESCUED"]
    assert rec["tail.merge.final"]["n"] == stats["UNIQUE_W_RESCUE"]


def test_record_function_only_under_a_profiler(counting_rf):
    trace.begin_run()
    with trace.span("quiet"):
        pass
    assert counting_rf.entered == 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with trace.span("loud"):
            pass
    assert counting_rf.entered == 1
    with trace.span("quiet"):
        pass
    assert counting_rf.entered == 1
    assert trace.end_run()["quiet"]["calls"] == 2


def test_profiler_trace_holds_the_spans_on_the_main_thread(tmp_path):
    """Under ``torch.profiler`` on the CPU the engine's chunk steps appear
    as ``km.engine.chunk_step`` on the thread that ran the pipeline."""
    fof = write_fof(tmp_path / "c.fof")
    opts = PipelineOptions(fof=fof, run_dir=str(tmp_path / "rd"),
                           kmer_size=31, nb_partitions=4, max_memory_mb=1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.main"):
            run_pipeline(opts, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    main = {e["tid"] for e in events if e["name"] == "test.main"}
    steps = [e for e in events if e["name"] == "km.engine.chunk_step"]
    assert len(main) == 1
    assert len(steps) == SE.last_run["chunks"] == \
        trace.last_run["engine.chunk_step"]["calls"]
    assert {e["tid"] for e in steps} == main
    loops = [e for e in events if e["name"] == "km.engine.chunk_loop"]
    assert len(loops) == 1
    lo, hi = loops[0]["ts"], loops[0]["ts"] + loops[0]["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in steps)


def test_prefetched_worker_exits_when_the_consumer_abandons():
    """A consumer that stops early (an error in the chunk loop) stops the
    worker: it leaves its blocked put, closes the generator and lets go
    of the items it held."""
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    before = {t for t in threading.enumerate() if t.name == "prefetch"}
    it = prefetched(endless(), depth=1)
    assert next(it) == 0
    time.sleep(0.05)           # the worker now blocks on the full queue
    it.close()
    assert closed.wait(5)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name == "prefetch" and t not in before
            for t in threading.enumerate()):
        time.sleep(0.01)
    assert not [t for t in threading.enumerate()
                if t.name == "prefetch" and t not in before]


def test_prefetched_spans_are_named_by_the_caller():
    trace.begin_run()
    assert list(prefetched(iter(range(5)), depth=2, name="stream")) == \
        list(range(5))
    assert list(prefetched(iter(range(3)), depth=2)) == [0, 1, 2]
    rec = trace.end_run()
    assert set(rec) == {"stream.decode", "stream.decode_wait"}
    assert rec["stream.decode"]["calls"] == 6
    assert rec["stream.decode_wait"]["calls"] == 6
