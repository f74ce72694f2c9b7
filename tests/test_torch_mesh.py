"""The mesh: ``build_sharded_pipeline``'s per-shard outputs against the
JAX package's on ``make_mesh(4)`` and ``make_mesh(8)`` (the k2, k3, kw,
h1, h2 and generic layouts, tests/test_parallel.py's golden cases, shards
that receive nothing), ``count_merge_packed`` over routed runs against
the JAX package's, the K3/K4 launch counters under threads, and run
directories over meshes of one to four CPU shards against
``kmtricks_tpu``, byte for byte."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmtricks_tpu.core.repartition import Repartition
from kmtricks_tpu.ops import count_merge as jcm
from kmtricks_tpu.parallel import pipeline as jpipe
from kmtricks_tpu.runtime.pipeline import PipelineOptions as JaxOptions
from kmtricks_tpu.runtime.pipeline import run_pipeline as jax_run_pipeline
from kmtricks_tpu_torch.convert import from_jax_inputs, words_from_msb_u32
from kmtricks_tpu_torch.ops import count_merge as CM
from kmtricks_tpu_torch.ops import merge_runs as MR
from kmtricks_tpu_torch.parallel import pipeline as PP
from kmtricks_tpu_torch.runtime import stream_engine as SE
from kmtricks_tpu_torch.runtime.pipeline import PipelineOptions, run_pipeline
from test_parallel import _pad_global, random_reads
from test_torch_chunked import chunked_files
from test_torch_pipeline import synthetic_batch, write_fof

torch.set_num_threads(2)

M, NB_PARTS, NSAMP = 10, 8, 3
GOLDEN = [(1, 1, 1, 0), (2, 3, 2, 2)]     # hard_min, amin, rmin, save_if

# layout: (mode, k, window bits or None, golden parameters)
LAYOUTS = {
    "k2": ("kmer", 21, None, GOLDEN[0]),
    "k3": ("kmer", 31, None, GOLDEN[1]),
    "kw": ("kmer", 63, None, GOLDEN[0]),
    "h1": ("hash", 31, 250_048, GOLDEN[1]),
    "h2": ("hash", 31, 2**31 + 64, GOLDEN[0]),
    "generic": ("hash", 31, 2**59, GOLDEN[1]),
}


def layout_of(mode, k, window, nsamp=NSAMP, nb_parts=NB_PARTS):
    return CM.stream_layout(k, nb_parts, nsamp, mode, window)


def test_layouts_cover_every_receiver():
    assert {n: layout_of(*c[:3]) for n, c in LAYOUTS.items()} == {
        "k2": "k2.3.42", "k3": "k3", "kw": "kw.3.126.4", "h1": "h1",
        "h2": "h2", "generic": None}


@pytest.fixture(scope="module")
def golden_batch():
    """tests/test_parallel.py's reads and XXH repartition over 8
    partitions; three samples of 24 reads, which overlap and repeat reads
    once or twice, so that its second golden case (hard-min 2, soft-min
    3, rescue) keeps rows. No N, so that k = 63 windows are many."""
    rng = np.random.default_rng(7)
    repart = Repartition.from_xxh(NB_PARTS, M)
    reads = random_reads(rng, 20)
    samples = [reads[4 * s:4 * s + 12] + reads[4 * s:4 * s + 8]
               + reads[4 * s:4 * s + 4] for s in range(NSAMP)]
    return repart.table.astype(np.int32), _pad_global(samples, 8)


def jax_shards(mesh, step_kw, args, rc):
    """The JAX sharded step's compacted rows per device, cut to their
    row counts: [(rows u32, pre u32, npres)]."""
    rows, pre, nrows, _maxc, npres, dropped = jpipe.build_sharded_pipeline(
        mesh, compact_rows=rc, with_stats=False, **step_kw)(*args)
    assert int(np.asarray(dropped)) == 0
    rows, pre = np.asarray(rows), np.asarray(pre)
    return [(rows[d * rc:d * rc + int(n)], pre[d * rc:d * rc + int(n)],
             int(npres[d])) for d, n in enumerate(np.asarray(nrows))]


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sharded_step_matches_jax(golden_batch, name, ndev):
    """Each shard's rows (keys, partition) and pre-merge counts equal the
    JAX device's on a mesh of the same size. On 8 shards the partitions
    are cut to 0-3, so shards 4-7 receive nothing from anyone."""
    mode, k, window, (hard_min, amin, rmin, save_if) = LAYOUTS[name]
    table, (batch, lengths, sarr) = golden_batch
    if ndev == 8:
        table = table % 4
    amin_vec = np.full(NSAMP, amin, np.uint32)
    n_windows = batch.shape[0] * (batch.shape[1] - k + 1)
    step_kw = dict(k=k, m=M, nb_parts=NB_PARTS, nsamp=NSAMP,
                   hard_min=hard_min, rmin=rmin, save_if=save_if,
                   count_max=255, mode=mode, window_bits=window)
    exp = jax_shards(jpipe.make_mesh(ndev), dict(step_kw, cap=n_windows),
                     tuple(jnp.asarray(a) for a in (batch, lengths, sarr,
                                                    table, amin_vec)),
                     n_windows)
    mesh = PP.make_mesh(["cpu"] * ndev)
    args = from_jax_inputs(batch, lengths, sarr, table, amin_vec, None,
                           "cpu")
    got = PP.build_sharded_pipeline(mesh, **step_kw)(*args[:5])
    assert len(got) == ndev
    nkw = 1 if mode == "hash" or k <= 32 else -(-k // 32)
    for d, ((rows_j, pre_j, npres_j), (rows, pre, nrows, _mx, npres)) in \
            enumerate(zip(exp, got)):
        assert (nrows, npres) == (len(rows_j), npres_j), d
        assert rows.shape == (nrows, nkw + 1)
        nw = 2 if mode == "hash" else 2 * nkw
        keys = words_from_msb_u32([rows_j[:, j] for j in range(nw)])
        for j in range(nkw):
            np.testing.assert_array_equal(rows[:, j].numpy(),
                                          keys[j].numpy())
        part = (keys[0].numpy() // window if mode == "hash"
                else rows_j[:, nw].astype(np.int64))
        np.testing.assert_array_equal(rows[:, -1].numpy(), part)
        np.testing.assert_array_equal(pre.numpy().view(np.uint32), pre_j)
        owner = PP.partition_to_device(NB_PARTS, ndev)
        assert (owner[part] == d).all()
    nrows = [g[2] for g in got]
    assert sum(nrows) > 100
    if ndev == 8:
        assert nrows[4:] == [0] * 4 and min(nrows[:4]) > 0


def encode_flat(side, batch, lengths, samp, table, k, m, mode, window):
    """(part, keys, samp, valid) of every window in row-major order: the
    JAX package's msb-first u32 key words, or the port's int64 keys."""
    if side == "jax":
        keys, sampw, parts, valid = jpipe._encode_flat(
            jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(samp),
            jnp.asarray(table), k, m, mode, window)
        return (np.asarray(parts), tuple(np.asarray(w) for w in keys),
                np.asarray(sampw), np.asarray(valid))
    tb, tl, ts, tt, _a, _h = from_jax_inputs(batch, lengths, samp, table,
                                             None, None, "cpu")
    keys, parts, valid = PP.encode(tb, tl, tt, k=k, m=m)
    if mode == "hash":
        keys = PP.window_hash(keys, parts, window)
    sampw = ts[:, None].expand(parts.shape).reshape(-1)
    return (parts.reshape(-1), PP._on_words(keys, lambda w: w.reshape(-1)),
            sampw, valid.reshape(-1))


# piece boundaries of the flat windows: five routed runs, one empty
PIECES = (0.0, 0.3, 0.3, 0.55, 0.9, 1.0)


@pytest.mark.parametrize("name", ["k2", "k3", "kw", "h1", "h2"])
def test_count_merge_packed_matches_jax(name):
    """count_merge_packed over ascending routed runs (one of them empty):
    the port merges them (K3/K4's plain version here), the JAX package
    takes them as sentinel-padded runs of one length (sorted_runs=5);
    every output on the valid entries."""
    mode, k, window, (hard_min, amin, rmin, save_if) = LAYOUTS[name]
    nsamp, m, nparts = 4, 8, NB_PARTS
    batch, lengths, samp, table, _amin = synthetic_batch(
        11, nsamp, B=32, m=m, nparts=nparts)
    amin_vec = np.full(nsamp, amin, np.uint32)
    layout = layout_of(mode, k, window, nsamp, nparts)
    jp, jk, js, jv = encode_flat("jax", batch, lengths, samp, table, k, m,
                                 mode, window)
    tp, tk, ts, tv = encode_flat("port", batch, lengths, samp, table, k, m,
                                 mode, window)
    n = len(jp)
    cuts = [int(f * n) for f in PIECES]
    jruns, truns = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sl = slice(lo, hi)
        jw = jcm.sort_packed(layout, jcm.pack_words(
            layout, jp[sl], tuple(w[sl] for w in jk), js[sl], jv[sl],
            nsamp))
        jruns.append([np.asarray(w) for w in jw])
        v = tv[sl]
        tw = CM.pack_words(layout, tp[sl][v],
                           PP._on_words(tk, lambda w: w[sl][v]), ts[sl][v],
                           None, nsamp)
        truns.append(CM.sort_packed(layout, tw))
    assert min(len(r[0]) for r in truns) == 0
    width = max(len(r[0]) for r in jruns)
    words = tuple(np.concatenate([np.concatenate(
        [r[j], np.full(width - len(r[j]), 0xFFFFFFFF, np.uint32)])
        for r in jruns]) for j in range(len(jruns[0])))
    key_bits = CM.hash_key_bits(window, nparts) if mode == "hash" else None
    exp = jcm.count_merge_packed(
        words, amin_vec, layout=layout, nsamp=nsamp, hard_min=hard_min,
        rmin=rmin, save_if=save_if, count_max=255, with_stats=False,
        key_bits=key_bits, window_bits=window, sorted_runs=len(jruns))
    got = CM.count_merge_packed(
        truns, torch.from_numpy(amin_vec.astype(np.int32)), layout=layout,
        nsamp=nsamp, hard_min=hard_min, rmin=rmin, save_if=save_if,
        count_max=255, window_bits=window)
    nv = int(tv.sum())
    assert got[0].shape[0] == nv > 1000
    e_keys = words_from_msb_u32([np.asarray(w)[:nv] for w in exp[1]])
    g_keys = CM.key_words(got[1])
    assert len(g_keys) == len(e_keys)
    for g, e in zip(g_keys, e_keys):
        assert torch.equal(g, e)
    names = ("part", None, "samp", "final", "cnt", "present", "row_head",
             "row_keep", "row_of")
    for i, nm in enumerate(names):
        if nm:
            np.testing.assert_array_equal(
                got[i].numpy().astype(np.int64),
                np.asarray(exp[i])[:nv].astype(np.int64), err_msg=nm)
    assert got[6].sum() > 100


def test_route_sorted_splits_at_the_owner():
    """The sorted words split into exactly sized runs, each on its
    owner's device: partitions 0-7 over 3 shards go to 0, 0, 0, 1, 1, 1,
    2, 2 (``p * ndev // nb_parts``); an owner of no entry gets an empty
    run."""
    layout = CM.stream_layout(31, NB_PARTS, 4)
    part = torch.tensor([0, 1, 1, 2, 6, 7, 7], dtype=torch.int32)
    keys = torch.arange(7, dtype=torch.int64) * 977
    samp = torch.tensor([0, 1, 2, 3, 0, 1, 2], dtype=torch.int32)
    ws = CM.sort_packed(layout, CM.pack_words(layout, part, keys, samp, None,
                                              4))
    assert list(PP.partition_to_device(NB_PARTS, 3)) == [0, 0, 0, 1, 1, 1,
                                                         2, 2]
    runs = PP._route_sorted(layout, ws, PP.make_mesh(["cpu"] * 3), nsamp=4,
                            nb_parts=NB_PARTS)
    assert [len(r[0]) for r in runs] == [4, 0, 3]
    got = [CM.part_of_sorted(layout, r, 4).tolist() for r in runs]
    assert got == [[0, 1, 1, 2], [], [6, 7, 7]]
    generic = PP._bucket_and_route(part.flip(0), keys, samp,
                                   PP.make_mesh(["cpu"] * 3),
                                   nb_parts=NB_PARTS)
    assert [g[0].tolist() for g in generic] == [[2, 1, 1, 0], [], [7, 7, 6]]


def test_merge_launch_counters_take_a_lock(monkeypatch):
    """Eight threads merging at once count every K3/K4 launch: the
    counters are read, incremented and stored under a lock (the counts
    here read slowly, so an unlocked increment loses updates)."""
    class SlowCounts(dict):
        def __getitem__(self, key):
            value = super().__getitem__(key)
            time.sleep(1e-4)
            return value

    class FakeLib:
        def km_merge_runs(self, *args):
            return 0

    counts = SlowCounts({key: 0 for key in MR.LAUNCHES})
    monkeypatch.setattr(MR, "LAUNCHES", counts)
    one = [((torch.arange(n, dtype=torch.int64),), None) for n in (5, 7)]
    two = [((torch.arange(n, dtype=torch.int64),) * 2, None)
           for n in (5, 7)]

    def work():
        for _ in range(25):
            MR._merge_two_cuda(*one, FakeLib(), 0)
            MR._merge_two_cuda(*two, FakeLib(), 0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert dict(counts) == {"K3": 200, "K4": 200, "K3_split": 200,
                            "K4_split": 200}


def test_make_mesh_defaults_to_cuda(monkeypatch):
    """The default mesh is every visible CUDA device (one shard on one
    card); without CUDA it raises rather than take the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PP.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert PP.make_mesh() == (torch.device("cuda", 0),
                              torch.device("cuda", 1))
    assert PP.make_mesh(["cpu"] * 3) == (torch.device("cpu"),) * 3


# run directories: the fused branch's routes over meshes of CPU shards
MESH_ROUTES = {
    "step_k31": dict(kmer_size=31, hard_min=1, soft_min="2", share_min=1),
    "step_k63": dict(kmer_size=63, hard_min=2, soft_min="1"),
    "step_hash_bf": dict(kmer_size=31, hard_min=1, soft_min="1",
                         mode="hash:bf:bin", bloom_size=1_000_000),
    "engine_k21_hist": dict(kmer_size=21, hard_min=1, soft_min="0.5",
                            hist=True, max_memory_mb=1),
    "engine_pa_bits": dict(kmer_size=31, hard_min=1, soft_min="2",
                           share_min=2, mode="kmer:pa:bin",
                           max_memory_mb=1),
}
# the last mesh holds two distinct (CPU) devices: its shards run on host
# threads of their own and its runs are copied between them
MESHES = {"1": ["cpu"], "2": ["cpu"] * 2, "3": ["cpu"] * 3,
          "4": ["cpu"] * 4, "4_threads": ["cpu", "cpu:0"] * 2}


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """The host stages' run directory of each route, made once."""
    root = tmp_path_factory.mktemp("mesh_host")
    fof = write_fof(root / "c.fof")
    done = {}

    def get(route):
        if route not in done:
            done[route] = chunked_files(jax_run_pipeline(JaxOptions(
                fof=fof, run_dir=str(root / route), backend="host",
                nb_partitions=4, **MESH_ROUTES[route])).root)
        return fof, done[route]

    return get


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("route", sorted(MESH_ROUTES))
def test_mesh_run_matches_host_backend(tmp_path, host_runs, route, mesh):
    """``run_pipeline`` over a mesh of CPU shards, the one-step path or
    the engine (its pa-bits tail, histograms and a float soft-min),
    byte-identical to ``kmtricks_tpu --backend host``, so to every other
    mesh size."""
    fof, exp = host_runs(route)
    kw = MESH_ROUTES[route]
    port = run_pipeline(PipelineOptions(
        fof=fof, run_dir=str(tmp_path / "port"), nb_partitions=4, **kw),
        device="cpu", devices=MESHES[mesh])
    got = chunked_files(port.root)
    assert sorted(got) == sorted(exp) and len(got) >= 8
    for name in exp:
        assert got[name] == exp[name], name
    if route.startswith("engine"):
        assert SE.last_run["shards"] == len(MESHES[mesh])
        assert SE.last_run["chunks"] >= 3
        assert SE.last_run["tail"] == ("pa_bits" if "pa" in route
                                       else "dense")
