"""The port owns its host layer: no module of ``kmtricks_tpu_torch`` (nor
``chip_smoke.py``, nor the port's multi-process test workers) imports jax
or the JAX package, and the port's copies of the JAX package's host
modules give the same arrays and bytes as the originals. The port's
multi-process start refuses NCCL where two ranks would share a card."""

import ast
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import xxhash

from kmtricks_tpu import native as jax_native
from kmtricks_tpu.core.repartition import Repartition as JaxRepartition
from kmtricks_tpu.host import ops as jax_hops
from kmtricks_tpu.io import lz4 as jax_lz4
from kmtricks_tpu.io import sequences as jax_seqio
from kmtricks_tpu_torch import native
from kmtricks_tpu_torch.core.repartition import Repartition
from kmtricks_tpu_torch.host import ops as hops
from kmtricks_tpu_torch.io import lz4
from kmtricks_tpu_torch.io import sequences as seqio
from kmtricks_tpu_torch.parallel import multihost as mh

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data_ref_exec"
PORT_FILES = sorted((ROOT / "kmtricks_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_multihost_worker.py",
    ROOT / "tests" / "torch_multihost_stream_worker.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "kmtricks_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_package(path):
    """Every import statement, at any depth of the module, names neither
    jax nor ``kmtricks_tpu`` / ``kmtricks_tpu.*`` (``kmtricks_tpu_torch``
    is the port itself)."""
    tree = ast.parse(path.read_text(), str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def _sample_reads(c: int):
    files = sorted(DATA.glob(f"c{c}_*.fasta"))
    return [s for p in files
            for s in jax_seqio.iter_sequences([str(p)])]


def _repart_table(m: int, nparts: int, seed: int):
    return np.random.default_rng(seed).integers(
        0, nparts, 4 ** m).astype(np.uint16)


def _count(ops, c, k, table):
    sc = ops.count_sequences(_sample_reads(c), k, 8, table, hard_min=1)
    return {p: v for p, v in sorted(sc.partitions.items())}


def case_count_sequences():
    table = _repart_table(8, 4, 0)
    for c, k in ((0, 31), (3, 21)):
        exp, got = _count(jax_hops, c, k, table), _count(hops, c, k, table)
        assert sorted(exp) == sorted(got) and exp
        for p in exp:
            np.testing.assert_array_equal(got[p][0], exp[p][0])
            np.testing.assert_array_equal(got[p][1], exp[p][1])


def _merge_inputs():
    """Partition 0 of four samples' k = 31 counts, with repeated files so
    that counts and soft-min verdicts vary."""
    table = _repart_table(8, 4, 1)
    keys, counts = [], []
    for c in range(4):
        reads = _sample_reads(c) + _sample_reads(c)[: 3 + c]
        sc = jax_hops.count_sequences(reads, 31, 8, table, hard_min=1)
        kk, cc = sc.partitions[0]
        keys.append(kk)
        counts.append(cc)
    return keys, counts, np.array([1, 2, 1, 2], np.uint32)


def _same_result(got, exp):
    np.testing.assert_array_equal(got.keys, exp.keys)
    np.testing.assert_array_equal(got.counts, exp.counts)
    np.testing.assert_array_equal(got.keep, exp.keep)
    for name in ("non_solid", "rescued", "uniq_wo_rescue", "uniq_w_rescue",
                 "total_wo_rescue", "total_w_rescue"):
        np.testing.assert_array_equal(getattr(got.stats, name),
                                      getattr(exp.stats, name))


def case_merge_partition():
    keys, counts, amin = _merge_inputs()
    for rmin, save_if in ((1, 0), (2, 1)):
        exp = jax_hops.merge_partition(keys, counts, amin, rmin, save_if)
        got = hops.merge_partition(keys, counts, amin, rmin, save_if)
        assert len(exp.keys) > 100
        _same_result(got, exp)


def case_merge_dense():
    keys, counts, amin = _merge_inputs()
    ref = jax_hops.merge_partition(keys, counts, amin, 1, 0)
    rng = np.random.default_rng(2)
    pre = (ref.counts * (rng.random(ref.counts.shape) < 0.8)).astype(
        np.uint32)
    for rmin, save_if in ((1, 0), (2, 2)):
        _same_result(hops.merge_dense(ref.keys, pre, amin, rmin, save_if),
                     jax_hops.merge_dense(ref.keys, pre, amin, rmin,
                                          save_if))


def case_native_xxh64():
    lib = native.lib()
    assert lib is not None, "g++ did not build the port's native library"
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 8, 31, 32, 33, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 12345):
            exp = xxhash.xxh64_intdigest(data, seed)
            assert lib.km_xxh64(data, len(data), seed) == exp
            assert jax_native.xxh64(data, seed) == exp


def case_lz4_round_trip():
    rng = np.random.default_rng(5)
    text = b"".join(p.read_bytes() for p in sorted(DATA.glob("c0_*.fasta")))
    for data in (b"", text, rng.integers(0, 4, 300_000,
                                         dtype=np.uint8).tobytes()):
        frame = lz4.compress(data)
        assert frame == jax_lz4.compress(data)
        assert lz4.decompress(frame) == data
        assert jax_lz4.decompress(frame) == data
        block = lz4.compress_block(data)
        assert block == jax_lz4.compress_block(data)
        assert lz4.decompress_block(block, len(data)) == data


def case_repartition_load_save(tmp_path):
    bins = np.random.default_rng(6).integers(0, 1000, 4 ** 6)
    paths = {}
    for name, cls in (("port", Repartition), ("jax", JaxRepartition)):
        rep = cls.from_bin_sizes(bins, 8)
        paths[name] = tmp_path / f"{name}.minimRepart"
        rep.save(str(paths[name]))
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    for path in paths.values():
        a, b = Repartition.load(str(path)), JaxRepartition.load(str(path))
        np.testing.assert_array_equal(a.table, b.table)
        assert a.nb_partitions == b.nb_partitions == 8


def case_write_bf_file(tmp_path):
    """The port's HowDe-SBT / SDSL filter writer gives the original's
    bytes."""
    from kmtricks_tpu.io import howde as jax_howde
    from kmtricks_tpu_torch.io import howde

    rng = np.random.default_rng(7)
    for bloom, fmt in ((1_000_064, "howdesbt"), (640, "sdsl"),
                       (4096, "howdesbt")):
        bits = rng.integers(0, 256, bloom // 8, dtype=np.uint8)
        a, b = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
        howde.write_bf_file(str(a), bits, bloom, 31, fmt=fmt)
        jax_howde.write_bf_file(str(b), bits, bloom, 31, fmt=fmt)
        assert a.read_bytes() == b.read_bytes()
        assert len(a.read_bytes()) > bloom // 8


def case_superkmer_codec():
    """The skp superkmer packing (native and Python) gives the
    original's bytes and round-trips."""
    from kmtricks_tpu.runtime import superk as jax_superk
    from kmtricks_tpu_torch.runtime import superk

    rng = np.random.default_rng(8)
    for k in (11, 21, 31, 32, 47, 63):
        for nbk in (1, 2, 5, 17, 100):
            codes = rng.integers(0, 4, k + nbk - 1).astype(np.uint8)
            data = superk.pack_superkmer(codes, k)
            assert data == jax_superk.pack_superkmer(codes, k)
            assert native.pack_superkmer(codes, k) == data
            np.testing.assert_array_equal(
                superk.unpack_superkmer(data, nbk, k), codes)
            np.testing.assert_array_equal(
                native.unpack_superkmer(data, k, nbk), codes)


def case_kff_writers(tmp_path):
    """The KFF raw and minimizer-section writers give the original's
    bytes, and the readers read them back."""
    from kmtricks_tpu.io import kff as jax_kff
    from kmtricks_tpu_torch.io import kff

    rng = np.random.default_rng(9)
    for k, slots in ((31, 1), (47, 2)):
        kmers = np.sort(rng.integers(0, 1 << 62, (200, slots),
                                     dtype=np.uint64), axis=0)
        if slots == 2:
            kmers[:, 1] &= np.uint64((1 << (2 * (k - 32))) - 1)
        counts = rng.integers(1, 300, 200).astype(np.uint32)
        a, b = tmp_path / f"p{k}.kff", tmp_path / f"j{k}.kff"
        kff.write_kff_file(str(a), kmers, counts, k, 2)
        jax_kff.write_kff_file(str(b), kmers, counts, k, 2)
        assert a.read_bytes() == b.read_bytes()
        assert kff.read_kff_file(str(a)) == jax_kff.read_kff_file(str(b))
    blocks = []
    for _ in range(30):
        n = int(rng.integers(31, 60))
        codes = rng.integers(0, 4, n).astype(np.uint8)
        blocks.append((codes, int(rng.integers(0, n - 10 + 1)),
                       rng.integers(0, 400, n - 31 + 1)))
    a, b = tmp_path / "psk.kff", tmp_path / "jsk.kff"
    kff.write_kff_sk_file(str(a), blocks, 31, 10)
    jax_kff.write_kff_sk_file(str(b), blocks, 31, 10)
    assert a.read_bytes() == b.read_bytes()
    got, exp = kff.read_kff_sk_file(str(a)), jax_kff.read_kff_sk_file(str(b))
    assert got[0] == exp[0] and len(got[1]) == len(exp[1]) == 30


def case_dump_text(tmp_path):
    """dump gives the original's text for count, hash, matrix and pa
    files written by the port's writers."""
    import io

    from kmtricks_tpu.io.dump import dump_text as jax_dump
    from kmtricks_tpu_torch.io import formats as F
    from kmtricks_tpu_torch.io.dump import dump_text

    rng = np.random.default_rng(10)
    kmers = np.sort(rng.integers(0, 1 << 62, (100, 1), dtype=np.uint64),
                    axis=0)
    counts = rng.integers(0, 50, (100, 3)).astype(np.uint32)
    paths = [tmp_path / n for n in ("a.kmer", "a.hash", "a.count", "a.pa")]
    F.write_kmer_file(str(paths[0]), kmers, counts[:, 0], 31, 4, 0, 0)
    F.write_hash_file(str(paths[1]), kmers[:, 0], counts[:, 0], 4, 0, 0)
    F.write_matrix_file(str(paths[2]), kmers, counts, 31, 4, 0, 0)
    F.write_pa_matrix_file(str(paths[3]), kmers, F.pack_pa_bits(counts > 0),
                           31, 3, 0, 0)
    for path in paths:
        a, b = io.StringIO(), io.StringIO()
        dump_text(str(path), a)
        jax_dump(str(path), b)
        assert a.getvalue() == b.getvalue()
        assert len(a.getvalue().splitlines()) == 100


COPY_CASES = {
    "count_sequences": case_count_sequences,
    "merge_partition": case_merge_partition,
    "merge_dense": case_merge_dense,
    "native_xxh64": case_native_xxh64,
    "lz4_round_trip": case_lz4_round_trip,
    "repartition_load_save": case_repartition_load_save,
    "write_bf_file": case_write_bf_file,
    "superkmer_codec": case_superkmer_codec,
    "kff_writers": case_kff_writers,
    "dump_text": case_dump_text,
}
WRITES_FILES = ("repartition_load_save", "write_bf_file", "kff_writers",
                "dump_text")


@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_host_copy_matches_original(case, tmp_path):
    fn = COPY_CASES[case]
    fn(tmp_path) if case in WRITES_FILES else fn()


def test_port_sequences_parse_like_the_original():
    """The port's bank reader gives the original's batches."""
    paths = [str(p) for p in sorted(DATA.glob("c2_*.fasta"))]
    got = list(seqio.iter_batches(paths))
    exp = list(jax_seqio.iter_batches(paths))
    assert len(got) == len(exp) > 0
    for (gb, gl), (eb, el) in zip(got, exp):
        np.testing.assert_array_equal(gb, eb)
        np.testing.assert_array_equal(gl, el)


@pytest.mark.parametrize("cards, world", [(1, 2), (2, 3), (0, 2)])
def test_nccl_refuses_ranks_that_share_a_card(monkeypatch, cards, world):
    """NCCL takes a card of its own per rank: a world larger than the
    host's cards raises in ``initialize``, before any process group
    starts; gloo is not taken in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: pytest.fail(
        "a card was taken"))
    for rank in range(world):
        with pytest.raises(ValueError, match="card of its own per rank"):
            mh.initialize("tcp://localhost:1", world, rank, "nccl")
    assert not dist.is_initialized()


def test_multihost_backend_is_the_callers(monkeypatch):
    """Only gloo and nccl are taken, and nccl without CUDA raises."""
    with pytest.raises(ValueError, match="gloo"):
        mh.initialize("tcp://localhost:1", 2, 0, "mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mh.initialize("tcp://localhost:1", 2, 0, "nccl")
    assert not dist.is_initialized()
