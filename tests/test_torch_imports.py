"""The port owns its host layer: no module of ``kmtricks_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package, and the port's copies of
the JAX package's host modules give the same arrays and bytes as the
originals."""

import ast
import pathlib

import numpy as np
import pytest
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

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data_ref_exec"
PORT_FILES = sorted((ROOT / "kmtricks_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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


COPY_CASES = {
    "count_sequences": case_count_sequences,
    "merge_partition": case_merge_partition,
    "merge_dense": case_merge_dense,
    "native_xxh64": case_native_xxh64,
    "lz4_round_trip": case_lz4_round_trip,
    "repartition_load_save": case_repartition_load_save,
    "write_bf_file": case_write_bf_file,
}
WRITES_FILES = ("repartition_load_save", "write_bf_file")


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
