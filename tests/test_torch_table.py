"""Port count tables (ops/table.py) and the engine's device steps
(parallel/pipeline.py) against the JAX package's, compared in decoded
form: the port's int64 words and exact sizes against the JAX u32 words
with sentinel tails and count-0 shadows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmtricks_tpu.ops import count_merge as jcm
from kmtricks_tpu.ops import table as jtable
from kmtricks_tpu.parallel import pipeline as jpipe
from kmtricks_tpu_torch.convert import from_jax_inputs, keys_from_msb_words
from kmtricks_tpu_torch.ops import count_merge as CM
from kmtricks_tpu_torch.ops.compact import compact_count_rows
from kmtricks_tpu_torch.ops.table import (
    U32_MAX, chunk_count_pairs, merge_pair_streams, run_sum_bounded)
from kmtricks_tpu_torch.parallel.pipeline import (
    build_chunk_pairs_step, table_compact, table_sort_collapse)
from test_torch_pipeline import synthetic_batch

torch.set_num_threads(2)

FF = np.uint32(0xFFFFFFFF)


def pack2(vals):
    """u64 values -> msb-first u32 (hi, lo), the JAX words."""
    v = np.asarray(vals, dtype=np.uint64)
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def unpack2(hi, lo, n):
    return ((np.asarray(hi)[:n].astype(np.uint64) << np.uint64(32))
            | np.asarray(lo)[:n])


def port_stream(vals, cnts):
    return ((torch.from_numpy(vals.astype(np.int64)),),
            torch.from_numpy(cnts.astype(np.int64)))


def jax_stream(vals, cnts, cap):
    hi, lo = pack2(vals)
    pad = cap - len(vals)
    return ((jnp.asarray(np.concatenate([hi, np.full(pad, FF)])),
             jnp.asarray(np.concatenate([lo, np.full(pad, FF)]))),
            jnp.asarray(np.concatenate([cnts.astype(np.uint32),
                                        np.zeros(pad, np.uint32)])))


@pytest.mark.parametrize("n,npad", [(4096, 0), (4096, 777), (256, 255)])
def test_chunk_count_pairs(n, npad):
    rng = np.random.default_rng(n + npad)
    vals = np.sort(rng.integers(0, 1 << 40, n).astype(np.uint64))
    hi, lo = pack2(vals)
    pw, pc, npairs = jax.jit(
        lambda a, b: jtable.chunk_count_pairs((a, b), pair_cap=n))(
        jnp.asarray(np.concatenate([hi, np.full(npad, FF)])),
        jnp.asarray(np.concatenate([lo, np.full(npad, FF)])))
    npairs = int(npairs)
    (words,), cnt = chunk_count_pairs(
        (torch.from_numpy(vals.astype(np.int64)),))
    assert words.shape[0] == cnt.shape[0] == npairs
    np.testing.assert_array_equal(words.numpy().astype(np.uint64),
                                  unpack2(pw[0], pw[1], npairs))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pc)[:npairs])


@pytest.mark.parametrize("nstreams", [2, 3, 5, 8])
def test_merge_pair_streams(nstreams):
    rng = np.random.default_rng(nstreams)
    cap = 2048
    port, jaxs = [], []
    for _ in range(nstreams):
        u = np.unique(rng.integers(0, 5000, rng.integers(10, cap // 2))
                      .astype(np.uint64))
        c = rng.integers(1, 1000, len(u)).astype(np.uint32)
        port.append(port_stream(u, c))
        jaxs.append(jax_stream(u, c, cap))
    out_w, out_c, n = jtable.merge_pair_streams(jaxs, out_cap=nstreams * cap)
    n = int(n)
    (words,), cnt = merge_pair_streams(port)
    assert cnt.shape[0] == n
    np.testing.assert_array_equal(words.numpy().astype(np.uint64),
                                  unpack2(out_w[0], out_w[1], n))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(out_c)[:n])


@pytest.mark.parametrize("counts,total", [
    ((0xF0000000,) * 3, 0xFFFFFFFF),          # saturates at u32
    ((0x60000000, 0x30000000), 0x90000000),   # in [2^31, 2^32): exact
])
def test_merge_saturates(counts, total):
    key = np.array([5], dtype=np.uint64)
    port = [port_stream(key, np.array([c])) for c in counts]
    jaxs = [jax_stream(key, np.array([c], np.uint32), 1) for c in counts]
    out_w, out_c, n = jtable.merge_pair_streams(jaxs, out_cap=4)
    (words,), cnt = merge_pair_streams(port)
    assert int(n) == 1 and words.tolist() == [5]
    assert cnt.tolist() == [total] == [int(np.asarray(out_c)[0])]


def test_empty_runs():
    """A chunk without a valid window gives an empty run; empty runs
    merge away and an empty table compacts to no rows."""
    e = torch.zeros(0, dtype=torch.int64)
    assert [t.numel() for t in chunk_count_pairs((e, e))[0]] == [0, 0]
    s = ((torch.tensor([1, 5, 9]),), torch.tensor([2, 3, 4]))
    (words,), cnt = merge_pair_streams([((e,), e), s, ((e,), e)])
    assert words.tolist() == [1, 5, 9] and cnt.tolist() == [2, 3, 4]
    rows, pre, part_rows, maxc, npres = table_compact(
        (e, e), e, layout="k3", nsamp=3, hard_min=1, nb_parts=4)
    assert rows.shape == (0, 2) and pre.shape == (0, 3)
    assert part_rows.tolist() == [0] * 4 and (maxc, npres) == (0, 0)


def test_run_sum_bounded_is_a_saturating_chain():
    """The int64 segment sum, clamped, against a loop of saturating adds,
    with two-word keys and runs that cross the u32 limit."""
    rng = np.random.default_rng(5)
    n = 3000
    hi = np.sort(rng.integers(0, 40, n))
    lo = rng.integers(0, 3, n)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    cnt = rng.integers(1, 1 << 31, n)
    start, total = run_sum_bounded(
        (torch.from_numpy(hi), torch.from_numpy(lo)), torch.from_numpy(cnt))
    exp_start = np.ones(n, bool)
    exp_start[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    exp = np.zeros(n, np.int64)
    for i in np.flatnonzero(exp_start):
        acc, j = 0, i
        while j < n and (j == i or not exp_start[j]):
            acc = min(acc + int(cnt[j]), U32_MAX)
            j += 1
        exp[i] = acc
    np.testing.assert_array_equal(start.numpy(), exp_start)
    np.testing.assert_array_equal(total.numpy(), exp)
    assert total.max() == U32_MAX


def test_phase_b_delivers_u32_counts():
    """Table counts at and above 2^31 reach the host as u32 through phase
    B: the int32 bit pattern of ``pre``, read with ``.view(np.uint32)``."""
    cnt = torch.tensor([1, 2**31, 2**32 - 1, 7], dtype=torch.int64)
    part = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    key = torch.tensor([3, 3, 9, 9], dtype=torch.int64)
    samp = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    ws = CM.pack_words("k3", part, key, samp, None, 2)
    rows, pre, part_rows, maxc, npres = table_compact(
        ws, cnt, layout="k3", nsamp=2, hard_min=1, nb_parts=2)
    assert rows.tolist() == [[3, 0], [9, 1]] and part_rows.tolist() == [1, 1]
    assert (maxc, npres) == (2**32 - 1, 4)
    assert pre.numpy().view(np.uint32).tolist() == [[1, 2**31],
                                                    [2**32 - 1, 7]]
    with pytest.raises(ValueError):
        compact_count_rows(part, key, samp, cnt + 2**32,
                           torch.ones(4, dtype=torch.bool),
                           torch.tensor([True, False, True, False]), nsamp=2)


def jax_chunk_runs(chunks, k, m, nsamp, nparts, table, mesh):
    step = jpipe.build_chunk_pairs_step(
        mesh, k=k, m=m, nb_parts=nparts, cap=1 << 16, nsamp=nsamp,
        batch_layout="lb", pair_cap=1 << 14)
    runs = []
    for b, ln, sa in chunks:
        pw, pc, npairs, _dropped = step(np.ascontiguousarray(b.T), ln, sa,
                                        table)
        runs.append((pw, pc, int(np.asarray(npairs)[0])))
    return runs


@pytest.mark.parametrize("k,hard_min", [(31, 2), (21, 1)])
def test_engine_steps_match_jax(k, hard_min):
    """Chunk pair runs, then phase A (merge + collapse) and phase B
    (presence + compaction) over three chunks, against the JAX engine's
    programs on a one-device mesh: the same pairs per chunk and the same
    rows and counts, decoded."""
    nsamp, m, nparts = 4, 8, 4
    batch, lengths, samp, table, _amin = synthetic_batch(
        k + 7, nsamp, B=48, m=m, nparts=nparts)
    chunks = [(batch[i:i + 16], lengths[i:i + 16], samp[i:i + 16])
              for i in range(0, 48, 16)]
    mesh = jpipe.make_mesh(1)
    layout_j = jpipe.stream_layout(k, m, nparts, nsamp, "kmer", None)
    layout = CM.stream_layout(k, nparts, nsamp)
    assert layout[:2] == layout_j[:2]
    jruns = jax_chunk_runs(chunks, k, m, nsamp, nparts, table, mesh)

    step = build_chunk_pairs_step((torch.device("cpu"),), k=k, m=m,
                                  nsamp=nsamp, nb_parts=nparts)
    runs = []
    for (b, ln, sa), (pw, pc, npairs) in zip(chunks, jruns):
        tb, tl, ts, tt, _, _ = from_jax_inputs(b, ln, sa, table, None, None,
                                               "cpu")
        (ws, cnt), = step(tb, tl, ts, tt)
        runs.append((ws, cnt))
        assert cnt.shape[0] == npairs
        jp, jk, js, _v, _o, _kd = jcm.unpack_sorted(
            layout_j, tuple(w[:npairs] for w in pw), nsamp, 2 * k, None)
        p_, k_, s_, _v, _o, _kd = CM.unpack_sorted(layout, ws, nsamp, npairs)
        np.testing.assert_array_equal(p_.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(k_.numpy(),
                                      keys_from_msb_words(*jk).numpy())
        np.testing.assert_array_equal(s_.numpy(), np.asarray(js))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(pc)[:npairs])

    nw = len(jruns[0][0])
    phase_a = jpipe.build_table_sort_collapse(
        mesh, layout=layout_j, nsamp=nsamp, hard_min=hard_min,
        n_runs=len(jruns), key_bits=2 * k, nb_parts=nparts)
    ws_j, cnt_j, _nr, _mx, phist = phase_a(
        *[x for pw, pc, _n in jruns for x in list(pw) + [pc]])
    assert len(ws_j) == nw
    phase_b = jpipe.build_table_compact(
        mesh, layout=layout_j, nsamp=nsamp, key_bits=2 * k,
        window_bits=None, hard_min=hard_min, rows_cap=1 << 14, mode="kmer")
    rows_j, pre_j, nrows_j, maxc_j, npres_j = phase_b(*ws_j, cnt_j)
    nrows_j = int(np.asarray(nrows_j)[0])

    ws, cnt = table_sort_collapse(runs)
    # collapsed duplicates: the JAX table's count-0 shadows
    assert cnt.shape[0] == int((np.asarray(cnt_j) > 0).sum())
    rows, pre, part_rows, maxc, npres = table_compact(
        ws, cnt, layout=layout, nsamp=nsamp, hard_min=hard_min,
        nb_parts=nparts)
    assert rows.shape[0] == nrows_j > 100
    assert (maxc, npres) == (int(maxc_j), int(np.asarray(npres_j)[0]))
    rows_j = np.asarray(rows_j)[:nrows_j]
    np.testing.assert_array_equal(
        rows[:, 0].numpy(),
        keys_from_msb_words(rows_j[:, 0], rows_j[:, 1]).numpy())
    np.testing.assert_array_equal(rows[:, 1].numpy(), rows_j[:, 2])
    np.testing.assert_array_equal(pre.numpy().view(np.uint32),
                                  np.asarray(pre_j)[:nrows_j])
    np.testing.assert_array_equal(part_rows.numpy(),
                                  np.asarray(phist).reshape(-1))
