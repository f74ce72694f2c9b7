"""Worker for the port's multi-process step tests (run as a subprocess).

Usage: python torch_multihost_worker.py <rank> <world> <port> <outdir>

Each rank holds a mesh of 4 CPU shards of a global mesh of 4 x world
(``torch.distributed`` with gloo over localhost), feeds its rows of the
global batch (``multihost.host_shard_bounds``), runs the fused sharded
step once per case of :data:`CASES` and saves its shards' compacted rows
under their global shard index to ``<outdir>/<case>_rank<rank>.npz``.
Imports nothing of JAX: the test builds the reference from the same
:func:`inputs`.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

LOCAL_SHARDS = 4
M, NSAMP, B, L = 10, 4, 64, 160
# case -> step parameters: tests/multihost_worker.py's step (k3 layout,
# --static-repart over 16 partitions, soft-min 2, reads a fifth 'N'), and
# on reads without 'N' at soft-min 1 (a row for every k-mer) a k2 layout
# and the generic (unpacked) route of 62-bit window hashes
CASES = {
    "k3_static": dict(k=31, nb_parts=16, mode="kmer", window_bits=None,
                      static=True, amin=2, bases=b"ACGTN"),
    "k2": dict(k=21, nb_parts=8, mode="kmer", window_bits=None,
               static=False, amin=1, bases=b"ACGT"),
    "generic": dict(k=31, nb_parts=8, mode="hash", window_bits=2**59,
                    static=False, amin=1, bases=b"ACGT"),
}


def inputs(case):
    """(batch, lengths, samp, repart table, soft-mins) of a case, numpy:
    tests/multihost_worker.py's reads (seed 11) over the case's bases."""
    c = CASES[case]
    k, nb_parts = c["k"], c["nb_parts"]
    rng = np.random.default_rng(11)
    genome = rng.choice(np.frombuffer(c["bases"], dtype=np.uint8),
                        size=B * L // 4)
    starts = rng.integers(0, len(genome) - L, B)
    batch = genome[starts[:, None] + np.arange(L)]
    lengths = rng.integers(k, L + 1, B).astype(np.int32)
    samp = (np.arange(B, dtype=np.int32) * NSAMP) // B
    table = (np.arange(4 ** M, dtype=np.int64) * 7919 % nb_parts).astype(
        np.int32)
    return batch, lengths, samp, table, np.full(NSAMP, c["amin"], np.uint32)


def step_kw(case):
    """The parameters both packages' steps take."""
    c = CASES[case]
    return dict(k=c["k"], m=M, nb_parts=c["nb_parts"], nsamp=NSAMP,
                hard_min=1, rmin=1, save_if=1, mode=c["mode"],
                window_bits=c["window_bits"])


def main():
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])
    import torch
    import torch.distributed

    from kmtricks_tpu_torch.convert import from_jax_inputs
    from kmtricks_tpu_torch.parallel import multihost as mh
    from kmtricks_tpu_torch.parallel.pipeline import build_sharded_pipeline

    torch.set_num_threads(1)
    mh.initialize(f"tcp://localhost:{port}", world, rank, "gloo",
                  timeout_s=120)
    mesh = mh.global_mesh(["cpu"] * LOCAL_SHARDS)
    lo, hi = mh.host_shard_bounds(B, mesh)
    for case, c in CASES.items():
        batch, lengths, samp, table, amin = inputs(case)
        args = from_jax_inputs(batch[lo:hi], lengths[lo:hi], samp[lo:hi],
                               table, amin, None, "cpu")
        step = build_sharded_pipeline(
            mesh, static_parts=c["nb_parts"] if c["static"] else None,
            **step_kw(case))
        out = {}
        for d, (rows, pre, nrows, _maxc, npres) in enumerate(
                step(*args[:5])):
            g = rank * LOCAL_SHARDS + d
            out[f"rows_{g}"] = rows.numpy()
            out[f"pre_{g}"] = pre.numpy()
            out[f"n_{g}"] = np.array([nrows, npres])
        np.savez(os.path.join(outdir, f"{case}_rank{rank}.npz"), **out)
    mh.barrier(mesh)
    torch.distributed.destroy_process_group()
    print("rank", rank, "done", flush=True)


if __name__ == "__main__":
    main()
