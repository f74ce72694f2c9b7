"""Worker for the port's multi-process engine tests (run as a subprocess).

Usage: python torch_multihost_stream_worker.py <rank> <world> <port> <fof>
           <rundir> <mode> <soft_min> <hist> <table_cap>

Each rank holds a mesh of 4 CPU shards of a global mesh of 4 x world
(``torch.distributed`` with gloo over localhost) and runs the streaming
engine (``stage_mesh_stream``, chunks decoded from the banks, a table
budget of ``table_cap`` entries a shard) against a shared run directory:
rank 0 runs config + repartition, the others load them after a barrier
(the module commands' re-runnability contract), then every rank runs the
engine, decoding only its own samples, and writes the partitions its
shards own. Each rank records its ``stream_engine.last_run`` in
``<rundir>/last_run_<rank>.json``. Imports nothing of JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

LOCAL_SHARDS = 4
CHUNK_WINDOWS = 3000


def main():
    rank, world, port, fof, rundir, mode, soft_min, hist, table_cap = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6], sys.argv[7], sys.argv[8] == "1",
        int(sys.argv[9]))
    import torch
    import torch.distributed

    from kmtricks_tpu_torch.core.repartition import Repartition
    from kmtricks_tpu_torch.parallel import multihost as mh
    from kmtricks_tpu_torch.runtime import stream_engine
    from kmtricks_tpu_torch.runtime.config import Config
    from kmtricks_tpu_torch.runtime.device_pipeline import _is_float_quantile
    from kmtricks_tpu_torch.runtime.kmdir import KmDir
    from kmtricks_tpu_torch.runtime.pipeline import (
        PipelineOptions, resolve_soft_min, stage_config, stage_repart)

    torch.set_num_threads(1)
    mh.initialize(f"tcp://localhost:{port}", world, rank, "gloo",
                  timeout_s=120)
    mesh = mh.global_mesh(["cpu"] * LOCAL_SHARDS)
    opts = PipelineOptions(
        fof=fof, run_dir=rundir, kmer_size=31, hard_min=1,
        soft_min=soft_min, share_min=2, mode=mode, static_repart=True,
        nb_partitions=8, backend="mesh", max_memory_mb=64,
        hist=hist or _is_float_quantile(soft_min), threads=2)
    if rank == 0:
        kmdir, config = stage_config(opts)
        repart = stage_repart(kmdir, config, opts, "cpu")
    mh.barrier(mesh)
    if rank != 0:
        kmdir = KmDir.init(rundir)
        config = Config.load(kmdir.config_storage)
        repart = Repartition.load(kmdir.repart_path)
    amin = None
    if not _is_float_quantile(soft_min):
        amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    stream_engine.stage_mesh_stream(
        kmdir, config, opts, repart, amin, mesh=mesh,
        chunk_windows=CHUNK_WINDOWS, table_cap=table_cap, use_stream=True)
    with open(os.path.join(rundir, f"last_run_{rank}.json"), "w") as f:
        json.dump(stream_engine.last_run, f)
    torch.distributed.destroy_process_group()
    print("rank", rank, "done", flush=True)


if __name__ == "__main__":
    main()
