"""The control of the comparison: the reference put in the program's place
with one stated guarantee broken.

    python -m kmbench.control --workload <cell> --seeds <a,b,...>

For each seed it writes the cell's collection, works out the outputs that
the cell's reference (:func:`kmbench.cells.reference`) gives with its
``control_options`` (for :mod:`kmbench.reference`, ``--hard-min 1`` where
the configurations state 2, so k-mers seen once in a sample would pass) and
its own greedy repartition table, and judges them with the same comparison
a run's files get. One number must come out above its limit of 0; the
readings are printed one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import torch

from kmbench import cells
from kmbench.reference.kmers import lpt_table
from kmbench.run import make_bank


def control_checks(cell: dict, manifest: dict, device) -> dict:
    """The numbers compared when the cell's reference with its control
    options stands in for the program."""
    ref = cells.reference(cell)
    opts, coll = ref.setup(cells.pipeline_args(cell), manifest["samples"],
                           device)
    nb = coll.nb_partitions(opts["max_memory"])
    table = lpt_table(coll.tally(), nb)
    files = ref.serialize(ref.expected_outputs(coll, table, nb,
                                               ref.control_options(opts)),
                          table, nb, len(coll.paths))
    return ref.judge(files.get, coll, opts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kmbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    work = os.path.join(tempfile.gettempdir(), "kmbench_control")
    for seed in (int(s) for s in args.seeds.split(",")):
        shutil.rmtree(work, ignore_errors=True)
        manifest = make_bank(cell, seed, work)
        t = time.perf_counter()
        checks = control_checks(cell, manifest, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": checks,
                          "seconds": time.perf_counter() - t}), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
