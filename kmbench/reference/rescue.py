"""Reference of a count matrix with low-abundance rescue: kmtricks'
``--soft-min``, ``--share-min`` and ``--recurrence-min`` at the merge.

kmtricks merges the samples' sorted count tables one k-mer at a time
(``include/kmtricks/merge.hpp``, ``KmerMerger::next()``, lines 183-260;
the rescue at 234-247). A k-mer reaches the merge in each sample where
its count is at least the hard-min (the count stage dropped the others).
For that k-mer:

- each sample whose count is at least the soft-min is solid: it adds one
  to the k-mer's ``solid_in``;
- each other sample where it is present is held back for a check, and
  once every sample is read, a held-back count is kept (rescued) when
  ``--share-min`` is above 0 and ``solid_in`` is at least ``--share-min``,
  and set to 0 otherwise;
- the row is written when ``solid_in`` is at least ``--recurrence-min``.

Every k-mer, written or not, adds to its samples' statistics: NON_SOLID
(held back), RESCUED, UNIQUE_WO_RESCUE and TOTAL_WO_RESCUE (solid
samples and their counts), UNIQUE_W_RESCUE and TOTAL_W_RESCUE (solid or
rescued samples and their counts), written per partition to
``merge_infos/partition<P>.merge_info`` (merge.hpp:49-100).

The matrix is worked out one partition at a time, so the host holds one
partition's (rows, samples) block. Counting, repartition and the file
layouts are :mod:`kmbench.reference`'s; this module imports nothing of
the program.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from kmbench import reference as base
from kmbench.reference import layout
from kmbench.reference.kmers import Collection, lpt_table

# pipeline options this reference models, at kmtricks' defaults
MODELLED = {"--kmer-size": "31", "--minimizer-size": "10", "--hard-min": "2",
            "--soft-min": "1", "--share-min": "0", "--recurrence-min": "1",
            "--mode": "kmer:count:bin", "--max-memory": "8192"}
# options it takes at one value only (the default reference's, but for
# the three it models here)
FIXED = {n: v for n, v in base.FIXED.items() if n not in MODELLED}
INTEGER = ("--kmer-size", "--minimizer-size", "--hard-min", "--soft-min",
           "--share-min", "--recurrence-min", "--max-memory")
# the statistics' lines of a merge_info file, in order
STATS = ("NON_SOLID", "RESCUED", "UNIQUE_WO_RESCUE", "UNIQUE_W_RESCUE",
         "TOTAL_WO_RESCUE", "TOTAL_W_RESCUE")

read_file = base.read_file
serialize = base.serialize


def options(args: list[str]) -> dict:
    """The reference's reading of a run's ``pipeline`` options. Raises
    ``ValueError`` on an option it does not model, on one it takes at one
    value given another, and on a threshold that is not a whole number (a
    float ``--soft-min`` is a quantile of each sample's histogram, and a
    file names per-sample values: neither is modelled)."""
    if len(args) % 2:
        raise ValueError(f"options not in pairs: {args}")
    given = dict(MODELLED)
    for name, value in zip(args[0::2], args[1::2]):
        if name in MODELLED:
            given[name] = value
        elif name in FIXED:
            if value != FIXED[name]:
                raise ValueError(f"the reference assumes {name} "
                                 f"{FIXED[name]}, not {value}")
        elif name not in base.NEUTRAL:
            raise ValueError(f"the reference does not model {name}")
    for name in INTEGER:
        if not re.fullmatch(r"[0-9]+", given[name]):
            raise ValueError(f"the reference models a whole number for "
                             f"{name}, not {given[name]}")
    if given["--mode"] != "kmer:count:bin":
        raise ValueError(f"the reference models --mode kmer:count:bin, "
                         f"not {given['--mode']}")
    k, m = int(given["--kmer-size"]), int(given["--minimizer-size"])
    if not 0 < m < k <= 31:
        raise ValueError(f"the reference models 0 < m < k <= 31, not "
                         f"k {k}, m {m}")
    return {"mode": given["--mode"], "k": k, "m": m,
            "hard_min": int(given["--hard-min"]),
            "soft_min": int(given["--soft-min"]),
            "share_min": int(given["--share-min"]),
            "recurrence_min": int(given["--recurrence-min"]),
            "max_memory": int(given["--max-memory"])}


def setup(args: list[str], samples: list[dict], device):
    """(options, :class:`Collection`) of a run of ``pipeline`` with
    ``args`` over the collection's ``samples``."""
    opts = options(args)
    return opts, Collection([(s["id"], s["path"]) for s in samples],
                            opts["k"], opts["m"], device)


def control_options(opts: dict) -> dict:
    """The options of the control: the rescue turned off (``--share-min``
    0), so counts under the soft-min are zeroed in every row. (The stated
    hard-min is already 1, so the default reference's control, which
    lowers it, breaks nothing here.)"""
    return dict(opts, share_min=0)


def merge(mat: torch.Tensor, opts: dict):
    """merge.hpp's ``next()`` over the rows of ``mat`` (k-mers x samples,
    each count at least the hard-min, 0 where absent): (final counts, kept
    rows, (6, samples) statistics in :data:`STATS` order)."""
    present = mat > 0
    solid = present & (mat >= opts["soft_min"])
    solid_in = solid.sum(dim=1)
    held = present & ~solid
    if opts["share_min"] > 0:
        rescued = held & (solid_in >= opts["share_min"])[:, None]
    else:
        rescued = torch.zeros_like(held)
    written = solid | rescued
    final = torch.where(written, mat, 0)
    stats = torch.stack([held.sum(0), rescued.sum(0), solid.sum(0),
                         written.sum(0), torch.where(solid, mat, 0).sum(0),
                         final.sum(0)])
    return final, solid_in >= opts["recurrence_min"], stats


def merge_info_bytes(stats: np.ndarray) -> np.ndarray:
    """A merge_info file: per statistic its name, then each sample's value,
    each followed by a tab, and a newline (kmtricks' ``write_vector``)."""
    text = "".join(name + "\t" + "".join(f"{int(v)}\t" for v in row) + "\n"
                   for name, row in zip(STATS, stats.tolist()))
    return np.frombuffer(text.encode(), dtype=np.uint8)


def partition_outputs(coll: Collection, table: np.ndarray,
                      nb_partitions: int, opts: dict):
    """Per partition, relative path -> what the run directory must hold:
    the matrix's (header, sorted kept keys, their final counts) and the
    merge_info file's bytes; one partition at a time."""
    t = torch.from_numpy(table.astype(np.int64)).to(coll.device)
    nsamp, least = len(coll.paths), max(opts["hard_min"], 1)
    samples = []
    for path in coll.paths:
        keys, counts = coll.sample_counts(path)
        reached = counts >= least
        keys = keys[reached]
        samples.append((keys, counts[reached].clamp(max=base.U32_MAX),
                        coll.partitions(keys, t)))
    for p in range(nb_partitions):
        keys, cols, cnts = [], [], []
        for s, (k, c, part) in enumerate(samples):
            sel = part == p
            keys.append(k[sel])
            cnts.append(c[sel])
            cols.append(torch.full_like(keys[-1], s))
        uk, inv = torch.unique(torch.cat(keys), return_inverse=True)
        mat = torch.zeros((uk.shape[0], nsamp), dtype=torch.int64,
                          device=uk.device)
        mat[inv, torch.cat(cols)] = torch.cat(cnts)
        del keys, cols, cnts, inv
        final, keep, stats = merge(mat, opts)
        del mat
        yield {f"matrices/matrix_{p}.count": (
                   layout.matrix_header(coll.k, nsamp, p),
                   uk[keep].cpu().numpy(), final[keep].cpu().numpy()),
               f"merge_infos/partition{p}.merge_info":
                   merge_info_bytes(stats.cpu().numpy())}


def expected_outputs(coll: Collection, table: np.ndarray,
                     nb_partitions: int, opts: dict) -> dict:
    """Every partition's :func:`partition_outputs` in one dict."""
    out = {}
    for files in partition_outputs(coll, table, nb_partitions, opts):
        out.update(files)
    return out


def judge_partition(read, expected: dict, nsamp: int) -> dict:
    """``rows_bad`` (matrix rows that differ, plus header bytes) and
    ``merge_info_bad`` (bytes that differ, plus the difference in length)
    of one partition's files."""
    out = {"rows_bad": 0, "merge_info_bad": 0}
    for rel, exp in expected.items():
        raw = read(rel)
        if rel.endswith(".count"):
            header, ek, ec = exp
            hbad, ak, ac = base.parse_matrix(raw, header, nsamp)
            out["rows_bad"] += hbad + base.rows_differing(
                ek, ec.astype(np.int64), ak, ac.astype(np.int64))
        elif raw is None:
            out["merge_info_bad"] += len(exp)
        else:
            n = min(len(raw), len(exp))
            out["merge_info_bad"] += int((raw[:n] != exp[:n]).sum()) + abs(
                len(raw) - len(exp))
    return out


def judge(read, coll: Collection, opts: dict) -> dict:
    """Every comparison of one run directory (through ``read``) against
    the reference: ``repart_bad``, ``rows_bad``, ``merge_info_bad``
    (limit 0 each)."""
    nb = coll.nb_partitions(opts["max_memory"])
    bins = coll.tally()
    repart_bad, table = base.judge_repart(read, bins, nb)
    if table is None:
        table = lpt_table(bins, nb)
    checks = {"repart_bad": repart_bad, "rows_bad": 0, "merge_info_bad": 0}
    for files in partition_outputs(coll, table, nb, opts):
        for name, bad in judge_partition(read, files,
                                         len(coll.paths)).items():
            checks[name] += bad
    return checks
