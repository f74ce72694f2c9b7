"""The comparison that decides a run's ``correct``.

:func:`expected_outputs` works out, from the sequence files alone (see
:mod:`kmbench.reference.kmers`), what a run directory must hold; the
``judge_*`` functions read what the program wrote and count every
difference. Each count's limit is 0.

This module is the reference of every configuration that names none. A
configuration that names another (its ``"reference"`` key, a module inside
this package; see :func:`kmbench.cells.reference`) gets that module's
:data:`INTERFACE` functions in place of these, and may import and reuse
this module, :mod:`~kmbench.reference.kmers` and
:mod:`~kmbench.reference.layout`.

The repartition table is the one thing the reference cannot rebuild byte
for byte: kmtricks sorts the sampled bins with an unstable sort and draws
partitions from a heap, so bins of equal size may land on any of several
partitions. The reference therefore tallies the bins itself and checks
that the program's table is one of the greedy placements of them
(:func:`~kmbench.reference.kmers.lpt_violations`); the checked table
then routes the reference's own k-mers.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from kmbench.reference import layout
from kmbench.reference.kmers import Collection, lpt_table, lpt_violations

# what the harness calls of a reference module: the options check before
# any work, the reading and judging of a run directory, and for the control
# the options with one stated guarantee broken, the outputs they give and
# their bytes
INTERFACE = ("options", "setup", "read_file", "judge", "control_options",
             "expected_outputs", "serialize")
U32_MAX = (1 << 32) - 1
REPART = "repartition/repartition.minimRepart"


# pipeline options the reference models, at the port's defaults
MODELLED = {"--kmer-size": "31", "--minimizer-size": "10", "--hard-min": "2",
            "--mode": "kmer:count:bin", "--bloom-size": "10000000",
            "--max-memory": "8192"}
MODES = ("kmer:count:bin", "hash:bft:bin")
# options the reference takes at one value only (kmtricks' defaults)
FIXED = {"--soft-min": "1", "--share-min": "0", "--recurrence-min": "1",
         "--minimizer-type": "0", "--repartition-type": "0",
         "--nb-partitions": "0", "--bitw": "2", "--mmer-scheme": "canonical",
         "--bf-format": "howdesbt"}
# options that change how the program runs, not what it writes
NEUTRAL = ("--threads", "--backend", "--verbose")


def options(args: list[str]) -> dict:
    """The reference's reading of a run's ``pipeline`` options (each an
    option and its value). Raises ``ValueError`` on an option it does not
    model, or one it takes at another value than the one it assumes, so
    that a configuration it cannot judge fails instead of being judged
    wrongly."""
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
        elif name not in NEUTRAL:
            raise ValueError(f"the reference does not model {name}")
    k, m = int(given["--kmer-size"]), int(given["--minimizer-size"])
    if given["--mode"] not in MODES:
        raise ValueError(f"the reference does not model --mode "
                         f"{given['--mode']}")
    if not 0 < m < k <= 31:
        raise ValueError(f"the reference models 0 < m < k <= 31, not "
                         f"k {k}, m {m}")
    return {"mode": given["--mode"], "k": k, "m": m,
            "hard_min": int(given["--hard-min"]),
            "bloom_size": int(given["--bloom-size"]),
            "max_memory": int(given["--max-memory"])}


def setup(args: list[str], samples: list[dict], device):
    """(options, :class:`Collection`) of a run of ``pipeline`` with
    ``args`` over the collection's ``samples`` (each with ``id`` and
    ``path``)."""
    opts = options(args)
    return opts, Collection([(s["id"], s["path"]) for s in samples],
                            opts["k"], opts["m"], device)


def control_options(opts: dict) -> dict:
    """The options of the control: the stated ``--hard-min`` (2 in every
    configuration of this reference) broken to 1, so that k-mers seen once
    in a sample pass."""
    return dict(opts, hard_min=1)


def read_file(root: str):
    """A reader of a run directory's files: relative path -> uint8 array,
    or None where the file is missing."""
    def read(rel: str):
        path = os.path.join(root, rel)
        return np.fromfile(path, dtype=np.uint8) if os.path.exists(path) \
            else None
    return read


def judge_repart(read, bins: np.ndarray, nb_partitions: int):
    """(differences, the table as written): header or trailer bytes that
    differ, plus the bin sizes the table does not place greedily."""
    raw = read(REPART)
    n = len(bins)
    head, tail = layout.repart_bytes(np.zeros(n, np.uint16), nb_partitions)
    if raw is None or len(raw) != len(head) + 2 * n + len(tail):
        return max(1, n), None
    bad = int((raw[:len(head)] != np.frombuffer(head, np.uint8)).sum())
    bad += int((raw[-len(tail):] != np.frombuffer(tail, np.uint8)).sum())
    table = raw[len(head):len(head) + 2 * n].view("<u2").astype(np.uint16)
    return bad + lpt_violations(bins, table, nb_partitions), table


def count_matrix(coll: Collection, table: torch.Tensor, hard_min: int):
    """The merged count matrix: sorted distinct canonical k-mers solid
    (count >= hard_min) in at least one sample, their per-sample counts
    (0 where absent or under the hard-min) and partitions."""
    keys, samp, cnts = [], [], []
    for s, path in enumerate(coll.paths):
        k, c = coll.sample_counts(path)
        solid = c >= hard_min
        keys.append(k[solid])
        cnts.append(c[solid].clamp(max=U32_MAX))
        samp.append(torch.full_like(keys[-1], s))
    uk, inv = torch.unique(torch.cat(keys), return_inverse=True)
    mat = torch.zeros((uk.shape[0], len(coll.paths)), dtype=torch.int64,
                      device=uk.device)
    mat[inv, torch.cat(samp)] = torch.cat(cnts)
    return uk, mat, coll.partitions(uk, table)


def sample_hashes(coll: Collection, table: torch.Tensor, hard_min: int,
                  window: int) -> list[torch.Tensor]:
    """Each sample's solid window hashes (hash count >= hard_min)."""
    out = []
    for path in coll.paths:
        keys, counts = coll.sample_counts(path)
        h, c = coll.hash_counts(keys, counts, table, window)
        out.append(h[c >= hard_min])
    return out


def bloom_bytes(hashes: torch.Tensor, nbits: int) -> np.ndarray:
    """LSB-first bit bytes with bit h set for each (distinct) hash h."""
    out = torch.zeros(nbits // 8, dtype=torch.int32, device=hashes.device)
    out.index_add_(0, hashes >> 3,
                   torch.ones_like(hashes, dtype=torch.int32)
                   << (hashes & 7).to(torch.int32))
    return out.to(torch.uint8).cpu().numpy()


def expected_outputs(coll: Collection, table: np.ndarray,
                     nb_partitions: int, opts: dict) -> dict:
    """Relative path -> what the run directory must hold: for count mode
    (sorted keys, counts) per partition matrix and its header; for hash
    bft the bytes of each partition's transposed window file and each
    sample's HowDe-SBT filter."""
    t = torch.from_numpy(table.astype(np.int64)).to(coll.device)
    k, nsamp = coll.k, len(coll.paths)
    out = {}
    if opts["mode"] == "kmer:count:bin":
        uk, mat, part = count_matrix(coll, t, opts["hard_min"])
        for p in range(nb_partitions):
            sel = part == p
            out[f"matrices/matrix_{p}.count"] = (
                layout.matrix_header(k, nsamp, p),
                uk[sel].cpu().numpy(), mat[sel].cpu().numpy())
        return out
    if opts["mode"] != "hash:bft:bin":
        raise ValueError(f"no reference for --mode {opts['mode']}")
    w = layout.window_bits(opts["bloom_size"], nb_partitions)
    bits = [bloom_bytes(h, w * nb_partitions)
            for h in sample_hashes(coll, t, opts["hard_min"], w)]
    rows = ((nsamp + 7) // 8) * 8
    wb = w // 8
    for p in range(nb_partitions):
        payload = np.zeros((rows, wb), dtype=np.uint8)
        for s in range(nsamp):
            payload[s] = bits[s][p * wb:(p + 1) * wb]
        out[f"matrices/matrix_{p}.cmbf"] = np.concatenate([
            np.frombuffer(layout.bitmatrix_header(nsamp, p, p * w, w),
                          np.uint8), payload.ravel()])
    for s, sid in enumerate(coll.ids):
        out[f"filters/{sid}.bf"] = np.concatenate([
            np.frombuffer(layout.bf_header(w * nb_partitions, k), np.uint8),
            np.frombuffer(struct.pack("<Q", w * nb_partitions), np.uint8),
            bits[s]])
    return out


def rows_differing(exp_keys, exp_counts, act_keys, act_counts) -> int:
    """Rows of either matrix that the other does not hold identically
    (key and every count)."""
    if len(act_keys) and (np.diff(act_keys.astype(np.int64)) <= 0).any():
        dup = int((np.diff(act_keys.astype(np.int64)) <= 0).sum())
        act_keys, idx = np.unique(act_keys, return_index=True)
        act_counts = act_counts[idx]
    else:
        dup = 0
    if not len(exp_keys) or not len(act_keys):
        return len(exp_keys) + len(act_keys) + dup
    ek = exp_keys.astype(np.uint64)
    ak = act_keys.astype(np.uint64)
    pos = np.minimum(np.searchsorted(ek, ak), len(ek) - 1)
    same = (ek[pos] == ak) & (exp_counts[pos] == act_counts).all(axis=1)
    matched = int(same.sum())
    return len(ek) + len(ak) - 2 * matched + dup


def parse_matrix(raw: np.ndarray, header: bytes, nsamp: int):
    """(header bytes that differ, keys, counts) of a count matrix file."""
    hb = np.frombuffer(header, np.uint8)
    if raw is None or len(raw) < len(hb):
        return max(1, len(hb)), np.zeros(0, np.uint64), np.zeros(
            (0, nsamp), np.uint32)
    bad = int((raw[:len(hb)] != hb).sum())
    rec = np.dtype([("k", "<u8"), ("c", "<u4", (nsamp,))])
    body = raw[len(hb):]
    whole = len(body) // rec.itemsize
    bad += int(len(body) != whole * rec.itemsize)
    r = body[:whole * rec.itemsize].view(rec)
    return bad, r["k"], r["c"]


def judge_outputs(read, expected: dict, nsamp: int) -> dict:
    """Count the differences between the expected outputs and the files
    ``read`` returns: ``rows_bad`` (matrix rows plus header bytes) in
    count mode; ``bloom_bytes_bad`` and ``filter_bytes_bad`` in bft mode."""
    out = {}
    for rel, exp in expected.items():
        raw = read(rel)
        if rel.endswith(".count"):
            header, ek, ec = exp
            hbad, ak, ac = parse_matrix(raw, header, nsamp)
            out["rows_bad"] = out.get("rows_bad", 0) + hbad + \
                rows_differing(ek, ec.astype(np.int64), ak,
                               ac.astype(np.int64))
            continue
        name = "bloom_bytes_bad" if rel.endswith(".cmbf") else \
            "filter_bytes_bad"
        if raw is None:
            bad = len(exp)
        else:
            n = min(len(raw), len(exp))
            bad = int((raw[:n] != exp[:n]).sum()) + abs(len(raw) - len(exp))
        out[name] = out.get(name, 0) + bad
    return out


def serialize(expected: dict, table: np.ndarray, nb_partitions: int,
              nsamp: int) -> dict:
    """Expected outputs as the file bytes a run would write (for putting
    the reference in the program's place)."""
    files = {}
    head, tail = layout.repart_bytes(table, nb_partitions)
    files[REPART] = np.frombuffer(
        head + table.astype("<u2").tobytes() + tail, np.uint8)
    rec = np.dtype([("k", "<u8"), ("c", "<u4", (nsamp,))])
    for rel, exp in expected.items():
        if rel.endswith(".count"):
            header, keys, counts = exp
            r = np.zeros(len(keys), rec)
            r["k"], r["c"] = keys, counts
            files[rel] = np.concatenate([np.frombuffer(header, np.uint8),
                                         r.view(np.uint8)])
        else:
            files[rel] = exp
    return files


def judge(read, coll: Collection, opts: dict) -> dict:
    """Every comparison of one run directory (through ``read``) against
    the reference. Returns each number compared (limit 0)."""
    nb = coll.nb_partitions(opts["max_memory"])
    bins = coll.tally()
    repart_bad, table = judge_repart(read, bins, nb)
    checks = {"repart_bad": repart_bad}
    if table is None:
        table = lpt_table(bins, nb)
    expected = expected_outputs(coll, table, nb, opts)
    checks.update(judge_outputs(read, expected, len(coll.paths)))
    return checks
