"""Run directory layout — the on-disk "distributed state".

Copy of ``kmtricks_tpu/runtime/kmdir.py``; ``KmDir.init(first=True)``
writes the port's own build_infos.txt.

Byte-compatible with the reference's KmDir (include/kmtricks/kmdir.hpp:34-286):
the run directory is the only communication backend between independently
launched modules (repart/superk/count/merge/...), locally or across machines
over a shared filesystem. Path templates match exactly so artifacts are
interchangeable with reference tooling.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from kmtricks_tpu_torch.io.fof import Fof

_SUBDIRS = ("superkmers", "counts", "matrices", "filters", "histograms",
            "merge_infos", "howde_index", "partition_infos", "fpr",
            "plugin_output")

# extension tables (kmdir.hpp:49-115)
_COUNT_EXT = {"kmer": "kmer", "hash": "hash", "vector": "vector", "kff": "kff"}
_COUNT_CPR = {"kmer": ".lz4", "hash": ".p4", "vector": ".lz4", "kff": ""}
_MATRIX_EXT = {("count", "kmer"): "count", ("count", "hash"): "count_hash",
               ("pa", "kmer"): "pa", ("pa", "hash"): "pa_hash",
               ("bf", "hash"): "cmbf", ("bfc", "hash"): "cmbf",
               ("bft", "hash"): "cmbf"}


@dataclass
class KmDir:
    root: str
    fof: Fof | None = field(default=None)

    def __post_init__(self):
        self.root = os.path.abspath(self.root)

    # -- paths ---------------------------------------------------------------

    @property
    def fof_path(self): return f"{self.root}/kmtricks.fof"
    @property
    def config_storage(self): return f"{self.root}/config"
    @property
    def repart_storage(self): return f"{self.root}/repartition"
    @property
    def superk_storage(self): return f"{self.root}/superkmers"
    @property
    def counts_storage(self): return f"{self.root}/counts"
    @property
    def matrix_storage(self): return f"{self.root}/matrices"
    @property
    def filter_storage(self): return f"{self.root}/filters"
    @property
    def hist_storage(self): return f"{self.root}/histograms"
    @property
    def stat_storage(self): return f"{self.root}/merge_infos"
    @property
    def part_info_storage(self): return f"{self.root}/partition_infos"
    @property
    def minimizer_storage(self): return f"{self.root}/minimizers"
    @property
    def fpr_storage(self): return f"{self.root}/fpr"
    @property
    def plugin_storage(self): return f"{self.root}/plugin_output"
    @property
    def hash_win(self): return f"{self.root}/hash.info"
    @property
    def run_infos(self): return f"{self.root}/run_infos.txt"
    @property
    def options_path(self): return f"{self.root}/options.txt"
    @property
    def repart_path(self): return f"{self.repart_storage}/repartition.minimRepart"

    def get_count_part_path(self, ident: str, part: int, compressed: bool,
                            kind: str) -> str:
        ext = _COUNT_EXT[kind] + (_COUNT_CPR[kind] if compressed else "")
        return f"{self.counts_storage}/partition_{part}/{ident}.{ext}"

    def get_files_to_merge(self, part: int, compressed: bool,
                           kind: str) -> list[str]:
        """Per-sample count files of a partition, in fof (= column) order."""
        assert self.fof is not None
        return [self.get_count_part_path(e.id, part, compressed, kind)
                for e in self.fof]

    def get_matrix_path(self, part: int, mode: str, fmt: str,
                        count_format: str, compressed: bool) -> str:
        ext = _MATRIX_EXT[(mode, count_format)]
        if fmt == "text":
            ext += ".txt"
        elif compressed:
            ext += ".lz4"
        return f"{self.matrix_storage}/matrix_{part}.{ext}"

    def get_filter_path(self, ident: str, out_format: str = "howdesbt") -> str:
        ext = "bf" if out_format == "howdesbt" else "sdsl"
        return f"{self.filter_storage}/{ident}.{ext}"

    def get_hist_path(self, ident: str) -> str:
        return f"{self.hist_storage}/{ident}.hist"

    def get_merge_info_path(self, part: int) -> str:
        return f"{self.stat_storage}/partition{part}.merge_info"

    def get_fpr_path(self, part: int) -> str:
        return f"{self.fpr_storage}/partition_{part}.txt"

    def get_merge_th_path(self) -> str:
        return f"{self.root}/merge_amin.txt"

    def get_minim_paths(self, nb_parts: int) -> list[str]:
        os.makedirs(self.minimizer_storage, exist_ok=True)
        return [f"{self.minimizer_storage}/minimizers.{i}"
                for i in range(nb_parts)]

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def init(cls, root: str, fof_path: str | None = None,
             first: bool = False) -> "KmDir":
        d = cls(root)
        if first:
            assert fof_path is not None
            fof = Fof.parse(fof_path)
            os.makedirs(d.root, exist_ok=True)
            fof.copy(d.fof_path)
            d.fof = Fof.parse(d.fof_path)
            for sub in _SUBDIRS:
                os.makedirs(f"{d.root}/{sub}", exist_ok=True)
            os.makedirs(d.config_storage, exist_ok=True)
            os.makedirs(d.repart_storage, exist_ok=True)
            from kmtricks_tpu_torch import build_infos
            with open(f"{d.root}/build_infos.txt", "w") as f:
                f.write(build_infos())
        else:
            d.fof = Fof.parse(d.fof_path)
        return d

    def init_parts(self, nb_parts: int) -> None:
        for i in range(nb_parts):
            os.makedirs(f"{self.counts_storage}/partition_{i}", exist_ok=True)
