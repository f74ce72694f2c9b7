"""kmtricks_tpu_torch — the PyTorch + CUDA port of kmtricks_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
torch and never jax, nor anything of ``kmtricks_tpu``: the host layer
(config, repartition, formats, the host count and merge, the writers) is
the port's own copy of the JAX package's numpy and C++ code, and the
device path is ported module by module, each TPU kernel as a CUDA kernel
written by hand with a plain PyTorch version beside it.

Ported: every subcommand of ``python -m kmtricks_tpu`` (pipeline,
repart, superk, count, merge, dump, aggregate, combine, filter, infos),
every ``--mode`` (k-mer and hash counts; count, pa, bf, bft and bfc
matrices; bin and text outputs) for k <= 128, with every backend:
``auto`` (the fused one-step path, the streaming engine or, for sort
layouts no packed word takes, the host-aggregated chunked path; or the
per-stage device path for ``--until``, ``--restrict-to[-list]``,
``--minimizer-type 1`` and ``--kff-output``), ``device``, ``mesh`` and
``host`` (numpy). The fused path runs in one process over a mesh of
devices (every visible GPU by default); several processes are not
ported yet.

Layout (each module names its ``kmtricks_tpu`` counterpart):
  constants.py, core/, host/, io/, native/
             copies of the JAX package's host modules (what the port runs)
  ops/       encode, sort words, segment stage (CUDA K1/K2), compaction,
             run merge (CUDA K3/K4), the engine's table ops, the
             repartition tally, the per-sample count and the
             per-partition merge of the per-stage path
  parallel/  the mesh, the route, the fused step and the engine's steps
  runtime/   the pipeline and its stages, the module commands, superk,
             filter, combine, config and run directory
  csrc/      CUDA sources, built at first use by _build.py
  cli.py     ``python -m kmtricks_tpu_torch <subcommand> ...``
"""

__version__ = "0.1.0"


def build_infos() -> str:
    """Build/version info (reference `kmtricks infos`, cmd/infos.hpp; the
    run directory's build_infos.txt): the torch and CUDA versions and the
    card's name, never jax."""
    import platform
    import sys

    import numpy as np
    import torch

    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "no CUDA device")
    return "\n".join([
        f"kmtricks_tpu_torch {__version__}",
        f"python {sys.version.split()[0]} ({platform.platform()})",
        f"torch {torch.__version__} (CUDA {torch.version.cuda})",
        f"device {card}",
        f"numpy {np.__version__}"]) + "\n"
