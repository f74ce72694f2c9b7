"""kmtricks_tpu_torch — the PyTorch + CUDA port of kmtricks_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
torch and never jax, nor anything of ``kmtricks_tpu``: the host layer
(config, repartition, formats, the host count and merge, the writers) is
the port's own copy of the JAX package's numpy and C++ code, and the
device path is ported module by module, each TPU kernel as a CUDA kernel
written by hand with a plain PyTorch version beside it.

Ported so far: the ``pipeline`` command on one GPU, every ``--mode``
(k-mer and hash counts; count, pa, bf, bft and bfc matrices; bin and
text outputs) for k <= 128, with the repartition tally on the device and
``--static-repart``, through the fused one-step path and the streaming
engine. Anything else (the other subcommands, ``--until`` before merge,
``--minimizer-type 1``, ``--restrict-to[-list]``, KFF outputs, sort
layouts that do not pack) raises NotImplementedError.

Layout (each module names its ``kmtricks_tpu`` counterpart):
  constants.py, core/, host/, io/, native/
             copies of the JAX package's host modules (what the port runs)
  ops/       encode, sort words, segment stage (CUDA K1/K2), compaction,
             run merge (CUDA K3/K4), the engine's table ops, the
             repartition tally
  parallel/  the fused single-device step and the engine's device steps
  runtime/   the pipeline, host stages, config and run directory
  csrc/      CUDA sources, built at first use by _build.py
  cli.py     ``python -m kmtricks_tpu_torch pipeline ...``
"""

__version__ = "0.1.0"


def build_infos() -> str:
    """Build/version info for the run directory's build_infos.txt."""
    import platform
    import sys

    import numpy as np
    import torch

    return "\n".join([
        f"kmtricks_tpu_torch {__version__}",
        f"python {sys.version.split()[0]} ({platform.platform()})",
        f"torch {torch.__version__} (CUDA {torch.version.cuda})",
        f"numpy {np.__version__}"]) + "\n"
