"""kmtricks_tpu_torch — the PyTorch + CUDA port of kmtricks_tpu.

A second package beside the JAX one, for NVIDIA Hopper GPUs. It imports
torch and never jax: the host layer (config, repartition, formats, the
dense merge and the writers) is shared with ``kmtricks_tpu`` by import,
and the device step is ported module by module, each TPU kernel as a
CUDA kernel written by hand with a plain PyTorch version beside it.

Ported so far: ``pipeline --mode kmer:count:bin`` for k <= 32 on one GPU,
for collections that fit one device step. Anything else raises
NotImplementedError.

Layout (each module names its ``kmtricks_tpu`` counterpart):
  ops/       encode, sort words, segment stage (CUDA K1/K2), compaction
  parallel/  the fused single-device step
  runtime/   the pipeline driver
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
