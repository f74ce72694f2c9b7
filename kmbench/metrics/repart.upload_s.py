"""The repartition tally's producer thread uploading a block: the
program's span ``repart.upload`` (``runtime/pipeline.py::
_sample_minimizer_bins_device``, pinning and the non-blocking copies):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "repart.upload")
