"""The repartition tally waiting for its next block: the program's span
``repart.tally_wait`` (``runtime/pipeline.py::
_sample_minimizer_bins_device``, the consumer blocked on the producer
thread's queue):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "repart.tally_wait")
