"""The repartition tally's producer thread parsing the sampled reads: the
program's span ``repart.parse`` (``runtime/pipeline.py::
_sample_minimizer_bins_device``, the next batch of ``_sample_batches``):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "repart.parse")
