"""The repartition tally's producer thread filling and packing a block:
the program's span ``repart.pack`` (``runtime/pipeline.py::
_sample_minimizer_bins_device``, the block fill and ``pack_2bit_host``):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "repart.pack")
