"""The host tail's copies of the rows to the host: the program's span
``tail.fetch`` (the engine's ``_fetch_merge_write``: row keys, partition
sizes and counts; the one step: row keys, counts and partitions):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "tail.fetch")
