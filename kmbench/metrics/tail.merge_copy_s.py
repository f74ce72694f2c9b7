"""The dense tail's copy of each partition's final counts and keep flags
to the host: the program's span ``tail.merge.copy`` (inside ``tail.merge``
in ``runtime/device_pipeline.py::device_merge_write_partition``; it first
waits for the merge on the card): seconds per run, mean over the window's
runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "tail.merge.copy")
