"""The streaming engine's chunk decode on its prefetch thread: the
program's span ``engine.decode`` (``runtime/device_pipeline.py::
prefetched``, the time in the chunk generator alone: parse, place and
pin; the wait for room in the queue left out):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "engine.decode")
