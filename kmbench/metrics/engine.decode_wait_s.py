"""The streaming engine's chunk loop waiting for its next chunk: the
program's span ``engine.decode_wait`` (``runtime/device_pipeline.py::
prefetched``, the consumer blocked on the decode thread's queue):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "engine.decode_wait")
