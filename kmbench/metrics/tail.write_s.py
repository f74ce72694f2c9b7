"""The host tail's writers: the program's span ``tail.write``
(``runtime/device_pipeline.py::merge_write_partition``, each partition's
``write_merge_outputs``, on the ``-t`` pool in the engine):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "tail.write")
