"""The host tail's merges: the program's span ``tail.merge``
(``runtime/device_pipeline.py::merge_write_partition``, each partition's
``host/ops.py::merge_dense``, on the ``-t`` pool in the engine):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "tail.merge")
