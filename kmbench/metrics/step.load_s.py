"""The one-step path loading the collection: the program's span
``step.load`` (``runtime/pipeline.py::_run_fused``, the call of
``_load_global_batch``):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "step.load")
