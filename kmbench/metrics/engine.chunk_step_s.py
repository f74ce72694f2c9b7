"""The streaming engine's chunk steps: the program's span
``engine.chunk_step`` (``runtime/stream_engine.py``, the call of
``build_chunk_pairs_step``'s step on each chunk, with its host work and
synchronisations):
seconds per run, mean over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    return program.mean_s(ctx, "engine.chunk_step")
