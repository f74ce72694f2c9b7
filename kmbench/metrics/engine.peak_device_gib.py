"""The streaming engine (``stage_mesh_stream``: chunk loop, phases A and B,
tails): device memory allocated at most inside it over the window's runs,
GiB."""


def _walls():
    from kmtricks_tpu_torch.runtime import stream_engine
    return dict(stream_engine.last_run["walls_s"])


# the same span as the engine's wall readers, so that either installs it
SPANS = (("kmtricks_tpu_torch.runtime.pipeline", "stage_mesh_stream",
          "engine", None, _walls),)


def read(ctx):
    peak = ctx.spans.peak("engine")
    return None if peak is None else peak / 2**30
