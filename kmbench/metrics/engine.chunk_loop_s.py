"""The streaming engine's chunk loop (chunk source, chunk step, folds):
``stream_engine.last_run["walls_s"]["chunk_loop"]``, mean per run."""


def _walls():
    from kmtricks_tpu_torch.runtime import stream_engine
    return dict(stream_engine.last_run["walls_s"])


SPANS = (("kmtricks_tpu_torch.runtime.pipeline", "stage_mesh_stream",
          "engine", None, _walls),)


def read(ctx):
    walls = [w["chunk_loop"] for w in ctx.spans.after_readings("engine")]
    return sum(walls) / len(walls) if walls else None
