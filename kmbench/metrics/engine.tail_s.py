"""The streaming engine after its chunk loop: phase A, phase B and the
tails (``last_run["walls_s"]`` phase_a + phase_b + tail), mean per run."""


def _walls():
    from kmtricks_tpu_torch.runtime import stream_engine
    return dict(stream_engine.last_run["walls_s"])


SPANS = (("kmtricks_tpu_torch.runtime.pipeline", "stage_mesh_stream",
          "engine", None, _walls),)


def read(ctx):
    walls = [w["phase_a"] + w["phase_b"] + w["tail"]
             for w in ctx.spans.after_readings("engine")]
    return sum(walls) / len(walls) if walls else None
