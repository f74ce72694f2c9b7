"""The one-step path (``stage_mesh_count_merge``): seconds per run, mean
over the window's runs."""

SPANS = (("kmtricks_tpu_torch.runtime.pipeline", "stage_mesh_count_merge",
          "step", None, None),)


def read(ctx):
    return ctx.spans.mean("step")
