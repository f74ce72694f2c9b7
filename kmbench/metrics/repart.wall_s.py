"""Configuration and repartition (``stage_config`` + ``stage_repart``):
seconds per pipeline run, mean over the window's runs."""

PIPELINE = "kmtricks_tpu_torch.runtime.pipeline"
SPANS = ((PIPELINE, "stage_config", "config", None, None),
         (PIPELINE, "stage_repart", "repart", None, None))


def read(ctx):
    return ctx.spans.mean("config", "repart")
