"""Configuration and repartition (``stage_config`` + ``stage_repart``):
device memory allocated at most inside them over the window's runs, GiB."""

PIPELINE = "kmtricks_tpu_torch.runtime.pipeline"
SPANS = ((PIPELINE, "stage_config", "config", None, None),
         (PIPELINE, "stage_repart", "repart", None, None))


def read(ctx):
    peak = ctx.spans.peak("config", "repart")
    return None if peak is None else peak / 2**30
