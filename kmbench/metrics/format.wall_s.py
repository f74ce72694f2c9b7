"""The per-sample HowDe-SBT filters (``stage_format``): seconds per run,
mean over the window's runs."""

SPANS = (("kmtricks_tpu_torch.runtime.pipeline", "stage_format", "format",
          None, None),)


def read(ctx):
    return ctx.spans.mean("format")
