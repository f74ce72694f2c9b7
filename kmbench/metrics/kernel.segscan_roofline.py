"""The segment stage (``segment_stage``, kernels K1/K2) in the profiled
run: 43 B per element at the HBM peak, over the device time inside the
spans around the calls, in percent."""

from kmbench import roofline


def _work(occ_diff, *_args, **_kwargs):
    return roofline.segscan_bytes(int(occ_diff.shape[0]))


SPANS = (("kmtricks_tpu_torch.ops.count_merge", "segment_stage",
          "segment_stage", _work, None),)


def read(ctx):
    if ctx.profile is None:
        return None
    return roofline.share(ctx.spans.profiled_bytes("segment_stage"),
                          ctx.profile.span_device_s("segment_stage"))
