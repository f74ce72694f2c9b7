"""Run merges (``merge_sorted_runs``, kernels K3/K4; the engine's folds and
phase A reach it through ``ops/table.py``, the mesh's receivers through
``ops/count_merge.py``) in the profiled run: the merged runs' bytes, each
word read and written once, at the HBM peak, over the device time inside
the spans around the calls, in percent."""

from kmbench import roofline


def _work(runs):
    entries = sum(int(words[0].shape[0]) for words, _payload in runs)
    payload = 1 if runs[0][1] is not None else 0
    return roofline.merge_bytes(entries, len(runs[0][0]), payload)


SPANS = (("kmtricks_tpu_torch.ops.table", "merge_sorted_runs", "merge_runs",
          _work, None),
         ("kmtricks_tpu_torch.ops.count_merge", "merge_sorted_runs",
          "merge_runs", _work, None))


def read(ctx):
    if ctx.profile is None:
        return None
    return roofline.share(ctx.spans.profiled_bytes("merge_runs"),
                          ctx.profile.span_device_s("merge_runs"))
