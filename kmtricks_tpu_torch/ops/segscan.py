"""Count+merge segment stage: sorted occurrence flags -> counts and rows.

Counterpart of ``kmtricks_tpu/ops/pallas_segscan.py`` (the Pallas kernels
``_bwd_kernel`` / ``_fwd_kernel``) and of the XLA branch of
``kmtricks_tpu/ops/count_merge.py::_segment_stage``.

Per sorted position: the (key, sample) run length at each occurrence head,
the count-stage hard-min and saturation, the solid verdict against the
soft-min, the per-key solid tally (rescue, recurrence), the first present
entry of each key (row head) and the dense row index.

:func:`segment_stage_torch` is the plain PyTorch version;
:func:`segment_stage` runs it for CPU tensors and the hand-written CUDA
kernels of ``csrc/segscan.cu`` for CUDA tensors (K1 = backward pass, K2 =
forward pass). It never falls back from one to the other.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch._build import TILE, segscan_lib

INT32_MAX = 2**31 - 1

# kernel launches, counted where each wrapper launches its CUDA kernel
LAUNCHES = {"bwd": 0, "fwd": 0}


def _next_after(flag, idx, n):
    """First index > i where ``flag`` holds (else n)."""
    suf = torch.cummin(torch.where(flag, idx, n).flip(0), 0).values.flip(0)
    return torch.cat([suf[1:], suf.new_full((1,), n)])


def segscan_bwd_torch(occ_diff, key_diff, valid, amin_of, hmin_of, *,
                      count_max: int):
    """Plain version of K1. Inputs: (N,) bool occurrence/key changes and
    validity, (N,) int32 per-position soft-min and hard-min. Returns
    (cnt int32, present bool, solid bool, suffix int32): run lengths at
    occurrence heads (saturated at ``count_max``), the hard-min and
    soft-min verdicts, and the suffix sum of ``solid`` within each key
    segment (segments start where ``key_diff`` holds)."""
    n = occ_diff.shape[0]
    i32 = torch.int32
    idx = torch.arange(n, dtype=i32, device=occ_diff.device)
    occ_head = occ_diff & valid
    # (key, sample) run length: distance to the next occurrence boundary
    nxt = _next_after(occ_diff | ~valid, idx, n)
    cnt_raw = torch.where(occ_head, nxt - idx, 0)
    present = occ_head & (cnt_raw >= hmin_of)
    cnt = cnt_raw.clamp(max=count_max) if count_max < 2**31 else cnt_raw
    solid = present & (cnt >= amin_of)
    incl = torch.cumsum(solid, 0, dtype=i32)
    seg_end = (_next_after(key_diff, idx, n) - 1).long()
    suffix = incl[seg_end] - incl + solid.to(i32)
    return cnt, present, solid, suffix


def segscan_fwd_torch(present, solid, suffix, key_diff, valid, cnt, *,
                      rmin: int, save_if: int):
    """Plain version of K2. Returns (final int32, row_head bool,
    row_keep bool, row_of int32): rescue against the key's solid total
    (its head's suffix), the first present entry of each key, the
    recurrence verdict and the dense row index."""
    n = present.shape[0]
    i32 = torch.int32
    idx = torch.arange(n, dtype=i32, device=present.device)
    key_head = key_diff & valid
    last_head = torch.cummax(torch.where(key_head, idx, -1), 0).values
    solid_in = torch.where(last_head >= 0,
                           suffix[last_head.clamp(min=0).long()], 0)
    pexcl = torch.cumsum(present, 0, dtype=i32) - present.to(i32)
    base = torch.cummax(torch.where(key_head, pexcl, 0), 0).values
    row_head = present & (pexcl == base)
    row_of = (torch.cumsum(row_head, 0, dtype=i32) - 1).clamp(min=0)
    if save_if > 0:
        rescued = present & ~solid & (solid_in >= save_if)
    else:
        rescued = torch.zeros_like(solid)
    final = torch.where(solid | rescued, cnt, 0)
    row_keep = row_head & (solid_in >= rmin)
    return final, row_head, row_keep, row_of


def segment_stage_torch(occ_diff, key_diff, valid, amin_of, hmin_of, *,
                        rmin: int, save_if: int, count_max: int):
    """Plain version of the whole stage (K1 then K2). Returns (cnt int32,
    present bool, solid bool, final int32, row_head bool, row_keep bool,
    row_of int32), the outputs of ``segment_stage_pallas``."""
    cnt, present, solid, suffix = segscan_bwd_torch(
        occ_diff, key_diff, valid, amin_of, hmin_of, count_max=count_max)
    final, row_head, row_keep, row_of = segscan_fwd_torch(
        present, solid, suffix, key_diff, valid, cnt, rmin=rmin,
        save_if=save_if)
    return cnt, present, solid, final, row_head, row_keep, row_of


def segment_stage(occ_diff, key_diff, valid, amin_of, hmin_of, *,
                  rmin: int, save_if: int, count_max: int):
    """Dispatch on the inputs' device: the plain version for CPU tensors,
    kernels K1 + K2 for CUDA tensors (never one for the other). Same
    signature and outputs as :func:`segment_stage_torch`."""
    dev = occ_diff.device
    if dev.type == "cpu":
        return segment_stage_torch(occ_diff, key_diff, valid, amin_of,
                                   hmin_of, rmin=rmin, save_if=save_if,
                                   count_max=count_max)
    if dev.type != "cuda":
        raise NotImplementedError(f"segment_stage: no kernel for {dev}")
    cnt, present, solid, suffix = segscan_bwd_cuda(
        occ_diff, key_diff, valid, amin_of, hmin_of, count_max=count_max)
    final, row_head, row_keep, row_of = segscan_fwd_cuda(
        present, solid, suffix, key_diff, valid, cnt, rmin=rmin,
        save_if=save_if)
    return cnt, present, solid, final, row_head, row_keep, row_of


def _checked(ts, dev):
    """Validate the kernel inputs: contiguous (N,) tensors of the given
    dtypes on one CUDA device, N < 2^31."""
    n = ts[0][1].shape[0]
    if n >= INT32_MAX - (1 << 16):
        raise ValueError(f"segment_stage: n = {n} needs int32 indices")
    for name, t, dtype in ts:
        if t.device != dev or t.dtype != dtype or t.shape != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"segment_stage: {name} must be a contiguous "
                             f"({n},) {dtype} tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return n


def _launch(fn, name, args, dev):
    """Call a C launcher on the current stream; raise on its error code."""
    lib = segscan_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"segscan {name} launch failed: "
                           f"{lib.km_error_string(err).decode()}")


def _scratch(n, dev):
    return torch.empty((8, -(-n // TILE)), dtype=torch.int32, device=dev)


def segscan_bwd_cuda(occ_diff, key_diff, valid, amin_of, hmin_of, *,
                     count_max: int):
    """K1 on the current CUDA stream (no synchronisation); the outputs of
    :func:`segscan_bwd_torch`."""
    dev = occ_diff.device
    b, i32 = torch.bool, torch.int32
    n = _checked([("occ_diff", occ_diff, b), ("key_diff", key_diff, b),
                  ("valid", valid, b), ("amin_of", amin_of, i32),
                  ("hmin_of", hmin_of, i32)], dev)
    cnt = torch.empty(n, dtype=i32, device=dev)
    present = torch.empty(n, dtype=b, device=dev)
    solid = torch.empty(n, dtype=b, device=dev)
    suffix = torch.empty(n, dtype=i32, device=dev)
    if n:
        scratch = _scratch(n, dev)      # referenced until after the launch
        _launch("km_segscan_bwd", "K1",
                (occ_diff.data_ptr(), key_diff.data_ptr(), valid.data_ptr(),
                 amin_of.data_ptr(), hmin_of.data_ptr(), n,
                 min(int(count_max), INT32_MAX), cnt.data_ptr(),
                 present.data_ptr(), solid.data_ptr(), suffix.data_ptr(),
                 scratch.data_ptr()), dev)
        LAUNCHES["bwd"] += 1
    return cnt, present, solid, suffix


def segscan_fwd_cuda(present, solid, suffix, key_diff, valid, cnt, *,
                     rmin: int, save_if: int):
    """K2 on the current CUDA stream (no synchronisation); the outputs of
    :func:`segscan_fwd_torch`."""
    dev = present.device
    b, i32 = torch.bool, torch.int32
    n = _checked([("present", present, b), ("solid", solid, b),
                  ("suffix", suffix, i32), ("key_diff", key_diff, b),
                  ("valid", valid, b), ("cnt", cnt, i32)], dev)
    final = torch.empty(n, dtype=i32, device=dev)
    row_head = torch.empty(n, dtype=b, device=dev)
    row_keep = torch.empty(n, dtype=b, device=dev)
    row_of = torch.empty(n, dtype=i32, device=dev)
    if n:
        scratch = _scratch(n, dev)      # referenced until after the launch
        _launch("km_segscan_fwd", "K2",
                (present.data_ptr(), solid.data_ptr(), suffix.data_ptr(),
                 key_diff.data_ptr(), valid.data_ptr(), cnt.data_ptr(), n,
                 int(rmin), int(save_if), final.data_ptr(),
                 row_head.data_ptr(), row_keep.data_ptr(), row_of.data_ptr(),
                 scratch.data_ptr()), dev)
        LAUNCHES["fwd"] += 1
    return final, row_head, row_keep, row_of
