"""Command line: ``python -m kmtricks_tpu_torch pipeline ...``.

The options are ``kmtricks_tpu``'s own (its parser is shared); only the
``pipeline`` command is ported, and it runs on the CUDA device.
"""

from __future__ import annotations

import logging

from kmtricks_tpu.cli import _options_from_args, build_parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level={"debug": logging.DEBUG, "info": logging.INFO,
               "warning": logging.WARNING, "error": logging.ERROR
               }.get(getattr(args, "verbose", "info"), logging.INFO),
        format="[%(asctime)s] [%(levelname)s] %(message)s",
        datefmt="%H:%M:%S")
    if args.cmd != "pipeline":
        raise NotImplementedError(
            f"kmtricks_tpu_torch ports only the pipeline command, not "
            f"{args.cmd}; run kmtricks_tpu instead")
    if args.backend not in ("auto", "mesh"):
        raise NotImplementedError(
            f"--backend {args.backend}: kmtricks_tpu_torch runs the fused "
            "device step only")
    from kmtricks_tpu_torch.runtime.pipeline import run_pipeline

    run_pipeline(_options_from_args(args), device="cuda")
    return 0
