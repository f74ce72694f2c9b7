"""``python -m kmbench.gen --traffic FILE --seed N --out DIR [--workers W]``:
write one read collection and print its manifest's path."""

from __future__ import annotations

import argparse
import json
import os

from kmbench.gen import make_bank


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kmbench.gen")
    ap.add_argument("--traffic", required=True, help="traffic mix (.json)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--workers", type=int, default=1)
    args = ap.parse_args(argv)
    with open(args.traffic) as f:
        traffic = json.load(f)
    make_bank(traffic, args.seed, args.out, workers=args.workers)
    print(os.path.join(args.out, "manifest.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
