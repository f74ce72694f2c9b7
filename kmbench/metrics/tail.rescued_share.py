"""The share of the written cells (solid or rescued: UNIQUE_W_RESCUE)
that rescue kept: 100 x the program's counter ``tail.merge.rescued`` over
its counter ``tail.merge.final``, summed over the window's runs."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    recs = [r for r in ctx.spans.after_readings(program.NAME)
            if "tail.merge.rescued" in r and "tail.merge.final" in r]
    final = sum(r["tail.merge.final"]["n"] for r in recs)
    if not final:
        return None
    return 100.0 * sum(r["tail.merge.rescued"]["n"] for r in recs) / final
