"""The share of the dense tail's rows that the merge keeps (solid in at
least ``--recurrence-min`` samples): 100 x the program's counter
``tail.merge.kept`` over the rows of its span ``tail.merge``, summed over
the window's runs. The other rows cross to the host and are never
written."""

from kmbench import program

SPANS = program.SPANS


def read(ctx):
    recs = [r for r in ctx.spans.after_readings(program.NAME)
            if "tail.merge.kept" in r and "tail.merge" in r]
    rows = sum(r["tail.merge"]["n"] for r in recs)
    if not rows:
        return None
    return 100.0 * sum(r["tail.merge.kept"]["n"] for r in recs) / rows
