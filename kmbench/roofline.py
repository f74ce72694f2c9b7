"""Peaks of the card and the least bytes each measured operation moves.

Bytes are counted from the work (entries, key words, elements): each
input read once and each output written once, whatever passes an
implementation makes, so a kernel redesigned later is held to the same
bound. Peaks are NVIDIA's data-sheet figures for one H100 SXM at its full
700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

# the segment stage's inputs and outputs per element: 21 B for its
# backward scan (K1) and 22 B for its forward scan (K2), the bounds of
# PERF.md's kernel table
SEGSCAN_BYTES_PER_ELEMENT = 21 + 22


def merge_bytes(entries: int, key_words: int, payload_words: int) -> int:
    """Merging sorted runs of ``entries`` int64 entries in all, each of
    ``key_words`` key words and ``payload_words`` payload words: every
    word read once and written once."""
    return 2 * 8 * entries * (key_words + payload_words)


def segscan_bytes(elements: int) -> int:
    """The segment stage (K1 then K2) over ``elements`` sorted elements."""
    return SEGSCAN_BYTES_PER_ELEMENT * elements


def share(nbytes: float, seconds: float) -> float | None:
    """Percent of the bandwidth roofline: the least time the bytes need
    at the peak over the measured time. None where nothing was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
