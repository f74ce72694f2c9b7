"""The roofline byte functions against the bounds of PERF.md's kernel
table (3.35 TB/s)."""

import pytest

from kmbench import roofline


def _ms(nbytes):
    return 1e3 * nbytes / roofline.HBM_BYTES_PER_S


def test_segscan_bound():
    # K1 0.487 ms + K2 0.510 ms at 77,651,280 elements
    assert _ms(roofline.segscan_bytes(77_651_280)) == pytest.approx(
        0.487 + 0.510, abs=0.002)


def test_merge_bounds():
    # K3: one key word, no payload, 16 B/entry: 0.0525 ms at 10,983,197
    assert _ms(roofline.merge_bytes(10_983_197, 1, 0)) == pytest.approx(
        0.0525, abs=0.0005)
    # K4: two key words and the count, 48 B/entry; wide k: 3 words, 64 B
    assert roofline.merge_bytes(1, 2, 1) == 48
    assert roofline.merge_bytes(1, 3, 1) == 64
    # hash form: one word and the count at the phase-A runs, 0.0999 ms
    assert roofline.merge_bytes(1, 1, 1) == 32


def test_share():
    assert roofline.share(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share(0, 1.0) is None
    assert roofline.share(10, 0.0) is None
