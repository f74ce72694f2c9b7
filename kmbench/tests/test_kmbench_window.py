"""The window and the rate taken over it."""

import pytest

from kmbench.window import Window, rate, run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_ends_with_the_run_that_crosses_the_length():
    clock = Clock()
    lengths = [4.0, 4.0, 4.0, 4.0]

    def once(i):
        clock.t += lengths[i]

    w = run_window(once, 10.0, clock)
    # runs end at 4, 8, 12: the third crosses 10 s mid-run and counts whole
    assert len(w.runs) == 3 and w.elapsed == 12.0
    assert rate(1000, w) == pytest.approx(3000 / 12.0)


def test_window_of_one_long_run():
    clock = Clock()

    def once(i):
        clock.t += 25.0

    w = run_window(once, 10.0, clock)
    assert len(w.runs) == 1 and rate(50, w) == pytest.approx(2.0)


def test_failed_run_ends_the_window():
    clock = Clock()

    def once(i):
        clock.t += 1.0
        if i == 2:
            raise RuntimeError("boom")

    w = run_window(once, 10.0, clock)
    assert len(w.runs) == 2 and isinstance(w.error, RuntimeError)
    assert w.elapsed == 3.0


def test_rate_of_empty_window():
    assert rate(10, Window()) == 0.0
