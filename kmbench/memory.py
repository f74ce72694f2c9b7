"""Peak resident memory of this process over an interval.

Linux keeps the peak in ``VmHWM``; writing 5 to ``/proc/self/clear_refs``
resets it to the current resident size. Where that write is refused, a
thread samples ``VmRSS`` every 20 ms instead (rarely enough that it
seldom takes the interpreter lock from the pipeline).
"""

from __future__ import annotations

import threading


def _status_kib(field: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1])
    raise KeyError(field)


class HostPeak:
    def __init__(self, interval_s: float = 0.02):
        self.interval_s = interval_s
        self.mode = None
        self._peak = 0
        self._stop = threading.Event()
        self._thread = None

    def start(self) -> None:
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.mode = "VmHWM"
            return
        except OSError:
            pass
        self.mode = "VmRSS sampled"
        self._peak = _status_kib("VmRSS")
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._peak = max(self._peak, _status_kib("VmRSS"))

    def stop(self) -> int:
        """The peak in bytes since :meth:`start`."""
        if self.mode == "VmHWM":
            return 1024 * _status_kib("VmHWM")
        self._stop.set()
        self._thread.join()
        return 1024 * max(self._peak, _status_kib("VmRSS"))


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
