"""The measured window of a closed loop with one client.

The client sends a request, waits for its answer, and sends the next. A
request is started while less than `seconds` have passed since the
window's start; the one in flight is finished, and the window ends with
it. So the window holds whole requests only, and every rate is all the
work completed over all the time from the window's start to the end of
its last request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

__all__ = ["Window", "run_window"]


@dataclasses.dataclass
class Window:
    start: float            # clock reading at the window's start
    end: float              # clock reading at the end of its last request
    request_s: List[float]  # each request's own time, in order
    work: int               # units of work completed (images)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def requests(self) -> int:
        return len(self.request_s)

    def rate(self) -> float:
        """Units of work per second of window."""
        return self.work / self.seconds

    def time_per_unit(self) -> float:
        """Seconds of window per unit of work."""
        return self.seconds / self.work


def run_window(request: Callable[[int], int], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Call `request(i)` for i = 0, 1, ... while less than `seconds` have
    passed; each call returns the units of work it completed and returns
    only once they are complete (it waits for the device)."""
    start = clock()
    t, times, work = start, [], 0
    while t - start < seconds:
        work += request(len(times))
        now = clock()
        times.append(now - t)
        t = now
    return Window(start, t, times, work)
