"""The window holds whole requests: one is started while less than the
window's seconds have passed, the one in flight is finished, and every rate
is all the work over all the time to the end of the last request."""
import pytest

from portbench.window import run_window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _requests(clock, durations, work=16):
    calls = []

    def request(i):
        calls.append(i)
        clock.t += durations[i]
        return work

    return request, calls


@pytest.mark.parametrize("seconds,expect", [(10.0, 3), (8.0, 2), (8.5, 3), (0.1, 1)])
def test_whole_requests_only(seconds, expect):
    clock = FakeClock()
    request, calls = _requests(clock, [4.0, 4.0, 4.0, 4.0, 4.0])
    w = run_window(request, seconds, clock)
    assert w.requests == expect == len(calls)
    assert w.end - w.start == pytest.approx(4.0 * expect)
    assert w.seconds >= seconds


def test_rate_is_all_work_over_all_time():
    clock = FakeClock()
    request, _ = _requests(clock, [4.0, 2.0, 6.0])
    w = run_window(request, 7.0, clock)
    assert w.requests == 3 and w.work == 48
    assert w.rate() == pytest.approx(48 / 12.0)
    assert w.time_per_unit() == pytest.approx(12.0 / 48)
    assert w.request_s == [4.0, 2.0, 6.0]
