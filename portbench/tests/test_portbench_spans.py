"""The readers of the program's own spans and counters (`portbench/spans.py`,
`metrics/eval_ms.py`, `dual_eval_ms.py`, `weight_casts_per_image.py`) on
a synthetic record; None where the record is empty, the run untraced, or
the program has no record (an older commit); and on a tiny cell's traced
run on the CPU, where the evals carry no device time but the counter
counts."""
import time

import pytest

from asyrp_official_torch.utils import profiling
from portbench import bench, harness
from portbench.tests.tiny import tiny_cell
from portbench.window import Window

READERS = ("eval_ms.lat", "dual_eval_ms.tput", "weight_casts_per_image.tput")


def _record():
    """One request: two plain evals of 10 and 12 ms and an edited one of 30."""
    return [profiling.Span("asyrp.eval", {"edited": False}, 10.0),
            profiling.Span("asyrp.eval", {"edited": True}, 30.0),
            profiling.Span("asyrp.eval", {"edited": False}, 12.0)]


def _outcome(traced=True, work=2):
    return harness.Outcome("bfloat16", "image", 1.0, Window(0.0, 1.0, [1.0], work), None,
                           object() if traced else None, traced_requests=1, traced_work=work)


def _read(name, run):
    return bench.load_module(bench.reader_path(name), name.replace(".", "_")).read(run)


def test_readers_on_a_synthetic_record(monkeypatch):
    monkeypatch.setattr(profiling, "records", _record)
    monkeypatch.setattr(profiling, "counters", lambda: {"weight_casts": 3000})
    run = _outcome()
    assert _read("eval_ms.lat", run) == pytest.approx(11.0)
    assert _read("dual_eval_ms.tput", run) == pytest.approx(30.0)
    assert _read("weight_casts_per_image.tput", run) == pytest.approx(1500.0)


def test_an_eval_without_device_time_is_left_out(monkeypatch):
    rec = _record()
    rec[0].device_ms = None
    monkeypatch.setattr(profiling, "records", lambda: rec)
    run = _outcome()
    assert _read("eval_ms.lat", run) == pytest.approx(12.0)
    rec[2].device_ms = None
    assert _read("eval_ms.lat", run) is None
    assert _read("dual_eval_ms.lat", run) == pytest.approx(30.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_record(monkeypatch, name):
    monkeypatch.setattr(profiling, "records", _record)
    monkeypatch.setattr(profiling, "counters", lambda: {"weight_casts": 3000})
    assert _read(name, _outcome(traced=False)) is None
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert _read(name, _outcome()) is None
    monkeypatch.delattr(profiling, "records")  # a program that records nothing
    assert _read(name, _outcome()) is None


def test_a_tiny_traced_run_records_its_traced_request():
    """A tiny cell's traced run on the CPU: the program records the one
    traced request and counts its casts; its spans have no device time, so
    the span readers stay silent. (The CPU trace holds no device operation,
    so the harness itself reads no per-layer metric here.)"""
    profiling.reset()
    cell = tiny_cell("afhq-edit-bf16-bs16", steps=4, batch=2)
    cell.traffic.update(trace_requests=1)
    try:
        result = harness.run_cell(cell, seed=2 ** 31 + 5, seconds=3.0, trace=True,
                                  t_start=time.perf_counter(), device="cpu")
        assert result["attempted"] > 1
        recs = profiling.records()
        assert [s.name for s in recs] == ["asyrp.eval"] * 7  # 3 + 4 steps
        assert sum(s.attrs["edited"] for s in recs) == 2
        run = _outcome(work=2)
        assert _read("eval_ms.tput", run) is None and _read("dual_eval_ms.tput", run) is None
        # 3 + 4 evals of the tiny iDDPM (90 tensors each) and 2 DeltaBlocks (6)
        assert _read("weight_casts_per_image.tput", run) == pytest.approx((7 * 90 + 2 * 6) / 2)
    finally:
        profiling.reset()
