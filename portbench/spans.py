"""The program's own spans and counters, as the per-layer metrics of the
layer "UNets and their convolutions" read them.

`asyrp_official_torch.utils.profiling` records while a torch profiler
records, so in a `--trace 1` run exactly over the window's traced requests.
Each `asyrp.eval` span carries its device time, read from a pair of CUDA
events on the stream (idle time inside the span included). A program
without that record (a commit before it was added) gives None, and so does
each reader.

The names are fixed here, not taken from the program, so a renamed span
leaves its metric silent rather than measuring something else.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["EVAL", "WEIGHT_CASTS", "recorded", "eval_ms"]

EVAL = "asyrp.eval"
WEIGHT_CASTS = "weight_casts"


def recorded(run) -> Optional[Tuple[List, Dict[str, int]]]:
    """(spans, counters) of a traced run's traced requests, or None where the
    run was not traced or the program recorded no span."""
    if run.trace is None:
        return None
    try:
        from asyrp_official_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records"):
        return None
    recs = profiling.records()
    return (recs, profiling.counters()) if recs else None


def eval_ms(spans, edited: bool) -> Optional[float]:
    """The mean device ms of an eval span with (edited) or without an edit."""
    ms = [s.device_ms for s in spans
          if s.name == EVAL and s.attrs.get("edited") == edited and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
