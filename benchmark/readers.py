"""What the per-layer readers (``benchmark/metrics/<metric>.py``) share.

Each reader takes the run's readings (``benchmark.run.run_cell``) and returns a
number, or None where it finds nothing to read (the metric is then left out
of the result line). A share of a roofline or of the peak is never
clamped: above 100 % means the count or the timing is wrong.
"""

from __future__ import annotations

import sys
from typing import Optional

from . import counts, trace


def _say(msg: str) -> None:
    print(f"reader: {msg}", file=sys.stderr)


def span_ms_per(r, span: str, per: str) -> Optional[float]:
    """The host-clock span ``span`` summed over the window, in ms, over the
    window's count of ``per`` (a key of the steps' work)."""
    n = r.work.get(per, 0)
    if not r.spans.get(span) or not n:
        return None
    return 1e3 * sum(r.spans[span]) / n


def mfu(r) -> Optional[float]:
    """Model FLOPs of the completed steps over the window and the bf16 peak, %."""
    if not r.work.get("flops") or r.window_s <= 0:
        return None
    return 100.0 * r.work["flops"] / r.window_s / counts.H100_BF16_FLOPS


def idle_share(r) -> Optional[float]:
    """The share of the traced window in which no device record ran, %."""
    if not r.records or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def roofline(r, kernel: str) -> Optional[float]:
    """The bound of a kernel's launches in the window over their device
    time, %. The steps declare their launches and the bound of each; the
    declared count must equal the program's launch counter. A session that
    kept fewer records than launches is read over the records it kept, each
    at the mean bound of a launch."""
    launches = r.work.get("launches", {}).get(kernel, 0)
    if not launches:
        return None
    counted = r.counters.get(kernel)
    if counted != launches:
        _say(f"{kernel}: the steps declared {launches} launches, the program's counter {counted}: not read")
        return None
    recs = trace.family_records(r.records, kernel)
    if not recs:
        return None
    if len(recs) != launches:
        _say(f"{kernel}: the trace kept {len(recs)} of {launches} launches; read over those")
    device_s = sum(x.end_us - x.start_us for x in recs) / 1e6
    return 100.0 * r.work["bound_s"][kernel] * len(recs) / launches / device_s
