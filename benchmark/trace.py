"""The device trace of a ``--trace 1`` run and what is read from it.

:class:`Recorder` is the harness's own tracing: host-clock spans around
the calls into the program's layers (each between two synchronisations),
and a marker kernel (``torch.cuda._sleep``, a few microseconds) launched
where the host enters a phase, so that the device records can be cut into
the phases the host was in. With tracing off it does nothing.

:func:`device_records` reads a finished ``torch.profiler`` session's raw
Kineto device records (a copy of the reader in ``chip_smoke.py``:
``prof.events()`` would first build the host-side event tree, tens of
microseconds an event in Python). :func:`busy_s` is the union of their
intervals; :func:`breakdown` the device time by kernel family and phase,
and the longest idle gaps by the phase the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

from . import program

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000


class Record(NamedTuple):
    name: str
    start_us: float
    end_us: float


class Recorder:
    """Spans and phase markers of a traced window (inert when ``on`` is False)."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.phases: List[str] = []

    def phase(self, name: str) -> None:
        """The host enters phase ``name``: a marker kernel goes in the stream."""
        if self.on:
            import torch

            torch.cuda._sleep(MARKER_CYCLES)
            self.phases.append(name)

    @contextlib.contextmanager
    def span(self, name: str, after: str = "host"):
        """Time the body on the host clock between two synchronisations, as
        phase ``name``; phase ``after`` follows it."""
        if not self.on:
            yield
            return
        import torch

        torch.cuda.synchronize()
        self.phase(name)
        t = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.spans[name].append(time.perf_counter() - t)
        self.phase(after)


def device_records(prof) -> List[Record]:
    """(name, start µs, end µs) of each device record of a finished
    ``torch.profiler`` session, user annotations left out."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            out.append(Record(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
    return out


def work(records: List[Record]) -> List[Record]:
    """The records of the program's work: the markers left out."""
    return [r for r in records if MARKER not in r.name]


def busy_s(records: List[Record]) -> float:
    """Seconds in which some record ran: the union of their intervals."""
    total, end = 0.0, None
    for r in sorted(records, key=lambda r: r.start_us):
        if end is None or r.start_us > end:
            total += r.end_us - r.start_us
            end = r.end_us
        elif r.end_us > end:
            total += r.end_us - end
            end = r.end_us
    return total / 1e6


def _phase_of(records: List[Record], phases: List[str]):
    """A function from a time (µs) to the phase the host was in, from the
    marker records (None when the session did not keep every marker)."""
    marks = sorted((r for r in records if MARKER in r.name), key=lambda r: r.start_us)
    if len(marks) != len(phases) or not marks:
        return None
    starts = [m.start_us for m in marks]

    def at(t: float) -> str:
        lo, hi = 0, len(starts)
        while lo < hi:
            mid = (lo + hi) // 2
            if starts[mid] <= t:
                lo = mid + 1
            else:
                hi = mid
        return phases[lo - 1] if lo else "before the first phase"

    return at


def breakdown(records: List[Record], phases: List[str], top: int = 10) -> dict:
    """``device_ops``: device seconds by kernel family (the optimizer's
    kernels as their own family, by the phase they ran in), the ``top``
    largest; ``idle_gaps``: the idle seconds between work records summed by
    the phase the host was in, the ``top`` largest."""
    at = _phase_of(records, phases)
    ops: Dict[str, float] = defaultdict(float)
    gaps: Dict[str, float] = defaultdict(float)
    end = None
    for r in sorted(work(records), key=lambda r: r.start_us):
        fam = program.family(r.name)
        if at is not None and at(r.start_us) == "optimizer":
            fam = "optimizer"
        ops[fam] += (r.end_us - r.start_us) / 1e6
        if end is not None and r.start_us > end:
            gaps["idle while " + (at(end) if at else "unattributed")] += (r.start_us - end) / 1e6
        end = r.end_us if end is None else max(end, r.end_us)
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def family_records(records: List[Record], family: str) -> List[Record]:
    return [r for r in work(records) if program.family(r.name) == family]
