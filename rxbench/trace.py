"""From a profiler trace of a few steady chunks to per-layer numbers.

The run traces a bounded sub-window of its chunks with ``torch.profiler``
(host and device activities) and keeps only the events in memory. The
benchmark's host spans (``rxbench.ingest``, ``rxbench.entry``,
``rxbench.fetch``) bound the traced window; device events are the kernels,
copies and fills the card ran in it, also those inside CUDA graph replays.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

SPAN_PREFIX = "rxbench."
KERNEL_NAMES_DIR = Path(__file__).resolve().parent / "metrics" / "kernel_names"
TOP = 10


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: float  # seconds, the trace's clock
    end: float

    @property
    def kind(self) -> str:
        n = self.name.lower()
        if n.startswith("memcpy"):
            return "copy"
        if n.startswith("memset"):
            return "fill"
        return "kernel"


def short_name(name: str) -> str:
    """A kernel's qualified name without its return type, template arguments
    and argument list: 'void ns::foo<1>(float*)' -> 'ns::foo'; a copy or fill
    keeps its kind and direction: 'Memcpy HtoD (Pinned -> Device)' ->
    'Memcpy HtoD'."""
    n = name.replace("(anonymous namespace)::", "").strip()
    if n.lower().startswith(("memcpy", "memset")):
        return n.split("(", 1)[0].strip()
    depth, cut = 0, len(n)
    for i, ch in enumerate(n):  # the argument list: the first '(' outside <>
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head, depth = [], 0
    for ch in n[:cut]:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            head.append(ch)
    words = "".join(head).split()
    return words[-1] if words else "(unnamed)"


def kernel_names(stage: str) -> set[str]:
    """Every name listed in the ``*.txt`` files of ``kernel_names/<stage>/``
    (one a line, ``#`` starts a comment)."""
    names = set()
    for f in sorted((KERNEL_NAMES_DIR / stage).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.add(line)
    return names


def events_of(prof) -> tuple[list[Event], list[Event]]:
    """(device events, the benchmark's host spans) of a finished profile."""
    import torch

    device, spans = [], []
    for e in prof.events():
        ev = Event(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name.startswith(SPAN_PREFIX):
            # a span shows on the host and, as an annotation, on the device
            if e.device_type != torch.autograd.DeviceType.CUDA:
                spans.append(Event(e.name[len(SPAN_PREFIX):], ev.start, ev.end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(ev)
    return device, spans


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Summary:
    """What the traced chunks did on the card."""

    chunks: int
    window_s: float  # from the first span's start to the last span's end
    busy_s: float  # time in which a kernel, copy or fill ran
    kernels: int  # kernel launches (copies and fills not counted)
    by_name: dict  # short name -> [count, seconds]
    gaps: list  # [(host span open at the gap's start, seconds)], longest first

    def kernel_time(self, names: set[str]) -> tuple[int, float]:
        """(launches, seconds) of the kernels with these short names."""
        n = t = 0
        for k, (c, s) in self.by_name.items():
            if k in names:
                n, t = n + c, t + s
        return n, t

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, s] for k, s in self.gaps[:TOP]]}


def summarize(device: list[Event], spans: list[Event], chunks: int) -> Summary:
    """Busy time, launches, time by kernel and the idle gaps of the traced
    chunks. The profile holds their device work alone (the card is idle when
    it starts and when it stops), so every device event counts, and the
    window runs from the first span or event to the last: the trace places
    device events up to a millisecond off the host's spans."""
    if not spans:
        raise ValueError("the trace holds none of the benchmark's spans")
    w0 = min(e.start for e in spans + device)
    w1 = max(e.end for e in spans + device)
    busy = union([(e.start, e.end) for e in device])
    by_name: dict[str, list] = {}
    for e in device:
        k = short_name(e.name)
        v = by_name.setdefault(k, [0, 0.0])
        v[0] += 1
        v[1] += e.end - e.start
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((_span_at(spans, t), a - t))
        t = max(t, b)
    gaps.sort(key=lambda g: -g[1])
    return Summary(chunks=chunks, window_s=w1 - w0, busy_s=sum(b - a for a, b in busy),
                   kernels=sum(1 for e in device if e.kind == "kernel"),
                   by_name=by_name, gaps=gaps)


def _span_at(spans: list[Event], t: float) -> str:
    """The innermost benchmark span open at ``t`` ('host' between spans)."""
    open_ = [s for s in spans if s.start <= t < s.end]
    return min(open_, key=lambda s: s.end - s.start).name if open_ else "host"
