"""The profiler's device trace, summarised in memory.

A traced run profiles a few whole units (frames or steps) of its window
with `torch.profiler` (host and CUDA activity) and keeps no chrome trace: a
frame runs some 70,000 kernels. Everything is read on the trace's own
clock: the span is the host span `bench.traced` around the profiled units,
which ends after the device has finished (each unit ends in a read back to
the host); busy time is the union of the device activity intervals inside
it, so overlapping kernels count once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

SPAN = "bench.traced"
SHORT_GAP_US = 10.0  # a gap this short is the device moving between two kernels
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def union_length(intervals: Sequence[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length covered by ``intervals`` (start, end), and the merged
    intervals in order."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


def idle_gaps(merged: Sequence[Tuple[float, float]], span: Tuple[float, float]):
    """The stretches of ``span`` that no merged interval covers."""
    gaps, at = [], span[0]
    for s, e in merged:
        s, e = max(s, span[0]), min(e, span[1])
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if span[1] > at:
        gaps.append((at, span[1]))
    return gaps


@dataclass
class Summary:
    span_s: float  # the profiled span
    busy_s: float  # union of device activity inside it
    units: int  # whole frames or steps profiled
    kernels: Dict[str, Tuple[int, float]]  # name -> (launches, seconds summed)
    copies: Dict[str, Tuple[int, float]]  # memcpy / memset -> (count, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # host label -> idle seconds

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.span_s

    def kernel_count(self) -> int:
        return sum(n for n, _ in self.kernels.values())

    def seconds_where(self, pred) -> float:
        return sum(s for name, (_, s) in self.kernels.items() if pred(name))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(
            ((name, s) for name, (_, s) in {**self.kernels, **self.copies}.items()),
            key=lambda x: -x[1],
        )[:top]
        return {
            "device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name[:160], s] for name, s in self.gaps[:top]],
        }


def summarize(events, units: int) -> Summary:
    """Summary of a profiler's ``events()`` (FunctionEvents; times in us)."""
    from torch.autograd import DeviceType

    span = None
    host = []
    device = []
    for e in events:
        r = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.name == SPAN:
                span = (r.start, r.end)
            else:
                host.append((r.start, r.end, e.name))
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            # a host span's image on the device's timeline is no device work
            device.append((r.start, r.end, e.name))
    if span is None:
        raise RuntimeError(f"the trace has no host span {SPAN!r}")
    inside = [(s, e, n) for s, e, n in device if e > span[0] and s < span[1]]
    if not inside:
        raise RuntimeError("the trace holds no device activity inside the traced span")
    busy_us, merged = union_length([(max(s, span[0]), min(e, span[1])) for s, e, _ in inside])
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    copies: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, n in inside:
        slot = copies if n.startswith(COPY_PREFIXES) else kernels
        slot[n][0] += 1
        slot[n][1] += (e - s) * 1e-6
    # label each longer idle stretch by the innermost host event around its
    # middle; the short ones are the device moving from kernel to kernel
    host.sort(key=lambda h: h[0])
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = defaultdict(float)
    for g0, g1 in idle_gaps(merged, span):
        if g1 - g0 < SHORT_GAP_US:
            by_label[f"between kernels (gaps under {SHORT_GAP_US:g} us)"] += (g1 - g0) * 1e-6
            continue
        mid = 0.5 * (g0 + g1)
        best = None
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(-1, last - 4000), -1):
            s, e, n = host[i]
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
        by_label[best[2] if best else "host outside any op"] += (g1 - g0) * 1e-6
    return Summary(
        span_s=(span[1] - span[0]) * 1e-6, busy_s=busy_us * 1e-6, units=units,
        kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
        copies={k: (int(v[0]), v[1]) for k, v in copies.items()},
        gaps=sorted(by_label.items(), key=lambda x: -x[1]),
    )
