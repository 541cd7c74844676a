"""What a ``torch.profiler`` trace of the window says: device busy time,
each kernel's self time, and where the device waited on the host.

Busy time is the union of the device operations' intervals (kernels,
copies, fills) on the trace's clock; an idle gap is the time between two of
them, named by what the host was doing at its middle: the innermost
benchmark span (``torch.profiler.record_function`` names that start with
"bench.") and the innermost host operation there.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

TOP = 10
WALK_BACK = 64


def _is_device(e, cuda) -> bool:
    return e.device_type == cuda


def summarize(prof) -> dict:
    """{'busy_s', 'device_ops', 'kernels': {name: [self_s, count]},
    'breakdown': {'device_ops': [[name, s]...], 'idle_gaps': [[name, s]...]}}."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    dev, host, spans = [], [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith("bench."):
            # a span, which the trace also marks on the device's timeline
            if not _is_device(e, cuda):
                spans.append((tr.start, tr.end, e.name))
        elif _is_device(e, cuda):
            dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for s, t, name in dev:
        kernels[name][0] += (t - s) * 1e-6
        kernels[name][1] += 1
    dev.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy_us += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_us += cur_t - cur_s
    host.sort()
    spans.sort()
    h_start = [x[0] for x in host]
    s_start = [x[0] for x in spans]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        idle[f"{_inner(spans, s_start, mid)}/{_inner(host, h_start, mid)}"] += (
            (b - a) * 1e-6)
    top_ops = sorted(((k, v[0]) for k, v in kernels.items()), key=lambda x: -x[1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return {
        "busy_s": busy_us * 1e-6,
        "device_ops": len(dev),
        "kernels": {k: v for k, v in kernels.items()},
        "breakdown": {"device_ops": [[k[:120], v] for k, v in top_ops],
                      "idle_gaps": [[k[:120], v] for k, v in top_gaps]},
    }


def _inner(items: list, starts: list, t: float, walk: int = WALK_BACK) -> str:
    """The name of the latest-starting interval that holds ``t``, looking
    back at most ``walk`` intervals, or "-"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - walk, -1), -1):
        if items[j][1] >= t:
            return items[j][2]
    return "-"


def kernel_s(summary: dict, part: str) -> tuple[float, int]:
    """(self seconds, launches) of every kernel whose name holds ``part``;
    (0, 0) where none ran."""
    s = n = 0
    for name, (sec, count) in summary["kernels"].items():
        if part in name:
            s += sec
            n += count
    return float(s), int(n)
