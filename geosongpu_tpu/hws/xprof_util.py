"""Device busy share from a jax.profiler trace (measured, not modeled).

The reference samples NVML utilization counters every 0.1 s
(/root/reference/src/tcn/hws/server.py:46-59).  A jax.profiler trace
records the interval of every kernel the GPU ran, so the union of those
intervals over the window is the measured busy time.  (Plain summing
double-counts kernels that overlap on several streams, so this takes the
interval union.)

In the .xplane.pb a trace writes, each GPU is a plane named
`/device:GPU:<n>` whose lines are its CUDA streams (`Stream #<id>(...)`),
one event per kernel or copy; the host threads are `/host:CPU` planes.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, List, Tuple

DEVICE_PLANE_PREFIX = "/device:GPU:"
STREAM_LINE_PREFIX = "Stream #"


def device_intervals(planes: Iterable) -> List[Tuple[int, int]]:
    """(start_ns, end_ns) of every event on the GPU stream lines of
    `planes` (objects with .name/.lines, lines with .name/.events, events
    with .start_ns/.duration_ns, as jax.profiler.ProfileData gives them)."""
    iv = []
    for plane in planes:
        if not plane.name.startswith(DEVICE_PLANE_PREFIX):
            continue
        for line in plane.lines:
            if not line.name.startswith(STREAM_LINE_PREFIX):
                continue
            iv.extend((e.start_ns, e.start_ns + e.duration_ns)
                      for e in line.events)
    return sorted(iv)


def busy_share(intervals: List[Tuple[int, int]]) -> Dict[str, float]:
    """{busy_s, span_s, busy_share} of sorted intervals: busy is their
    union, span runs from the first start to the last end."""
    if not intervals:
        raise ValueError("no device events in the trace: it holds no GPU "
                         "stream lines (was it taken on a GPU?)")
    busy = 0
    cs, ce = intervals[0]
    for s, t in intervals[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, t
        else:
            ce = max(ce, t)
    busy += ce - cs
    span = max(t for _, t in intervals) - intervals[0][0]
    return {"busy_s": busy / 1e9, "span_s": span / 1e9,
            "busy_share": busy / span if span else 0.0}


def device_busy(trace_dir: str) -> Dict[str, float]:
    """busy_share of the GPU streams in the newest trace under
    trace_dir."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths,
                                                  key=os.path.getmtime))
    return busy_share(device_intervals(data.planes))
