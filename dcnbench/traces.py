"""Reading torch.profiler's trace: device operations, the benchmark's own
spans, the union of busy time, the deformable op's kernels, and the idle
gaps by what the host was doing.

Times are in the trace's microseconds unless a name says seconds.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
PREFIX = "dcnbench."


def events(prof) -> List[dict]:
    """The complete ("X") events of a finished profiler, by way of its
    Chrome trace in a temporary file that is deleted at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def device_ops(evs: Sequence[dict]) -> List[Tuple[str, float, float]]:
    """(name, start, end) of every kernel, copy and fill on the device."""
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in evs if e.get("cat") in DEVICE_CATS)


def spans(evs: Sequence[dict], name: str) -> List[Tuple[float, float]]:
    """(start, end) of every host span of this name."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in evs
                  if e.get("name") == name and e.get("cat") in HOST_CATS)


def union(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def inside(t: float, windows: Sequence[Tuple[float, float]]) -> bool:
    return any(a <= t <= b for a, b in windows)


def dcn_share(evs: Sequence[dict]) -> Dict[str, float]:
    """For each device operation's name, the share of its time that ran
    inside the deformable op, in a traced eager step whose op calls the
    benchmark fenced with synchronised spans: "dcnbench.dcn_fwd" around
    each forward, and "dcnbench.dcn_bwd_begin" / "dcnbench.dcn_bwd_end"
    markers at each backward's first and last node."""
    windows = spans(evs, PREFIX + "dcn_fwd")
    begins = spans(evs, PREFIX + "dcn_bwd_begin")
    ends = spans(evs, PREFIX + "dcn_bwd_end")
    if len(begins) != len(ends):
        raise RuntimeError(f"{len(begins)} backward begin markers against "
                           f"{len(ends)} end markers")
    windows += [(b[0], e[0]) for b, e in zip(begins, ends)]
    total, dcn = defaultdict(float), defaultdict(float)
    for name, a, b in device_ops(evs):
        total[name] += b - a
        if inside(a, windows):
            dcn[name] += b - a
    return {n: dcn[n] / total[n] for n in total if total[n] > 0}


def _label(active: Sequence[dict]) -> str:
    """The outermost benchmark span and the innermost host event of those
    around a moment, "outer/inner"."""
    if not active:
        return "no host event"
    ours = [e for e in active if e["name"].startswith(PREFIX)
            and e["name"] != PREFIX + "window"]
    outer = max(ours, key=lambda e: e["dur"])["name"] if ours else ""
    inner = min(active, key=lambda e: e["dur"])["name"]
    return inner if not outer or outer == inner else f"{outer}/{inner}"


def idle_by_host(host: Sequence[dict], idle) -> Dict[str, float]:
    """Idle seconds by what the host was doing at each gap's middle: one
    sweep over the host events and the gaps, both in time order."""
    host = sorted(({"name": e["name"], "ts": float(e["ts"]),
                    "dur": float(e["dur"])} for e in host),
                  key=lambda e: e["ts"])
    out, active, i = defaultdict(float), [], 0
    for a, b in sorted(idle):
        t = (a + b) / 2
        while i < len(host) and host[i]["ts"] <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e["ts"] + e["dur"] >= t]
        out[_label(active)] += (b - a) * 1e-6
    return dict(out)


def window(evs: Sequence[dict]) -> dict:
    """What the traced window ("dcnbench.window") holds: its length, the
    device's busy time, device time by operation name (seconds), and the
    idle time by the host's activity (seconds)."""
    (lo, hi), = spans(evs, PREFIX + "window")
    ops = [(n, a, b) for n, a, b in device_ops(evs) if lo <= a <= hi]
    by_name = defaultdict(float)
    for n, a, b in ops:
        by_name[n] += (min(b, hi) - a) * 1e-6
    host = [e for e in evs if e.get("cat") in HOST_CATS
            and float(e["ts"]) + float(e["dur"]) >= lo
            and float(e["ts"]) <= hi]
    busy = [(a, b) for _, a, b in ops]
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": union(busy, lo, hi) * 1e-6,
            "by_name": dict(by_name),
            "idle_by_host": idle_by_host(host, gaps(busy, lo, hi))}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k[:160], v] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]
