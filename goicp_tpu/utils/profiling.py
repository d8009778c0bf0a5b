"""Profiling / tracing utilities.

The reference's only instrumentation is clock() prints
(jly_main.cpp:108-123, jly_goicp.cpp:694-700).  Here:
  * `phase_timer` — lightweight named phase timing accumulated in a dict;
  * `trace` — wraps jax.profiler.trace for TensorBoard-viewable device
    traces of the search hot loop;
  * `summarize_trace` — reduces such a trace to device busy time, idle
    share, the time of one named scope and the top device ops.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4), "calls": self.counts[k]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1])}


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler device trace when log_dir is given; no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


def _union_ns(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def hlo_ops_in_scope(hlo_text: str, scope: str) -> set:
    """Names of the HLO instructions of a compiled program whose op_name
    metadata lies under `scope` (a jax.named_scope): the kernels a trace
    attributes to that scope."""
    import re
    # the scope is a path element of op_name, possibly wrapped by a
    # transformation: ".../bound_eval/..." or ".../vmap(bound_eval)/..."
    pat = re.compile(r'op_name="(?:[^"]*[/(])?' + re.escape(scope)
                     + r'(?:[/)][^"]*)?"')
    names = set()
    for line in hlo_text.splitlines():
        s = line.strip()
        if s.startswith("ROOT "):
            s = s[5:]
        if s.startswith("%") and pat.search(s):
            names.add(s[1:].split(" ", 1)[0])
    return names


def _norm_op(name: str) -> str:
    """HLO op and GPU kernel names differ in separators ("loop_fusion.3"
    launches kernel "loop_fusion_3")."""
    return name.replace(".", "_")


def summarize_trace(log_dir: str, plane_prefix: str = "/device:",
                    window: str | None = None, scope: str | None = None,
                    scope_ops=(), top: int = 10) -> dict:
    """Reduce a jax.profiler trace under log_dir to device metrics.

    Device events are those of the planes whose name starts with
    plane_prefix.  On a GPU plane the kernels themselves are on the
    "Stream #..." lines (one event per kernel, also for kernels a CUDA
    graph launches), and the "XLA Ops" line holds one event per executed
    HLO op or command buffer; the kernels are used where present, else
    "XLA Ops", else every line.  busy = union of their intervals; the
    window is the host TraceAnnotation named `window` when given, else the
    span of the device events; idle share = 1 - busy / window.  scope_ns
    is the union of the events attributed to `scope`: an event whose stats
    name the scope, or whose name is an HLO op in scope_ops (see
    hlo_ops_in_scope).  Returns nanosecond totals, shares, the top events
    by time, and the lines read (name, event count, a sample event)."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    pd = ProfileData.from_file(paths[-1])
    events, lines_read, win = [], [], None
    scope_ops = {_norm_op(n) for n in scope_ops}
    for plane in pd.planes:
        if window and plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == window:
                        win = (ev.start_ns, ev.end_ns)
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        use = ([ln for ln in lines if ln.name.startswith("Stream")]
               or [ln for ln in lines if ln.name == "XLA Ops"] or lines)
        for line in use:
            n = 0
            for ev in line.events:
                stats = dict(ev.stats)
                if n == 0:
                    lines_read.append({
                        "plane": plane.name, "line": line.name,
                        "sample": ev.name,
                        "sample_stats": {k: str(v)[:120]
                                         for k, v in stats.items()}})
                n += 1
                in_scope = bool(scope) and (
                    _norm_op(ev.name) in scope_ops
                    or _norm_op(str(stats.get("hlo_op", ""))) in scope_ops
                    or any(scope in str(v) for v in stats.values()))
                events.append((ev.start_ns, ev.end_ns, ev.name, in_scope))
            if lines_read and lines_read[-1]["line"] == line.name:
                lines_read[-1]["events"] = n
    if not events:
        raise ValueError(f"no device events on planes {plane_prefix}* "
                         f"in {paths[-1]}")
    if win is not None:
        events = [e for e in events if e[1] > win[0] and e[0] < win[1]]
    else:
        win = (min(e[0] for e in events), max(e[1] for e in events))
    window_ns = float(win[1] - win[0])
    busy = _union_ns((s, e) for s, e, _, _ in events)
    by_op: dict = defaultdict(float)
    for s, e, name, _ in events:
        by_op[name] += e - s
    scope_ns = _union_ns((s, e) for s, e, _, sc in events if sc)
    return {
        "trace": paths[-1], "window_ns": window_ns, "busy_ns": busy,
        "idle_share": 1.0 - busy / window_ns if window_ns else None,
        "n_events": len(events),
        "scope": scope, "scope_ns": scope_ns,
        "scope_share_of_window": scope_ns / window_ns if window_ns else None,
        "scope_share_of_busy": scope_ns / busy if busy else None,
        "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        "lines": lines_read,
    }
