"""Per-layer metrics read from inside the system: the spans that the port's
own tracer (`pillarnet_lts_torch/runtime/tracing.py`) records at its layer
boundaries on the host clock, at its default level, in every run.

A record is one `serving.request` or `train.step` span with the host ms
of every span recorded inside it, summed by name. Only spans recorded
with no profiler running count: the traced stretch's are inflated by the
profiler's own cost. Of those, a run's window made the last ones: as
many as its requests (`ctx.host_issue_ms`, one a call of the serving
entry) or steps (`ctx.layer_ms["forward"]`, one a step); without that
count every record counts (the few warm-up requests cannot move a median
over a window's hundreds). The int8 calibration's forwards are under no
request.

Everything here returns None where the system has no tracer (an older
checkout) or recorded none of the spans asked for, and in a cell other
than the reader's.
"""

import statistics


def snapshot():
    """The tracer's spans and counters, or None without a tracer."""
    try:
        from pillarnet_lts_torch.runtime import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def _window_count(ctx):
    if ctx.tag == "train":
        return len(ctx.layer_ms.get("forward") or []) or None
    return len(getattr(ctx, "host_issue_ms", None) or []) or None


def _last(items, n):
    return items[-n:] if n else items


def records(ctx, kind):
    """The window's `kind` requests (or steps), each as {span name: host
    ms summed over its occurrences in the request}, oldest first."""
    snap = snapshot()
    if snap is None:
        return []
    per = {}
    for s in snap["spans"]:
        if s["request"] is not None and not s["profiled"]:
            per.setdefault(s["request"], []).append(s)
    out = []
    for rid in sorted(per):
        spans = per[rid]
        if not any(s["id"] == rid and s["name"] == kind for s in spans):
            continue
        ms = {}
        for s in spans:
            ms[s["name"]] = (ms.get(s["name"], 0.0)
                             + (s["end_ns"] - s["start_ns"]) * 1e-6)
        out.append(ms)
    return _last(out, _window_count(ctx))


def request_ms(ctx, tag, kind, *names):
    """In a run of the cell tagged `tag`: the median over the window's
    `kind` requests of the host ms of the spans `names` in a request,
    summed (requests that hold none of them left out)."""
    if ctx.tag != tag:
        return None
    values = [sum(r.get(n, 0.0) for n in names) for r in records(ctx, kind)
              if any(n in r for n in names)]
    return statistics.median(values) if values else None


def span_ms(ctx, tag, name):
    """In a run of the cell tagged `tag`: the median host ms of the
    window's `name` spans recorded outside any request (`serving.sync`:
    one a request)."""
    if ctx.tag != tag:
        return None
    snap = snapshot()
    if snap is None:
        return None
    values = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in snap["spans"]
              if s["name"] == name and not s["profiled"]]
    values = _last(values, _window_count(ctx))
    return statistics.median(values) if values else None
