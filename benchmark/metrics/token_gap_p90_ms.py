"""Scheduler (`inference/serve.py` ServeEngine): the 90th percentile of
each request's mean gap between streamed tokens ((last - first) / (tokens
- 1)), over the window's finished requests whose last token came before
the traced slice began: the slice's syncs and the profiler's collection
slow the loop, so later gaps would measure the profiler. Its blocking
admissions and decode ticks both lengthen it. Moves ttft_p90_ms."""

from benchmark.stats import percentile


def read(records):
    if records.get("kind") != "serve":
        return None
    rec = records.get("trace")
    until = rec["t0"] if rec is not None else float("inf")
    gaps = [g for last_ns, g in records.get("gaps", []) if last_ns < until]
    return percentile(gaps, 90) * 1e3 if gaps else None
