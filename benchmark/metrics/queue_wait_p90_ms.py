"""Scheduler (`inference/serve.py` ServeEngine): the 90th percentile of
the wait from submit to admission into a slot (`Completed.queue_s`, which
the engine stamps), over the window's finished requests that were
admitted before the traced slice began: the slice's syncs and the
profiler's collection slow the loop and grow the backlog behind it, so
later admissions would measure the profiler. Moves ttft_p90_ms."""

from benchmark.stats import percentile


def read(records):
    if records.get("kind") != "serve":
        return None
    rec = records.get("trace")
    until = rec["t0"] if rec is not None else float("inf")
    waits = [q for submitted_ns, q in records["queue"]
             if submitted_ns + q * 1e9 < until]
    return percentile(waits, 90) * 1e3 if waits else None
