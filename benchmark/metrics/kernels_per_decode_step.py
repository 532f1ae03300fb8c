"""Model step: kernels launched per decode step in the traced ticks'
decode steps (`readers.decode_events`; the engine's state machine and
snapshot included). Moves ttft_p90_ms."""

from benchmark import readers


def read(records):
    if records.get("kind") != "serve":
        return None
    ticks = readers.traced_ticks(records) or []
    steps = sum(t["steps"] for t in ticks)
    if not steps:
        return None
    n = sum(1 for t in ticks for name, _, _ in readers.decode_events(t)
            if readers.is_kernel(name))
    return n / steps
