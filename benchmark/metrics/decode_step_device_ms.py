"""Model step (`models/llama.decode_step`): device milliseconds of the
kernels of the traced ticks' decode steps (`readers.decode_events`), per
decode step. Moves ttft_p90_ms."""

from benchmark import readers


def read(records):
    if records.get("kind") != "serve":
        return None
    ticks = readers.traced_ticks(records) or []
    steps = sum(t["steps"] for t in ticks)
    if not steps:
        return None
    ns = sum(d for t in ticks for name, _, d in readers.decode_events(t)
             if readers.is_kernel(name))
    return ns / 1e6 / steps
