"""Scheduler: host milliseconds of one `ServeEngine.step()` call that
only decodes (no admission), the mean over those ticks of the window
outside the traced slice (whose per-tick reads of the cache lengths would
add to it). Moves ttft_p90_ms."""


def read(records):
    if records.get("kind") != "serve":
        return None
    ms = [(t["t1"] - t["t0"]) / 1e6 for t in records["ticks"]
          if t["steps"] and not t["prefill"] and not t["traced"]]
    return sum(ms) / len(ms) if ms else None
