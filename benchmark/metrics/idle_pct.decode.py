"""Device: the share of the traced slice of a serving window in which no
operation ran on the card, in %. Moves ttft_p90_ms."""

from benchmark import readers


def read(records):
    if records.get("kind") != "serve":
        return None
    return readers.idle_pct(records)
