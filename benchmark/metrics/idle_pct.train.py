"""Device: the share of the traced optimizer steps in which no operation
ran on the card, in %. Moves train_tok_per_s."""

from benchmark import readers


def read(records):
    if records.get("kind") != "train":
        return None
    return readers.idle_pct(records)
