"""CPU tests of the benchmark (the card-marked ones skip without a card)."""
