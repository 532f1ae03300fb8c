"""One driver per kind of window: run(ctx) -> result."""
