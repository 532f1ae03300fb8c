"""Plain float32 references of the model, its training and its serving."""
