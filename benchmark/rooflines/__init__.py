"""Operations and bytes of kernels and steps, from shapes and real lengths."""
