"""Parameter counts of a configuration (the decoder's layers, its head,
the tower, the projector and the vision head), from its sizes alone."""


def decoder_layer(lc: dict) -> int:
    D, F = lc["hidden_size"], lc["intermediate_size"]
    H, KV, Dh = lc["num_heads"], lc["num_kv_heads"], lc["head_dim"]
    return D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F + 2 * D


def head(lc: dict) -> int:
    return lc["hidden_size"] * lc["vocab_size"]


def tower(sc: dict) -> int:
    D, F, P = sc["hidden_size"], sc["intermediate_size"], sc["patch_size"]
    layer = 4 * (D * D + D) + 2 * D * F + F + D + 4 * D
    n_patch = (sc["image_size"] // P) ** 2
    return P * P * 3 * D + D + n_patch * D + sc["num_layers"] * layer + 2 * D


def dense_stack(dims) -> int:
    return sum(di * do + do for di, do in dims)
