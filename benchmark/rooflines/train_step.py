"""A training step's model FLOPs: what the real tokens need, counting
neither recompute nor padding.

Per real position, 6 * the trained dense parameters (the decoder's
layers and its head: forward 2, backward 4); causal attention over the
real pairs, 12 * H * Dh per pair per layer (forward 4, backward 8); the
vision head on each answer-image target (6 * its parameters); the
projector on each real image's K tokens (6 * its parameters); and the
frozen tower's forward over each real image.
"""

from benchmark.rooflines import decode_step, model


def model_flops(cfg: dict, lens, images: int, ar_targets: int) -> float:
    lc, sc = cfg["llama"], cfg["siglip"]
    L, H, Dh = lc["num_layers"], lc["num_heads"], lc["head_dim"]
    D, Dv = lc["hidden_size"], sc["hidden_size"]
    K = cfg["mm"]["num_image_tokens"]
    dense = L * model.decoder_layer(lc) + model.head(lc)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    vhead = model.dense_stack([(D, D), (D, Dv)])
    proj = model.dense_stack([(Dv, D), (D, D)])
    return (6 * dense * sum(lens) + 12 * L * H * Dh * pairs
            + 6 * vhead * ar_targets + 6 * proj * K * images
            + decode_step.tower_flops(sc, images))
