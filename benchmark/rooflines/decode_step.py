"""A serving step's least time: the decode step, the batched prefill of
an admission, and an image's encode, from the shapes and real lengths.

Decode step over the rows that advance (`lengths`: each such row's keys
after its write): FLOPs 2 * (decoder + head parameters) per row, plus
4 * H * Dh per key per layer; bytes: the decoder's and the head's weights
read once (bf16), each row's keys and values read and its new entry
written (bf16, KV heads, every layer).

Prefill of rows of real lengths n_i: FLOPs 2 * decoder parameters per
position plus the causal pairs' 4 * H * Dh per layer, and the head on
each row's last position; bytes: the weights once and the cache entries
written.

Image encode (tower, reduction, projector) of one 384 px image: FLOPs of
the tower's products over its 729 tokens (attention 4 * T^2 * D per
layer) and the projector's over the K tokens; bytes: the tower's and the
projector's weights (bf16) once per call.
"""

from benchmark.rooflines import model


def decode_step(lc: dict, lengths):
    L, H, KV, Dh = (lc["num_layers"], lc["num_heads"], lc["num_kv_heads"],
                    lc["head_dim"])
    dense = L * model.decoder_layer(lc) + model.head(lc)
    n, keys = len(lengths), sum(lengths)
    flops = 2 * dense * n + L * 4 * H * Dh * keys
    nbytes = 2 * dense + L * 2 * 2 * KV * Dh * (keys + n)
    return flops, nbytes


def prefill(lc: dict, lens):
    L, H, KV, Dh = (lc["num_layers"], lc["num_heads"], lc["num_kv_heads"],
                    lc["head_dim"])
    layers = L * model.decoder_layer(lc)
    tokens = sum(lens)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = (2 * layers * tokens + L * 4 * H * Dh * pairs
             + 2 * model.head(lc) * len(lens))
    nbytes = 2 * (layers + model.head(lc)) + L * 2 * 2 * KV * Dh * tokens
    return flops, nbytes


def tower_flops(sc: dict, n_images: int) -> int:
    """The tower's forward over n images: its products over the 729
    tokens of each, attention 4 * T^2 * D per layer."""
    D, F, P = sc["hidden_size"], sc["intermediate_size"], sc["patch_size"]
    T = (sc["image_size"] // P) ** 2
    per_token = P * P * 3 * D + sc["num_layers"] * (4 * D * D + 2 * D * F)
    return n_images * (2 * per_token * T + sc["num_layers"] * 4 * T * T * D)


def image_encode(cfg: dict, n_images: int = 1):
    sc, lc = cfg["siglip"], cfg["llama"]
    D = lc["hidden_size"]
    proj = [(sc["hidden_size"], D), (D, D)]
    K = cfg["mm"]["num_image_tokens"]
    flops = (tower_flops(sc, n_images)
             + n_images * 2 * K * sum(a * b for a, b in proj))
    nbytes = 2 * (model.tower(sc) + model.dense_stack(proj))
    return flops, nbytes
