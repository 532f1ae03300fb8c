"""A serving step's least time on the DeepSeek-V3 block (latent
attention, routed experts): the decode step at the rows that advance and
the batched prefill of an admission, from the sizes, the real lengths
and the experts each decode step's rows touched.

Parameters a token runs through (its active parameters): every layer's
attention (wq, wkv_a, wkv_b, wo and the norms), the leading dense layers'
FFN, and in each expert layer the router, the shared expert and
num_experts_per_tok routed experts; the head.

Decode step over rows of `lengths` keys, whose expert layers touched
`touched[m]` experts: FLOPs 2 * active parameters per row (the absorbed
form multiplies through W_UK and W_UV, as many as wkv_b holds) plus 2 * H
* (d_latent + d_v) per key per layer (kernel G); bytes every weight but
the experts', the touched experts' (3 * D * Fe each), each row's latent
rows read (d_latent bf16 values a key) and its new row written, every
layer.

Prefill of rows of real lengths n_i: FLOPs 2 * active parameters per
position, the causal pairs' 2 * H * (qk + v) per layer, and the head on
each row's last position; bytes every weight (a prompt's tokens touch
every expert) and the latent rows written.
"""


def _sizes(lc: dict):
    D, H, R = lc["hidden_size"], lc["num_heads"], lc["kv_lora_rank"]
    nope, rope, dv = (lc["qk_nope_head_dim"], lc["qk_rope_head_dim"],
                      lc["v_head_dim"])
    L, E, k = lc["num_layers"], lc["n_routed_experts"], lc[
        "num_experts_per_tok"]
    Fe = lc["moe_intermediate_size"]
    dense = lc["first_k_dense_replace"]
    attn = (D * H * (nope + rope) + D * (R + rope) + R
            + R * H * (nope + dv) + H * dv * D + 2 * D)
    ffn_dense = 3 * D * lc["intermediate_size"]
    shared = 3 * D * lc["n_shared_experts"] * Fe + D * E
    expert = 3 * D * Fe
    head = D * lc["vocab_size"]
    return dict(L=L, Lm=L - dense, E=E, k=k, H=H, attn=attn,
                ffn_dense=ffn_dense, shared=shared, expert=expert, head=head,
                dense=dense, lat=R + rope, lat_v=R, qk=nope + rope, v=dv)


def active_params(lc: dict) -> int:
    s = _sizes(lc)
    return (s["L"] * s["attn"] + s["dense"] * s["ffn_dense"]
            + s["Lm"] * (s["shared"] + s["k"] * s["expert"]) + s["head"])


def resident_params(lc: dict) -> int:
    """Every weight but the routed experts'."""
    s = _sizes(lc)
    return (s["L"] * s["attn"] + s["dense"] * s["ffn_dense"]
            + s["Lm"] * s["shared"] + s["head"])


def decode_step(lc: dict, lengths, touched):
    s = _sizes(lc)
    n, keys = len(lengths), sum(lengths)
    flops = (2 * active_params(lc) * n
             + s["L"] * 2 * s["H"] * (s["lat"] + s["lat_v"]) * keys)
    nbytes = (2 * resident_params(lc) + 2 * s["expert"] * sum(touched)
              + s["L"] * 2 * s["lat"] * (keys + n))
    return flops, nbytes


def prefill(lc: dict, lens):
    s = _sizes(lc)
    tokens = sum(lens)
    pairs = sum(n * (n + 1) // 2 for n in lens)
    flops = (2 * (active_params(lc) - s["head"]) * tokens
             + s["L"] * 2 * s["H"] * (s["qk"] + s["v"]) * pairs
             + 2 * s["head"] * len(lens))
    nbytes = (2 * (resident_params(lc) + s["Lm"] * s["E"] * s["expert"])
              + s["L"] * 2 * s["lat"] * tokens)
    return flops, nbytes
