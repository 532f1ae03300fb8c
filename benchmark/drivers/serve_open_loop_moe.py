"""Driver of a serving cell on the DeepSeek-V3 block (latent attention,
routed experts): the open loop of `serve_open_loop.py` (its `measure`,
`_warm` and `_engine`, by import; `measure` picks the requests to
judge), with the block's seeded weights (`benchmark/weights_mla_moe.py`)
and its plain reference (`benchmark/reference/mla_moe.py`) as the judge.

The engine reports each plain tick's expert picks per (step, expert
layer, expert) when the next tick harvests its snapshot (`ServeEngine.
routes`). `eng.step` is wrapped to note them, and each traced tick's
record gets its own as `routes`. In `--trace 1` runs the program's
tracer is on for the window, and its spans (a `model.moe` span per
expert layer of each admission among them) go to `records` as
`program_spans`.

The engine also logs every position's picks (`ServeEngine.log_routes`),
and each finished request brings its own: the reference follows them
over the checked requests (`reference/mla_moe.py`), and the judge reads
the widest gap of a served token ("logit_gap_max") and of a pick
("route_gap_max") below the reference's best.
"""

from __future__ import annotations

import gc
import time

from benchmark import weights_mla_moe as wl
from benchmark.drivers import serve_open_loop as base
from benchmark.drivers.serve_open_loop import _engine, _warm, measure


class Session(base.Session):
    """`serve_open_loop.Session` on the block's weights; `routes` holds
    (host ns at each `step()` call, the expert counts it harvested)."""

    def __init__(self, ctx):
        torch = ctx.torch
        from metamorph_tpu_torch.config import MetaMorphConfig
        from metamorph_tpu_torch.models.metamorph import (MetaMorph,
                                                          encode_images)

        self.ctx, dev = ctx, ctx.device
        if dev.type == "cuda":
            torch.set_num_threads(1)
        self.mmcfg = mmcfg = MetaMorphConfig.from_dict(ctx.config)
        with torch.no_grad():
            self.model = MetaMorph(mmcfg, dtype=torch.bfloat16, device=dev)
            wl.fill_model_(self.model, ctx.config, ctx.seed)
        self.model.requires_grad_(False)
        self.stream = {}

        def on_token(uid, ids):
            now = time.perf_counter()
            s = self.stream.setdefault(uid, [now, now, 0, []])
            s[1] = now
            s[2] += len(ids)
            s[3].append((now, len(ids)))

        def encode(px):
            with torch.no_grad():
                return encode_images(self.model, mmcfg, px)[0]

        self.encode = encode
        self.eng = eng = _engine(ctx, self.model, mmcfg, on_token)
        eng.log_routes()
        self.routes = []          # (ns at each step() call, counts)
        self.picks = {}           # prompt ids' bytes -> the request's picks
        submit, step = eng.submit, eng.step
        uid_of = {}

        def submit_noting_prompts(req):
            submit(req)
            uid_of[req.uid] = req.prompt_ids.tobytes()

        def step_noting_routes():
            t = time.perf_counter_ns()
            step()
            self.routes.append((t, eng.routes))
            for c in eng.completed:     # `run()` keeps them until its end
                key = uid_of.pop(c.uid, None)
                if key is not None:
                    self.picks[key] = c.routes

        eng.submit = submit_noting_prompts
        eng.step = step_noting_routes
        _warm(ctx, self.eng, self.model, mmcfg, self.pixels(1, "warm"),
              encode)
        self.stream.clear()
        self.routes.clear()
        self.picks.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            gc.collect()
            gc.freeze()


def attach_routes(ticks, noted) -> None:
    """Give each traced tick the expert counts of its decode steps: those
    the next `step()` call harvested (as nested lists [step][layer][E])."""
    starts = [t for t, _ in noted]
    for tick in ticks:
        if not tick["traced"]:
            continue
        k = next((i for i, t in enumerate(starts)
                  if tick["t0"] <= t <= tick["t1"]), None)
        nxt = noted[k + 1][1] if k is not None and k + 1 < len(noted) \
            else None
        tick["routes"] = nxt.tolist() if nxt is not None else None


def run(ctx) -> dict:
    from metamorph_tpu_torch.utils import trace

    sess = Session(ctx)
    ctx.log(f"set-up done: {sess.eng.n_slots} slots x {sess.eng.S}")
    sess.routes.clear()
    if ctx.trace:
        trace.enable()
    try:
        res = measure(ctx, sess, ctx.traffic, ctx.seconds, ctx.trace)
    finally:
        spans = trace.drain()
        trace.disable()
    attach_routes(res["records"]["ticks"], sess.routes)
    if ctx.trace:
        res["records"]["program_spans"] = spans
    checked = res["checked"]
    for c in checked:
        c["routes"] = sess.picks[c["prompt_ids"].tobytes()]
    sess.routes.clear()
    sess.picks.clear()
    sess.free()
    res["judge"] = lambda modes=("fp32",): judge(ctx, checked, modes)
    return res


def judge(ctx, checked, modes=("fp32",)) -> dict:
    """`serve_open_loop.judge` with this block's reference, which follows
    the program's picks: the widest gap of a served token's reference
    logit below the reference's best ("logit_gap_max") and of a pick's
    biased score below the reference's k-th best ("route_gap_max"); per
    lower precision in `modes`, following the same picks, the widest gap
    of the token that precision puts first and of the picks it would
    make itself ("control_gap_max_<mode>", "control_route_gap_max_<mode>")."""
    torch = ctx.torch
    from benchmark.reference import mla_moe as ref
    from benchmark.reference.precision import fp32_only
    from benchmark.reference.serve import gaps

    fp32_only()
    if not checked:
        return {"logit_gap_max": float("inf"), "served_tokens": 0}
    W = wl.weights(ctx.config, ctx.seed, ctx.device, torch.bfloat16)
    seen = [[] for _ in checked]
    lg = ref.served_logits(W, ctx.config, checked, "fp32", seen)
    out = {"logit_gap_max": max(gaps(lg, [c["served"] for c in checked])),
           "route_gap_max": max(
               [ref.route_gap(choice, pk) for s, c in zip(seen, checked)
                for (choice, _), pk in zip(s, _picks(c, ctx))] or [0.0]),
           "served_tokens": sum(len(c["served"]) for c in checked)}
    for mode in modes:
        if mode == "fp32":
            continue
        low_seen = [[] for _ in checked]
        low = ref.served_logits(W, ctx.config, checked, mode, low_seen)
        firsts = [l.argmax(dim=-1) for l in low]
        out[f"control_gap_max_{mode}"] = max(gaps(lg, firsts))
        out[f"control_route_gap_max_{mode}"] = max(
            [ref.route_gap(choice, own) for s, ls in zip(seen, low_seen)
             for (choice, _), (_, own) in zip(s, ls)] or [0.0])
    return out


def _picks(c: dict, ctx) -> list:
    """The program's picks of a checked request, by expert layer, over the
    positions the reference runs (the prompt and the served tokens but
    the last)."""
    T = len(c["prompt_ids"]) + len(c["served"]) - 1
    pk = ctx.torch.as_tensor(c["routes"][:T], device=ctx.device)
    return [pk[:, m] for m in range(pk.shape[1])]
