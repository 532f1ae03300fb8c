"""Driver of a serving cell: an open loop of requests into the port's
`ServeEngine`, driven as the HTTP front end's scheduler thread drives it
(submit what has arrived, then `step()` while work exists), with images
through the port's own tower and projector (`encode_images`) before
`submit`, inside the timed path.

Each request is timed from when it was due, so a stall delays the
requests behind it. Its tokens are timed when the engine streams them
(`on_token`). After the window closes, arrivals go on at the same rate
until every request due in the window has finished (or a cap passes);
those later requests are load, not measured.

Then the engine is freed and the plain reference judges a sample of the
finished requests (`benchmark/reference/serve.py`).
"""

from __future__ import annotations

import gc
import time
import zlib

import numpy as np

from benchmark import stats, traffic
from benchmark.consts import IM_START_ID
from benchmark.runtime import Spans
from benchmark.weights import fill_model_, weights

WARM_NEW = 2          # tokens per warm-up request


def _engine(ctx, model, mmcfg, on_token):
    from metamorph_tpu_torch.inference.serve import ServeEngine

    e = ctx.traffic["engine"]
    return ServeEngine(model, mmcfg, n_slots=e["n_slots"],
                       max_cache_len=e["max_cache_len"],
                       max_new_tokens_cap=e["max_new_tokens_cap"],
                       steps_per_sync=e["steps_per_sync"], seed=0,
                       on_token=on_token)


def _warm(ctx, eng, model, mmcfg, pixels, encode):
    """Every prefill bucket the mix can reach, for text and image
    requests, at the largest batch the engine admits at once (8) and at 1;
    then decode ticks. Nothing of the port compiles per shape; this grows
    the allocator's pool and settles the library's choices."""
    from metamorph_tpu_torch.inference.serve import Request

    req = ctx.traffic["requests"]
    K = mmcfg.mm.num_image_tokens
    top = req["prompt_tokens"]["max"] + K + 1
    rng = traffic.rng_for(ctx.seed, "warm")
    n = 0
    for b in eng.prefill_buckets:
        size = min(b, eng.S - WARM_NEW - 1)
        for batch, image in ((8, False), (1, False), (1, True)):
            if image and size < 2 * K:
                continue
            for _ in range(batch):
                ids = rng.integers(traffic.ID_LO, traffic.ID_HI, size)
                kw = {}
                if image:
                    ids[1:1 + K] = 0
                    kw = dict(image_embeds=encode(pixels[:1]),
                              image_positions=np.array([1], np.int32))
                eng.submit(Request(prompt_ids=ids.astype(np.int32),
                                   max_new_tokens=WARM_NEW,
                                   uid=f"warm{n}", **kw))
                n += 1
        eng.run()
        if b >= top:
            break
    for _ in range(3):
        eng.submit(Request(prompt_ids=np.arange(10, 40, dtype=np.int32),
                           max_new_tokens=3 * eng.steps_per_sync,
                           uid=f"warm{n}"))
        n += 1
    eng.run()
    eng.completed.clear()


class Session:
    """The set-up of a serving run: the weights in the port's modules, the
    engine, and the stream of tokens the engine reports."""

    def __init__(self, ctx):
        torch = ctx.torch
        from metamorph_tpu_torch.config import MetaMorphConfig
        from metamorph_tpu_torch.kernels._build import LIBRARY
        from metamorph_tpu_torch.models.metamorph import (MetaMorph,
                                                          encode_images)

        self.ctx, dev = ctx, ctx.device
        if dev.type == "cuda":
            # the tick is bound by the host's launches: one thread for the
            # few CPU ops, so no idle worker spins beside the launching one
            torch.set_num_threads(1)
        self.mmcfg = mmcfg = MetaMorphConfig.from_dict(ctx.config)
        with torch.no_grad():
            self.model = MetaMorph(mmcfg, dtype=torch.bfloat16, device=dev)
            fill_model_(self.model, ctx.config, ctx.seed)
        self.model.requires_grad_(False)
        self.stream = {}          # uid -> [t_first, t_last, n, [(t, n)]]

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
        self.eng = _engine(ctx, self.model, mmcfg, on_token)
        if dev.type == "cuda":
            LIBRARY.get()
        _warm(ctx, self.eng, self.model, mmcfg, self.pixels(1, "warm"),
              encode)
        self.stream.clear()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            # what set-up made lives to the end: out of the collector's
            # full passes, which would otherwise walk it inside the window
            gc.collect()
            gc.freeze()

    def pixels(self, n: int, name: str):
        """n normalised 384 px images drawn on the card from the seed."""
        torch, S = self.ctx.torch, self.mmcfg.siglip.image_size
        gen = torch.Generator(device=self.ctx.device)
        gen.manual_seed((int(self.ctx.seed) * 1_000_003
                         + zlib.crc32(name.encode())) % (2 ** 63))
        return torch.rand((max(n, 1), S, S, 3), generator=gen,
                          device=self.ctx.device) * 2 - 1

    def free(self):
        del self.eng, self.model, self.encode
        gc.unfreeze()
        gc.collect()
        if self.ctx.device.type == "cuda":
            self.ctx.torch.cuda.empty_cache()


def run(ctx) -> dict:
    sess = Session(ctx)
    ctx.log(f"set-up done: {sess.eng.n_slots} slots x {sess.eng.S}")
    res = measure(ctx, sess, ctx.traffic, ctx.seconds, ctx.trace)
    sess.free()
    checked = res["checked"]
    res["judge"] = lambda modes=("fp32",): judge(ctx, checked, modes)
    return res


def measure(ctx, sess, mix, seconds, trace) -> dict:
    """One window of the open loop at the mix's rate, until every request
    due in it has finished (or the cap); returns the readings, the records
    of the per-layer metrics and the requests to judge."""
    torch = ctx.torch
    from metamorph_tpu_torch.inference.serve import Request

    dev, seed, eng, encode = ctx.device, ctx.seed, sess.eng, sess.encode
    K = sess.mmcfg.mm.num_image_tokens
    plan = traffic.serve_plan(mix, seed, seconds, mix["tail_seconds"])
    pixels = sess.pixels(sum(r["image"] for r in plan),
                         f"window{mix['arrivals']['rate_per_s']}")
    if eng.pending or any(u is not None for u in eng.slot_uid):
        eng.run()                 # the last window's load, unmeasured
    eng.completed.clear()
    stream = sess.stream
    stream.clear()
    # -- the window ----------------------------------------------------------
    spans = Spans()
    ticks = []
    prompts = {}
    img_index = {}
    due_abs = {}
    submitted_at = {}
    refused = set()
    in_window = [i for i, r in enumerate(plan) if r["in_window"]]
    done = {}
    tr_cfg = mix.get("trace", {})
    tracer = None
    if trace:
        from benchmark.trace import DeviceTrace
        tracer = DeviceTrace(torch)
        tracer.warm()
    tr_start = tr_cfg.get("start_frac", 0.4) * seconds
    tr_max = tr_cfg.get("max_seconds", 8.0)
    tr_ticks = tr_cfg.get("min_ticks", 8)
    tracing = False
    traced = False
    nxt = 0
    t0 = time.perf_counter()
    ctx.mark_measured(t0)
    t_close = t0 + seconds
    cap = t_close + mix["drain_cap_seconds"]
    counts0 = dict(eng.tick_counts)
    backlog = None
    while True:
        now = time.perf_counter()
        # arrivals: encode images, then submit
        while nxt < len(plan) and t0 + plan[nxt]["due"] <= now:
            r = plan[nxt]
            ids, at = traffic.prompt_for(seed, nxt, r["prompt_len"],
                                         r["image"], K)
            prompts[nxt] = (ids, at)
            kw = {}
            s0 = time.perf_counter_ns()
            if at is not None:
                img_index[nxt] = len(img_index)
                j = img_index[nxt]
                kw = dict(image_embeds=encode(pixels[j:j + 1]),
                          image_positions=np.array([at], np.int32))
            try:
                eng.submit(Request(prompt_ids=ids, max_new_tokens=r["max_new"],
                                   uid=nxt, **kw))
            except ValueError as e:
                refused.add(nxt)
                ctx.log(f"request {nxt} refused: {e}")
            spans.add("submit", s0, time.perf_counter_ns(), uid=nxt,
                      image=at is not None)
            due_abs[nxt] = t0 + r["due"]
            submitted_at[nxt] = time.perf_counter()
            nxt += 1
        now = time.perf_counter()
        if now >= t_close and backlog is None:
            backlog = (len(eng.pending),
                       sum(u is not None for u in eng.slot_uid))
        if all(i in done or i in refused for i in in_window) \
                and now >= t_close:
            break
        if now >= cap:
            break
        if tracer is not None and not traced:
            # the slice: from start_frac of the window until it holds
            # min_ticks ticks, or max_seconds have passed, or the window
            # closes
            if not tracing and now - t0 >= tr_start:
                tracer.start()
                tracing, t_tr, n_tr = True, time.perf_counter(), len(ticks)
            elif tracing and (len(ticks) - n_tr >= tr_ticks
                              or now - t_tr >= tr_max or now >= t_close):
                tracer.stop()
                tracing, traced = False, True
                ctx.log(f"traced {len(ticks) - n_tr} ticks in "
                        f"{tracer.window_s:.2f} s")
        busy = bool(eng.pending or any(u is not None for u in eng.slot_uid))
        if not busy:
            wait = (t0 + plan[nxt]["due"] - now) if nxt < len(plan) else 0.01
            s0 = time.perf_counter_ns()
            time.sleep(max(min(wait, 0.05), 0))
            spans.add("idle", s0, time.perf_counter_ns())
            continue
        before = dict(eng.tick_counts)
        pending_before = [q.uid for q in eng.pending]
        lens0 = (eng.state.cache_lens.tolist() if tracing else None)
        s0 = time.perf_counter_ns()
        eng.step()
        s1 = time.perf_counter_ns()
        lens1 = (eng.state.cache_lens.tolist() if tracing else None)
        admitted = [(s, u) for s, u in enumerate(eng.slot_uid)
                    if u in pending_before]
        ticks.append(dict(
            t0=s0, t1=s1, traced=tracing, lens0=lens0, lens1=lens1,
            steps=eng.steps_per_sync if (
                eng.tick_counts["plain"] > before["plain"]) else 0,
            prefill=eng.tick_counts["prefill"] - before["prefill"],
            admitted=[(s, len(prompts[u][0]), prompts[u][1] is not None)
                      for s, u in admitted]))
        spans.add("tick", s0, s1)
        for c in eng.completed:
            done[c.uid] = c
        eng.completed.clear()
    if tracing:
        tracer.stop()
        traced = True
    t_end = time.perf_counter()
    counts = {k: eng.tick_counts[k] - counts0[k] for k in counts0}
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)

    # -- end-to-end readings --------------------------------------------------
    ttft, gaps, missing = [], [], 0
    for i in in_window:
        s = stream.get(i)
        if s is None or i not in done:
            # refused, or unfinished at the cap: missing, its first token
            # counted when it came or, without one, when the run stopped
            missing += 1
            ttft.append((s[0] if s else t_end) - due_abs[i])
            continue
        ttft.append(s[0] - due_abs[i])
        if s[2] > 1:
            # (last token's time in ns, mean gap after the first token)
            gaps.append((s[1] * 1e9, (s[1] - s[0]) / (s[2] - 1)))
    out_tokens = sum(n for s in stream.values() for t, n in s[3]
                     if t0 <= t < t_close)
    late = [submitted_at[i] - due_abs[i] for i in in_window
            if i in submitted_at]
    e2e = {"ttft_p90_ms": stats.percentile(ttft, 90) * 1e3,
           "out_tok_per_s": out_tokens / seconds}
    ctx.log(f"window {seconds} s (+{t_end - t_close:.1f} s to finish): "
            f"{len(in_window)} due, {len(done)} finished, {missing} missing; "
            f"ttft median {stats.percentile(ttft, 50) * 1e3:.1f} ms "
            f"(n={len(ttft)}), token gap median "
            f"{stats.percentile([g for _, g in gaps], 50) * 1e3:.2f} ms, p90 "
            f"{stats.percentile([g for _, g in gaps], 90) * 1e3:.2f} ms "
            f"(n={len(gaps)}), "
            f"{out_tokens} tokens in the window; ticks {counts}; generator "
            f"late median {stats.percentile(late, 50) * 1e3:.1f} ms, max "
            f"{max(late) * 1e3:.1f} ms")
    records = dict(
        kind="serve", config=ctx.config, ticks=ticks, spans=spans.items,
        queue=[(submitted_at[i] * 1e9, done[i].queue_s) for i in in_window
               if i in done],
        gaps=gaps,
        trace=tracer.record() if traced else None)
    result = dict(attempted=len(in_window), failed=missing, e2e=e2e,
                  records=records, memory_peak_bytes=peak,
                  tracer=tracer if traced else None, spans=spans.items,
                  sweep=dict(due=len(in_window), finished=len(done),
                             missing=missing, ttft_p50_ms=stats.percentile(
                                 ttft, 50) * 1e3,
                             pending_at_close=(backlog or (0, 0))[0],
                             busy_slots_at_close=(backlog or (0, 0))[1],
                             finish_after_close_s=t_end - t_close,
                             ticks=counts))

    # -- the comparison --------------------------------------------------------
    finished = [i for i in in_window if i in done]
    picks = pick_checked(finished, done, seed, mix["check"]["requests"],
                         images={i for i in finished
                                 if prompts[i][1] is not None})
    checked = []
    for i in picks:
        ids = [int(t) for t in done[i].ids]
        if IM_START_ID in ids:          # the image the row then generates
            ids = ids[:ids.index(IM_START_ID) + 1]
        p_ids, at = prompts[i]
        checked.append(dict(prompt_ids=p_ids, image_at=at, served=ids,
                            pixels=(pixels[img_index[i]:img_index[i] + 1]
                                    .clone() if at is not None else None)))
    result["checked"] = checked
    return result


def pick_checked(finished, done, seed, n, images=()):
    """The requests to judge: the one with the most served tokens, the
    image request with the most (where one finished and the first is
    none), so that the tower and the splice are always judged, and more
    drawn from the seed up to n."""
    if not finished:
        return []

    def most(pool):
        return max(pool, key=lambda i: (len(done[i].ids), -i))

    picks = [most(finished)]
    with_image = [i for i in finished if i in images]
    if with_image and picks[0] not in images:
        picks.append(most(with_image))
    rest = [i for i in finished if i not in picks]
    rng = traffic.rng_for(seed, "check")
    more = rng.choice(len(rest), max(min(n - len(picks), len(rest)), 0),
                      replace=False) if rest else []
    return picks + [rest[j] for j in sorted(more)]


def judge(ctx, checked, modes=("fp32",)) -> dict:
    """The reference's readings over the checked requests: the widest gap
    of a served token below the reference's best ("logit_gap_max"), and
    for each lower precision in `modes`, the widest gap of the token that
    precision puts first ("control_gap_max_<mode>")."""
    torch = ctx.torch
    from benchmark.reference import serve as ref
    from benchmark.reference.precision import fp32_only

    fp32_only()
    if not checked:
        return {"logit_gap_max": float("inf"), "served_tokens": 0}
    W = weights(ctx.config, ctx.seed, ctx.device, torch.bfloat16)
    lg = ref.served_logits(W, ctx.config, checked, "fp32")
    out = {"logit_gap_max": max(ref.gaps(lg, [c["served"]
                                              for c in checked])),
           "served_tokens": sum(len(c["served"]) for c in checked)}
    for mode in modes:
        if mode == "fp32":
            continue
        low = ref.served_logits(W, ctx.config, checked, mode)
        firsts = [l.argmax(dim=-1) for l in low]
        out[f"control_gap_max_{mode}"] = max(ref.gaps(lg, firsts))
    return out
