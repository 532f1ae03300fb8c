"""The one generator of traffic: it reads a mix's parameters
(`benchmark/traffic/<mix>.json`) and makes requests or training samples.

Sizes and arrival gaps come from the mix's own `base_seed`, so every run
of a cell has the same set of sizes and gaps; the run's `--seed` puts them
in another order (serving: within blocks of a few requests; training:
within each step) and draws the content (token ids, pixels). That keeps
the work of a window, and where in the window it falls, the same from seed
to seed.
"""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np

from benchmark.consts import (BOS_ID, EOT_ID, IGNORE_INDEX, IM_END_ID,
                              IM_START_ID, IMAGE_SENTINEL)

# ordinary ids: above the low specials, below every special id the port
# knows (LLaMA-3's 128000+, the image ids)
ID_LO, ID_HI = 10, 120000


def rng_for(seed: int, *names) -> np.random.Generator:
    """A numpy generator keyed by a run seed (any size) and names."""
    key = [int(seed) % (2 ** 63)] + [zlib.crc32(str(n).encode())
                                     for n in names]
    return np.random.default_rng(key)


def lengths(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """n integer lengths from a clipped lognormal {median, sigma, min,
    max}."""
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def text_ids(rng: np.random.Generator, n: int) -> List[int]:
    return rng.integers(ID_LO, ID_HI, n).tolist()


# -- serving ------------------------------------------------------------------

def blocked_order(rng: np.random.Generator, n: int, block: int
                  ) -> np.ndarray:
    """A permutation of range(n) that shuffles only within consecutive
    blocks of `block`: the order changes, where in the window each block's
    work falls does not."""
    out = np.arange(n)
    for s in range(0, n, block):
        out[s:s + block] = s + rng.permutation(min(block, n - s))
    return out


def serve_plan(mix: dict, seed: int, seconds: float, tail_seconds: float
               ) -> List[Dict]:
    """Requests of an open loop: the window's requests (due in
    [0, seconds)) then those of `tail_seconds` more at the same rate (the
    load that keeps running while the window's requests finish). Each
    request: due (s from the window's start), prompt_len, max_new,
    image (bool), in_window (bool). Sizes and gaps are the base seed's,
    in the run seed's order within blocks of `arrivals.order_block`
    requests; within the window there are exactly round(rate * seconds)
    requests."""
    rate = float(mix["arrivals"]["rate_per_s"])
    block = int(mix["arrivals"]["order_block"])
    req = mix["requests"]
    out = []
    t0 = 0.0
    for part, span in (("window", seconds), ("tail", tail_seconds)):
        n = max(int(round(rate * span)), 1)
        base = rng_for(mix["base_seed"], part, n)
        gaps = base.exponential(1.0, n)
        plens = lengths(base, req["prompt_tokens"], n)
        outs = lengths(base, req["output_tokens"], n)
        n_img = int(round(req["image_share"] * n))
        images = base.permutation(n) < n_img
        order = rng_for(seed, "order", part)
        gaps = gaps[blocked_order(order, n, block)]
        # scaled so the n arrivals fill the span: the last one falls at
        # span * n / (n + 1), where the last of n uniform arrivals falls on
        # average
        gaps = gaps * (span * n / (n + 1)) / gaps.sum()
        perm = blocked_order(order, n, block)
        due = t0 + np.cumsum(gaps) - gaps[0]
        for i in range(n):
            j = perm[i]
            out.append(dict(due=float(due[i]), prompt_len=int(plens[j]),
                            max_new=int(outs[j]), image=bool(images[j]),
                            in_window=part == "window"))
        t0 += span
    return out


def prompt_for(seed: int, index: int, prompt_len: int, image: bool,
               k_image: int):
    """(prompt ids, image position or None) of request `index`: a bos,
    text, and for an image request K placeholder positions after the
    first tenth of the text (the port splices the image tokens there).
    An image request's prompt is its text plus the K image tokens."""
    rng = rng_for(seed, "prompt", index)
    ids = [BOS_ID] + text_ids(rng, prompt_len - 1)
    if not image:
        return np.asarray(ids, np.int32), None
    at = 1 + (prompt_len - 1) // 10
    ids = ids[:at] + [0] * k_image + ids[at:]
    return np.asarray(ids, np.int32), at


# -- training -----------------------------------------------------------------

def _kind_counts(mix: dict, rows: int) -> Dict[str, int]:
    kinds = mix["mix"]
    counts = {k["kind"]: int(round(k["share"] * rows)) for k in kinds}
    if sum(counts.values()) != rows:
        raise ValueError("the mix's shares do not give whole rows per step")
    return counts


def train_plan(mix: dict, steps: int) -> List[List[Dict]]:
    """`steps` optimizer steps of `rows` rows each (one row per
    microbatch), every step with the mix's kinds in their shares. Lengths
    come from the base seed; rows are dealt to steps longest first, each
    to the step with the fewest tokens so far among those with room for
    its kind, so that every step carries about the same real tokens, as a
    step of the recipe's 1,536-row global batch does."""
    rows = mix["microbatches"]
    counts = _kind_counts(mix, rows)
    base = rng_for(mix["base_seed"], "train", steps)
    pool = []
    for spec in mix["mix"]:
        n = counts[spec["kind"]] * steps
        for _ in range(n):
            pool.append(_draw_row(base, spec))
    pool.sort(key=lambda r: -r["length"])
    plan = [[] for _ in range(steps)]
    totals = [0] * steps
    for row in pool:
        room = [s for s in range(steps)
                if sum(r["kind"] == row["kind"] for r in plan[s])
                < counts[row["kind"]]]
        s = min(room, key=lambda i: (totals[i], i))
        plan[s].append(row)
        totals[s] += row["length"]
    return plan


def _draw_row(rng: np.random.Generator, spec: dict) -> Dict:
    kind = spec["kind"]
    if kind == "image_qa":
        q = int(lengths(rng, spec["question"], 1)[0])
        a = int(lengths(rng, spec["answer"], 1)[0])
        return dict(kind=kind, question=q, answer=a, length=q + a)
    if kind == "visual_generation":
        p = int(lengths(rng, spec["prompt"], 1)[0])
        return dict(kind=kind, prompt=p, length=p)
    if kind == "text_only":
        n = int(lengths(rng, spec["length"], 1)[0])
        p = max(int(n * spec["prompt_share"]), 1)
        return dict(kind=kind, prompt=p, answer=n - p, length=n)
    raise ValueError(f"unknown sample kind {kind!r}")


def sample(row: Dict, seed: int, index: int, image_size: int) -> Dict:
    """One raw training sample of a planned row, as the port's dataset
    yields them: input_ids with IMAGE_SENTINEL where an image goes,
    labels (IGNORE_INDEX on the prompt), and pixels ([1, S, S, 3]
    normalised floats, or None). The ids and pixels come from the run's
    seed and the row's index."""
    rng = rng_for(seed, "sample", index)
    kind = row["kind"]
    pixels = None
    if kind == "image_qa":
        prompt = [BOS_ID, IMAGE_SENTINEL] + text_ids(rng, row["question"])
        answer = text_ids(rng, row["answer"]) + [EOT_ID]
        ids = prompt + answer
        labels = [IGNORE_INDEX] * len(prompt) + answer
        pixels = rng.uniform(-1, 1, (1, image_size, image_size, 3))
    elif kind == "visual_generation":
        prompt = [BOS_ID] + text_ids(rng, row["prompt"])
        answer = [IM_START_ID, IMAGE_SENTINEL, IM_END_ID, EOT_ID]
        ids = prompt + answer
        labels = ([IGNORE_INDEX] * len(prompt)
                  + [IM_START_ID, IGNORE_INDEX, IM_END_ID, EOT_ID])
        pixels = rng.uniform(-1, 1, (1, image_size, image_size, 3))
    else:
        prompt = [BOS_ID] + text_ids(rng, row["prompt"])
        answer = text_ids(rng, row["answer"]) + [EOT_ID]
        ids = prompt + answer
        labels = [IGNORE_INDEX] * len(prompt) + answer
    if pixels is not None:
        pixels = pixels.astype(np.float32)
    return dict(input_ids=ids, labels=labels, pixels=pixels, kind=kind)
