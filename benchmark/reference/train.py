"""Plain reference of the stage-2 train step: MetaMorph's dual loss (text
cross-entropy on next tokens, plus the cosine loss of the vision head's
predicted visual tokens against the frozen tower's features of each
answer image) over gradient-accumulated microbatches, the recipe's global
norm clip, and AdamW with the warmup-cosine schedule.

float32 arithmetic with TF32 off; the weights and both Adam moments are
stored in bfloat16, as the configuration states (`param_dtype`), so each
update is rounded to bfloat16 as the program's is. Each microbatch is one
row, packed here from the raw sample (no padding: a causal row's real
positions never see the padding after them). The tower is frozen.

It fits beside nothing else on the card: 8B weights (16 GB) and two
moments (32 GB) in bfloat16, and per step two passes over the layers,
layer by layer. The first pass forms every gradient (float32, one layer at
a time, the microbatches summed) and keeps only the sum of squares; the
second forms them again and applies the clipped update to each layer as
soon as its gradient is whole, which the layers below it no longer need.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.consts import IGNORE_INDEX, IM_START_ID, IMAGE_SENTINEL
from benchmark.reference import decoder as dec
from benchmark.reference import vision as vis
from benchmark.reference.precision import matmul
from benchmark.weights import groups, weights

CE_BLOCK = 512
TRAINABLE = ("llama.", "projector.", "vision_head.")


def lr_at(tc: dict, count: int) -> float:
    """optax's warmup_cosine_decay_schedule(0, lr, warmup, total, 0)."""
    lr = tc["learning_rate"]
    warmup = max(int(tc["total_steps"] * tc["warmup_ratio"]), 1)
    if count < warmup:
        return lr * count / warmup
    decay = max(tc["total_steps"], warmup + 1) - warmup
    c = min(count - warmup, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * c / decay))


def expand(sample: dict, K: int, T: int) -> dict:
    """A raw sample as one row: each image sentinel becomes K image
    positions (an answer image where the label before it is
    <image_start>), its label dropped; truncated at T; then the targets of
    each position t are token t + 1's."""
    ids, labels = sample["input_ids"], sample["labels"]
    tok, lab, img, ans = [], [], [], []
    for i, t in enumerate(ids):
        if t == IMAGE_SENTINEL:
            answer = i > 0 and labels[i - 1] == IM_START_ID
            for j in range(K):
                tok.append(0), lab.append(IGNORE_INDEX), img.append(j)
                ans.append(answer)
        else:
            tok.append(t), lab.append(labels[i]), img.append(-1)
            ans.append(False)
    tok, lab, img, ans = tok[:T], lab[:T], img[:T], ans[:T]
    L = len(tok)
    nxt_lab = lab[1:] + [IGNORE_INDEX]
    nxt_ar = [ans[t + 1] if t + 1 < L else False for t in range(L)]
    nxt_img = [img[t + 1] if t + 1 < L else -1 for t in range(L)]
    return dict(tokens=tok, img=img, labels=nxt_lab, ar=nxt_ar,
                ar_img=nxt_img, pixels=sample["pixels"], length=L)


class RefTrainer:
    """The reference's train state (weights drawn anew from the seed) and
    its step over a list of raw samples, one per microbatch."""

    def __init__(self, cfg: dict, seed: int, device, mode: str = "fp32",
                 dtype=torch.bfloat16):
        self.cfg, self.mode, self.device = cfg, mode, device
        self.lc, self.tc = cfg["llama"], cfg["train"]
        self.W = weights(cfg, seed, device, dtype)
        self.names = [n for n in self.W if n.startswith(TRAINABLE)]
        self.mu = {n: torch.zeros_like(self.W[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(self.W[n]) for n in self.names}
        self.count = 0

    # -- one pass over the layers ------------------------------------------

    def _pass(self, rows: List[dict], feats: List, apply) -> float:
        """Forward and backward of the accumulated loss; each whole
        float32 gradient goes to apply(name, grad). Returns the loss."""
        cfg, W, lc, mode = self.cfg, self.W, self.lc, self.mode
        dev = self.device
        R = len(rows)
        proj_p = {n: W[n].detach().float().requires_grad_()
                  for n in self.W if n.startswith("projector.")}
        x0s, projs, toks, pos = [], [], [], []
        for r, row in enumerate(rows):
            tok = torch.tensor(row["tokens"], device=dev)
            img = torch.tensor(row["img"], device=dev)
            x = dec.embed(W, tok)
            proj = None
            if feats[r] is not None:
                proj = vis.project(W, cfg, feats[r], mode, proj_p)[0]
                x = torch.where((img >= 0)[:, None],
                                proj.detach()[img.clamp_min(0)], x)
            x0s.append(x)
            projs.append(proj)
            toks.append((tok, img))
            pos.append(torch.arange(row["length"], device=dev))
        # forward, keeping each layer's input
        inputs = []
        xs = x0s
        with torch.no_grad():
            for l in range(lc["num_layers"]):
                inputs.append(xs)
                w = dec.layer_weights(W, l)
                xs = [dec.layer(x, w, lc, p, mode) for x, p in zip(xs, pos)]
        # the head: cross-entropy and the vision loss, block by block
        head_p = {"llama.final_norm": W["llama.final_norm"].detach().float()}
        head_name = ("llama.embed" if lc.get("tie_word_embeddings")
                     else "llama.lm_head")
        head_p[head_name] = W[head_name].detach().float()
        head_p.update({n: W[n].detach().float() for n in W
                       if n.startswith("vision_head.")})
        for t in head_p.values():
            t.requires_grad_()
        lm = (head_p[head_name].T if lc.get("tie_word_embeddings")
              else head_p[head_name])
        coef = cfg["mm"]["vision_coef"] if cfg["mm"]["use_vision_ar"] else 0.0
        loss = 0.0
        grads = []
        for r, row in enumerate(rows):
            xL = xs[r].detach().requires_grad_()
            labels = torch.tensor(row["labels"], device=dev)
            ar = torch.tensor(row["ar"], device=dev)
            ar_img = torch.tensor(row["ar_img"], device=dev)
            n_text = max(int((labels != IGNORE_INDEX).sum()), 1)
            n_ar = max(int(ar.sum()), 1)
            for s in range(0, row["length"], CE_BLOCK):
                e = min(s + CE_BLOCK, row["length"])
                h = dec.rms_norm(xL[s:e], head_p["llama.final_norm"],
                                 lc["rms_norm_eps"])
                lab = labels[s:e]
                valid = lab != IGNORE_INDEX
                logp = torch.log_softmax(matmul(h, lm, mode), dim=-1)
                ce = -logp.gather(-1, lab.clamp_min(0)[:, None])[:, 0]
                term = (ce * valid).sum() / n_text
                m = ar[s:e]
                if coef and bool(m.any()):
                    pred = vis.vision_head(W, cfg, h[m], mode, head_p)
                    tgt = feats[r][0, ar_img[s:e][m]]
                    tgt = tgt / tgt.norm(dim=-1, keepdim=True).clamp_min(1e-12)
                    term = term + coef * (-(pred * tgt).sum(-1)).sum() / n_ar
                (term / R).backward()
                loss += float(term.detach()) / R
            grads.append(xL.grad)
        for name, t in head_p.items():
            apply(name, t.grad if t.grad is not None
                  else torch.zeros_like(t))
        del head_p, lm
        # the layers, top down
        for l in reversed(range(lc["num_layers"])):
            w = {k: v.requires_grad_() for k, v in
                 dec.layer_weights(W, l).items()}
            for r in range(R):
                x = inputs[l][r].detach().requires_grad_()
                dec.layer(x, w, lc, pos[r], mode).backward(grads[r])
                grads[r] = x.grad
            inputs[l] = None
            for k, v in w.items():
                apply(f"llama.layers.{l}.{k}", v.grad)
            del w
        # the input embeddings and the projector
        if "llama.embed" in W and not lc.get("tie_word_embeddings"):
            ge = torch.zeros(W["llama.embed"].shape, device=dev)
            for r in range(R):
                tok, img = toks[r]
                text = img < 0
                ge.index_add_(0, tok[text], grads[r][text])
            apply("llama.embed", ge)
            del ge
        outs, gouts = [], []
        for r in range(R):
            if projs[r] is None:
                continue
            tok, img = toks[r]
            at = img >= 0
            gp = torch.zeros_like(projs[r])
            gp.index_add_(0, img[at], grads[r][at])
            outs.append(projs[r])
            gouts.append(gp)
        if outs:
            torch.autograd.backward(outs, gouts)
        for n, t in proj_p.items():
            apply(n, t.grad if t.grad is not None else torch.zeros_like(t))
        return loss

    # -- the step -----------------------------------------------------------

    def step(self, samples: List[dict]) -> dict:
        """One optimizer step over `samples` (one per microbatch). Returns
        the loss, the global norm and each trainable leaf's norm of the
        gradient as AdamW gets it (clipped)."""
        cfg, tc = self.cfg, self.tc
        K, T = cfg["mm"]["num_image_tokens"], tc["max_seq_len"]
        rows = [expand(s, K, T) for s in samples]
        feats = []
        for row in rows:
            px = row["pixels"]
            feats.append(None if px is None else vis.image_features(
                self.W, cfg, torch.as_tensor(px, device=self.device),
                self.mode))
        sq = torch.zeros((), dtype=torch.float64, device=self.device)

        def norm_only(name, g):
            nonlocal sq
            sq += g.double().square().sum()

        self._pass(rows, feats, norm_only)
        norm = float(sq.sqrt())
        max_norm = tc["grad_clip_norm"]
        scale = max_norm / norm if norm >= max_norm else 1.0
        lr, count = lr_at(tc, self.count), self.count
        b1, b2, eps = tc["adam_b1"], tc["adam_b2"], tc["adam_eps"]
        wd = tc["weight_decay"]
        bc1, bc2 = 1 - b1 ** (count + 1), 1 - b2 ** (count + 1)
        leaf_norms = {}

        @torch.no_grad()
        def update(name, g):
            g = g.float() * scale
            leaf_norms[name] = float(g.norm())
            p, mu, nu = self.W[name], self.mu[name], self.nu[name]
            m = b1 * mu.float() + (1 - b1) * g
            v = b2 * nu.float() + (1 - b2) * g * g
            u = (m / bc1) / ((v / bc2).sqrt() + eps)
            p32 = p.float()
            if wd:
                u = u + wd * p32
            p.copy_(p32 - lr * u)
            mu.copy_(m)
            nu.copy_(v)

        loss = self._pass(rows, feats, update)
        self.count += 1
        return dict(loss=loss, global_norm=norm, grad_norms=leaf_norms)

    @torch.no_grad()
    def change_norms(self, seed: int) -> Dict[str, float]:
        """Each trainable leaf's norm of its change since the start (the
        start drawn anew, group by group)."""
        return change_norms(self.cfg, seed, self.W, self.device,
                            next(iter(self.W.values())).dtype)


@torch.no_grad()
def change_norms(cfg: dict, seed: int, params: Dict[str, torch.Tensor],
                 device, dtype=torch.bfloat16) -> Dict[str, float]:
    """||p - p0|| of each trainable leaf in `params` (name -> tensor, the
    reference's or the program's), p0 drawn anew from the seed one group
    at a time."""
    from benchmark.weights import iter_params

    out = {}
    want = [g for g, entries in groups(cfg).items()
            if entries[0][0].startswith(TRAINABLE)]
    for name, p0 in iter_params(cfg, seed, device, dtype, want):
        if name in params:
            out[name] = float((params[name].float() - p0.float()).norm())
    return out
