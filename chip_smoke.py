#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`metamorph_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure raises and the script exits nonzero):
  1. device  — needs CUDA; prints the card's name and power limit; TF32 off;
  2. build   — compiles metamorph_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernels — each hand-written kernel against its plain PyTorch version
               (fp32 math on the same bf16 inputs) at LLaMA-3.1-8B shapes
               (H=32, KV=8, Dh=128; kernel A causal at the 2048 prefill
               bucket and at T=4096, the train forward), with max-abs error,
               tolerance, and the times of both from CUDA events; nvcc's
               `-Xptxas -v` lines (registers, spills, warnings) before it;
  3b. backward kernels — kernels C (dq) and D (dk, dv) against the plain
               backward at 8B shapes, causal and not, ragged, with an lse
               cotangent and an empty row; bitwise equal on a second launch;
               median times of each kernel and of the plain backward;
  3c. serving-option kernels — kernel B's int8 branch at B=8, S=4096 and
               kernel E (chunk attention) in its verify form (B=8, C=4,
               ragged offsets, S=4108) and its fill form (C=256), bf16 and
               int8, with stale entries past each chunk, against their plain
               versions;
  10b. drafter-shape kernels — kernel B (bf16, 8 full rows) and kernel
               E's verify form (8 rows, C=4) and fill form (8 rows, C=8,
               the catch-up at spec_k 8) at the 1B drafter's attention
               shape (Dh=64, KV=8, G=4, S=4096), as 3c checks them;
     Every kernel row carries its bound (the larger of bytes over 3.35 TB/s
     and FLOPs over 989 TFLOP/s, from this run's shapes), the FLOP/s and
     bytes/s it reached and the bound's share of its time, and, where one
     PyTorch call computes the same function, that call's time (SDPA, with
     a boolean mask where rows are ragged; the port never calls it). Times
     are per call over 20 calls queued back to back between two CUDA
     events; kernels A, C and D (and their SDPA yardsticks) also give the
     time of one call alone, which includes the wrapper's host time;
  4. reference — a 2-layer model at head dim 128 through prefill + decode on
               the card (kernels) and on the CPU in fp32 (plain versions):
               logits must agree;
  4c. options reference — phase 4's model through the verify chunk
               (`decode_chunk_step_batched`) and the fused fill step
               (`decode_step_with_chunk`) with a bf16 and an int8 cache: card
               vs CPU logits must agree;
  4b. train reference — one train_step of a 2-layer model on one packed
               T=1024 row (text, a prompt image, an answer image) on the card
               (bf16, kernels) and on the CPU (fp32, plain): losses and
               gradients must agree;
  5. main path — ServeEngine at full width (LLaMA-3.1-8B + SigLIP-SO400M,
               mlp2x_gelu projector, K=64, random bf16 weights from seed 0,
               8 slots, 4096-token cache) serving text requests (one long
               enough for the 2048 prefill bucket) and one image request
               encoded by the port's SigLIP tower; twice, with identical ids;
               the greedy engine replays its plain ticks from CUDA graphs,
               so kernel B's count is what ran on the card (host calls less
               those recorded by a capture, plus replays x calls per capture);
  5d. serving options — the same model through ServeEngine(spec_k=4,
               fill_chunk=256, max_fills=2), with the bf16 and the int8
               cache: phase 5's requests plus two long prompts that stream
               in through chunked fill while the slots decode; kernel E must
               launch from the fill and the verify steps, kernel B in bf16
               and int8;
  5b. train main path — configs/stage2_finetune.json (LLaMA-3.1-8B +
               SO400M, dual loss) cut to one card: 4 train steps on one packed
               4096-token row with a prompt and an answer image; step time,
               tokens/s, peak memory; kernels A, C and D must run;
  5c. train() — the trainer loop at the 4b width: logging, saves, pruning and
               a resume;
  8. the recipe's data path — a conversation JSONL written by the phase
               (PNG images, or inline arrays through the metaclip route
               where PIL does not import) tokenized by `word_tokenize`
               (LLaMA-3 special ids), through LazySupervisedDataset ->
               PackedCollator -> DataIterator -> train(), as
               `train/main.py` builds them:
     8a. at 5b's width and cut (T=4096, 4 steps): host ms per batch of
               dataset + collate + pack, the native and the Python packer
               per row, each step's loss and AR-token count against the
               batch the iterator gives, the wait on the prefetch queue,
               real tokens/s, peak memory (no checkpoint: the 8B state is
               ~49 GB); then the same batches collated beforehand, so that
               the loader's host share of the step shows; the native
               packer must pack every batch, kernels A, C and D must run,
               both runs must give the same losses, and the step time must
               stay within 5 % of 5b's spread;
     8b. at the 4b width: text-only and image rows, a run resumed from
               the save at step 2 against an uninterrupted one (the same
               batches); an anyres run (spatial_unpad, learned newline)
               whose losses match the CPU on the same weights;
  9. weights — checkpoint files at full width, in a temporary directory
               (~20 GB, deleted at the end whatever happens; its
               filesystem is in 9a's row):
     9a. (after 5d, on phase 5's model) per-tensor checksums, then
               `export_hf` (HF-layout LLaMA + tower, projector, vision head,
               configs, the fp32 `vision_tower/` dir) and `save_adapter`;
               bytes, seconds, GB/s, then a sync; phase 5's model is freed;
     9b. (after 5b) `load_pretrained_model` from that directory, just
               written, so read through whatever page cache keeps it:
               seconds, GB/s, GiB on the card, seconds from the load's
               start to a first served token; every tensor bitwise the
               exported one (checksums); first-token logits of the base
               model; phase 5's requests give phase 5's greedy ids
               (kernels A, B);
     9c. `add_lora(r=64)`, 3 `lora_enable` train steps on 5b's batch at
               T=4096 (kernels A, C, D): finite losses, every base weight
               bitwise unchanged, every B factor nonzero; step time and
               peak memory beside 5b's; then the B factors are set to
               seeded values that move the first-token logits to cosine
               <= 0.99 of the base model's (gated), so that 9d can tell a
               merge from none; `save_lora`; phase 5's requests served
               with the factors unmerged;
     9d. `load_lora_model` (the factors merged): first-token logits
               within cosine 0.999 of 9c's unmerged model (a merge that
               did nothing would be at 9c's cosine to the base); the
               cosine to the base model and the share of equal greedy ids;
     9e. `train()` from the files (`hf_llama_path`, `hf_siglip_path`,
               `pretrain_mm_mlp_adapter`), 2 steps at T=4096, no save: the
               built model bitwise the files' tensors, finite losses, the
               step time beside 5b's.
  10. decode entry points and front ends — on phase 5's model (after 5d,
               before 9a): a LLaMA-3.2-1B-shaped drafter (random bf16, seed
               1); 10a `generate`, `greedy_decode` (stop id, int8 cache),
               `greedy_decode_spec` (spec_k 4: kernel E's verify form; 8:
               its fill form) and `greedy_decode_spec_draft_model` on a
               300-token text prompt, then the demo's work function on an
               image (greedy, spec_k 8, the drafter) and that image's
               fused prompt through `greedy_decode` (stop id, int8 cache)
               and `greedy_decode_spec` (spec_k 4), then
               `batched_greedy_decode` and `batched_greedy_decode_spec` on 8
               left-padded prompts of 40-1,500 tokens; each run twice with
               identical ids, the same first token across a prompt's runs,
               tokens/s, accepted drafts per chunk step, and the device's
               busy share over one greedy run (profiler); 10c
               `ServeEngine(spec_k=4, draft=...)` on phase 5's requests with
               the 1B drafter and with the main LLaMA as its own drafter
               (gate: >= 0.5 of the text requests' drafts accepted); 10d
               the serve CLI's work function over a requests JSONL (text,
               a long prompt through chunked fill, an image, per-row
               budgets; `word_tokenize`); 10e `MetaMorphHTTPServer` on
               127.0.0.1:0 over an 8-slot engine, 8 concurrent requests
               (half streaming), time to first chunk and to completion.
               Kernels A, B (bf16, int8) and E (both forms) must launch.
  11. int8 weights, the shared prefix and eval — 11a (after 10b) kernel
               F (`csrc/w8_matmul.cu`) against its plain version at M = 8
               and 32 rows on the 8B decode shapes (wq/wo, wk/wv, gate/up,
               down, the lm head; the gemv form) and M = 264 and 4096 on
               the four layer shapes (the tiled form): relative error,
               bitwise repeats, device ms, bound, the plain version's time,
               `torch._weight_int8pack_mm` (bf16 scales) where PyTorch has
               a CUDA kernel for it, and, as a yardstick only,
               `torch.matmul` on the bf16 weight; on phase 5's model
               (after 10): 11b
               `quantize_llama_decode`, the first-step logits' cosine to
               the bf16 model per request (>= 0.99), phase 5's requests
               through the engine on int8 weights with the bf16 and the
               int8 cache, plain and spec_k=4, their ids against the same
               int8 model on the plain product, one `greedy_decode`,
               decode ticks profiled on both models (device and GEMM ms
               per step), the admission tick's GEMM and kernel F ms on
               both models; 11c a 1,024-token shared prefix with phase 5's
               prompts as suffixes against the plain engine on prefix +
               suffix, the admission tick's device ms with and without it,
               then kv_int8 (against the plain engine's int8 cache),
               spec_k=4 and the 1B-shaped drafter; 11d `run_task` on 16
               rows (8 PNGs) against single-request gold answers, on bf16
               and int8 weights, and (inside 8a, on its trained model and
               batches) `evaluate`. Every comparison of two runs' ids
               (`compare_ids`) reads both runs' own logits, recorded as
               they ran (`LogitRecorder`): per request the first-step
               cosine >= 0.99, and ids equal or parting only where the
               swap lies within the logit difference measured between the
               two runs.
               Kernels F, A, B (bf16, int8) and E (both forms) must launch.
  12. the visualizer's render path at SD-1.5 width — on phase 5's model
               (after 11d): 12a the UNet (320/640/1280/1280, 8 heads, ctx
               768; 860 M parameters), the VAE (128/256/512/512) and the mlp
               adapter, seeded on the CPU in fp32 and copied to the card
               (TF32 off), against the CPU on one `unet_apply` at a 16 x 16
               latent, one `vae_decode` and one 3-step DDIM `render`; 12b
               `greedy_decode(start_in_image=True)` on phase 5's image prompt
               writes one 64-token chunk of visual embeddings (kernels A and
               B must launch), the visualizer goes through `save_visualizer`
               and `load_visualization` (the card by default) bit for bit,
               and the demo's `render_chunks` renders the chunk (PNDM-50,
               512 px, guidance 6.0 / 7.5 / 10.0 / 12.5) in fp32 and in
               bf16: four finite 512 x 512 PNGs each, in [0, 1], and the
               bf16 images' PSNR against the fp32 ones; 12c in each dtype at
               512 px, CFG batch 2: UNet steps/s, the step's device ms by op
               group (conv, GEMM, attention, norms, elementwise), the busy
               share, its FLOPs (from the shapes) and their share of 989
               TFLOP/s, VAE decode ms, peak memory, and the level-0
               self-attention and the VAE's mid attention in the port's
               plain form beside SDPA (a yardstick; the path never calls
               it).
  5e. offload_optimizer — 5b's cut with the AdamW moments in pinned host
               memory (`train/optimizer.py` streams them through the card
               per 256 MB chunk): /proc/meminfo, the moments' GiB (from
               the trainable mask) and the host <-> card copy rates, then
               3 offloaded steps against 3 with the moments on the card
               from the same start: losses and every parameter bitwise
               equal (checksums), the moments pinned, kernels A, C and D
               launched; step s and device peak beside 5b's. A host that
               cannot pin the moments cuts the LLaMA's layers (logged);
  13. the visualizer's training path:
     13a. a 4-level UNet at small widths, the tiny VAE and a 2-layer mlp
               adapter made on the CPU and copied to the card (fp32, TF32
               off): the loss (1e-5 relative) and the adapter and UNet
               gradients (1e-4 of max |g|) with the same draws, then 3
               adapter-only and 2 `unfreeze_unet` steps (losses 1e-5, the
               trees within Adam's 2 * lr * steps);
     13b. at SD-1.5 width (phase 12's configs, fp32, 512 px, random
               weights, seed 0): 5 adapter-only steps, then 3 with the UNet
               unfrozen, at JAX's batch of 24 or the largest of 16, 8, 4
               predicted to fit (from the peaks at 2 and 4 images; each
               cut logged): step s, images/s, peak memory,
               busy share, FLOPs from the shapes and their share of 989
               TFLOP/s; the losses finite;
     13c. `python -m metamorph_tpu_torch.visualizer.main` on two tar
               shards of PNGs (one member corrupt) and a random SO400M
               SigLIP written in HF layout, 3 steps: the directory reloads,
               the adapter trained, the UNet and VAE bitwise their seeds'
               init; the SigLIP encode's ms per image. In a temporary
               directory, deleted whatever happens (~5.5 GB written).
  14. multi-GPU training on the one card, in a one-rank NCCL process group
               (rendezvous: a FileStore in a temporary directory; the group
               is destroyed at the end of the phase):
     14a. `make_sharded_train_step` over the mesh (data 1, fsdp -1,
               tensor 1), 5b's config, seed and batch: FSDP2 wrapping, the
               global normalizers, the sharded norm and update; two steps
               held to 5b's first two (bitwise, or losses within 1e-3 and
               each tensor's update within 2e-2 of its max |update|; the
               log says which); step s, peak memory, NCCL's kernels and
               the busy share from the profiler, kernels A/C/D launched;
     14b. ring attention at configs/longctx_sp.json's layout (T 16,384
               in 8 chunks of 2,048, H 32, KV 8, Dh 128, bf16): each ring
               position in turn through `_ring_body`, forward and backward,
               against kernels A/C/D over the whole T in one call (each row
               within 2e-2 of its own max |ref|); A, C and D launched once
               per unskipped chunk (8 causal, 28 non-causal), never for a
               skipped one; ms per position, their sum against the one
               call; the full chunk's kernels alone (non-causal T = S =
               2,048, with lse and an lse cotangent) with bounds, plain and
               SDPA times;
     14c. the visualizer's data-parallel step over the one-rank mesh at
               13b's width, batch 2, 2 steps: bitwise the one-card step;
     14d. `train()` under the process group (the sharded path), 2 layers
               of the 8B width, T 1024: 2 steps unbroken against 1 step, a
               save (~10 GB, in a temporary directory) and a resume.
  5f. the DeepSeek-V3 block's serving path — MetaMorph on Kimi-VL-A3B's
               decoder (benchmark/configs/mm-kimivl-a3b.json: latent
               attention over a 576-wide latent cache, 64 routed experts,
               top 6; seeded bf16 weights, SigLIP-SO400M) through
               ServeEngine at 128 slots x 4,096, 40 text and 8 image
               requests of the chat mix's lengths, served eagerly and with
               the plain ticks replayed from CUDA graphs: equal ids, every
               plain tick after its key's capture replayed, each step's
               expert counts k per advancing row in every expert layer;
               kernel G's and the grouped products' launches on the card in
               the graphed run (the counters reset just before it); kernel
               G against its plain version on the query and latent rows of
               the path's first decode step at layer 3, with its device ms,
               the plain ms and the bound of those rows' keys.
The phases run in the order 1-3c, 10b, 11a, 4, 5, 5d, 10, 11b-11d, 12, 9a,
5b, 9b-9e, 5e, 13, 5c, 8 (with 11d's `evaluate`), 14, 5f.

The last two lines of stdout are the kernel summary JSON and
{"ok": true, "device": {...}}; the whole script's wall time is printed
before them. Without a CUDA device, or outside a
repository checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
# the 8B train step runs near the card's memory: let the allocator grow
# segments instead of fragmenting (read when CUDA first initialises)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

FLASH_TOL_O = 2e-2      # bf16 output vs fp32 plain: half a bf16 step of |o|
                        # (<= 0.0078 below 4) plus the bf16 P tile of the PV
                        # product (relative 2**-9 per weight)
FLASH_TOL_LSE = 2e-3    # fp32 logsumexp; only the fp32 sum order differs
DECODE_TOL = 2e-2       # bf16 output vs fp32 plain (P stays fp32 in kernel B)
REF_MIN_COS = 0.999     # bf16 model on the card vs fp32 model on the CPU
REF_MIN_COS_INT8 = 0.995  # int8 cache on both sides: the card quantizes bf16
                          # K/V, the CPU fp32 K/V, so some entries round to
                          # a neighbouring int8 step (1/254 of the row's amax)
BWD_TOL = 3e-2          # kernels C/D: max|err| / max|ref| of dq, dk, dv; P and
                        # dS enter the tensor-core products in bf16 (relative
                        # 2**-9 each) and the outputs are bf16
TRAIN_LOSS_RTOL = 2e-2  # bf16 train step on the card vs fp32 on the CPU
TRAIN_MIN_GRAD_COS = 0.99
PEAK_BF16_TFLOPS = 989.0   # H100 SXM dense bf16 (data sheet, 700 W)
PEAK_HBM_TBS = 3.35        # H100 SXM HBM3 (data sheet)
MS_METHOD = ("ms: CUDA graph of 20 calls, replay timed by CUDA events; "
             "ms_queued: 20 calls queued; ms_alone: one call")


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes each read or written
    once over the memory rate, or the FLOPs over the bf16 tensor rate,
    whichever is larger."""
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_ops = flops / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def rates(b: dict, ms: float) -> dict:
    """What a kernel row achieved: FLOP/s and bytes/s of the work its bound
    counts, and the bound's share of the measured time."""
    return dict(tflops=b["flops"] / ms / 1e9, gb_per_s=b["bytes"] / ms / 1e6,
                bound_share=b["bound_ms"] / ms)


def causal_pairs(T: int, lens) -> int:
    """Visible (query, key) pairs of a causal T x T problem with per-row
    key lengths: query i sees keys j <= i, j < len."""
    return sum(sum(min(i + 1, n) for i in range(T)) for n in lens)


def log(*a):
    print(*a, flush=True)


# the LLaMA-3 ids of the template's specials and the two added vision tokens
LLAMA3_SPECIALS = {"<|begin_of_text|>": 128000, "<|start_header_id|>": 128006,
                   "<|end_header_id|>": 128007, "<|eot_id|>": 128009,
                   "<image_start>": 128256, "<image_end>": 128257}
_SPECIAL_SPLIT = re.compile(
    "(" + "|".join(re.escape(s) for s in LLAMA3_SPECIALS) + ")")


def word_tokenize(text: str) -> list:
    """A deterministic word-level stand-in for the LLaMA-3 tokenizer: it
    prepends <|begin_of_text|> as HF's does (the round masking counts on
    it), keeps the specials at their LLaMA-3 ids, and maps each
    whitespace-separated word to 1000 + crc32(word) % 100000."""
    ids = [LLAMA3_SPECIALS["<|begin_of_text|>"]]
    for chunk in _SPECIAL_SPLIT.split(text):
        if chunk in LLAMA3_SPECIALS:
            ids.append(LLAMA3_SPECIALS[chunk])
        else:
            ids.extend(1000 + zlib.crc32(w.encode()) % 100000
                       for w in chunk.split())
    return ids


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of `calls` back-to-back calls between two CUDA
    events (median of `reps`): the host queues the next launch while the
    card runs this one, so the wrapper's host time hides behind the kernel
    where the kernel is the longer of the two: the kernel's own time on the
    card. `cuda_ms_alone` times one call alone,
    host time included."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def cuda_graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device milliseconds per call: `calls` calls captured in one CUDA
    graph, whose replay is timed between two CUDA events (median of
    `reps`). No host time enters: what the card spends on the calls, for
    kernels shorter than their wrapper's ~0.06-0.1 ms of Python."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def three_ways(fn, prefix: str = "") -> dict:
    """A short kernel (or its library yardstick) timed three ways: `ms`
    from a CUDA graph's replay (device time), `ms_queued` from 20 calls
    queued back to back, `ms_alone` one call alone (host time included)."""
    return {f"{prefix}ms": cuda_graph_ms(fn),
            f"{prefix}ms_queued": cuda_ms(fn),
            f"{prefix}ms_alone": cuda_ms_alone(fn)}


def cuda_ms_alone(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `iters` runs, CUDA events around
    each run alone: the card waits for the host to issue the call, so the
    wrapper's host time is part of it (how the first designs were timed)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def sdpa_mask(fa, lengths, T: int, S: int, causal: bool):
    """None where SDPA's own causal flag (or no mask) gives the kernels'
    visibility, else the boolean [B, 1, T, S] mask of it."""
    if bool((lengths == S).all()) and (T == S or not causal):
        return None
    return fa._visible(lengths, T, S, causal, lengths.device)[:, 0]


def library_fwd_ms(F, fa, qt, kt, vt, lengths, causal: bool, timer=None
                   ) -> float:
    T, S = qt.shape[2], kt.shape[2]
    mask = sdpa_mask(fa, lengths, T, S, causal)
    return (timer or cuda_ms)(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True))


def phase_kernels(torch, dev):
    import torch.nn.functional as F

    from metamorph_tpu_torch.ops import decode_attention as da
    from metamorph_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    H, KV, Dh = 32, 8, 128
    rows = {"flash": [], "decode": []}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    # kernel A: (B, T, S, causal, lengths); model layout through
    # flash_attention and `_fwd` (timed), kernel layout + lse through
    # flash_attention_with_lse
    cases = [
        (1, 2048, 2048, True, [2048]),          # the main path's 2048 bucket
        (1, 4096, 4096, True, [4096]),          # the train step's forward
        (1, 1024, 1024, True, [1024]),
        (2, 2048, 2048, True, [2048, 1337]),
        (2, 777, 777, True, [777, 500]),
        (2, 512, 777, False, [777, 600]),
    ]
    for B, T, S, causal, lens in cases:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q, k, v = randn(B, T, H, Dh), randn(B, S, KV, Dh), randn(B, S, KV, Dh)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # reference in fp32 end to end (an fp32 output, not a bf16 one, so
        # the error is not quantized to whole bf16 steps)
        ref_o, ref_lse = fa.flash_attention_plain(
            qt.float(), kt.float(), vt.float(), lengths, causal)
        mask = torch.arange(S, device=dev)[None] < lengths[:, None]
        o = fa.flash_attention(q, k, v, attn_mask=mask, causal=causal)
        ok, lse = fa.flash_attention_with_lse(qt, kt, vt, lengths, causal)
        err = max((o.transpose(1, 2).float() - ref_o).abs().max(),
                  (ok.float() - ref_o).abs().max()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        # timed through the kernel's wrapper on the model-layout views, as
        # the main paths reach it (without the mask-to-lengths sum)
        kern = lambda: fa._fwd(qt, kt, vt, lengths, causal, Dh ** -0.5)
        ms = cuda_ms(kern)
        ms_alone = cuda_ms_alone(kern)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
            qt, kt, vt, lengths, causal))
        pairs = (causal_pairs(T, lens) if causal else T * sum(lens))
        b = bound(2 * (2 * B * T * H * Dh + 2 * B * S * KV * Dh)
                  + 4 * B * H * T, 4 * Dh * H * pairs)
        # the library's call for the same function: SDPA with GQA, causal
        # where no row is ragged, else with the boolean [B, 1, T, S] mask
        library_ms = library_fwd_ms(F, fa, qt, kt, vt, lengths, causal)
        library_ms_alone = library_fwd_ms(F, fa, qt, kt, vt, lengths, causal,
                                          cuda_ms_alone)
        row = dict(B=B, T=T, S=S, causal=causal, lengths=lens,
                   max_abs_err=err, tol=FLASH_TOL_O, lse_err=lse_err,
                   lse_tol=FLASH_TOL_LSE, ms=ms, ms_alone=ms_alone,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_ms_alone=library_ms_alone, **b,
                   **rates(b, ms))
        log("kernel A flash_fwd", json.dumps(row))
        if not (err <= FLASH_TOL_O and lse_err <= FLASH_TOL_LSE):
            raise AssertionError(f"flash kernel disagrees with plain: {row}")
        rows["flash"].append(row)
        del q, k, v, ref_o, ref_lse, o, ok, lse

    # kernel B: stacked cache [L, B, KV, S, Dh] with a layer index
    L, B, S = 32, 8, 4096
    ck = torch.empty((L, B, KV, S, Dh), dtype=torch.bfloat16, device=dev)
    cv = torch.empty_like(ck)
    for l in (0, 31):
        ck[l].copy_(randn(B, KV, S, Dh))
        cv[l].copy_(randn(B, KV, S, Dh))
    q = randn(B, H, Dh)
    lengths = torch.tensor([1, 1024, 1025, 4096, 37, 2000, 3000, 513],
                           dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 100, 1000, 0, 5, 1999, 64, 512],
                          dtype=torch.int32, device=dev)
    for layer, st in ((0, None), (31, None), (31, starts)):
        o = da.decode_attention(q, ck, cv, lengths, starts=st, layer=layer)
        again = da.decode_attention(q, ck, cv, lengths, starts=st,
                                    layer=layer)
        ref = da.decode_attention_plain(q.float(), ck[layer].float(),
                                        cv[layer].float(), lengths, st)
        err = (o.float() - ref).abs().max().item()
        repeat = bool(torch.equal(o, again))
        # alternate two layers so a timed launch finds its window out of L2
        other = 0 if layer == 31 else 31
        flip = [layer]

        def kern():
            flip[0] = other if flip[0] == layer else layer
            da.decode_attention(q, ck, cv, lengths, starts=st, layer=flip[0])

        times = three_ways(kern)
        plain_ms = cuda_ms(lambda: da.decode_attention_plain(
            q, ck[layer], cv[layer], lengths, st))
        lo = st if st is not None else torch.zeros_like(lengths)
        window = int((lengths - lo).clamp_min(0).sum())
        b = bound(window * KV * Dh * 2 * 2 + 2 * B * H * Dh * 2,
                  4 * H * Dh * window)
        pos = torch.arange(S, device=dev)
        keymask = (pos[None] < lengths[:, None]) & (pos[None] >= lo[:, None])
        library = three_ways(lambda: F.scaled_dot_product_attention(
            q[:, :, None], ck[layer], cv[layer],
            attn_mask=keymask[:, None, None], enable_gqa=True), "library_")
        row = dict(B=B, S=S, layer=layer, starts=st is not None,
                   lengths=lengths.tolist(), max_abs_err=err, tol=DECODE_TOL,
                   bitwise_repeat=repeat, ms_method=MS_METHOD, **times,
                   plain_ms=plain_ms, **library, **b,
                   **rates(b, times["ms"]))
        log("kernel B decode_attn", json.dumps(row))
        if not (err <= DECODE_TOL and repeat):
            raise AssertionError(f"decode kernel disagrees with plain or "
                                 f"does not repeat: {row}")
        rows["decode"].append(row)
    del ck, cv
    torch.cuda.empty_cache()
    return rows


def phase_bwd_kernels(torch, dev):
    """Kernels C and D against the plain backward at 8B attention shapes,
    in the model layout the train step gives them."""
    import torch.nn.functional as F

    from metamorph_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    H, KV, Dh = 32, 8, 128
    scale = Dh ** -0.5
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    # (B, T, S, causal, lengths, with dlse)
    cases = [
        (1, 4096, 4096, True, [4096], False),     # the 5b main path's shape
        (1, 2048, 2048, True, [2048], False),
        (2, 2048, 2048, True, [2048, 1337], False),
        (2, 777, 777, True, [777, 500], False),
        (2, 512, 777, False, [777, 600], True),
        (2, 512, 512, True, [512, 0], False),     # a row with no key
    ]
    for B, T, S, causal, lens, with_dlse in cases:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        # model layout, read by the kernels through strides
        q, k, v = randn(B, T, H, Dh), randn(B, S, KV, Dh), randn(B, S, KV, Dh)
        do = randn(B, T, H, Dh)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        o, lse = fa.flash_attention_with_lse(qt, kt, vt, lengths, causal)
        dlse = (torch.randn((B, H, T), generator=gen, device=dev)
                if with_dlse else None)
        got = fa.flash_attention_bwd(qt, kt, vt, o, lse, dot, dlse, lengths,
                                     causal, scale)
        again = fa.flash_attention_bwd(qt, kt, vt, o, lse, dot, dlse,
                                       lengths, causal, scale)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(qt.float(), kt.float(), vt.float(),
                                           o.float(), lse, dot.float(), dlse,
                                           lengths, causal, scale)
        err, rel, repeat = {}, {}, True
        for name, x, y, r in zip(("dq", "dk", "dv"), got, again, ref):
            d = (x.float() - r).abs().max().item()
            err[name] = d
            rel[name] = d / max(r.abs().max().item(), 1e-30)
            repeat = repeat and torch.equal(x, y) and bool(
                torch.isfinite(x).all())
        del ref, again
        torch.cuda.empty_cache()
        # kernel-only timings: delta precomputed, each kernel launched alone
        delta = (dot.float() * o.float()).sum(-1)
        dd = (delta - dlse if dlse is not None else delta).contiguous()
        dq, dk, dv = got
        dqf = lambda: fa._launch_dq(qt, kt, vt, dot, lse, dd, dq, lengths,
                                    causal, scale)
        ms_dq, ms_dq_alone = cuda_ms(dqf), cuda_ms_alone(dqf)
        dkv = lambda: fa._launch_dkv(qt, kt, vt, dot, lse, dd, dk, dv,
                                     lengths, causal, scale)
        ms_dkv, ms_dkv_alone = cuda_ms(dkv), cuda_ms_alone(dkv)
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            qt, kt, vt, o, lse, dot, dlse, lengths, causal, scale), calls=5,
            reps=3)
        pairs = (causal_pairs(T, lens) if causal else T * sum(lens))
        qkv_do = 2 * (2 * B * T * H * Dh + 2 * B * S * KV * Dh)
        b_dq = bound(qkv_do + 8 * B * H * T + 2 * B * T * H * Dh,
                     6 * Dh * H * pairs)
        b_dkv = bound(qkv_do + 8 * B * H * T + 4 * B * S * KV * Dh,
                      8 * Dh * H * pairs)
        # the library's backward (dq, dk, dv together) for the same
        # attention: SDPA with GQA, with the boolean mask where a row is
        # ragged; it takes no lse cotangent, so a dlse row times it without
        library_ms = library_ms_alone = None
        if lens[-1] > 0:     # SDPA's backward of an all-masked row is NaN
            mask = sdpa_mask(fa, lengths, T, S, causal)
            ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))
            out = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
            grad = lambda: torch.autograd.grad(out, (ql, kl, vl), dot,
                                               retain_graph=True)
            library_ms = cuda_ms(grad, calls=5, reps=3)
            library_ms_alone = cuda_ms_alone(grad, iters=5)
            del ql, kl, vl, out, mask, grad
        row = dict(B=B, T=T, S=S, causal=causal, lengths=lens,
                   dlse=with_dlse, max_abs_err=err, rel_err=rel,
                   tol_rel=BWD_TOL, bitwise_repeat=repeat, ms_dq=ms_dq,
                   ms_dq_alone=ms_dq_alone, ms_dkv=ms_dkv,
                   ms_dkv_alone=ms_dkv_alone,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_ms_alone=library_ms_alone,
                   bound_dq=dict(b_dq, **rates(b_dq, ms_dq)),
                   bound_dkv=dict(b_dkv, **rates(b_dkv, ms_dkv)))
        log("kernels C/D flash_bwd", json.dumps(row))
        if not (repeat and max(rel.values()) <= BWD_TOL):
            raise AssertionError(f"backward kernels disagree with plain or "
                                 f"do not repeat: {row}")
        if lens[-1] == 0 and not all(bool((g[-1] == 0).all()) for g in got):
            raise AssertionError("a row with no visible key got a gradient")
        rows.append(row)
        del q, k, v, do, o, lse, got, dq, dk, dv, delta, dd
        torch.cuda.empty_cache()
    return rows


def check_attn_row(torch, name, out, again, ref, row) -> None:
    """Kernel B's and E's check against the plain version: DECODE_TOL of
    max|ref| over each query row's head vector, finite, equal bits on a
    second launch, and the split kernels' arrival counters back at zero."""
    from metamorph_tpu_torch.ops import decode_attention as da

    row.update(rates(row, row["ms"]))
    diff = (out.float() - ref).abs()
    # each (query, head) row against its own magnitude; the floor only
    # guards a row with no visible key, whose output is 0
    rel = (diff.amax(-1) / ref.abs().amax(-1).clamp_min(1e-3)).max()
    row.update(max_abs_err=diff.max().item(), max_rel_err=rel.item(),
               tol_rel=DECODE_TOL,
               bitwise_repeat=bool(torch.equal(out, again)),
               counters_zero=all(bool((ctr == 0).all())
                                 for _, ctr in da._SCRATCH.values()))
    log(name, json.dumps(row))
    if not (rel.item() <= DECODE_TOL and torch.isfinite(out).all()
            and row["bitwise_repeat"] and row["counters_zero"]):
        raise AssertionError(f"{name} disagrees with plain or does not "
                             f"repeat: {row}")


def phase_option_kernels(torch, dev, S: int = 4096):
    """Kernel B's int8 branch and kernel E (both forms, both cache types)
    at the serving options' main-path shapes (cache length S), against
    their plain versions on the same inputs. Tolerance: DECODE_TOL of
    max|ref| over each query row's head vector (bf16 output; the chunk
    kernel also rounds P to bf16 for its PV product); two launches give
    equal bits, and the split kernels' arrival counters end at zero. Per
    row, because a row that sees one key has |o| ~ 3 and one that sees
    4,096 has ~0.05: a bound scaled by the whole case would let the long
    rows be wrong."""
    import torch.nn.functional as F

    from metamorph_tpu_torch.ops import decode_attention as da
    from metamorph_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device=dev)
    gen.manual_seed(777)
    H, KV, Dh, L = 32, 8, 128, 4
    rows = {"decode_int8": [], "chunk": []}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # kernel B int8: 8 full rows of a 4096-token cache (every key read),
    # then ragged windows with starts
    B, S_max = 8, S
    ck, ks = quantize_kv(randn(L, B, KV, S, Dh))
    cv, vs = quantize_kv(randn(L, B, KV, S, Dh))
    q = randn(B, H, Dh).to(torch.bfloat16)
    full = torch.full((B,), S, dtype=torch.int32, device=dev)
    ragged = torch.tensor([1, 1024, 1025, 4096, 37, 2000, 3000, 513],
                          dtype=torch.int32, device=dev).clamp(max=S)
    starts = torch.tensor([0, 100, 1000, 0, 5, 1999, 64, 512],
                          dtype=torch.int32, device=dev).clamp(max=S - 1)
    for lengths, st in ((full, None), (ragged, starts)):
        layer = 3
        o, again = (da.decode_attention(q, ck, cv, lengths, starts=st,
                                        layer=layer, k_scale=ks, v_scale=vs)
                    for _ in range(2))
        ref = da.decode_attention_plain(q.float(), ck[layer], cv[layer],
                                        lengths, st, k_scale=ks[layer],
                                        v_scale=vs[layer])
        flip = [layer]

        def kern():   # alternate layers: each launch finds its rows cold
            flip[0] = 0 if flip[0] == layer else layer
            da.decode_attention(q, ck, cv, lengths, starts=st, layer=flip[0],
                                k_scale=ks, v_scale=vs)

        lo = st if st is not None else torch.zeros_like(lengths)
        window = int((lengths - lo).clamp_min(0).sum())
        row = dict(B=B, S=S, starts=st is not None, window_keys=window,
                   ms_method=MS_METHOD, **three_ways(kern),
                   plain_ms=cuda_ms(lambda: da.decode_attention_plain(
                       q, ck[layer], cv[layer], lengths, st,
                       k_scale=ks[layer], v_scale=vs[layer])),
                   library_ms=None,
                   **bound(window * KV * (2 * Dh + 8) + 4 * B * H * Dh,
                           4 * H * Dh * window))
        check_attn_row(torch, "kernel B decode_attn_int8", o, again, ref, row)
        rows["decode_int8"].append(row)
    del ck, cv, ks, vs

    # kernel E: (form, NB, C, S, offsets). Verify: S = 4096 + spec_k + 8,
    # every row at its own offset; fill: one 256-token chunk of row 5.
    cases = [("verify", 8, 4, S_max + 12,
              [S_max - 4, 17, S_max // 4, S_max - 96, S_max * 5 // 8, 0,
               S_max * 13 // 16, S_max // 7]),
             ("fill", 1, 256, S_max, [S_max - 256]),
             ("fill", 1, 256, S_max, [S_max // 4])]
    for form, NB, C, S, offs in cases:
        Bc = 8
        k = randn(L, Bc, KV, S, Dh)
        v = randn(L, Bc, KV, S, Dh)
        rws = list(range(NB)) if form == "verify" else [5]
        for r, off in zip(rws, offs):      # stale entries past each chunk
            k[:, r, :, off + C:] = 30.0
            v[:, r, :, off + C:] = -50.0
        q = randn(NB, C, H, Dh).to(torch.bfloat16)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        r_t = torch.tensor(rws, dtype=torch.int32, device=dev)
        last = offs_t.long()[:, None] + torch.arange(C, device=dev)
        pairs = int((last + 1).clamp(max=S).sum())
        kv_keys = int((offs_t.long() + C).clamp(max=S).sum())
        layer = 2
        for quant in (False, True):
            if quant:
                (kc, ksc), (vc, vsc) = quantize_kv(k), quantize_kv(v)
            else:
                kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
                ksc = vsc = None
            # rows and offsets as int32 device tensors, as the steps pass them
            if form == "verify":
                call = lambda l: da.chunk_attention_batched(
                    q, kc, vc, offs_t, layer=l, k_scale=ksc, v_scale=vsc,
                    rows=r_t)
            else:
                call = lambda l: da.chunk_attention(
                    q[0], kc, vc, r_t, offs_t, layer=l, k_scale=ksc,
                    v_scale=vsc)[None]
            o, again = call(layer), call(layer)
            plain = lambda: da.chunk_attention_plain(
                q.float(), kc[layer][r_t], vc[layer][r_t], offs_t,
                k_scale=None if ksc is None else ksc[layer][r_t],
                v_scale=None if vsc is None else vsc[layer][r_t])
            ref = plain()
            flip = [layer]

            def kern():
                flip[0] = 0 if flip[0] == layer else layer
                call(flip[0])

            library = dict(library_ms=None)
            if not quant:   # SDPA with a boolean mask and GQA
                mask = (torch.arange(S, device=dev)[None, None]
                        <= last[..., None])[:, None]      # [NB, 1, C, S]
                qt, kl, vl = (q.transpose(1, 2), kc[layer][r_t],
                              vc[layer][r_t])
                library = three_ways(
                    lambda: F.scaled_dot_product_attention(
                        qt, kl, vl, attn_mask=mask, enable_gqa=True),
                    "library_")
            elem = 1 if quant else 2
            row = dict(form=form, dtype="int8" if quant else "bf16", NB=NB,
                       C=C, S=S, offs=offs, ms_method=MS_METHOD,
                       **three_ways(kern),
                       plain_ms=cuda_ms(plain, calls=5, reps=3), **library,
                       **bound(kv_keys * KV * (2 * Dh * elem
                                               + (8 if quant else 0))
                               + 4 * NB * C * H * Dh,
                               4 * H * Dh * pairs))
            check_attn_row(torch, "kernel E chunk_attn", o, again, ref, row)
            rows["chunk"].append(row)
            del kc, vc, ksc, vsc, o, again, ref
        del k, v
        torch.cuda.empty_cache()
    return rows


def phase_reference(torch, dev):
    """Small model, same weights: card (bf16, kernels) vs CPU (fp32, plain
    versions) through prefill and greedy decode steps."""
    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig)
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.models import llama as L

    lcfg = LlamaConfig(hidden_size=512, intermediate_size=1024, num_layers=2,
                       num_heads=4, num_kv_heads=1, head_dim=128)
    cfg = MetaMorphConfig(llama=lcfg, siglip=SiglipConfig.tiny(),
                          mm=MultimodalConfig(num_image_tokens=4))
    cpu = init_params(cfg, seed=3, device="cpu", dtype=torch.float32).llama
    gpu = copy.deepcopy(cpu).to(device=dev, dtype=torch.bfloat16)
    T, steps, S = 300, 8, 512
    ids = torch.randint(10, 120000, (1, T),
                        generator=torch.Generator().manual_seed(5))
    worst = 1.0
    agree = 0
    caches = {}
    states = {}
    for name, m, d in (("cpu", cpu, torch.device("cpu")), ("gpu", gpu, dev)):
        cache = L.init_kv_cache(lcfg, 1, S, dtype=m.embed.dtype, device=d)
        emb = L.embed_tokens(m, ids.to(d))
        pos = torch.arange(T, device=d)[None]
        h, _ = L.prefill(m, lcfg, emb, pos, None, cache)
        caches[name], states[name] = cache, h[:, -1]
    for i in range(steps + 1):
        lc = L.lm_head(cpu, lcfg, states["cpu"])[0]
        lg = L.lm_head(gpu, lcfg, states["gpu"])[0].cpu()
        cos = torch.nn.functional.cosine_similarity(lc, lg, dim=0).item()
        worst = min(worst, cos)
        agree += int(lc.argmax() == lg.argmax())
        tok = lc.argmax()[None]               # teacher-force the CPU stream
        if i == steps:
            break
        for name, m, d in (("cpu", cpu, torch.device("cpu")),
                           ("gpu", gpu, dev)):
            x = L.embed_tokens(m, tok.to(d))[:, None]
            idx = torch.tensor([T + i], device=d)
            h, _ = L.decode_step(m, lcfg, x, idx[:, None], caches[name], idx)
            states[name] = h[:, 0]
    row = dict(prompt=T, steps=steps, min_logit_cosine=worst,
               argmax_agree=f"{agree}/{steps + 1}", min_cos=REF_MIN_COS)
    log("reference (card bf16 kernels vs CPU fp32 plain)", json.dumps(row))
    if worst < REF_MIN_COS:
        raise AssertionError(f"card disagrees with the CPU reference: {row}")
    return row


def phase_reference_options(torch, dev):
    """Small model, same weights: card (bf16 weights, kernels B and E) vs
    CPU (fp32, plain versions) through the verify chunk and the fused fill
    step, with a bf16 (card) / fp32 (CPU) cache and with an int8 cache on
    both sides."""
    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig)
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.models import llama as L
    from metamorph_tpu_torch.ops import decode_attention as da

    lcfg = LlamaConfig(hidden_size=512, intermediate_size=1024, num_layers=2,
                       num_heads=4, num_kv_heads=1, head_dim=128)
    cfg = MetaMorphConfig(llama=lcfg, siglip=SiglipConfig.tiny(),
                          mm=MultimodalConfig(num_image_tokens=4))
    cpu = init_params(cfg, seed=4, device="cpu", dtype=torch.float32).llama
    gpu = copy.deepcopy(cpu).to(device=dev, dtype=torch.bfloat16)
    B, S, C_v, C_f, off, clen = 4, 512, 4, 64, 192, 50
    lens = [300, off, 257, 90]       # row 1 is filled from `off` on
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(10, 120000, (B, max(lens)), generator=g)
    v_ids = torch.randint(10, 120000, (B, C_v), generator=g)
    f_ids = torch.randint(10, 120000, (C_f,), generator=g)
    d_ids = torch.randint(10, 120000, (B,), generator=g)
    kernels = (da.DECODE_ATTN, da.DECODE_ATTN_INT8, da.CHUNK_ATTN,
               da.CHUNK_ATTN_INT8)
    out = {}
    for quant in (False, True):
        logits = {}
        for name, m, d in (("cpu", cpu, torch.device("cpu")),
                           ("gpu", gpu, dev)):
            cache = L.init_kv_cache(lcfg, B, S, dtype=m.embed.dtype, device=d,
                                    quantized=quant)
            T = max(lens)
            pos = torch.arange(T, device=d)[None].expand(B, T)
            L.prefill(m, lcfg, L.embed_tokens(m, ids.to(d)), pos, None,
                      cache)
            lens_t = torch.tensor(lens, dtype=torch.int32, device=d)
            # verify chunk at each row's length (stale prefill pad past it)
            rope = lens_t[:, None] + torch.arange(C_v, device=d)
            h_v, _ = L.decode_chunk_step_batched(
                m, lcfg, L.embed_tokens(m, v_ids.to(d)), rope, lens_t, cache)
            # fused fill step: row 1 gets a chunk at `off`, masked past
            # clen, with its decode write parked at off + clen
            idx = lens_t + C_v
            idx[1] = off + clen
            cpos = off + torch.arange(C_f, device=d)
            h_d, h_c, _ = L.decode_step_with_chunk(
                m, lcfg, L.embed_tokens(m, d_ids.to(d))[:, None],
                idx[:, None], cache, idx, L.embed_tokens(m, f_ids.to(d)),
                cpos, torch.arange(C_f, device=d) < clen, 1)
            hs = torch.cat([h_v.reshape(-1, h_v.shape[-1]),
                            h_d[[0, 2, 3], 0], h_c[:clen]])
            logits[name] = L.lm_head(m, lcfg, hs).float().cpu()
        cos = torch.nn.functional.cosine_similarity(logits["cpu"],
                                                    logits["gpu"], dim=-1)
        agree = (logits["cpu"].argmax(-1) == logits["gpu"].argmax(-1))
        key = "int8" if quant else "bf16"
        out[key] = dict(min_logit_cosine=cos.min().item(),
                        argmax_agree=f"{int(agree.sum())}/{agree.numel()}",
                        min_cos=REF_MIN_COS_INT8 if quant else REF_MIN_COS)
    row = dict(rows=B, verify_chunk=C_v, fill_chunk=C_f, fill_valid=clen,
               launched={k.symbol: k.launches for k in kernels}, **out)
    log("options reference (card bf16 kernels vs CPU fp32 plain)",
        json.dumps(row))
    for key, r in out.items():
        if r["min_logit_cosine"] < r["min_cos"]:
            raise AssertionError(f"card disagrees with the CPU reference "
                                 f"({key} cache): {row}")
    return row


def small_train_cfg(total_steps: int = 8):
    from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                            MultimodalConfig, SiglipConfig,
                                            TrainConfig)

    lcfg = LlamaConfig(hidden_size=512, intermediate_size=1024, num_layers=2,
                       num_heads=4, num_kv_heads=1, head_dim=128)
    return MetaMorphConfig(
        llama=lcfg, siglip=SiglipConfig.tiny(),
        mm=MultimodalConfig(num_image_tokens=4),
        train=TrainConfig(batch_size=1, max_seq_len=1024,
                          max_images_per_batch=2, total_steps=total_steps,
                          learning_rate=1e-4, remat_policy="save_attn_qkv"))


def phase_train_reference(torch, dev):
    """One train step of a small model, same weights: card (bf16, kernels)
    vs CPU (fp32, plain versions)."""
    import numpy as np

    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.profile_train import packed_row

    cfg = small_train_cfg()
    arrays = batch_to_arrays(packed_row(1024, 4, 2, seed=11))
    pixels = np.random.default_rng(12).normal(size=(2, 28, 28, 3)).astype(
        np.float32)
    cpu = init_params(cfg, seed=3, device="cpu", dtype=torch.float32)
    gpu = copy.deepcopy(cpu).to(device=dev, dtype=torch.bfloat16)
    out = {}
    for name, model, d in (("cpu", cpu, torch.device("cpu")),
                           ("gpu", gpu, dev)):
        state = TS.init_train_state(model, cfg)
        tx = make_optimizer(cfg.train, model)
        batch = {k: torch.from_numpy(v).to(d) for k, v in arrays.items()}
        _, m = TS.train_step(state, batch, torch.from_numpy(pixels).to(d),
                             cfg, tx)
        out[name] = ({k: float(v) for k, v in m.items()},
                     {n: p.grad.float().cpu()
                      for n, p in model.named_parameters()
                      if p.grad is not None})
    (mc, gc_), (mg, gg) = out["cpu"], out["gpu"]
    cos = {n: torch.nn.functional.cosine_similarity(
        gc_[n].flatten(), gg[n].flatten(), dim=0).item() for n in gc_}
    worst = min(cos, key=cos.get)
    # the AR term is a cosine in [-1, 1]: its scale is 1, not its value
    scale = {"loss": abs(mc["loss"]), "loss_language": abs(mc["loss_language"]),
             "loss_image_ar": 1.0}
    loss_err = {k: abs(mg[k] - mc[k]) / scale[k] for k in scale}
    row = dict(T=1024, metrics_gpu=mg, metrics_cpu=mc, loss_rel_err=loss_err,
               loss_tol=TRAIN_LOSS_RTOL, n_grads=len(cos),
               min_grad_cosine=cos[worst], worst_grad=worst,
               min_cos=TRAIN_MIN_GRAD_COS)
    log("train reference (card bf16 kernels vs CPU fp32 plain)",
        json.dumps(row))
    if gg.keys() != gc_.keys() or len(cos) == 0:
        raise AssertionError("card and CPU trained different tensors")
    if max(loss_err.values()) > TRAIN_LOSS_RTOL or \
            cos[worst] < TRAIN_MIN_GRAD_COS or mg["n_image_ar_tokens"] != 4:
        raise AssertionError(f"train step on the card disagrees with the CPU "
                             f"reference: {row}")
    return row


def phase_main(torch, dev):
    import numpy as np

    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.constants import LLAMA3_EOS_IDS
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.models.metamorph import encode_images
    from metamorph_tpu_torch.ops.decode_attention import DECODE_ATTN
    from metamorph_tpu_torch.ops.flash_attention import FLASH_FWD

    cfg = MetaMorphConfig()   # LLaMA-3.1-8B, SigLIP-SO400M, mlp2x_gelu, K=64
    K, D = cfg.mm.num_image_tokens, cfg.llama.hidden_size
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main: init_params 8B+SO400M {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = cfg.siglip.image_size
    with torch.no_grad():
        pixels = torch.randn((1, s, s, 3), generator=gen, device=dev)
        image_embeds, _ = encode_images(model, cfg, pixels)
    if tuple(image_embeds.shape) != (1, K, D) or \
            not torch.isfinite(image_embeds).all():
        raise AssertionError(f"encode_images gave {tuple(image_embeds.shape)}"
                             f" / non-finite values")

    rng = np.random.default_rng(0)
    spec = [(40, 16), (300, 32), (700, 24), (1500, 48), (77, 64), (200, 40)]
    reqs = [dict(prompt_ids=rng.integers(10, 128000, (t,)).astype(np.int32),
                 max_new_tokens=b, uid=f"text{t}") for t, b in spec]
    reqs.append(dict(prompt_ids=rng.integers(10, 128000, (120,)).astype(
        np.int32), image_embeds=image_embeds, image_positions=np.asarray([10]),
        max_new_tokens=32, uid="image"))

    eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096)

    def serve():
        for r in reqs:
            eng.submit(Request(**r))
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return {c.uid: c for c in done}, time.perf_counter() - t

    FLASH_FWD.launches = 0
    DECODE_ATTN.launches = 0
    run1, wall1 = serve()
    launches = {"flash_fwd": FLASH_FWD.launches,
                "decode_attn": ran_on_card(DECODE_ATTN, eng)}
    host_calls = {"decode_attn": DECODE_ATTN.launches}
    run2, wall2 = serve()

    budgets = {r["uid"]: r["max_new_tokens"] for r in reqs}
    eos = set(LLAMA3_EOS_IDS)
    for run in (run1, run2):
        if sorted(run) != sorted(budgets):
            raise AssertionError(f"served {sorted(run)}, want "
                                 f"{sorted(budgets)}")
        for uid, c in run.items():
            stopped = len(c.ids) > 0 and int(c.ids[-1]) in eos
            if not (c.steps == budgets[uid] or stopped):
                raise AssertionError(f"{uid}: {c.steps} steps, budget "
                                     f"{budgets[uid]}")
            if not np.isfinite(c.image_embeds).all():
                raise AssertionError(f"{uid}: non-finite image embeds")
    if not torch.isfinite(eng.state.next_embed).all():
        raise AssertionError("non-finite hidden state fed back")
    for uid in run1:
        if not np.array_equal(run1[uid].ids, run2[uid].ids):
            raise AssertionError(f"{uid}: ids differ between the two runs")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} did not run on the main "
                                 f"path")
    new_tokens = sum(c.steps for c in run1.values())
    row = dict(requests=len(run1), new_tokens=new_tokens,
               prompt_tokens=sum(len(r["prompt_ids"]) for r in reqs),
               wall_s_run1=wall1, wall_s_run2=wall2,
               tok_per_s_run1=new_tokens / wall1,
               tok_per_s_run2=new_tokens / wall2,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, host_calls=host_calls,
               ticks=dict(eng.tick_counts),
               image_tokens_generated=int(sum(c.image_embeds.shape[0]
                                              for c in run1.values())),
               ids_identical=True)
    log("main path", json.dumps(row))
    return row, (model, cfg, reqs, run1)


def ran_on_card(kern, eng) -> int:
    """Launches of `kern` that ran on the card while `eng` served: its host
    calls (`launches`, counted since the engine was made), less those made
    while the engine captured a plain tick's graph (recorded, not run),
    plus the graphs' replays times those calls."""
    captured, replayed = eng.graph_launches().get(kern.symbol, (0, 0))
    return kern.launches - captured + replayed


def record_fills(eng) -> list:
    """Have `eng` list the uid of every request it starts filling."""
    filled = []
    start_fill = eng._start_fill

    def wrapped(slot, req):
        filled.append(req.uid)
        start_fill(slot, req)

    eng._start_fill = wrapped
    return filled


def phase_serve_options(torch, dev, model, cfg, reqs, plain_run):
    """The serving options' main path at full width, on phase 5's model:
    ServeEngine(spec_k=4, fill_chunk=256, max_fills=2), once with the bf16
    cache and once with the int8 cache. Phase 5's requests plus two long
    prompts, queued after them, that stream in through chunked fill while
    the other slots decode. Every kernel count is set to 0 just before each
    run and read just after."""
    import numpy as np

    from metamorph_tpu_torch.constants import LLAMA3_EOS_IDS
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.ops import decode_attention as da
    from metamorph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(1)
    long_reqs = [dict(prompt_ids=rng.integers(10, 128000, (t,)).astype(
        np.int32), max_new_tokens=b, uid=f"long{t}")
        for t, b in ((1100, 40), (1500, 32))]
    all_reqs = list(reqs) + long_reqs
    budgets = {r["uid"]: r["max_new_tokens"] for r in all_reqs}
    eos = set(LLAMA3_EOS_IDS)
    kernels = (fa.FLASH_FWD, da.DECODE_ATTN, da.DECODE_ATTN_INT8,
               da.CHUNK_ATTN, da.CHUNK_ATTN_INT8)
    rows = {}
    for kv_int8 in (False, True):
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096,
                          spec_k=4, fill_chunk=256, max_fills=2,
                          kv_int8=kv_int8)
        filled = record_fills(eng)
        for r in all_reqs:
            eng.submit(Request(**r))
        for kern in kernels:
            kern.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = {c.uid: c for c in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k.symbol: dict(k.sites, total=k.launches,
                                   forms=dict(k.forms)) for k in kernels}
        key = "int8" if kv_int8 else "bf16"
        if sorted(done) != sorted(budgets):
            raise AssertionError(f"{key}: served {sorted(done)}")
        for uid, c in done.items():
            stopped = len(c.ids) > 0 and int(c.ids[-1]) in eos
            if not (c.steps == budgets[uid] or stopped):
                raise AssertionError(f"{key} {uid}: {c.steps} steps, budget "
                                     f"{budgets[uid]}")
            if not np.isfinite(c.image_embeds).all():
                raise AssertionError(f"{key} {uid}: non-finite image embeds")
        if not torch.isfinite(eng.state.next_embed).all():
            raise AssertionError(f"{key}: non-finite hidden state fed back")
        dec = da.DECODE_ATTN_INT8 if kv_int8 else da.DECODE_ATTN
        chunk = da.CHUNK_ATTN_INT8 if kv_int8 else da.CHUNK_ATTN
        need = {"fill ticks": eng.tick_counts["fill"],
                "spec ticks": eng.tick_counts["spec"],
                f"{dec.symbol} launches": dec.launches,
                f"{chunk.symbol} from chunk_attention (fill)":
                    chunk.sites.get("chunk_attention", 0),
                f"{chunk.symbol} from chunk_attention_batched (verify)":
                    chunk.sites.get("chunk_attention_batched", 0),
                "requests through chunked fill": len(filled)}
        missing = [k for k, n in need.items() if n <= 0]
        if missing or not {r["uid"] for r in long_reqs} <= set(filled):
            raise AssertionError(f"{key}: the options path did not run "
                                 f"{missing or 'the long prompts as fills'}:"
                                 f" {need}")
        # greedy ids against phase 5's plain bf16 engine: reported only
        # (bf16 argmax near-ties are not a fault)
        same = total = 0
        for uid, c in plain_run.items():
            n = min(len(c.ids), len(done[uid].ids))
            same += int((np.asarray(c.ids[:n]) == done[uid].ids[:n]).sum())
            total += max(len(c.ids), len(done[uid].ids))
        new_tokens = sum(c.steps for c in done.values())
        rows[key] = dict(
            requests=len(done), new_tokens=new_tokens, wall_s=wall,
            tok_per_s=new_tokens / wall, spec_accepted=eng.spec_accepted,
            ticks=dict(eng.tick_counts), filled=filled,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            cache_gib=sum(x.numel() * x.element_size()
                          for x in eng.state.cache.values()) / 2**30,
            ids_equal_to_plain_share=same / max(total, 1),
            launches=launches)
        log(f"serving options main path ({key} cache)", json.dumps(rows[key]))
        del eng, done
        free_memory(torch)
    return rows


# ---------------------------------------------------------------------------
# phase 10: the decode entry points and the front ends
# ---------------------------------------------------------------------------

DECODE_NEW = 48           # tokens per single-request run
SELF_DRAFT_MIN_ACCEPT = 0.5   # 10c: share of the drafts proposed to text
                              # requests that are accepted, with the main
                              # LLaMA as its own drafter (predicted >= 0.9;
                              # a broken catch-up or accept chain accepts
                              # about none). The image request is reported
                              # apart: the drafter sees its placeholder ids,
                              # not the image, so its drafts miss.


def drafter_1b_config():
    """The drafter's shape: the public meta-llama/Llama-3.2-1B config.json
    (hidden 2048, 16 layers, 32 heads, 8 KV heads, head dim 64,
    intermediate 8192, vocab 128256, tied embeddings, llama3 rope with
    factor 32)."""
    from metamorph_tpu_torch.config import LlamaConfig

    return LlamaConfig(vocab_size=128256, hidden_size=2048,
                       intermediate_size=8192, num_layers=16, num_heads=32,
                       num_kv_heads=8, head_dim=64, rope_theta=500000.0,
                       rms_norm_eps=1e-5, max_position_embeddings=131072,
                       rope_scaling=True, rope_scaling_factor=32.0,
                       rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
                       rope_original_max_position=8192,
                       tie_word_embeddings=True)


def phase_drafter_kernels(torch, dev, S: int = 4096):
    """10b: kernel B (bf16) and kernel E's two forms at the drafter's
    attention shape (Dh=64, KV=8, G=4) over a 4096-token cache, against
    their plain versions, with times, bounds and SDPA's time, as phase 3c
    does at Dh=128."""
    import torch.nn.functional as F

    from metamorph_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev)
    gen.manual_seed(4242)
    H, KV, Dh, L, B = 32, 8, 64, 2, 8
    rows = {"decode": [], "verify": [], "fill": []}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    # kernel B: 8 full rows (every key read), the serving slots' batch
    ck, cv = randn(L, B, KV, S, Dh), randn(L, B, KV, S, Dh)
    q = randn(B, H, Dh)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    layer = 1
    o, again = (da.decode_attention(q, ck, cv, lengths, layer=layer)
                for _ in range(2))
    ref = da.decode_attention_plain(q.float(), ck[layer].float(),
                                    cv[layer].float(), lengths)
    flip = [layer]

    def kern():   # alternate layers: each launch finds its rows cold
        flip[0] = 0 if flip[0] == layer else layer
        da.decode_attention(q, ck, cv, lengths, layer=flip[0])

    window = B * S
    row = dict(B=B, S=S, Dh=Dh, KV=KV, G=H // KV, ms_method=MS_METHOD,
               **three_ways(kern),
               plain_ms=cuda_ms(lambda: da.decode_attention_plain(
                   q, ck[layer], cv[layer], lengths)),
               **three_ways(lambda: F.scaled_dot_product_attention(
                   q[:, :, None], ck[layer], cv[layer], enable_gqa=True),
                   "library_"),
               **bound(window * KV * Dh * 2 * 2 + 2 * B * H * Dh * 2,
                       4 * H * Dh * window))
    check_attn_row(torch, "kernel B decode_attn (Dh=64)", o, again, ref,
                   row)
    rows["decode"].append(row)
    del ck, cv

    # kernel E: every row's chunk at its own offset, stale entries past
    # each chunk (S = 4096 + spec_k + 8, as the engine's); spec_k 4 gives
    # the verify form (G * C = 16 rows), spec_k 8 the fill form (32 rows),
    # which is the drafter's catch-up at --spec-k 8
    offs = [S - 4, 17, S // 4, S - 96, S * 5 // 8, 0, S * 13 // 16, S // 7]
    NB = len(offs)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    r_t = torch.arange(NB, dtype=torch.int32, device=dev)
    for form, C in (("verify", 4), ("fill", 8)):
        Sv = S + C + 8
        k, v = randn(L, B, KV, Sv, Dh), randn(L, B, KV, Sv, Dh)
        for r, off in enumerate(offs):
            k[:, r, :, off + C:] = 30.0
            v[:, r, :, off + C:] = -50.0
        q = randn(NB, C, H, Dh)
        call = lambda l: da.chunk_attention_batched(q, k, v, offs_t,
                                                    layer=l, rows=r_t)
        o, again = call(layer), call(layer)
        plain = lambda: da.chunk_attention_plain(q.float(), k[layer].float(),
                                                 v[layer].float(), offs_t)
        ref = plain()
        flip = [layer]

        def kern_e():
            flip[0] = 0 if flip[0] == layer else layer
            call(flip[0])

        last = offs_t.long()[:, None] + torch.arange(C, device=dev)
        mask = (torch.arange(Sv, device=dev)[None, None]
                <= last[..., None])[:, None]             # [NB, 1, C, Sv]
        pairs = int((last + 1).sum())
        kv_keys = int((offs_t.long() + C).sum())
        row = dict(form=form, NB=NB, C=C, S=Sv, Dh=Dh, KV=KV, G=H // KV,
                   offs=offs, ms_method=MS_METHOD, **three_ways(kern_e),
                   plain_ms=cuda_ms(plain, calls=5, reps=3),
                   **three_ways(lambda: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k[layer], v[layer],
                       attn_mask=mask, enable_gqa=True), "library_"),
                   **bound(kv_keys * KV * 2 * Dh * 2 + 4 * NB * C * H * Dh,
                           4 * H * Dh * pairs))
        check_attn_row(torch, f"kernel E chunk_attn {form} (Dh=64)", o,
                       again, ref, row)
        rows[form].append(row)
        del k, v
    torch.cuda.empty_cache()
    return rows


def _phase10_kernels():
    from metamorph_tpu_torch.ops import decode_attention as da
    from metamorph_tpu_torch.ops import flash_attention as fa

    return (fa.FLASH_FWD, da.DECODE_ATTN, da.DECODE_ATTN_INT8, da.CHUNK_ATTN,
            da.CHUNK_ATTN_INT8)


def _phase10_counts() -> dict:
    """Launches since the last reset: kernels A and B by symbol, kernel E
    by form (both cache types)."""
    fwd, dec, dec8, ch, ch8 = _phase10_kernels()
    return {"flash_fwd": fwd.launches, "decode_attn": dec.launches,
            "decode_attn_int8": dec8.launches,
            "chunk_verify": ch.forms.get("verify", 0)
            + ch8.forms.get("verify", 0),
            "chunk_fill": ch.forms.get("fill", 0) + ch8.forms.get("fill", 0)}


def _reset_phase10_counts() -> None:
    for k in _phase10_kernels():
        k.reset()


def _ids_of(out) -> list:
    """The generated ids of one entry point's output (a decode dict, a
    demo result, or a batched dict's rows)."""
    if "text" in out:
        return list(out["ids"])
    ids, n = out["ids"], out["n_ids"]
    if ids.dim() == 1:
        return ids[:int(n)].tolist()
    return [ids[b, :int(n[b])].tolist() for b in range(ids.shape[0])]


def _equal_share(a: list, b: list) -> float:
    n = max(len(a), len(b))
    return sum(x == y for x, y in zip(a, b)) / max(n, 1)


def phase_decode_frontends(torch, dev, model, cfg, reqs, plain_run):
    """Phase 10 on phase 5's model: the single-request and batched decode
    entry points (10a), the engine with a drafter (10c), the serve CLI's
    work function (10d) and the HTTP server (10e). Every kernel count is
    set to 0 just before each run and read just after."""
    import numpy as np

    from metamorph_tpu_torch.convert import init_llama
    from metamorph_tpu_torch.inference import decode as dec
    from metamorph_tpu_torch.inference import demo
    from metamorph_tpu_torch.inference import spec_decode as sd
    from metamorph_tpu_torch.inference.profile_serve import _kernel_table
    from metamorph_tpu_torch.models import llama as llama_lib
    from metamorph_tpu_torch.multimodal.mm_utils import tokenizer_image_token

    dcfg = drafter_1b_config()
    t = time.perf_counter()
    draft = init_llama(dcfg, seed=1, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"decode: 1B drafter init {time.perf_counter() - t:.1f}s")
    totals = {k: 0 for k in _phase10_counts()}
    runs = {}

    def run(name, fn, need, new_tokens):
        """fn() twice: the counts of the first run, its wall time, and
        identical ids on the second."""
        _reset_phase10_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _phase10_counts()
        for k, n in counts.items():
            totals[k] += n
        again = fn()
        same = _ids_of(out) == _ids_of(again)
        missing = [k for k in need if counts[k] <= 0]
        n_new = new_tokens(out)
        row = dict(wall_s=wall, new_tokens=n_new, tok_per_s=n_new / wall,
                   launches=counts, ids_repeat=same)
        if "iters" in out:           # chunk steps; single-request runs
            it = int(out["iters"])  # also give accepted drafts per step
            row.update(iters=it, steps=out["steps"].tolist())
            if out["steps"].dim() == 0:
                row["accepted_per_chunk"] = (int(out["steps"]) - 1 - it) / it
        runs[name] = (row, out)
        log(f"decode {name}", json.dumps(row))
        if not same or missing:
            raise AssertionError(f"{name}: ids differ between two runs "
                                 f"({not same}) or kernels not launched "
                                 f"{missing}: {row}")
        return out

    steps1 = lambda o: int(o["steps"])
    N = DECODE_NEW
    # 10a: one text request (phase 5's 300-token prompt)
    text = next(r for r in reqs if r["uid"] == "text300")["prompt_ids"]
    ids_t = torch.as_tensor(text, device=dev)
    with torch.no_grad():
        pe = llama_lib.embed_tokens(model.llama, ids_t[None])
    batch = {"tokens": text[None], "attn_mask": np.ones((1, len(text)),
                                                        np.int32)}
    g = run("generate", lambda: dec.generate(model, cfg, batch, None,
                                             max_new_tokens=N),
            ("flash_fwd", "decode_attn"), steps1)
    stop = int(g["ids"][N // 2])       # an id the greedy run emits midway
    run("greedy_int8_stop", lambda: dec.greedy_decode(
        model, cfg, pe, max_new_tokens=N, stop_ids=(stop,), kv_int8=True),
        ("flash_fwd", "decode_attn_int8"), steps1)
    for k, form in ((4, "chunk_verify"), (8, "chunk_fill")):
        run(f"spec{k}", lambda: sd.greedy_decode_spec(
            model, cfg, pe, ids_t, max_new_tokens=N, spec_k=k),
            ("flash_fwd", form), steps1)
    run("draft4", lambda: sd.greedy_decode_spec_draft_model(
        model, draft, cfg, dcfg, pe, ids_t, max_new_tokens=N, spec_k=4),
        ("flash_fwd", "chunk_verify", "decode_attn"), steps1)
    # one image request through the demo's work function (template,
    # packer, tower, projector, `generate` with pixels)
    frame = np.random.default_rng(3).integers(0, 256, (480, 640, 3),
                                              dtype=np.uint8)

    def demo_run(**kw):
        return demo.run(model, cfg, word_tokenize,
                        lambda ids: " ".join(map(str, ids)), 128000, [frame],
                        "What is in this image?", "square", N, **kw)

    n_ids = lambda o: len(o["ids"]) + o["n_image_tokens"]
    run("demo_image", demo_run, ("flash_fwd", "decode_attn"), n_ids)
    run("demo_image_spec8", lambda: demo_run(spec_k=8),
        ("flash_fwd", "chunk_fill"), n_ids)
    run("demo_image_draft4", lambda: demo_run(spec_k=4, draft=(draft, dcfg)),
        ("flash_fwd", "chunk_verify", "decode_attn"), n_ids)
    # the same image prompt, fused once, through the other entry points
    img_ids = tokenizer_image_token(demo.build_prompt(
        "What is in this image?", 1), word_tokenize, bos_token_id=128000)
    with torch.no_grad():
        emb, bt = dec._fused_embeds(
            model, cfg, *demo.prepare_inputs(cfg, img_ids, [frame]))
    n_img = int(bt["attn_mask"][0].sum())
    pe_img, ids_img = emb[:, :n_img], bt["tokens"][0, :n_img]
    gen_img = runs["demo_image"][1]["ids"]
    stop_img = int(gen_img[min(N // 2, len(gen_img) - 1)])
    run("demo_image_greedy_int8_stop", lambda: dec.greedy_decode(
        model, cfg, pe_img, max_new_tokens=N, stop_ids=(stop_img,),
        kv_int8=True), ("flash_fwd", "decode_attn_int8"), steps1)
    run("demo_image_spec4", lambda: sd.greedy_decode_spec(
        model, cfg, pe_img, ids_img, max_new_tokens=N, spec_k=4),
        ("flash_fwd", "chunk_verify"), steps1)
    del emb, pe_img
    # the device's busy share over one greedy run, under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        dec.generate(model, cfg, batch, None, max_new_tokens=N)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_ms = sum(r["ms"] for r in _kernel_table(prof))
    # 8 prompts of unequal length, left-padded as the JAX layout has them
    rng = np.random.default_rng(2)
    lens = [40, 77, 120, 200, 300, 700, 1000, 1500]
    T0 = max(lens)
    bids = np.zeros((len(lens), T0), np.int32)
    mask = np.zeros((len(lens), T0), np.int32)
    for b, n in enumerate(lens):
        bids[b, T0 - n:] = rng.integers(10, 128000, (n,))
        mask[b, T0 - n:] = 1
    with torch.no_grad():
        bemb = llama_lib.embed_tokens(model.llama,
                                      torch.as_tensor(bids, device=dev))
    nsum = lambda o: int(o["n_ids"].sum())
    bg = run("batched_greedy", lambda: dec.batched_greedy_decode(
        model, cfg, bemb, mask, max_new_tokens=N),
        ("flash_fwd", "decode_attn"), nsum)
    bs = run("batched_spec4", lambda: sd.batched_greedy_decode_spec(
        model, cfg, bemb, mask, bids, max_new_tokens=N, spec_k=4),
        ("flash_fwd", "chunk_verify"), nsum)
    del bemb

    # gates: the same prefill gives the same first token
    first = {name: _ids_of(out)[0] for name, (_, out) in runs.items()
             if not name.startswith(("batched", "demo"))}
    demo_first = {name: _ids_of(out)[0] for name, (_, out) in runs.items()
                  if name.startswith("demo")}
    batched_first = [[r[0] for r in _ids_of(out)] for out in (bg, bs)]
    if (len(set(first.values())) != 1 or len(set(demo_first.values())) != 1
            or batched_first[0] != batched_first[1]):
        raise AssertionError(f"first tokens differ: {first} {demo_first} "
                             f"{batched_first}")
    plain_ids = _ids_of(g)
    equal = {name: _equal_share(plain_ids, _ids_of(runs[name][1]))
             for name in ("spec4", "spec8", "draft4")}
    equal["batched_spec4"] = statistics.mean(
        _equal_share(a, b) for a, b in zip(_ids_of(bg), _ids_of(bs)))
    row = {"runs": {k: r for k, (r, _) in runs.items()},
           "ids_equal_to_plain_share": equal,
           "device_busy_share_generate": kernel_ms / prof_wall_ms,
           "profiled_generate": dict(wall_ms=prof_wall_ms,
                                     kernel_ms=kernel_ms, tokens=N)}
    log("decode entry points", json.dumps({
        k: v for k, v in row.items() if k != "runs"}))
    del runs, g, bg, bs, pe
    free_memory(torch)

    row["engine_draft"] = phase_engine_draft(torch, dev, model, cfg, reqs,
                                             plain_run, draft, dcfg, totals)
    del draft
    free_memory(torch)
    row["serve_cli"] = phase_serve_cli(torch, dev, model, cfg, totals)
    row["http"] = phase_http(torch, dev, model, cfg, totals)
    row["launches"] = totals
    for k in ("flash_fwd", "decode_attn", "decode_attn_int8",
              "chunk_verify", "chunk_fill"):
        if totals[k] <= 0:
            raise AssertionError(f"phase 10 never launched {k}: {totals}")
    log("decode and front ends: launches", json.dumps(totals))
    return row


def phase_engine_draft(torch, dev, model, cfg, reqs, plain_run, draft, dcfg,
                       totals):
    """10c: ServeEngine(spec_k=4, draft=...) on phase 5's requests, with
    the 1B drafter and then with the main LLaMA as its own drafter. Each
    request has a slot of its own (7 requests, 8 slots), so a slot's
    counter of accepted drafts is its request's. A greedy row's steps are
    1 (prefill) + its chunk steps + its accepted drafts while only spec
    ticks run, so (spec_k - 1) * (steps - 1 - accepted) is the drafts it
    was proposed; a plain tick adds a step without proposing, so with
    plain ticks the share read here is a lower bound."""
    import numpy as np

    from metamorph_tpu_torch.constants import LLAMA3_EOS_IDS
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine

    budgets = {r["uid"]: r["max_new_tokens"] for r in reqs}
    eos = set(LLAMA3_EOS_IDS)
    rows = {}
    for name, drafter in (("drafter_1b", (draft, dcfg)),
                          ("self", (model.llama, cfg.llama))):
        torch.cuda.reset_peak_memory_stats()
        eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=2048,
                          spec_k=4, draft=drafter)
        for r in reqs:
            eng.submit(Request(**r))
        _reset_phase10_counts()
        slot_of = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        # ServeEngine.run's loop, reading which slot holds each request
        while eng.pending or any(u is not None for u in eng.slot_uid):
            eng.step()
            slot_of.update({u: s for s, u in enumerate(eng.slot_uid)
                            if u is not None})
        done = {c.uid: c for c in eng.completed}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = _phase10_counts()
        for k, n in counts.items():
            totals[k] += n
        if sorted(done) != sorted(budgets):
            raise AssertionError(f"draft engine ({name}) served "
                                 f"{sorted(done)}")
        for uid, c in done.items():
            stopped = len(c.ids) > 0 and int(c.ids[-1]) in eos
            if not (c.steps == budgets[uid] or stopped):
                raise AssertionError(f"{name} {uid}: {c.steps} steps")
        extra = eng.state.spec_extra.tolist()
        per_req = {u: (extra[s], 3 * (done[u].steps - 1 - extra[s]))
                   for u, s in slot_of.items()}
        accepted = sum(a for a, _ in per_req.values())
        proposed = sum(p for _, p in per_req.values())
        text = [v for u, v in per_req.items() if u.startswith("text")]
        text_share = sum(a for a, _ in text) / max(sum(p for _, p in text), 1)
        new_tokens = sum(c.steps for c in done.values())
        rows[name] = dict(
            requests=len(done), new_tokens=new_tokens, wall_s=wall,
            tok_per_s=new_tokens / wall, accepted=accepted,
            proposed=proposed, accepted_share=accepted / max(proposed, 1),
            accepted_share_text=text_share,
            accepted_proposed_by_request=per_req, ticks=dict(eng.tick_counts),
            ids_equal_to_plain_share=statistics.mean(
                _equal_share(list(plain_run[u].ids), list(done[u].ids))
                for u in done),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=counts)
        log(f"draft engine ({name})", json.dumps(rows[name]))
        need = ("flash_fwd", "chunk_verify", "decode_attn")
        if any(counts[k] <= 0 for k in need):
            raise AssertionError(f"draft engine ({name}) did not launch "
                                 f"{need}: {counts}")
        del eng, done
        free_memory(torch)
    share = rows["self"]["accepted_share_text"]
    if share < SELF_DRAFT_MIN_ACCEPT:
        raise AssertionError(f"the main LLaMA as its own drafter had "
                             f"{share:.3f} of the drafts for text requests "
                             f"accepted (< {SELF_DRAFT_MIN_ACCEPT})")
    return rows


def phase_serve_cli(torch, dev, model, cfg, totals):
    """10d: the serve CLI's work function over a requests JSONL written
    here (text rows, one long prompt that streams in through chunked
    fill, one image row, per-row budgets), tokenized by `word_tokenize`,
    the model given in memory."""
    import numpy as np

    from metamorph_tpu_torch.inference import serve_cli

    d = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        rng = np.random.default_rng(5)
        frame = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
        try:
            from PIL import Image

            image = os.path.join(d, "image.png")
            Image.fromarray(frame).save(image)
            frames_of = None                   # the CLI's own loader
        except ImportError:
            image = "inline"
            frames_of = lambda path: [frame]
        words = lambda n: " ".join(f"w{int(x)}" for x in
                                   rng.integers(0, 5000, n))
        rows = [{"prompt": words(12), "uid": "short", "max_new_tokens": 16},
                {"prompt": words(700), "uid": "long", "max_new_tokens": 24},
                {"prompt": "What is in this image?", "image": image,
                 "uid": "image", "max_new_tokens": 20},
                {"prompt": words(60), "uid": "default"},
                {"prompt": words(200), "uid": "mid", "max_new_tokens": 8}]
        path = os.path.join(d, "requests.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        rows = [json.loads(line) for line in open(path)]
        args = serve_cli.parse_args([
            "--model-path", "-", "--tokenizer", "-", "--requests", path,
            "--out", "-", "--max-new-tokens", "32"])
        _reset_phase10_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = serve_cli.run(model, cfg, rows, word_tokenize,
                            lambda ids: " ".join(map(str, ids)), 128000,
                            args, frames_of=frames_of)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    counts = _phase10_counts()
    for k, n in counts.items():
        totals[k] += n
    budgets = [r.get("max_new_tokens", 32) for r in rows]
    if [o["uid"] for o in out] != [r["uid"] for r in rows] or not all(
            1 <= o["steps"] <= b for o, b in zip(out, budgets)):
        raise AssertionError(f"serve CLI: {out}")
    if counts["flash_fwd"] <= 0 or counts["decode_attn"] <= 0:
        raise AssertionError(f"serve CLI did not launch A and B: {counts}")
    row = dict(requests=len(out), wall_s=wall, image_source=(
        "png" if frames_of is None else "inline array"),
        steps={o["uid"]: o["steps"] for o in out},
        n_image_tokens={o["uid"]: o["n_image_tokens"] for o in out},
        launches=counts)
    log("serve CLI", json.dumps(row))
    return row


def phase_http(torch, dev, model, cfg, totals):
    """10e: MetaMorphHTTPServer on 127.0.0.1:0 over an 8-slot engine, 8
    concurrent requests through urllib, half of them streaming."""
    import threading
    import urllib.request

    import numpy as np

    from metamorph_tpu_torch.inference.serve import ServeEngine
    from metamorph_tpu_torch.inference.serve_http import MetaMorphHTTPServer

    rng = np.random.default_rng(7)
    lens = [40, 1500, 120, 700, 77, 300, 1000, 200]
    bodies = [{"prompt_ids": rng.integers(10, 128000, (n,)).tolist(),
               "max_new_tokens": 32, "stream": bool(i % 2)}
              for i, n in enumerate(lens)]
    srv = MetaMorphHTTPServer(ServeEngine(model, cfg, n_slots=8,
                                          max_cache_len=4096),
                              port=0, decode=lambda ids: " ".join(
                                  map(str, ids)))
    results, errors = {}, []

    def go(i):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=json.dumps(bodies[i]).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            first = None
            with urllib.request.urlopen(req, timeout=300) as r:
                if bodies[i]["stream"]:
                    lines = []
                    for line in r:
                        if line.strip():
                            first = first or time.perf_counter() - t0
                            lines.append(json.loads(line))
                    final = lines[-1]
                    streamed = [t for x in lines[:-1] for t in x["ids"]]
                    if not final.get("done") or streamed != final["ids"]:
                        raise AssertionError(f"request {i}: streamed "
                                             f"chunks != final ids")
                else:
                    final = json.loads(r.read())
            results[i] = dict(first_s=first, done_s=time.perf_counter() - t0,
                              n=len(final["ids"]))
        except Exception as e:              # noqa: BLE001 (re-raised below)
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    _reset_phase10_counts()
    srv.start()
    try:
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
    counts = _phase10_counts()
    for k, n in counts.items():
        totals[k] += n
    if errors or len(results) != len(bodies):
        raise AssertionError(f"HTTP: {errors or sorted(results)}")
    if not (health["slots_free"] == 8 and health["pending"] == 0):
        raise AssertionError(f"HTTP health after the run: {health}")
    if counts["flash_fwd"] <= 0 or counts["decode_attn"] <= 0:
        raise AssertionError(f"HTTP path did not launch A and B: {counts}")
    firsts = [r["first_s"] for r in results.values() if r["first_s"]]
    dones = [r["done_s"] for r in results.values()]
    row = dict(requests=len(results), streaming=len(firsts),
               first_chunk_s_median=statistics.median(firsts),
               first_chunk_s_max=max(firsts),
               completion_s_median=statistics.median(dones),
               completion_s_max=max(dones), health=health, launches=counts)
    log("HTTP server", json.dumps(row))
    del srv
    free_memory(torch)
    return row


def phase_train_main(torch, dev):
    """The stage-2 dual-loss train step at LLaMA-3.1-8B + SO400M width."""
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.profile_train import (STAGE2, packed_row,
                                                         stage2_one_card)

    cfg, reduced = stage2_one_card(4096)
    full = MetaMorphConfig.from_json(STAGE2.read_text()).train
    for k, v in reduced.items():
        log(f"train main: reduced train.{k} {getattr(full, k)} -> {v}")
    T, K, N = cfg.train.max_seq_len, cfg.mm.num_image_tokens, \
        cfg.train.max_images_per_batch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    state = TS.init_train_state(model, cfg)
    tx = make_optimizer(cfg.train, model)
    torch.cuda.synchronize()
    log(f"train main: params + AdamW state {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_to_arrays(packed_row(T, K, N, seed=21)).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = cfg.siglip.image_size
    pixels = torch.randn((N, s, s, 3), generator=gen, device=dev)
    lm = model.llama
    sampled = {"llama.layers.0.wq": lm.layers[0].wq,
               "llama.layers.31.w_down": lm.layers[31].w_down,
               "llama.final_norm": lm.final_norm,
               "projector.layers.0.kernel": model.projector.layers[0].kernel,
               "vision_head.layers.1.kernel":
                   model.vision_head.layers[1].kernel}
    before = {n: p.detach().clone() for n, p in sampled.items()}
    # 14a holds the sharded step to this one after its second step: every
    # tensor's checksum, and the first UPDATE_SAMPLE elements of each
    init_sample = {n: p.detach().reshape(-1)[:UPDATE_SAMPLE].float().cpu()
                   for n, p in model.named_parameters()}
    step2 = {}

    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
    for kern in kernels:
        kern.launches = 0
    steps, times = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = TS.train_step(state, batch, pixels, cfg, tx)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        steps.append(m)
        log(f"train main: step {i + 1} {times[-1]:.3f}s", json.dumps(m))
        if i == 0:
            changed = [n for n, p in sampled.items()
                       if not torch.equal(p, before[n])]
            if changed:
                raise AssertionError(f"step 1 runs at lr 0 but changed "
                                     f"{changed}")
        if i == 1:
            step2 = {n: (tensor_checksum(torch, p),
                         p.detach().reshape(-1)[:UPDATE_SAMPLE].float().cpu()
                         - init_sample[n])
                     for n, p in model.named_parameters()}
    launches = {k.symbol: k.launches for k in kernels}
    del before, sampled

    for i, m in enumerate(steps):
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       m.values())):
            raise AssertionError(f"step {i + 1}: non-finite metric {m}")
        if m["n_image_ar_tokens"] != K or not m["grad_norm"] > 0:
            raise AssertionError(f"step {i + 1}: {m}")
    l1 = steps[0]["loss"]
    if abs(steps[1]["loss"] - l1) > 1e-6 * abs(l1):
        raise AssertionError(f"step 2 loss {steps[1]['loss']} != step 1 loss "
                             f"{l1} on unchanged weights")
    if not (steps[2]["loss"] < l1 and steps[3]["loss"] < l1):
        raise AssertionError(f"losses did not fall below step 1: "
                             f"{[m['loss'] for m in steps]}")
    for kern in kernels:
        if kern.launches <= 0:
            raise AssertionError(f"kernel {kern.symbol} was not launched by "
                                 f"the train main path")

    lc = cfg.llama
    n_dense = sum(p.numel() for p in lm.parameters()) - lm.embed.numel()
    attn_flops = 6 * lc.num_layers * lc.num_heads * lc.head_dim * T * T
    step_s = statistics.median(times[1:])
    row = dict(T=T, K=K, image_slots=N, reduced=reduced,
               step_s=times, step_s_median_2_4=step_s,
               tokens_per_s=T / step_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               losses=[m["loss"] for m in steps],
               grad_norms=[m["grad_norm"] for m in steps],
               launches=launches, llm_dense_params=n_dense,
               model_flop_share=(6 * n_dense * T + attn_flops) / step_s
               / (PEAK_BF16_TFLOPS * 1e12))
    log("train main path", json.dumps(row))
    # for 14a, kept out of the logged row
    row["step2"] = step2
    del state, model, batch, pixels
    return row


def phase_trainer(torch, dev):
    """train() on the card at the 4b width: metrics.jsonl, saves with
    pruning, and a resume."""
    import dataclasses
    import signal

    from metamorph_tpu_torch.train.trainer import TrainerArgs, train

    from metamorph_tpu_torch.train.profile_train import packed_row

    cfg = small_train_cfg(total_steps=3)
    packed = packed_row(1024, 4, 2, seed=31)

    class Data:
        def __init__(self):
            self.state = {"step_in_epoch": 0}

        def state_dict(self):
            return dict(self.state)

        def load_state_dict(self, s):
            self.state = dict(s)

        def __iter__(self):
            import numpy as np

            rng = np.random.default_rng(32)
            while True:
                self.state["step_in_epoch"] += 1
                yield packed, rng.normal(size=(2, 28, 28, 3)).astype(
                    np.float32)

    with tempfile.TemporaryDirectory() as d:
        args = TrainerArgs(output_dir=d, save_steps=2, save_total_limit=2)

        def logged():
            with open(os.path.join(d, "metrics.jsonl")) as f:
                return [json.loads(l)["step"] for l in f]

        out = train(cfg, args, Data())
        first = (out["step"], logged(), sorted(os.listdir(d)))
        cfg4 = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, total_steps=4))
        out = train(cfg4, args, Data())
        second = (out["step"], logged(), sorted(os.listdir(d)))
    # PreemptionSaver's handlers: hand SIGTERM/SIGUSR1 back
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        signal.signal(sig, signal.SIG_DFL)
    row = dict(first_run=first, resumed_run=second,
               loss=out["metrics"]["loss"])
    log("train() loop", json.dumps(row))
    if first != (3, [1, 2, 3], ["metrics.jsonl", "step_2", "step_3"]) or \
            second != (4, [1, 2, 3, 4],
                       ["metrics.jsonl", "step_3", "step_4"]):
        raise AssertionError(f"train() loop: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 8: the recipe's data path
# ---------------------------------------------------------------------------

RECIPE_TRAIN_STEPS = 4
STEP_SPREAD_MARGIN = 0.05   # 8a's step against 5b's spread, either side


def write_recipe_jsonl(d: str, seed: int, n_rows: int = 12,
                       image_hw=((480, 640), (384, 512), (600, 400)),
                       words=(700, 3400), use_files: bool = True) -> str:
    """A conversation JSONL in the llama3 recipe's format, written into
    `d` with its images: rows with one prompt image, rows whose gpt turn
    holds an answer image (AR targets), multi-image and multi-turn rows;
    long answers, so rows hold 1,000-4,000 tokens. Images are PNG files
    (`use_files`), or pre-loaded arrays inline (the reference's metaclip
    route, which needs no decoder) in a file whose name says `metacliptar`.
    Row r holds r % 4 + 1 images at most (4 image slots per batch)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                rng.integers(2, 9))) for _ in range(4000)]

    def text(n):
        return " ".join(rng.choice(vocab, n))

    def image(i):
        h, w = image_hw[i % len(image_hw)]
        base = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
        arr = (base + rng.normal(0, 30, (h, w, 3))).clip(0, 255)
        return arr.astype(np.uint8)

    name = "recipe.jsonl" if use_files else "recipe_metacliptar.jsonl"
    rows = []
    n_img = 0
    for r in range(n_rows):
        n_words = int(rng.integers(*words))
        kind = r % 4
        if kind == 0:       # one prompt image, a long answer
            convs = [("human", "<image>\n" + text(30)),
                     ("gpt", text(n_words))]
            k = 1
        elif kind in (1, 3):  # an answer image early in the gpt turn
            convs = [("human", "<image>\n" + text(25) + " draw it"),
                     ("gpt", text(12) + " <image> " + text(n_words))]
            k = 2
        else:               # two prompt images, then a second round
            convs = [("human", "<image> <image>\n" + text(40)),
                     ("gpt", text(n_words // 2)),
                     ("human", text(20) + " <image> and this one"),
                     ("gpt", text(n_words // 2))]
            k = 3
        arrays = [image(n_img + i) for i in range(k)]
        n_img += k
        if use_files:
            from PIL import Image

            paths = []
            for i, arr in enumerate(arrays):
                path = os.path.join(d, f"img_{r}_{i}.png")
                Image.fromarray(arr).save(path)
                paths.append(path)
            images = paths
        else:               # one stack per row: the arrays share a shape
            images = np.stack([a[:96, :128] for a in arrays]).tolist()
        rows.append({"id": f"recipe_{r}", "image": images,
                     "conversations": [{"from": f, "value": v}
                                       for f, v in convs]})
    path = os.path.join(d, name)
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return path


def recipe_builder(cfg, d: str, data_path: str, **flags):
    """`train.main`'s builder on the phase's tokenizer: the CLI flags of a
    recipe run (the config JSON written into `d`), then the dataset,
    collator and iterator, and the TrainerArgs."""
    from metamorph_tpu_torch.train import main as cli

    cfg_path = os.path.join(d, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    argv = ["--config", cfg_path, "--data-path", data_path,
            "--tokenizer", "(word_tokenize)", "--output-dir",
            os.path.join(d, "out"), "--group-by-modality-length"]
    for k, v in flags.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return cli.build(cli.parse_args(argv), cfg, word_tokenize)


def read_metrics(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f]


def phase_recipe_main(torch, dev, train_row):
    """8a: the stage-2 recipe from a JSONL at LLaMA-3.1-8B + SO400M width:
    dataset -> collator -> iterator -> train() on the card."""
    import dataclasses

    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.multimodal import native
    from metamorph_tpu_torch.multimodal.packing import pack_sequences
    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.train.profile_train import (STAGE2,
                                                         stage2_one_card)
    from metamorph_tpu_torch.train.trainer import train

    cfg, reduced = stage2_one_card(4096)
    reduced = dict(reduced, total_steps=RECIPE_TRAIN_STEPS)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_steps=RECIPE_TRAIN_STEPS))
    full = MetaMorphConfig.from_json(STAGE2.read_text()).train
    for k, v in reduced.items():
        log(f"recipe main: reduced train.{k} {getattr(full, k)} -> {v}")
    try:
        import PIL  # noqa: F401
        use_files = True
    except ImportError:
        use_files = False
        log("recipe main: PIL does not import here; the images go inline "
            "through the metaclip route (a 'metacliptar' data path)")
    if not native.native_available():
        raise AssertionError(f"the native packer did not build: "
                             f"{native.NATIVE.error}")

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = write_recipe_jsonl(d, seed=0, use_files=use_files)
        log(f"recipe main: wrote {path} ({os.path.getsize(path)} bytes, "
            f"{'PNG files' if use_files else 'inline arrays'}) in "
            f"{time.perf_counter() - t0:.1f}s")
        # the host side alone: a second iterator in the same order times
        # dataset + collate + pack per batch and gives the batches the
        # trainer will see
        probe, _ = recipe_builder(cfg, d, path)
        host_ms, expect = [], []
        gen = iter(probe)
        for _ in range(8):
            t = time.perf_counter()
            packed, pixels = next(gen)
            host_ms.append((time.perf_counter() - t) * 1e3)
            if len(expect) < RECIPE_TRAIN_STEPS:
                expect.append(dict(
                    real_tokens=int(packed.attn_mask.sum()),
                    n_image_ar_tokens=int(packed.image_ar_mask.sum()),
                    n_text_tokens=int((packed.labels[:, 1:] != -100).sum()),
                    images=int(packed.image_slot_used.sum())))
        items = [probe.dataset[i] for i in range(4)]
        ids = [[it["input_ids"]] for it in items]
        labs = [[it["labels"]] for it in items]
        K, T, N = cfg.mm.num_image_tokens, cfg.train.max_seq_len, \
            cfg.train.max_images_per_batch
        pack_ms = {}
        for name, fn in (("native", native.pack_sequences_native),
                         ("python", pack_sequences)) * 2:
            t = time.perf_counter()
            for a, b in zip(ids, labs):
                fn(a, b, K, T, N)
            pack_ms.setdefault(name, []).append(
                (time.perf_counter() - t) * 1e3 / len(ids))
        row_tokens = [len(it["input_ids"]) + 63 * it["input_ids"].count(-200)
                      for it in items]
        log("recipe main: host path", json.dumps(dict(
            host_ms_per_batch=host_ms, expect=expect,
            pack_ms_per_row={k: min(v) for k, v in pack_ms.items()},
            first_rows_tokens=row_tokens)))
        if not any(e["n_image_ar_tokens"] > 0 for e in expect):
            raise AssertionError(f"no answer image in the first "
                                 f"{RECIPE_TRAIN_STEPS} batches: {expect}")
        del probe, gen, items

        # no checkpoint: the 8B state is ~49 GB, more than the 45 GiB a
        # chip machine's disk takes in all; 8b saves and resumes
        data_iter, args = recipe_builder(cfg, d, path, save_steps=0,
                                         no_resume=True)
        kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
        for kern in kernels:
            kern.launches = 0
        native.PACKS.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train(cfg, args, data_iter, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        packs = dict(native.PACKS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = read_metrics(args.output_dir)
        saved = sorted(os.listdir(args.output_dir))
        del out
        free_memory(torch)
        # the same batches collated beforehand: no loader work on the host
        # while the steps run, so the difference in step time is the
        # loader's share of the host (its Python competes for the GIL with
        # the thread that launches the step's kernels)
        ready_iter, ready_args = recipe_builder(
            cfg, d, path, save_steps=0, no_resume=True,
            output_dir=os.path.join(d, "ready"))
        ready = [b for _, b in zip(range(RECIPE_TRAIN_STEPS), ready_iter)]
        ready_out = train(cfg, ready_args, ready, device=dev)
        ready_steps = read_metrics(ready_args.output_dir)
        # 11d: `evaluate` over the same batches on the trained model
        eval_row = phase_evaluate(torch, ready_out["state"]["params"], cfg,
                                  ready)
        del ready, ready_out
    free_memory(torch)

    step_s = [m["step_s"] for m in steps]
    ready_s = [m["step_s"] for m in ready_steps]
    med = statistics.median(step_s[1:])
    ref = train_row["step_s"][1:]
    lo, hi = min(ref), max(ref)
    real = sum(e["real_tokens"] for e in expect[1:])
    row = dict(T=T, K=K, image_slots=N, reduced=reduced,
               images="png" if use_files else "inline arrays",
               losses=[m["loss"] for m in steps],
               n_image_ar_tokens=[m["n_image_ar_tokens"] for m in steps],
               step_s=step_s, step_s_median_2_4=med,
               train_main_step_s_2_4=ref,
               ready_batches_step_s=ready_s,
               ready_batches_step_s_median_2_4=statistics.median(ready_s[1:]),
               ready_batches_losses=[m["loss"] for m in ready_steps],
               real_tokens_per_s=real / sum(step_s[1:]),
               data_wait_s=[m["data_wait_s"] for m in steps],
               host_ms_per_batch_median=statistics.median(host_ms),
               host_ms_per_batch_max=max(host_ms),
               pack_ms_per_row={k: min(v) for k, v in pack_ms.items()},
               packs=packs, peak_mem_gib=peak, launches=launches,
               train_wall_s=wall, evaluate=eval_row)
    log("recipe main path", json.dumps(row))
    for i, (m, e) in enumerate(zip(steps, expect)):
        if not all(map(lambda x: x == x and abs(x) != float("inf"),
                       m.values())):
            raise AssertionError(f"step {i + 1}: non-finite metric {m}")
        if m["n_image_ar_tokens"] != e["n_image_ar_tokens"] or \
                m["n_text_tokens"] != max(e["n_text_tokens"], 1):
            raise AssertionError(f"step {i + 1} trained another batch than "
                                 f"the iterator gives: {m} vs {e}")
    if [m["loss"] for m in ready_steps] != [m["loss"] for m in steps]:
        raise AssertionError("the batches collated beforehand trained to "
                             "other losses")
    if len(steps) != RECIPE_TRAIN_STEPS or saved != ["metrics.jsonl"]:
        raise AssertionError(f"train() logged {len(steps)} steps and wrote "
                             f"{saved}")
    if packs.get("native", 0) < RECIPE_TRAIN_STEPS or packs.get("python"):
        raise AssertionError(f"the native packer did not pack every batch: "
                             f"{packs}")
    for kern in kernels:
        if kern.launches <= 0:
            raise AssertionError(f"kernel {kern.symbol} was not launched by "
                                 f"the recipe's data path")
    if not lo * (1 - STEP_SPREAD_MARGIN) <= med <= \
            hi * (1 + STEP_SPREAD_MARGIN):
        raise AssertionError(
            f"recipe step {med:.3f}s is outside the train main path's spread "
            f"[{lo:.3f}, {hi:.3f}]s +-{STEP_SPREAD_MARGIN:.0%}")
    return row


def phase_recipe_small(torch, dev):
    """8b at the 4b width: text-only and image rows, a resume from the data
    state of the save at step 2 against an uninterrupted run; then an
    anyres run on the card against the CPU on the same weights."""
    import dataclasses
    import signal

    import numpy as np

    from metamorph_tpu_torch.config import MultimodalConfig
    from metamorph_tpu_torch.convert import from_jax_params, to_jax_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.trainer import build_params, train

    small = small_train_cfg(total_steps=4)
    cfg = dataclasses.replace(small, train=dataclasses.replace(
        small.train, max_seq_len=256, max_images_per_batch=4))
    row = {}
    with tempfile.TemporaryDirectory() as d:
        path = write_recipe_jsonl(d, seed=1, n_rows=6, image_hw=((40, 30),),
                                  words=(20, 80))
        with open(path, "a") as f:   # text-only rows: the dummy image
            for i in range(4):
                f.write(json.dumps({"id": f"text_{i}", "image": None,
                                    "conversations": [
                                        {"from": "human",
                                         "value": "hello " * (i + 2)},
                                        {"from": "gpt",
                                         "value": "fine words " * (3 + i)}]})
                        + "\n")
        runs = {}
        # only the interrupted run saves (at step 2, its last)
        for name, total, save_steps, resume in (
                ("whole", 4, 0, False), ("first", 2, 2, False),
                ("resumed", 4, 0, True)):
            out_dir = os.path.join(d, "whole" if name == "whole" else "cut")
            run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, total_steps=total))
            data_iter, args = recipe_builder(
                run_cfg, d, path, save_steps=save_steps, output_dir=out_dir,
                **({} if resume else {"no_resume": True}))
            train(run_cfg, args, data_iter, device=dev)
            runs[name] = read_metrics(out_dir)
            if name == "first":
                with open(os.path.join(out_dir, "step_2", "meta.json")) as f:
                    saved_state = json.load(f)["data_state"]
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        signal.signal(sig, signal.SIG_DFL)
    whole, resumed = runs["whole"], runs["resumed"]
    keys = ("n_text_tokens", "n_image_ar_tokens")
    row["resume"] = dict(
        data_state_at_save=saved_state,
        whole=[{k: m[k] for k in keys + ("loss",)} for m in whole],
        resumed=[{k: m[k] for k in keys + ("loss",)} for m in resumed])
    log("recipe small: resume", json.dumps(row["resume"]))
    if [m["step"] for m in resumed] != [1, 2, 3, 4] or \
            [[m[k] for k in keys] for m in resumed[2:]] != \
            [[m[k] for k in keys] for m in whole[2:]]:
        raise AssertionError(f"the resumed run saw other batches than the "
                             f"uninterrupted one: {row['resume']}")
    if any(abs(a["loss"] - b["loss"]) > TRAIN_LOSS_RTOL * abs(b["loss"])
           for a, b in zip(resumed[2:], whole[2:])):
        raise AssertionError(f"the resumed run's losses differ: "
                             f"{row['resume']}")

    # anyres: pinpoints that are multiples of the tiny tower's 28 pixels
    pins = ((28, 56), (56, 28), (56, 56))
    acfg = dataclasses.replace(cfg, mm=MultimodalConfig(
        num_image_tokens=4, image_token_reduction="none",
        image_aspect_ratio="anyres", mm_patch_merge_type="spatial_unpad",
        image_grid_pinpoints=pins), train=dataclasses.replace(
            cfg.train, total_steps=2, batch_size=2, max_images_per_batch=6))
    with tempfile.TemporaryDirectory() as d:
        path = write_recipe_jsonl(d, seed=2, n_rows=4,
                                  image_hw=((30, 60), (50, 20)),
                                  words=(20, 60))
        flags = dict(image_aspect_ratio="anyres", no_resume=True,
                     save_steps=0)
        data_iter, args = recipe_builder(acfg, d, path, **flags)
        tree = to_jax_params(build_params(acfg, args, device=dev))
        train(acfg, args, data_iter, device=dev)
        card = read_metrics(args.output_dir)
        probe, _ = recipe_builder(acfg, d, path, **flags)
        batches = [b for _, b in zip(range(2), iter(probe))]
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        signal.signal(sig, signal.SIG_DFL)
    model = from_jax_params(tree, acfg, device="cpu", dtype=torch.float32)
    state = TS.init_train_state(model, acfg)
    tx = make_optimizer(acfg.train, model)
    cpu = []
    for packed, pixels in batches:
        if packed.view_map is None:
            raise AssertionError("the anyres collator gave no view_map")
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch_to_arrays(packed).items()}
        state, m = TS.train_step(state, batch, torch.from_numpy(pixels),
                                 acfg, tx)
        cpu.append({k: float(v) for k, v in m.items()})
    err = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(card, cpu)]
    row["anyres"] = dict(card=[m["loss"] for m in card],
                         cpu=[m["loss"] for m in cpu], loss_rel_err=err,
                         tol=TRAIN_LOSS_RTOL)
    log("recipe small: anyres (card bf16 vs CPU fp32)",
        json.dumps(row["anyres"]))
    if len(card) != 2 or max(err) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"anyres train() on the card disagrees with "
                             f"the CPU: {row['anyres']}")
    return row


# ---------------------------------------------------------------------------
# phase 9: weights (export, load, LoRA, train() from the files)
# ---------------------------------------------------------------------------

LORA_R, LORA_ALPHA = 64, 16.0
LORA_MIN_COS = 0.999     # merged bf16 weights against the unmerged factors:
                         # the bf16 merge rounds w + a @ b * scale once more
LORA_MAX_BASE_COS = 0.99  # the unmerged factors against the base model
# The std of the seeded B factors: with x @ a about as large as x (A ~
# N(0, 1/D_in)) and scale alpha / r = 0.25, the LoRA path of every linear is
# about half the size of x @ w (w ~ N(0, 1/D_in)), far above the rounding of
# a bf16 weight
LORA_B_STD = 0.25
CHECKSUM_CHUNK = 1 << 24


def tensor_checksum(torch, t) -> tuple:
    """Two int64 sums of a tensor's bits on its device, plain and weighted
    by position (mod 65521): equal bits give equal sums, and a changed or
    moved element changes them. With the dtype and shape."""
    v = t.detach().reshape(-1)
    v = v.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[v.element_size()])
    s1 = torch.zeros((), dtype=torch.int64, device=v.device)
    s2 = torch.zeros((), dtype=torch.int64, device=v.device)
    for start in range(0, v.numel(), CHECKSUM_CHUNK):
        c = v[start:start + CHECKSUM_CHUNK].to(torch.int64)
        w = torch.arange(start, start + c.numel(), device=v.device) % 65521
        s1 += c.sum()
        s2 += (c * (w + 1)).sum()
    return int(s1), int(s2), str(t.dtype), tuple(t.shape)


def changed_params(torch, model, sums, parts) -> list:
    """Names of the parameters of the top-level `parts` (LoRA factors
    aside) whose bits differ from `sums`."""
    return [n for n, p in model.named_parameters()
            if n.split(".")[0] in parts and "_lora_" not in n
            and tensor_checksum(torch, p) != sums[n]]


def page_cache_bytes() -> int:
    """`Cached` of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("Cached:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no Cached line in /proc/meminfo")


def filesystem_of(path: str) -> str:
    """The type of the filesystem `path` lies on (/proc/mounts)."""
    path = os.path.realpath(path)
    best, fs = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            mnt, kind = line.split()[1:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best):
                best, fs = mnt, kind
    return fs


def serve_requests(torch, model, cfg, reqs) -> dict:
    """Phase 5's engine (8 slots, a 4096-token cache) on `reqs`."""
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine

    eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096)
    for r in reqs:
        eng.submit(Request(**r))
    done = {c.uid: c for c in eng.run()}
    torch.cuda.synchronize()
    if not torch.isfinite(eng.state.next_embed).all():
        raise AssertionError("non-finite hidden state fed back")
    return done


def first_token_logits(torch, model, cfg, reqs):
    """fp32 logits of the first generated token of each text request [n, V]
    (the full-sequence forward on kernel A)."""
    from metamorph_tpu_torch.models import llama as L

    out = []
    with torch.no_grad():
        for r in reqs:
            if r.get("image_embeds") is not None:
                continue
            ids = torch.from_numpy(r["prompt_ids"]).to(
                model.llama.embed.device)[None]
            pos = torch.arange(ids.shape[1], device=ids.device)[None]
            h = L.llama_forward(model.llama, cfg.llama,
                                L.embed_tokens(model.llama, ids), pos, None)
            out.append(L.lm_head(model.llama, cfg.llama, h[:, -1:])[0, 0])
    return torch.stack(out).cpu()


def phase_weights_export(torch, dev, d, model, cfg):
    """9a: checksums of every tensor of phase 5's model, then export_hf of
    it (8B + SO400M, bf16; the standalone tower dir fp32) and its stage-1
    adapter file into `d`, then a sync; how far `Cached` in /proc/meminfo
    moved meanwhile, and the filesystem and kernel, say what 9b will read
    through. Returns the checksums."""
    from metamorph_tpu_torch.train import checkpoint as C

    torch.cuda.synchronize()
    cached = page_cache_bytes()
    t = time.perf_counter()
    sums = {n: tensor_checksum(torch, p) for n, p in model.named_parameters()}
    checksum_s = time.perf_counter() - t
    t = time.perf_counter()
    written = C.export_hf(os.path.join(d, "export"), model, cfg)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    C.save_adapter(os.path.join(d, "adapter.safetensors"), model)
    adapter_s = time.perf_counter() - t
    t = time.perf_counter()
    os.sync()
    sync_s = time.perf_counter() - t
    on_disk = sum(os.path.getsize(os.path.join(r, n))
                  for r, _, names in os.walk(d) for n in names)
    row = dict(tensors=len(sums), checksum_s=checksum_s,
               export_tensor_bytes=written, export_s=export_s,
               export_gb_per_s=written / export_s / 1e9,
               adapter_bytes=os.path.getsize(
                   os.path.join(d, "adapter.safetensors")),
               adapter_s=adapter_s, bytes_on_disk=on_disk, sync_s=sync_s,
               cached_change_bytes=page_cache_bytes() - cached,
               filesystem=filesystem_of(d), kernel=os.uname().release)
    log("weights export (9a)", json.dumps(row))
    return sums


def phase_weights(torch, dev, d, sums, cfg5, reqs, plain_run, train_row):
    """9b-9e on the files 9a wrote: the load and serve, LoRA train
    steps and serve, the merged LoRA model, and train() from the files.
    Every kernel count is set to 0 just before each window and read just
    after it."""
    import dataclasses
    import signal

    import numpy as np

    from metamorph_tpu_torch.inference.loader import (load_lora_model,
                                                      load_pretrained_model)
    from metamorph_tpu_torch.models.lora import LORA_TARGETS, add_lora
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.ops import decode_attention as da
    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.train import checkpoint as C
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train import trainer
    from metamorph_tpu_torch.train.optimizer import make_optimizer
    from metamorph_tpu_torch.train.profile_train import (packed_row,
                                                         stage2_one_card)

    kernels = (fa.FLASH_FWD, da.DECODE_ATTN, fa.FLASH_BWD_DQ,
               fa.FLASH_BWD_DKV)
    windows = {}

    def counted(name, fn):
        for kern in kernels:
            kern.reset()
        out = fn()
        torch.cuda.synchronize()
        windows[name] = {k.symbol: k.launches for k in kernels}
        return out

    def need(name, *kerns):
        missing = [k.symbol for k in kerns if windows[name][k.symbol] <= 0]
        if missing:
            raise AssertionError(f"weights {name}: {missing} not launched: "
                                 f"{windows[name]}")

    def check_served(key, run):
        budgets = {r["uid"]: r["max_new_tokens"] for r in reqs}
        if sorted(run) != sorted(budgets):
            raise AssertionError(f"{key}: served {sorted(run)}")
        for uid, c in run.items():
            if not np.isfinite(c.image_embeds).all():
                raise AssertionError(f"{key} {uid}: non-finite image embeds")

    def same_ids_share(a, b):
        same = total = 0
        for uid, c in a.items():
            n = min(len(c.ids), len(b[uid].ids))
            same += int((np.asarray(c.ids[:n]) == b[uid].ids[:n]).sum())
            total += max(len(c.ids), len(b[uid].ids))
        return same / max(total, 1)

    export_dir = os.path.join(d, "export")
    # what 9b reads: model.safetensors (the standalone tower dir is not)
    gb = os.path.getsize(os.path.join(export_dir, "model.safetensors")) / 1e9
    row = {}

    # 9b: load, bitwise check, serve phase 5's requests
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, cfg = load_pretrained_model(export_dir, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    counted("9b_first_token", lambda: serve_requests(
        torch, model, cfg, [dict(reqs[0], max_new_tokens=1, uid="first")]))
    first_token_s = time.perf_counter() - t0
    row["9b"] = dict(load_s=load_s, load_file_gb=gb, load_gb_per_s=gb / load_s,
                     first_token_s=first_token_s,
                     gib_on_card=torch.cuda.memory_allocated() / 2**30)
    if cfg != cfg5:
        raise AssertionError("the loaded config differs from phase 5's")
    bad = changed_params(torch, model, sums, {"llama", "siglip", "projector",
                                              "vision_head"})
    if bad or sorted(sums) != sorted(n for n, _ in model.named_parameters()):
        raise AssertionError(f"9b: loaded tensors differ from the exported "
                             f"ones: {bad[:8]}")
    logits_b = counted("9b_logits", lambda: first_token_logits(
        torch, model, cfg, reqs))
    run_b = counted("9b_serve", lambda: serve_requests(torch, model, cfg,
                                                       reqs))
    check_served("9b", run_b)
    need("9b_serve", fa.FLASH_FWD, da.DECODE_ATTN)
    diff = [u for u in plain_run
            if not np.array_equal(plain_run[u].ids, run_b[u].ids)]
    if diff:
        raise AssertionError(f"9b: greedy ids differ from phase 5's on "
                             f"{diff}")
    row["9b"].update(bitwise_equal_tensors=len(sums), ids_equal=True)
    log("weights load + serve (9b)", json.dumps(row["9b"]))

    # 9c: LoRA factors, 3 lora_enable train steps at T=4096, save, serve
    train_cfg, reduced = stage2_one_card(4096)
    cfg_l = dataclasses.replace(
        cfg, llama=dataclasses.replace(cfg.llama, lora_r=LORA_R,
                                       lora_alpha=LORA_ALPHA),
        train=dataclasses.replace(train_cfg.train, lora_enable=True))
    add_lora(model.llama, r=LORA_R, seed=0)
    T, K, N = cfg_l.train.max_seq_len, cfg_l.mm.num_image_tokens, \
        cfg_l.train.max_images_per_batch
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_to_arrays(packed_row(T, K, N, seed=21)).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = cfg.siglip.image_size
    pixels = torch.randn((N, s, s, 3), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_train_state(model, cfg_l)
    tx = make_optimizer(cfg_l.train, model)
    trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    steps, times = [], []

    def lora_steps():
        nonlocal state
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = TS.train_step(state, batch, pixels, cfg_l, tx)
            steps.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)

    counted("9c_lora_train", lora_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    need("9c_lora_train", fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
    for p in model.parameters():
        p.grad = None
        p.requires_grad_(False)
    del state, tx, batch, pixels
    free_memory(torch)
    losses = [m["loss"] for m in steps]
    if not all(np.isfinite(x) for m in steps for x in m.values()):
        raise AssertionError(f"9c: non-finite metrics {steps}")
    moved = changed_params(torch, model, sums, {"llama", "siglip"})
    if moved:
        raise AssertionError(f"9c: lora_enable moved base weights {moved[:8]}")
    zero_b = [f"{l}.{name}" for l, layer in enumerate(model.llama.layers)
              for _, name in LORA_TARGETS
              if not getattr(layer, f"{name}_lora_b").any()]
    if zero_b:
        raise AssertionError(f"9c: B factors still zero: {zero_b[:8]}")
    # two real updates (step 1 runs at lr 0) leave a @ b * scale below one
    # bf16 step of w, so that a merge that did nothing would pass 9d
    gen_b = torch.Generator(device=dev)
    gen_b.manual_seed(1)
    with torch.no_grad():
        for layer in model.llama.layers:
            for _, name in LORA_TARGETS:
                b = getattr(layer, f"{name}_lora_b")
                b.copy_(torch.randn(b.shape, generator=gen_b, device=dev)
                        * LORA_B_STD)
    lora_path = os.path.join(d, "lora.safetensors")
    t = time.perf_counter()
    C.save_lora(lora_path, model)
    save_lora_s = time.perf_counter() - t
    logits_c = counted("9c_logits", lambda: first_token_logits(
        torch, model, cfg_l, reqs))
    run_c = counted("9c_lora_serve", lambda: serve_requests(
        torch, model, cfg_l, reqs))
    check_served("9c", run_c)
    need("9c_lora_serve", fa.FLASH_FWD, da.DECODE_ATTN)
    cos_cb = torch.nn.functional.cosine_similarity(logits_c, logits_b, dim=-1)
    row["9c"] = dict(r=LORA_R, alpha=LORA_ALPHA, T=T, trainable_params=trainable,
                     losses=losses, grad_norms=[m["grad_norm"] for m in steps],
                     step_s=times, peak_mem_gib=peak,
                     train_main_step_s_median_2_4=train_row[
                         "step_s_median_2_4"],
                     train_main_peak_mem_gib=train_row["peak_mem_gib"],
                     lora_bytes=os.path.getsize(lora_path),
                     save_lora_s=save_lora_s, b_std=LORA_B_STD,
                     first_token_logits_cos_to_base=cos_cb.tolist(),
                     ids_equal_to_plain_share=same_ids_share(plain_run, run_c),
                     base_bitwise_unchanged=True, b_factors_nonzero=True)
    log("weights LoRA (9c)", json.dumps(row["9c"]))
    if not float(cos_cb.max()) <= LORA_MAX_BASE_COS:
        raise AssertionError(f"9c: the factors leave the logits at cosine "
                             f"{cos_cb.tolist()} of the base model's, above "
                             f"{LORA_MAX_BASE_COS}")
    del model
    free_memory(torch)

    # 9d: the merged LoRA model
    t = time.perf_counter()
    model, cfg_d = load_lora_model(export_dir, lora_path, r=LORA_R,
                                   alpha=LORA_ALPHA, device=dev)
    torch.cuda.synchronize()
    merge_load_s = time.perf_counter() - t
    logits_d = counted("9d_logits", lambda: first_token_logits(
        torch, model, cfg_d, reqs))
    cos = torch.nn.functional.cosine_similarity(logits_d, logits_c, dim=-1)
    cos_db = torch.nn.functional.cosine_similarity(logits_d, logits_b, dim=-1)
    run_d = counted("9d_serve", lambda: serve_requests(torch, model, cfg_d,
                                                       reqs))
    check_served("9d", run_d)
    row["9d"] = dict(load_and_merge_s=merge_load_s,
                     first_token_logits_cos=cos.tolist(),
                     first_token_logits_cos_to_base=cos_db.tolist(),
                     ids_equal_to_unmerged_share=same_ids_share(run_c, run_d))
    log("weights merged LoRA (9d)", json.dumps(row["9d"]))
    if not float(cos.min()) >= LORA_MIN_COS:
        raise AssertionError(f"9d: merged logits cosine {cos.tolist()} < "
                             f"{LORA_MIN_COS}")
    del model
    free_memory(torch)

    # 9e: train() from the HF-layout files
    cfg_e = dataclasses.replace(train_cfg, train=dataclasses.replace(
        train_cfg.train, total_steps=2))
    args = trainer.TrainerArgs(
        output_dir=os.path.join(d, "train"), save_steps=0, resume=False,
        hf_llama_path=export_dir,
        hf_siglip_path=os.path.join(export_dir, "vision_tower"),
        pretrain_mm_mlp_adapter=os.path.join(d, "adapter.safetensors"))
    packed = packed_row(T, K, N, seed=21)
    px = np.random.default_rng(0).normal(size=(N, s, s, 3)).astype(np.float32)
    built = {}
    build_params = trainer.build_params

    def checked_build(*a, **kw):
        m = build_params(*a, **kw)
        torch.cuda.synchronize()
        built["changed"] = changed_params(torch, m, sums,
                                          {"llama", "siglip", "projector"})
        return m

    trainer.build_params = checked_build
    torch.cuda.reset_peak_memory_stats()
    try:
        counted("9e_train", lambda: trainer.train(
            cfg_e, args, iter(lambda: (packed, px), None), device=dev))
    finally:
        trainer.build_params = build_params
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            signal.signal(sig, signal.SIG_DFL)
    free_memory(torch)
    metrics = read_metrics(args.output_dir)
    need("9e_train", fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
    if built.get("changed") != []:
        raise AssertionError(f"9e: the built model differs from the files: "
                             f"{built}")
    if len(metrics) != 2 or not all(np.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"9e: {metrics}")
    row["9e"] = dict(losses=[m["loss"] for m in metrics],
                     step_s=[m["step_s"] for m in metrics],
                     train_main_step_s=train_row["step_s"],
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                     built_bitwise_equal_to_files=True)
    log(f"weights train() from the files (9e): step 2 "
        f"{metrics[1]['step_s']:.3f}s against 5b's median "
        f"{train_row['step_s_median_2_4']:.3f}s", json.dumps(row["9e"]))
    row["launches"] = windows
    row["launches_total"] = {k.symbol: sum(w[k.symbol]
                                           for w in windows.values())
                             for k in kernels}
    return row


# ---------------------------------------------------------------------------
# phase 11: int8 weights (kernel F), the shared prefix, eval
# ---------------------------------------------------------------------------

W8_TOL = 4e-3          # kernel F: max|err| / max|ref| of the bf16 output
                       # against fp32 sums of the same bf16 x and int8 weights
                       # (one bf16 rounding, 2**-9 relative, plus sum order)
W8_MIN_COS = 0.99      # first-step logits, int8 weights against bf16; and
                       # per request between any two runs compared by ids
RECORD_TOPK = 16       # logits kept per generated position by LogitRecorder
W8_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
             (4096, 128256))     # (K, N): wq / wo, wk / wv, gate / up, down,
                                 # the lm head at 8B width
PREFIX_LEN = 1024
EVAL_ROWS, EVAL_IMAGE_ROWS, EVAL_NEW = 16, 8, 16


def _w8_kernels():
    from metamorph_tpu_torch.ops import decode_attention as da
    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.ops import quant as q

    return (q.W8_MATMUL, fa.FLASH_FWD, da.DECODE_ATTN, da.DECODE_ATTN_INT8,
            da.CHUNK_ATTN, da.CHUNK_ATTN_INT8)


def _reset_p11() -> None:
    for k in _w8_kernels():
        k.reset()


def _p11_counts() -> dict:
    """Launches since the last reset: F, A and B by symbol, E by form."""
    f, fwd, dec, dec8, ch, ch8 = _w8_kernels()
    return {"w8_matmul": f.launches, "flash_fwd": fwd.launches,
            "decode_attn": dec.launches, "decode_attn_int8": dec8.launches,
            "chunk_verify": ch.forms.get("verify", 0)
            + ch8.forms.get("verify", 0),
            "chunk_fill": ch.forms.get("fill", 0) + ch8.forms.get("fill", 0)}


def int8pack_mm_probe(torch, x, wq):
    """`torch._weight_int8pack_mm(x, q, scale)` on the card, PyTorch's own
    weight-only int8 product (its scale is bf16, not fp32): a callable, or
    the reason it cannot run here."""
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is None:
        return None, "torch._weight_int8pack_mm does not exist"
    sc = wq.scale.to(torch.bfloat16)
    try:
        op(x, wq.q, sc)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:   # no CUDA kernel
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return (lambda: op(x, wq.q, sc)), None


def phase_w8_kernels(torch, dev):
    """11a: kernel F against its plain version at the 8B decode shapes (M =
    8 and 32 rows, the gemv form) and the four layer shapes at M = 264 (the
    fill step's 8 + 256 rows) and 4096 (the tiled form), with its bound,
    `torch._weight_int8pack_mm` where it has a CUDA kernel (library_ms,
    bf16 scales) and, as a yardstick only, `torch.matmul` on the bf16
    weight of the same shape (the product F replaces; not the same
    function)."""
    from metamorph_tpu_torch.ops import quant as Q

    gen = torch.Generator(device=dev)
    gen.manual_seed(1111)
    rows = []
    cases = [(M, kn) for M in (8, 32) for kn in W8_SHAPES]
    cases += [(M, kn) for M in (264, 4096) for kn in W8_SHAPES[:4]]
    for M, (K, N) in cases:
        w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
        wq, wb = Q.quantize_weight(w), w.to(torch.bfloat16)
        del w
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        out = Q.quantized_matmul(x, wq)
        again = Q.quantized_matmul(x, wq)
        ref = Q.quantized_matmul_plain(x.float(), wq)
        abs_err = (out.float() - ref).abs().max().item()
        rel_err = abs_err / ref.abs().max().item()
        timer = cuda_graph_ms if M <= Q.GEMV_MAX_M else cuda_ms
        b = bound(K * N + 4 * N + 2 * M * K + 2 * M * N, 2 * M * N * K)
        ms = timer(lambda: Q.quantized_matmul(x, wq))
        (_, shape, form, _), = wq.plans.values()
        lib, lib_note = int8pack_mm_probe(torch, x, wq)
        row = dict(M=M, K=K, N=N, form=form, ctas=shape[4],
                   max_abs_err=abs_err, rel_err=rel_err, tol=W8_TOL,
                   bitwise_repeat=bool(torch.equal(out, again)),
                   ms=ms, ms_method=("CUDA graph of 20 calls"
                                     if M <= Q.GEMV_MAX_M
                                     else "20 calls queued"),
                   plain_ms=cuda_ms(lambda: Q.quantized_matmul_plain(x, wq)),
                   # PyTorch's int8 product takes ~0.5 s a call at M = 4096
                   library_ms=(None if lib is None else timer(lib)
                               if M <= Q.GEMV_MAX_M
                               else cuda_ms(lib, calls=2, reps=3)),
                   library_note=("torch._weight_int8pack_mm, bf16 scales"
                                 if lib else lib_note),
                   bf16_matmul_ms=timer(lambda: x @ wb),
                   bf16_matmul_note="torch.matmul on the bf16 weight: the "
                                    "product F replaces, timed as a "
                                    "yardstick, not the same function",
                   **b, **rates(b, ms))
        log("kernel F w8_matmul", json.dumps(row))
        if not (rel_err <= W8_TOL and row["bitwise_repeat"]):
            raise AssertionError(f"kernel F disagrees with its plain version "
                                 f"or does not repeat: {row}")
        rows.append(row)
        del wq, wb, x, out, again, ref, lib
        torch.cuda.empty_cache()
    return rows


def request_embeds(torch, model, cfg, r, gen_ids=()):
    """[1, T, D] embeddings of request r's prompt, its images spliced at
    their positions, followed by `gen_ids`."""
    import numpy as np

    from metamorph_tpu_torch.models import llama as L

    dev = model.llama.embed.device
    ids = np.concatenate([np.asarray(r["prompt_ids"], np.int32),
                          np.asarray(gen_ids, np.int32)])
    with torch.no_grad():
        pe = L.embed_tokens(model.llama, torch.as_tensor(ids, device=dev))
        if r.get("image_embeds") is not None:
            ie = torch.as_tensor(r["image_embeds"]).to(dev, pe.dtype)
            for j, p in enumerate(np.asarray(r["image_positions"])):
                pe[int(p):int(p) + ie.shape[1]] = ie[j]
    return pe[None]


def last_logits(torch, model, cfg, pe):
    """fp32 logits after the last position of `pe` (a full forward on
    kernel A)."""
    from metamorph_tpu_torch.models import llama as L

    with torch.no_grad():
        pos = torch.arange(pe.shape[1], device=pe.device)[None]
        h = L.llama_forward(model.llama, cfg.llama, pe, pos, None)
        return L.lm_head(model.llama, cfg.llama, h[:, -1])[0]


class LogitRecorder:
    """While active, keeps the logits each greedy id of a run was picked
    from, as the run computed them: the lm head inside the engine's state
    machine (`serve._advance_rows`) and the single-request loops'
    (`decode._advance`), and the spec tick's draft check. Per request
    (`by_uid[uid][position] = (pick, top ids, top values)`, the top
    RECORD_TOPK) and, for the first step, the whole logits (`first[uid]`).
    Engine records are tied to requests by slot after each
    `ServeEngine.step` (the slot's uid after the step where the step
    admitted it, else before: a finished row records nothing more);
    single-request loops record under `uid`, set by the caller. Nothing
    synchronizes until `resolve`."""

    def __init__(self, torch):
        self.torch = torch
        self.uid = None
        self.by_uid, self.first = {}, {}
        self._tick, self._done = [], []
        self._in_first = False
        self._last = self._mid = None

    def __enter__(self):
        from metamorph_tpu_torch.inference import decode as D
        from metamorph_tpu_torch.inference import serve as S
        from metamorph_tpu_torch.models import llama as L

        self._mods = (L, S, D)
        self._orig = (L.lm_head, S._advance_rows, S._first_transition,
                      S._spec_verify_tick, S.ServeEngine.step, D._advance)
        head, adv_rows, first_tr, spec_tick, step, adv = self._orig
        rec = self

        def lm_head(*a, **k):
            rec._last = head(*a, **k)
            return rec._last

        def picks(keep, pos, full=None):
            logits = rec._last
            v, i = logits.topk(RECORD_TOPK, dim=-1)
            return ("step", keep, pos.clone(), logits.argmax(dim=-1), i, v,
                    full)

        def advance_rows(model, cfg, state, h_last, fresh, K, *a, **k):
            act = fresh & state.active
            keep = act & ~(act & state.in_image & (state.img_count < K))
            pos = state.n_ids.clone()
            out = adv_rows(model, cfg, state, h_last, fresh, K, *a, **k)
            rec._tick.append(picks(keep, pos, rec._last.clone()
                                   if rec._in_first else None))
            rec._mid = state.n_ids
            return out

        def first_transition(*a, **k):
            rec._in_first = True
            try:
                return first_tr(*a, **k)
            finally:
                rec._in_first = False

        def spec_verify(model, state, cfg, drafts, K, spec_k, *a, **k):
            out = spec_tick(model, state, cfg, drafts, K, spec_k, *a, **k)
            if spec_k > 1:      # the draft check's head, [B * (spec_k-1), V]
                B, logits = drafts.shape[0], rec._last
                v, i = logits.topk(RECORD_TOPK, dim=-1)
                rec._tick.append(("spec", state.n_ids - rec._mid, rec._mid,
                                  logits.argmax(dim=-1).reshape(B, -1),
                                  i.reshape(B, spec_k - 1, -1),
                                  v.reshape(B, spec_k - 1, -1)))
            return out

        def engine_step(eng):
            # the records are taken by the Python of each step, which a
            # replayed graph does not run: the engine stays eager
            eng._capture = None
            before = list(eng.slot_uid)
            rec._tick = []
            out = step(eng)
            after = list(eng.slot_uid)
            rec._done.append(([x if x is not None and x != y else y
                               for y, x in zip(before, after)], rec._tick))
            rec._tick = []
            return out

        def advance(model, cfg, state, h_last, K, *a, **k):
            act = ~state.done
            keep = act & ~(act & state.in_image & (state.img_count < K))
            pos = state.n_ids.clone()
            out = adv(model, cfg, state, h_last, K, *a, **k)
            first = rec.uid not in rec.first and rec.uid not in {
                u for uids, _ in rec._done for u in uids}
            rec._done.append(([rec.uid], [picks(
                keep, pos, rec._last.clone() if first else None)]))
            return out

        L.lm_head, S._advance_rows, S._first_transition = (
            lm_head, advance_rows, first_transition)
        S._spec_verify_tick, S.ServeEngine.step, D._advance = (
            spec_verify, engine_step, advance)
        return self

    def __exit__(self, *exc):
        L, S, D = self._mods
        (L.lm_head, S._advance_rows, S._first_transition,
         S._spec_verify_tick, S.ServeEngine.step, D._advance) = self._orig
        self.resolve()
        return False

    def resolve(self) -> None:
        """Moves the records to the host, by request and position."""
        for uids, tick in self._done:
            for r in tick:
                kind, r = r[0], [x.cpu() if hasattr(x, "cpu") else x
                                 for x in r[1:]]
                if kind == "step":
                    keep, pos, pick, ids, vals, full = r
                    for b in range(len(uids)):
                        if uids[b] is None or not bool(keep[b]):
                            continue
                        p = int(pos[b])
                        self.by_uid.setdefault(uids[b], {})[p] = (
                            int(pick[b]), ids[b].tolist(), vals[b].tolist())
                        if full is not None and p == 0:
                            self.first[uids[b]] = full[b].float()
                else:
                    n_extra, mid, pick, ids, vals = r
                    for b in range(len(uids)):
                        for j in range(int(n_extra[b]) if uids[b] is not None
                                       else 0):
                            self.by_uid.setdefault(uids[b], {})[
                                int(mid[b]) + j] = (int(pick[b, j]),
                                                    ids[b, j].tolist(),
                                                    vals[b, j].tolist())
        self._done = []

    def ids(self, uid) -> list:
        """The ids the run picked for `uid`, in order, as recorded."""
        rec = self.by_uid.get(uid, {})
        return [rec[p][0] for p in range(len(rec)) if p in rec]


def ids_of(done) -> dict:
    """{uid: ids} of a run's completions."""
    return {u: [int(t) for t in c.ids] for u, c in done.items()}


def compare_ids(torch, tag, ref_rec, rec, ref_ids=None, ids=None) -> dict:
    """Two runs of the same requests, from their own recorded logits
    (`LogitRecorder`): per request, the first-step logits' cosine must be
    >= W8_MIN_COS, and the ids equal or, where they first part at position
    p (the reference picks a, the run b), the swap must lie within the
    logit difference measured between the two runs: each run holds the
    other's pick in its top RECORD_TOPK, and the two margins (a over b in
    the reference, b over a in the run) add up to at most twice the largest
    |reference - run| difference over the ids both tops share, taken at
    the positions before p and at p apart from a and b. `ref_ids` / `ids`
    (by uid) are the runs' own outputs, checked against what was recorded;
    without them the recorded picks are the ids. Prints and returns the
    report; raises on any other difference."""
    report, bad = {}, []
    for uid in sorted(ref_rec.by_uid, key=str):
        a = ref_rec.ids(uid) if ref_ids is None else ref_ids[uid]
        b = rec.ids(uid) if ids is None else ids[uid]
        if a != ref_rec.ids(uid) or b != rec.ids(uid):
            bad.append(uid)
            report[uid] = {"recorded": False}
            continue
        cos = torch.nn.functional.cosine_similarity(
            ref_rec.first[uid], rec.first[uid], dim=0).item()
        entry = {"first_step_cosine": cos}
        report[uid] = entry
        if cos < W8_MIN_COS:
            bad.append(uid)
        if a == b:
            continue
        p = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                 min(len(a), len(b)))
        entry.update(diverge_at=p, of=len(a))
        if p >= min(len(a), len(b)):
            bad.append(uid)         # one run stopped where the other went on
            continue
        diff = 0.0
        for q in range(p + 1):
            ra, rb = ref_rec.by_uid[uid][q], rec.by_uid[uid][q]
            va, vb = dict(zip(ra[1], ra[2])), dict(zip(rb[1], rb[2]))
            for t in set(va) & set(vb) - ({a[p], b[p]} if q == p else set()):
                diff = max(diff, abs(va[t] - vb[t]))
        va, vb = [dict(zip(r[1], r[2])) for r in (ref_rec.by_uid[uid][p],
                                                  rec.by_uid[uid][p])]
        if b[p] not in va or a[p] not in vb:
            entry["in_tops"] = False
            bad.append(uid)
            continue
        m_ref, m_run = va[a[p]] - va[b[p]], vb[b[p]] - vb[a[p]]
        entry.update(margin_ref=m_ref, margin_run=m_run,
                     measured_max_diff=diff,
                     within=m_ref + m_run <= 2 * diff)
        if not entry["within"]:
            bad.append(uid)
    log(f"ids {tag}", json.dumps(report))
    if bad:
        raise AssertionError(f"{tag}: runs differ beyond their measured "
                             f"logit difference: "
                             f"{ {u: report[u] for u in bad} }")
    return report


def serve_counted(torch, model, cfg, reqs, profile_first=False, **kw):
    """Phase 5's engine (8 slots, 4096-token cache) with `kw` on `reqs`,
    every kernel count set to 0 just before the engine is built (a shared
    prefix's prefill is part of the run) and read just after, under a
    LogitRecorder: (done by uid, row, recorder). With `profile_first`, the
    first tick (the admissions and one decode tick) runs under the
    profiler and its device ms is in the row."""
    with LogitRecorder(torch) as rec:
        done, row = _serve_counted(torch, model, cfg, reqs, profile_first,
                                   **kw)
    return done, row, rec


def _serve_counted(torch, model, cfg, reqs, profile_first, **kw):
    import numpy as np

    from metamorph_tpu_torch.constants import LLAMA3_EOS_IDS
    from metamorph_tpu_torch.inference.profile_serve import _profiled
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine

    _reset_p11()            # a prefix engine's prefill counts (kernel A)
    eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096, **kw)
    for r in reqs:
        eng.submit(Request(**r))
    torch.cuda.synchronize()
    first, profiled_s = {}, 0.0
    if profile_first:
        table, wall_ms = _profiled(eng.step)
        profiled_s = wall_ms / 1e3
        first = dict(first_tick_device_ms=sum(r["ms"] for r in table),
                     first_tick_wall_ms=wall_ms,
                     first_tick_flash_fwd_ms=sum(
                         r["ms"] for r in table
                         if "flash_fwd_kernel" in r["name"]),
                     first_tick_chunk_fill_ms=sum(
                         r["ms"] for r in table
                         if "chunk_fill_kernel" in r["name"]),
                     first_tick_w8_ms=sum(r["ms"] for r in table
                                          if "w8_" in r["name"]),
                     first_tick_launches=_p11_counts())
    t = time.perf_counter()
    done = {c.uid: c for c in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t + profiled_s  # not the profiler's tables
    counts = _p11_counts()
    eos = set(LLAMA3_EOS_IDS)
    if sorted(done) != sorted(r["uid"] for r in reqs):
        raise AssertionError(f"served {sorted(done)}")
    for r in reqs:
        c = done[r["uid"]]
        stopped = len(c.ids) > 0 and int(c.ids[-1]) in eos
        if not (c.steps == r["max_new_tokens"] or stopped):
            raise AssertionError(f"{r['uid']}: {c.steps} steps, budget "
                                 f"{r['max_new_tokens']}")
        if not np.isfinite(c.image_embeds).all():
            raise AssertionError(f"{r['uid']}: non-finite image embeds")
    if not torch.isfinite(eng.state.next_embed).all():
        raise AssertionError("non-finite hidden state fed back")
    new_tokens = sum(c.steps for c in done.values())
    row = dict(wall_s=wall, new_tokens=new_tokens,
               tok_per_s=new_tokens / wall, ticks=dict(eng.tick_counts),
               spec_accepted=eng.spec_accepted, launches=counts, **first)
    del eng
    return done, row


def host_cost(torch, model, cfg, bf_llama, q_llama) -> dict:
    """The host's side of int8 weights, bf16 and int8 in turns within one
    process (the host clock of that machine drifts by tens of percent
    between runs): (1) host us per call of kernel F's wrapper against
    `torch.matmul` on the bf16 weight, layer 0's wk at decode's [8, 1,
    4096] (2,000 queued calls, 3 rounds each); (2) one engine (8 slots,
    profile_serve's prompts) whose LLaMA is swapped between ticks: 6
    rounds of 3 decode ticks per model, alternating which goes first,
    wall and process CPU ms per step."""
    import numpy as np

    from metamorph_tpu_torch.inference.profile_serve import PROMPTS
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.ops import quant as Q

    dev = bf_llama.embed.device
    wq, wb = q_llama.layers[0].wk, bf_llama.layers[0].wk
    x = torch.randn((8, 1, cfg.llama.hidden_size), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(13)
                    ).to(wb.dtype)
    calls = {"w8_wrapper": lambda: Q.quantized_matmul(x, wq),
             "bf16_matmul": lambda: x @ wb}
    us = {k: [] for k in calls}
    for _ in range(3):
        for k, f in calls.items():
            for _ in range(50):
                f()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2000):
                f()
            us[k].append((time.perf_counter() - t) / 2000 * 1e6)
            torch.cuda.synchronize()
    eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096)
    rng = np.random.default_rng(0)
    for n in PROMPTS:
        eng.submit(Request(prompt_ids=rng.integers(10, 128000, (n,)).astype(
            np.int32), max_new_tokens=400, uid=n))
    models = {"bf16": bf_llama, "int8": q_llama}
    eng.step()                                   # admissions
    for llm in models.values():
        model.llama = llm
        eng.step()
    wall = {k: [] for k in models}
    cpu = {k: [] for k in models}
    steps = 3 * eng.steps_per_sync
    for rnd in range(6):
        for k in (("bf16", "int8") if rnd % 2 == 0 else ("int8", "bf16")):
            model.llama = models[k]
            torch.cuda.synchronize()
            t, c = time.perf_counter(), time.process_time()
            for _ in range(3):
                eng.step()
            torch.cuda.synchronize()
            wall[k].append((time.perf_counter() - t) * 1e3 / steps)
            cpu[k].append((time.process_time() - c) * 1e3 / steps)
    model.llama = q_llama
    del eng
    med = statistics.median
    return {"host_us_per_call": {k: v for k, v in us.items()},
            "host_us_per_call_median": {k: med(v) for k, v in us.items()},
            "ticks_wall_ms_per_step": wall, "ticks_cpu_ms_per_step": cpu,
            "ticks_wall_ms_per_step_median": {k: med(v)
                                              for k, v in wall.items()},
            "tok_per_s_median": {k: 8e3 / med(v) for k, v in wall.items()}}


def first_tick(torch, model, cfg, reqs) -> dict:
    """The admission tick of a fresh engine (8 slots, 4096-token cache) on
    `reqs` (their prefills and one decode step) under the profiler: device
    ms, GEMM ms (kernel F's among them) and kernel F's ms."""
    from metamorph_tpu_torch.inference.profile_serve import _groups, _profiled
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine

    eng = ServeEngine(model, cfg, n_slots=8, max_cache_len=4096)
    for r in reqs:
        eng.submit(Request(**r))
    table, wall_ms = _profiled(eng.step)
    del eng
    return dict(device_ms=sum(r["ms"] for r in table), wall_ms=wall_ms,
                gemm_ms=_groups(table, 1)["gemm"],
                w8_ms=sum(r["ms"] for r in table if "w8_" in r["name"]))


def phase_int8_weights(torch, dev, model, cfg, reqs, plain_run, main_row):
    """11b: `quantize_llama_decode` on phase 5's model; phase 5's requests
    through ServeEngine on int8 weights (bf16 and int8 cache, plain and
    spec_k=4); the first-step logits against the bf16 model (cosine per
    request); ids against the same int8 model on the plain product; one
    `greedy_decode`; decode ticks profiled on both models. Then 11d's
    task runs on the int8 model. The bf16 LLaMA is put back at the end."""
    from metamorph_tpu_torch.inference import decode as dec
    from metamorph_tpu_torch.inference.profile_serve import profile_ticks
    from metamorph_tpu_torch.models import llama as L
    from metamorph_tpu_torch.ops import quant as Q

    def first_logits():
        return torch.stack([last_logits(torch, model, cfg, request_embeds(
            torch, model, cfg, r)) for r in reqs]).cpu()

    row = {"bf16_profile": profile_ticks(model, cfg, ticks=2)[0],
           "bf16_first_tick": first_tick(torch, model, cfg, reqs)}
    logits_bf = first_logits()
    bf_llama = model.llama
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model.llama = Q.quantize_llama_decode(bf_llama)
    torch.cuda.synchronize()
    row["quantize_s"] = time.perf_counter() - t
    row["int8_llama_gib"] = sum(
        b.numel() * b.element_size() for m in model.llama.modules()
        if isinstance(m, Q.QuantizedWeight) for b in m.buffers()) / 2**30
    row["quantize_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    try:
        logits_q = first_logits()
        cos = torch.nn.functional.cosine_similarity(logits_q, logits_bf,
                                                    dim=-1)
        row["first_step_logit_cosine"] = {
            r["uid"]: c for r, c in zip(reqs, cos.tolist())}
        log("int8 weights: first-step logit cosine to bf16",
            json.dumps(row["first_step_logit_cosine"]))
        if cos.min().item() < W8_MIN_COS:
            raise AssertionError(f"int8 logits cosine {cos.tolist()} < "
                                 f"{W8_MIN_COS}")
        row["int8_first_tick"] = first_tick(torch, model, cfg, reqs)
        log("int8 weights: admission tick, bf16 then int8",
            json.dumps([row["bf16_first_tick"], row["int8_first_tick"]]))
        row["host_cost"] = host_cost(torch, model, cfg, bf_llama,
                                     model.llama)
        log("int8 weights: host cost against bf16, in turns",
            json.dumps(row["host_cost"]))
        runs, recs = {}, {}
        for kv_int8 in (False, True):
            for spec_k in (0, 4):
                torch.cuda.reset_peak_memory_stats()
                key = f"{'int8' if kv_int8 else 'bf16'}_cache" + (
                    f"_spec{spec_k}" if spec_k else "")
                runs[key], r, recs[key] = serve_counted(
                    torch, model, cfg, reqs, kv_int8=kv_int8, spec_k=spec_k)
                r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
                row[key] = r
                log(f"int8 weights: engine {key}", json.dumps(r))
                if r["launches"]["w8_matmul"] <= 0:
                    raise AssertionError(f"{key}: kernel F never launched")
        # the same quantized model on the plain product (a check: it
        # launches no kernel F)
        orig = L.quantized_matmul
        L.quantized_matmul = Q.quantized_matmul_plain
        try:
            plain_prod, _, plain_rec = serve_counted(torch, model, cfg,
                                                     reqs)
            row["ids_vs_plain_product"] = compare_ids(
                torch, "int8 weights, kernel F vs the plain product",
                plain_rec, recs["bf16_cache"], ids_of(plain_prod),
                ids_of(runs["bf16_cache"]))
        finally:
            L.quantized_matmul = orig
        row["ids_equal_to_bf16_share"] = statistics.mean(
            _equal_share(list(plain_run[u].ids), list(c.ids))
            for u, c in runs["bf16_cache"].items())
        text = next(r for r in reqs if r["uid"] == "text300")
        _reset_p11()
        t = time.perf_counter()
        g = dec.greedy_decode(model, cfg, request_embeds(torch, model, cfg,
                                                         text),
                              max_new_tokens=DECODE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        row["greedy_decode"] = dict(tokens=int(g["steps"]), wall_s=wall,
                                    tok_per_s=int(g["steps"]) / wall,
                                    launches=_p11_counts())
        if row["greedy_decode"]["launches"]["w8_matmul"] <= 0:
            raise AssertionError("greedy_decode on int8 weights never "
                                 "launched kernel F")
        prof, _ = profile_ticks(model, cfg, ticks=2)
        row["int8_profile"] = prof
        row["tasks_int8"] = phase_eval_tasks(torch, dev, model, cfg, "int8")
    finally:
        model.llama = bf_llama
    free_memory(torch)
    keep = ("decode_step_ms", "decode_tok_per_s", "device_ms_per_step",
            "device_busy_share", "kernel_launches_per_step")
    for name in ("bf16_profile", "int8_profile"):
        p = row[name]
        row[name] = {**{k: p[k] for k in keep},
                     "gemm_ms_per_step":
                         p["device_ms_per_step_by_group"]["gemm"],
                     "by_group": p["device_ms_per_step_by_group"]}
    row["phase5_bf16"] = {k: main_row[k] for k in (
        "tok_per_s_run1", "tok_per_s_run2", "peak_mem_gib")}
    launches = {k: sum(r["launches"][k] for r in (
        *(row[x] for x in ("bf16_cache", "bf16_cache_spec4", "int8_cache",
                           "int8_cache_spec4")), row["greedy_decode"],
        row["tasks_int8"])) for k in _p11_counts()}
    row["launches"] = launches
    log("int8 weights", json.dumps({k: v for k, v in row.items()
                                    if k not in ("tasks_int8",)}))
    return row


def phase_prefix(torch, dev, model, cfg, reqs):
    """11c: a 1,024-token shared prefix (seeded ids) with phase 5's prompts
    as suffixes (the image keeps its image, suffix-relative) against the
    plain engine given prefix + suffix; the admission tick's device ms with
    and without the prefix; then kv_int8, spec_k=4 and the 1B-shaped
    drafter on the prefix engine."""
    import numpy as np

    from metamorph_tpu_torch.convert import init_llama

    prefix = np.random.default_rng(11).integers(
        10, 128000, (PREFIX_LEN,)).astype(np.int32)
    whole = []
    for r in reqs:
        w = dict(r, prompt_ids=np.concatenate([prefix, r["prompt_ids"]]))
        if r.get("image_positions") is not None:
            w["image_positions"] = np.asarray(r["image_positions"]) \
                + PREFIX_LEN
        whole.append(w)
    row = {}
    pref_run, row["prefix"], pref_rec = serve_counted(
        torch, model, cfg, reqs, profile_first=True,
        shared_prefix_ids=prefix)
    plain, row["plain_whole_prompts"], plain_rec = serve_counted(
        torch, model, cfg, whole, profile_first=True)
    for k, r in (("prefix", row["prefix"]),
                 ("plain_whole_prompts", row["plain_whole_prompts"])):
        log(f"prefix: engine {k}", json.dumps(r))
    lp = row["prefix"]["launches"]
    if lp["chunk_fill"] <= 0 or lp["flash_fwd"] != cfg.llama.num_layers:
        raise AssertionError(f"the prefix's one prefill (kernel A) and the "
                             f"suffix chunks (kernel E's fill form) did not "
                             f"run as they should: {lp}")
    row["ids_vs_plain"] = compare_ids(
        torch, "prefix vs plain engine on prefix + suffix", plain_rec,
        pref_rec, ids_of(plain), ids_of(pref_run))
    runs, recs = {}, {}
    dcfg = drafter_1b_config()
    draft = init_llama(dcfg, seed=1, device=dev, dtype=torch.bfloat16)
    for key, kw in (("kv_int8", dict(kv_int8=True)),
                    ("spec4", dict(spec_k=4)),
                    ("draft4", dict(spec_k=4, draft=(draft, dcfg)))):
        runs[key], row[key], recs[key] = serve_counted(
            torch, model, cfg, reqs, shared_prefix_ids=prefix, **kw)
        log(f"prefix: engine {key}", json.dumps(row[key]))
    del draft
    free_memory(torch)
    for key in ("spec4", "draft4"):
        row[f"ids_{key}"] = compare_ids(
            torch, f"prefix {key} vs prefix", pref_rec, recs[key],
            ids_of(pref_run), ids_of(runs[key]))
    # the prefix's K/V and scales copied into each slot against the plain
    # engine's own int8 writes of the whole prompt
    plain8, row["plain_whole_prompts_kv_int8"], plain8_rec = serve_counted(
        torch, model, cfg, whole, kv_int8=True)
    row["ids_kv_int8"] = compare_ids(
        torch, "prefix kv_int8 vs plain kv_int8", plain8_rec,
        recs["kv_int8"], ids_of(plain8), ids_of(runs["kv_int8"]))
    launches = {k: sum(row[x]["launches"][k] for x in (
        "prefix", "kv_int8", "spec4", "draft4")) for k in _p11_counts()}
    if launches["chunk_verify"] <= 0 or launches["decode_attn_int8"] <= 0:
        raise AssertionError(f"prefix options did not launch kernel E's "
                             f"verify form or B int8: {launches}")
    row["launches"] = launches
    log("prefix", json.dumps({k: row[k] for k in (
        "ids_vs_plain", "ids_spec4", "ids_draft4", "ids_kv_int8",
        "launches")}))
    return row


def phase_eval_tasks(torch, dev, model, cfg, tag):
    """11d, `run_task`: 16 rows (8 with PNG images written here), metric
    "exact", on `model` (bf16 or int8 weights) with `word_tokenize`; the
    gold answers are `greedy_decode`'s on the same request alone. Both
    runs are recorded (LogitRecorder) and compared by `compare_ids`; a row
    may score below 1.0 only where its ids part from the gold's within the
    logit difference measured between the two runs."""
    import numpy as np
    from PIL import Image

    from metamorph_tpu_torch.constants import (IM_END_TOKEN_ID,
                                               IM_START_TOKEN_ID,
                                               LLAMA3_EOS_IDS)
    from metamorph_tpu_torch.eval import runner
    from metamorph_tpu_torch.inference import decode as dec
    from metamorph_tpu_torch.inference.demo import load_frames

    drop = set(LLAMA3_EOS_IDS) | {IM_START_TOKEN_ID, IM_END_TOKEN_ID}
    rng = np.random.default_rng(12)
    words = ["".join(rng.choice(list("abcdefghij"), 5)) for _ in range(200)]
    detok = lambda ids: " ".join(map(str, ids))
    with tempfile.TemporaryDirectory() as d:
        rows = []
        for i in range(EVAL_ROWS):
            row = {"question": " ".join(rng.choice(words, 6 + i)),
                   "uid": f"row{i}"}
            if i < EVAL_IMAGE_ROWS:
                path = os.path.join(d, f"img{i}.png")
                Image.fromarray(rng.integers(0, 256, (240 + 8 * i, 320, 3),
                                             dtype=np.uint8)).save(path)
                row["image"] = path
            rows.append(row)
        frames_of = lambda row: load_frames(row["image"]) if row.get(
            "image") else []
        golds = {}
        with LogitRecorder(torch) as gold_rec:
            for i, row in enumerate(rows):
                req = runner.build_request(model, cfg, word_tokenize,
                                           row["question"], frames_of(row),
                                           EVAL_NEW, row["uid"], 128000)
                r = dict(prompt_ids=req.prompt_ids, uid=row["uid"])
                if req.image_embeds is not None:
                    r.update(image_embeds=req.image_embeds,
                             image_positions=req.image_positions)
                gold_rec.uid = i        # run_task's engine names row i `i`
                g = dec.greedy_decode(model, cfg, request_embeds(
                    torch, model, cfg, r), max_new_tokens=EVAL_NEW)
                golds[i] = g["ids"][:int(g["n_ids"])].tolist()
                row["answer"] = detok([t for t in golds[i] if t not in drop])
        _reset_p11()
        with LogitRecorder(torch) as task_rec:
            res = runner.run_task(model, cfg, word_tokenize, detok, rows,
                                  load_frames=frames_of, metric="exact",
                                  n_slots=8, max_cache_len=4096,
                                  max_new_tokens=EVAL_NEW,
                                  bos_token_id=128000)
            torch.cuda.synchronize()
        counts = _p11_counts()
    ids = compare_ids(torch, f"run_task ({tag} weights) vs single-request "
                      f"greedy", gold_rec, task_rec, ref_ids=golds)
    misses = {rows[i]["uid"]: ids[i] for i, p in
              enumerate(res["predictions"]) if p["score"] != 1.0}
    out = dict(weights=tag, accuracy=res["accuracy"], n=res["n"],
               image_rows=EVAL_IMAGE_ROWS,
               new_tokens_per_sec=res["new_tokens_per_sec"],
               misses=misses, launches=counts)
    log(f"eval run_task ({tag} weights)", json.dumps(out))
    bad = {u: m for u, m in misses.items() if "diverge_at" not in m}
    if bad or counts["flash_fwd"] <= 0 or (tag == "int8" and
                                           counts["w8_matmul"] <= 0):
        raise AssertionError(f"run_task ({tag}): rows scored below 1.0 "
                             f"with the gold's ids {bad} or kernels not "
                             f"launched {counts}")
    return out


def phase_evaluate(torch, model, cfg, batches):
    """11d, `evaluate` over 8a's batches at 8B width (kernel A): a finite
    perplexity, and the first batch's `loss_language` equal to what
    `metamorph_forward` gives for it within 1e-3 relative."""
    import numpy as np

    from metamorph_tpu_torch.eval.perplexity import evaluate
    from metamorph_tpu_torch.models.metamorph import metamorph_forward
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.ops import flash_attention as fa

    dev = model.llama.embed.device
    fa.FLASH_FWD.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = evaluate(model, cfg, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = fa.FLASH_FWD.launches
    one = evaluate(model, cfg, batches[:1])
    packed, pixels = batches[0]
    with torch.no_grad():
        _, m = metamorph_forward(
            model, cfg, {k: torch.as_tensor(np.asarray(v), device=dev)
                         for k, v in batch_to_arrays(packed).items()},
            torch.as_tensor(np.asarray(pixels), device=dev))
    direct = float(m["loss_language"])
    rel = abs(one["loss_language"] - direct) / abs(direct)
    row = dict(res, wall_s=wall, s_per_batch=wall / len(batches),
               launches={"flash_fwd": launches},
               first_batch_loss_language=one["loss_language"],
               metamorph_forward_loss_language=direct, rel_diff=rel)
    log("eval evaluate", json.dumps(row))
    if not (np.isfinite(res["perplexity"]) and rel <= 1e-3
            and launches > 0):
        raise AssertionError(f"evaluate: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 12: the visualizer's render path at SD-1.5 width
# ---------------------------------------------------------------------------

VIS_REL_TOL = 1e-3      # 12a: fp32 on the card (TF32 off) vs fp32 on the CPU,
                        # max|err| / max|ref| of the UNet's noise prediction
                        # and the VAE's image: fp32 sums of up to 11,520
                        # terms in another order (~1e-6 each), through ~70
                        # layers
VIS_IMG_TOL = 5e-3      # 12a: max|err| of the 3-step DDIM images in [0, 1]:
                        # each step's difference scaled by the guidance 7.5
VIS_LATENT = 64         # 12b, 12c: 512 px
VIS_CHECK_LATENT = 16   # 12a: 128 px, so the CPU's side stays near seconds
VIS_STEPS = 50          # 12b: PNDM-50, the demo's default
VIS_ATTN_SHAPES = (("unet_level0_self", (2, 8, 4096, 40)),
                   ("vae_mid", (1, 1, 4096, 512)))
VIS_GROUPS = (("conv", ("convolution",)), ("gemm", ("aten::mm", "aten::addmm")),
              ("attention", ("aten::bmm", "aten::_softmax")),
              ("norms", ("aten::native_group_norm", "aten::native_layer_norm")))


def vis_configs():
    """SD-1.5's UNet and VAE, the mlp adapter (1152 -> 4096, four 4096 ->
    4096, 4096 -> 768)."""
    from metamorph_tpu_torch.visualizer.unet import UNetConfig
    from metamorph_tpu_torch.visualizer.vae import VAEConfig

    return UNetConfig(), VAEConfig(), dict(mode="mlp")


def rel_err(torch, out, ref) -> dict:
    err = (out.float().cpu() - ref.float()).abs().max().item()
    return {"max_abs_err": err,
            "rel_err": err / max(ref.float().abs().max().item(), 1e-30)}


def params_equal(a, b) -> bool:
    import torch

    want = dict(b.named_parameters())
    got = dict(a.named_parameters())
    return sorted(got) == sorted(want) and all(
        torch.equal(got[n], want[n]) for n in got)


def op_groups(torch, fn) -> dict:
    """Device ms of fn() by op group: each kernel's time goes to the aten op
    that launched it (profiler, CPU and CUDA activity); "elementwise" is
    every other op (casts, adds, SiLU, GELU, concatenation, upsampling)."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in VIS_GROUPS}
    out["elementwise"] = 0.0
    kernels = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels += us / 1e3
            continue
        if not us:
            continue
        for name, keys in VIS_GROUPS:
            if any(k == e.key or (k == "convolution" and k in e.key)
                   for k in keys):
                out[name] += us / 1e3
                break
        else:
            out["elementwise"] += us / 1e3
    out["unattributed"] = kernels - sum(out.values())
    return out


def profiled_spans(torch, fn):
    """fn() under the profiler (the card's activity only): (kernel table,
    kernel ms summed, ms in which at least one kernel ran, wall ms). The
    two device figures differ where kernels overlap on several streams
    (cuDNN's fp32 convolutions do)."""
    from metamorph_tpu_torch.inference.profile_serve import _kernel_table

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    table = _kernel_table(prof)
    return table, sum(r["ms"] for r in table), busy_us / 1e3, wall_ms


def unet_step_flops(torch, ucfg, B: int, latent: int, ctx_len: int = 77
                    ) -> int:
    """FLOPs of one UNet call counted from the shapes (GEMMs, convolutions
    and the attention products; torch.utils.flop_counter on "meta"
    tensors, nothing computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    from metamorph_tpu_torch.visualizer.unet import init_unet_params, unet_apply

    u = init_unet_params(ucfg, device="meta")
    meta = dict(device="meta")
    with FlopCounterMode(display=False) as fc:
        unet_apply(u, ucfg, torch.empty(B, latent, latent,
                                        ucfg.sample_channels, **meta),
                   torch.zeros(B, dtype=torch.int32, **meta),
                   torch.empty(B, ctx_len, ucfg.cross_attention_dim, **meta))
    return fc.get_total_flops()


def attention_rows(torch, dev, dtype) -> dict:
    """The UNet's level-0 self-attention (B=2, 8 heads, T=4096, Dh=40) and
    the VAE's mid attention (T=4096, C=512, one head) in the port's plain
    form (fp32 scores and softmax), and the same function through SDPA as
    a yardstick only: ms (20 calls queued), bound, max|plain - SDPA|."""
    import torch.nn.functional as F

    from metamorph_tpu_torch.visualizer.unet import attention_probs

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    rows = {}
    for name, shape in VIS_ATTN_SHAPES:
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        B, H, T, Dh = shape

        def plain():
            return attention_probs(q, k, dtype) @ v

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v)

        with torch.no_grad():
            diff = (plain().float() - sdpa().float()).abs().max().item()
            b = bound(4 * q.numel() * q.element_size(), 4 * B * H * T * T * Dh)
            ms, lib = cuda_ms(plain), cuda_ms(sdpa)
        rows[name] = dict(shape=list(shape), ms=ms, sdpa_ms=lib,
                          max_abs_plain_vs_sdpa=diff, **b,
                          bound_share=b["bound_ms"] / ms)
    return rows


def render_numbers(torch, dev, vis, smi: str) -> dict:
    """12c at 512 px in the visualizer's dtype: the UNet step (CFG batch 2)
    in steps/s (5 calls queued between CUDA events), its kernel ms by op
    group, the share of the profiled wall in which a kernel ran, its FLOPs
    and their share of 989 TFLOP/s; the VAE decode's ms; each one's peak
    memory above what was allocated before it."""
    from metamorph_tpu_torch.visualizer.unet import unet_apply
    from metamorph_tpu_torch.visualizer.vae import vae_decode

    adapter, unet, vae, ucfg, vcfg, _ = vis
    dtype = next(unet.parameters()).dtype
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    L = VIS_LATENT
    lat = torch.randn(2, L, L, ucfg.sample_channels, generator=g,
                      device=dev).to(dtype)
    ctx = torch.randn(2, 77, ucfg.cross_attention_dim, generator=g,
                      device=dev).to(dtype)
    tt = torch.full((2,), 981, dtype=torch.int32, device=dev)
    lat1 = torch.randn(1, L, L, vcfg.latent_channels, generator=g,
                       device=dev).to(dtype)

    def step():
        return unet_apply(unet, ucfg, lat, tt, ctx)

    def decode():
        return vae_decode(vae, vcfg, lat1)

    def peak_gib(fn) -> float:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    with torch.no_grad():
        step_ms = cuda_ms(step, calls=5, reps=3)
        table, kernel_ms, busy_ms, wall_ms = profiled_spans(
            torch, lambda: [step() for _ in range(3)])
        groups = op_groups(torch, step)
        vae_ms = cuda_ms(decode, calls=3, reps=3)
        peaks = {"unet_step_peak_gib": peak_gib(step),
                 "vae_decode_peak_gib": peak_gib(decode)}
    flops = unet_step_flops(torch, ucfg, 2, L)
    row = dict(dtype=str(dtype).replace("torch.", ""), smi=smi, latent=L,
               unet_step_ms=step_ms, unet_steps_per_s=1e3 / step_ms,
               unet_step_kernel_ms=kernel_ms / 3,
               unet_step_busy_ms=busy_ms / 3, busy=busy_ms / wall_ms,
               profiled_step_wall_ms=wall_ms / 3,
               op_group_ms=groups, unet_step_tflop=flops / 1e12,
               tflops=flops / step_ms / 1e9,
               share_of_989=flops / step_ms / 1e9 / PEAK_BF16_TFLOPS,
               vae_decode_ms=vae_ms, **peaks,
               top_kernels=table[:6],
               attention=attention_rows(torch, dev, dtype))
    log("visualizer 12c", json.dumps(row))
    return row


def phase_visualizer(torch, dev, model, cfg, reqs, smi: str) -> dict:
    """Phase 12 on phase 5's model: 12a the SD-1.5-width UNet, VAE and mlp
    adapter, seeded on the CPU in fp32 and copied to the card, against the
    CPU on one UNet call, one VAE decode and one 3-step DDIM render; 12b
    `greedy_decode(start_in_image=True)` writes one 64-token chunk of
    visual embeddings (kernels A and B), the visualizer goes through
    `save_visualizer` / `load_visualization` bit for bit, and the demo's
    `render_chunks` renders the chunk (PNDM-50, 512 px, four guidance
    scales) in fp32 and in bf16; 12c the render's numbers in each dtype."""
    import numpy as np
    from PIL import Image

    from metamorph_tpu_torch.inference import decode as dec
    from metamorph_tpu_torch.inference import demo, loader
    from metamorph_tpu_torch.ops.decode_attention import DECODE_ATTN
    from metamorph_tpu_torch.ops.flash_attention import FLASH_FWD
    from metamorph_tpu_torch.visualizer import adapter as va
    from metamorph_tpu_torch.visualizer import pipeline
    from metamorph_tpu_torch.visualizer import unet as vu
    from metamorph_tpu_torch.visualizer import vae as vv

    ucfg, vcfg, akw = vis_configs()
    K = cfg.mm.num_image_tokens
    Dv = cfg.siglip.hidden_size
    row = {}
    # 12a
    t = time.perf_counter()
    cpu = (va.init_adapter(akw["mode"], input_dim=Dv,
                           output_dim=ucfg.cross_attention_dim,
                           **{k: v for k, v in akw.items() if k != "mode"},
                           seed=0, device="cpu"),
           vu.init_unet_params(ucfg, seed=1, device="cpu"),
           vv.init_vae_params(vcfg, seed=2, device="cpu"))
    row["params_m"] = [sum(p.numel() for p in t_.parameters()) / 1e6
                       for t_ in cpu]
    row["init_cpu_s"] = time.perf_counter() - t
    card = tuple(t_.copy_to(dev) for t_ in cpu)
    g = torch.Generator()
    g.manual_seed(12)
    S = VIS_CHECK_LATENT
    lat = torch.randn(2, S, S, ucfg.sample_channels, generator=g)
    ctx = torch.randn(2, 77, ucfg.cross_attention_dim, generator=g)
    tt = torch.tensor([981, 981], dtype=torch.int32)
    emb = torch.randn(1, K, Dv, generator=g)
    checks = {}
    with torch.no_grad():
        t = time.perf_counter()
        ref = vu.unet_apply(cpu[1], ucfg, lat, tt, ctx)
        checks["unet_cpu_s"] = time.perf_counter() - t
        checks["unet"] = rel_err(torch, vu.unet_apply(
            card[1], ucfg, lat.to(dev), tt.to(dev), ctx.to(dev)), ref)
        lat1 = lat[:1] * 0.18215
        t = time.perf_counter()
        ref = vv.vae_decode(cpu[2], vcfg, lat1)
        checks["vae_cpu_s"] = time.perf_counter() - t
        checks["vae"] = rel_err(torch, vv.vae_decode(card[2], vcfg,
                                                     lat1.to(dev)), ref)
        kw = dict(scheduler="ddim", num_inference_steps=3, latent_size=S)
        t = time.perf_counter()
        ref = pipeline.render(*cpu, ucfg, vcfg, emb,
                              torch.Generator().manual_seed(3), **kw)
        checks["render_cpu_s"] = time.perf_counter() - t
        checks["render"] = rel_err(torch, pipeline.render(
            *card, ucfg, vcfg, emb, torch.Generator().manual_seed(3), **kw),
            ref)
    row["check"] = checks
    log("visualizer 12a", json.dumps(row))
    bad = [n for n in ("unet", "vae") if checks[n]["rel_err"] > VIS_REL_TOL]
    if bad or checks["render"]["max_abs_err"] > VIS_IMG_TOL:
        raise AssertionError(f"visualizer 12a: card vs CPU beyond "
                             f"{VIS_REL_TOL} (rel) / {VIS_IMG_TOL} (images): "
                             f"{bad} {checks}")

    # 12b: the served path writes one chunk of visual embeddings
    r = next(r for r in reqs if r["uid"] == "image")
    pe = request_embeds(torch, model, cfg, r)
    FLASH_FWD.reset()
    DECODE_ATTN.reset()
    out = dec.greedy_decode(model, cfg, pe, max_new_tokens=K + 8,
                            max_images=1, start_in_image=True)
    launches = {"flash_fwd": FLASH_FWD.launches,
                "decode_attn": DECODE_ATTN.launches}
    n_img = int(out["n_image_tokens"])
    embeds = out["image_embeds"][:n_img].float().cpu().numpy()
    row["decode"] = dict(launches=launches, n_image_tokens=n_img,
                         steps=int(out["steps"]))
    if n_img != K or embeds.shape != (K, Dv) or \
            not np.isfinite(embeds).all() or min(launches.values()) <= 0:
        raise AssertionError(f"visualizer 12b: decode gave {n_img} visual "
                             f"tokens {embeds.shape}, launches {launches}")
    d = tempfile.mkdtemp(prefix="chip_smoke_vis_")
    try:
        t = time.perf_counter()
        loader.save_visualizer(os.path.join(d, "vis"), *cpu, ucfg, vcfg,
                               akw["mode"])
        row["save_s"] = time.perf_counter() - t
        del cpu
        runs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            t = time.perf_counter()
            vis = loader.load_visualization(os.path.join(d, "vis"),
                                            dtype=dtype, device=dev)
            torch.cuda.synchronize()
            run = {"load_s": time.perf_counter() - t}
            if dtype == torch.float32:
                if not all(params_equal(a, b) for a, b in zip(vis, card)):
                    raise AssertionError("visualizer 12b: the loaded "
                                         "visualizer differs from the saved")
                del card
                free_memory(torch)
            out_dir = os.path.join(d, f"png_{tag}")
            torch.cuda.synchronize()
            t = time.perf_counter()
            imgs = demo.render_chunks(embeds, vis, out_dir, "pndm",
                                      VIS_STEPS, K, latent_size=VIS_LATENT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            imgs = imgs[0]
            names = sorted(os.listdir(out_dir))
            side = VIS_LATENT * 2 ** (len(vcfg.block_out_channels) - 1)
            pngs = [np.asarray(Image.open(os.path.join(out_dir, n)))
                    for n in names]
            if names != [f"gen_0_scale{i}.png" for i in range(4)] or \
                    imgs.shape != (4, side, side, 3) or \
                    not np.isfinite(imgs).all() or imgs.min() < 0 or \
                    imgs.max() > 1 or any(p.shape != (side, side, 3)
                                          for p in pngs):
                raise AssertionError(f"visualizer 12b ({tag}): {names}, "
                                     f"{imgs.shape}, range "
                                     f"[{imgs.min()}, {imgs.max()}]")
            run.update(render_chunks_s=wall, s_per_image=wall / 4,
                       pixel_mean=float(imgs.mean()),
                       pixel_std=float(imgs.std()))
            runs[tag] = (run, imgs)
            row[f"numbers_{tag}"] = render_numbers(torch, dev, vis, smi)
            del vis
            free_memory(torch)
        mse = float(((runs["bfloat16"][1] - runs["float32"][1]) ** 2).mean())
        row["render"] = {k: r for k, (r, _) in runs.items()}
        row["render"]["psnr_bf16_vs_fp32_db"] = 10 * math.log10(
            1.0 / max(mse, 1e-20))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log("visualizer 12b", json.dumps({k: row[k] for k in ("decode",
                                                         "render")}))
    return row


# ---------------------------------------------------------------------------
# phase 13: the visualizer's training path; 5e: offload_optimizer at 8B
# ---------------------------------------------------------------------------

VIS_TRAIN_LOSS_RTOL = 1e-5   # 13a: the loss, fp32 card (TF32 off) vs CPU
VIS_TRAIN_GRAD_TOL = 1e-4    # 13a: gradients, of the tree's max |g|
# 13a: SD-1.5's 4-level topology at small widths (SMALL4 of
# tests/test_torch_visualizer.py), the tiny VAE, a 2-layer mlp adapter
VIS_CHECK_UNET = dict(block_out_channels=(8, 16, 24, 24), layers_per_block=2,
                      cross_attention_dim=8, attention_head_dim=2,
                      norm_groups=4, attn_levels=(True, True, True, False))
VIS_CHECK_TC = dict(cfg_prob=0.5, noise_offset=0.05, learning_rate=1e-3,
                    unet_lr=5e-4, total_steps=40)
VIS_TRAIN_BATCHES = (24, 16, 8, 4)  # 13b: JAX's default first, then cuts
VIS_TRAIN_MEM_SHARE = 0.9   # 13b: the predicted peak's limit, of the card
VIS_TRAIN_RES = 512
VIS_TRAIN_STEPS = {"adapter_only": 5, "unfreeze_unet": 3}
VIS_CLI_BATCH = 8       # 13c: at most, so its data stays near seconds
OFFLOAD_STEPS = 3
GIB = 1 << 30


def vis_state_to(state: dict, dev) -> dict:
    """A copy of a visualizer train state on `dev`."""
    out = {k: state[k].copy_to(dev) for k in ("adapter", "unet", "vae")}
    for k in ("opt_adapter", "opt_unet"):
        o = state[k]
        out[k] = {"count": o["count"],
                  **{m: {n: t.to(dev, copy=True) for n, t in o[m].items()}
                     for m in ("mu", "nu")}}
    return out


def tree_max_err(torch, a, b) -> float:
    """max |a - b| over the parameters of two trees (b on the CPU)."""
    want = dict(b.named_parameters())
    return max((p.detach().cpu() - want[n]).abs().max().item()
               for n, p in a.named_parameters())


def phase_vis_train_check(torch, dev) -> dict:
    """13a: the visualizer's loss, gradients and train steps on the card
    (fp32, TF32 off) against the CPU, from one state made on the CPU and
    copied, with the same draws (a CPU generator feeds both): the loss and
    the adapter and UNet gradients, then 3 adapter-only steps and 2
    `unfreeze_unet` steps, losses every step and the trees after."""
    from metamorph_tpu_torch.train.optimizer import PlainAdamW
    from metamorph_tpu_torch.visualizer import adapter as va
    from metamorph_tpu_torch.visualizer import train as vt
    from metamorph_tpu_torch.visualizer import unet as vu
    from metamorph_tpu_torch.visualizer import vae as vv
    from metamorph_tpu_torch.visualizer.scheduler import DDPMScheduler

    ucfg, vcfg = vu.UNetConfig(**VIS_CHECK_UNET), vv.VAEConfig.tiny()
    cpu = torch.device("cpu")
    trees = dict(adapter=va.init_adapter("mlp", input_dim=32, hidden_dim=32,
                                         output_dim=ucfg.cross_attention_dim,
                                         num_layers=2, seed=0, device=cpu),
                 unet=vu.init_unet_params(ucfg, 1, cpu),
                 vae=vv.init_vae_params(vcfg, 2, cpu))
    states = {"cpu": {**trees,
                      "opt_adapter": PlainAdamW.init(trees["adapter"]),
                      "opt_unet": PlainAdamW.init(trees["unet"])}}
    states["card"] = vis_state_to(states["cpu"], dev)
    g = torch.Generator().manual_seed(13)
    emb = torch.randn(2, 4, 32, generator=g)
    img = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1
    where = {"cpu": cpu, "card": dev}
    tc = vt.VisualizerTrainConfig(**VIS_CHECK_TC)
    row = {"grads": {}}
    out = {}
    for side, st in states.items():
        st["adapter"].requires_grad_(True)
        st["unet"].requires_grad_(True)
        loss = vt.visualizer_loss(st["adapter"], st["unet"], st["vae"],
                                  (tc, ucfg, vcfg, DDPMScheduler()),
                                  emb.to(where[side]), img.to(where[side]),
                                  torch.Generator().manual_seed(100))
        loss.backward()
        out[side] = (float(loss.detach()), {
            t: {n: p.grad.detach().cpu() for n, p in st[t].named_parameters()}
            for t in ("adapter", "unet")})
        for t in ("adapter", "unet"):
            st[t].requires_grad_(False)
            for p in st[t].parameters():
                p.grad = None
    row["loss"] = [out["cpu"][0], out["card"][0]]
    bad = []
    if abs(out["card"][0] - out["cpu"][0]) > VIS_TRAIN_LOSS_RTOL * abs(
            out["cpu"][0]):
        bad.append("loss")
    for t in ("adapter", "unet"):
        ref, got = out["cpu"][1][t], out["card"][1][t]
        scale = max(x.abs().max().item() for x in ref.values())
        err = max((got[n] - ref[n]).abs().max().item() for n in ref)
        row["grads"][t] = dict(max_abs_err=err, max_abs_grad=scale)
        if not err <= VIS_TRAIN_GRAD_TOL * scale:
            bad.append(f"{t} gradient")

    steps, n = {}, 0
    for name, count, unfreeze in (("adapter_only", 3, False),
                                  ("unfreeze_unet", 2, True)):
        step, _ = vt.make_visualizer_train_step(
            vt.VisualizerTrainConfig(unfreeze_unet=unfreeze, **VIS_CHECK_TC),
            ucfg, vcfg)
        losses = {side: [] for side in states}
        for i in range(count):
            for side, st in states.items():
                _, loss = step(st, emb.to(where[side]), img.to(where[side]),
                               torch.Generator().manual_seed(200 + n))
                losses[side].append(float(loss))
            n += 1
        steps[name] = losses
        if any(abs(a - b) > VIS_TRAIN_LOSS_RTOL * abs(a)
               for a, b in zip(losses["cpu"], losses["card"])):
            bad.append(f"{name} losses")
    row["steps"] = steps
    # Adam's first updates are near lr * sign(m / sqrt(v)): a gradient that
    # differs in its low bits can flip a near-zero entry's sign
    atol = {"adapter": 2 * tc.learning_rate * 5 + 1e-6,
            "unet": 2 * tc.unet_lr * 2 + 1e-6, "vae": 0.0}
    row["trees"] = {}
    for t, tol in atol.items():
        err = tree_max_err(torch, states["card"][t], states["cpu"][t])
        row["trees"][t] = dict(max_abs_err=err, atol=tol)
        if err > tol:
            bad.append(f"{t} after the steps")
    log("visualizer train 13a", json.dumps(row))
    if bad:
        raise AssertionError(f"visualizer train 13a: card vs CPU: {bad}")
    return row


def vis_train_flops(torch, ucfg, vcfg, akw, B: int, unfreeze: bool,
                    res: int) -> int:
    """FLOPs of one visualizer train step counted from the shapes
    (`unet_step_flops` extended to the step): the VAE encode, the adapter
    forward and backward, the UNet forward and its backward to the
    conditioning, plus the UNet's weight gradients when it is unfrozen
    (torch.utils.flop_counter on "meta" tensors, nothing computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    from metamorph_tpu_torch.visualizer import adapter as va
    from metamorph_tpu_torch.visualizer import unet as vu
    from metamorph_tpu_torch.visualizer import vae as vv

    meta = dict(device="meta")
    a = va.init_adapter(akw["mode"], output_dim=ucfg.cross_attention_dim,
                        **meta)
    u = vu.init_unet_params(ucfg, **meta)
    v = vv.init_vae_params(vcfg, **meta)
    a.requires_grad_(True)
    u.requires_grad_(unfreeze)
    emb = torch.empty(B, 64, 1152, **meta)
    img = torch.empty(B, res, res, 3, **meta)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            lat = vv.vae_encode(v, vcfg, img)
        cond = va.pad_tokens(va.apply_adapter(a, emb, mode=akw["mode"]), 77)
        pred = vu.unet_apply(u, ucfg, lat,
                             torch.zeros(B, dtype=torch.int64, **meta), cond)
        ((pred.float() - lat) ** 2).mean().backward()
    return fc.get_total_flops()


def fit_vis_batch(torch, dev, state, tc, ucfg, vcfg, inputs):
    """The first of VIS_TRAIN_BATCHES whose step is predicted to fit in
    VIS_TRAIN_MEM_SHARE of the card: the peak of a loss and backward
    (where the step peaks; the update after it adds per-tensor
    temporaries only) is measured at 2 and 4 images and extended linearly.
    Returns (batch, the cuts with their predicted peaks, the measured
    peaks). A batch is never tried to find out: an out-of-memory error
    does not give its memory back reliably."""
    from metamorph_tpu_torch.visualizer import train as vt
    from metamorph_tpu_torch.visualizer.scheduler import DDPMScheduler

    trained = ("adapter", "unet") if tc.unfreeze_unet else ("adapter",)
    peaks = {}
    for B in (2, 4):
        for name in ("adapter", "unet", "vae"):
            state[name].requires_grad_(name in trained)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = vt.visualizer_loss(
            state["adapter"], state["unet"], state["vae"],
            (tc, ucfg, vcfg, DDPMScheduler()), *inputs(B),
            torch.Generator(device=dev).manual_seed(99))
        loss.backward()
        del loss
        torch.cuda.synchronize()
        peaks[B] = torch.cuda.max_memory_allocated()
        for name in trained:
            for p in state[name].parameters():
                p.grad = None
        free_memory(torch)
    per_image = (peaks[4] - peaks[2]) / 2
    limit = VIS_TRAIN_MEM_SHARE * torch.cuda.get_device_properties(
        dev).total_memory
    cuts = []
    for B in VIS_TRAIN_BATCHES:
        need = peaks[4] + per_image * (B - 4)
        if need <= limit:
            return B, cuts, {k: v / GIB for k, v in peaks.items()}
        cuts.append({"batch_size": B, "predicted_peak_gib": need / GIB})
        log(f"visualizer train 13b: batch {B} would peak at "
            f"{need / GIB:.2f} GiB, over {limit / GIB:.2f}")
    raise AssertionError(f"visualizer train 13b: no batch fits: {cuts}")


def phase_vis_train(torch, dev, smi: str) -> dict:
    """13b: the visualizer's train step at SD-1.5 width (`vis_configs`:
    UNet 859.5 M, VAE 83.7 M, mlp adapter 75.0 M parameters), fp32 at
    512 px, random weights from seed 0 and random inputs: 5 adapter-only
    steps, then 3 with `unfreeze_unet`, each at the largest batch of
    VIS_TRAIN_BATCHES predicted to fit; step s, images/s, peak memory, busy
    share over one profiled step, FLOPs and their share of 989 TFLOP/s."""
    import dataclasses

    from metamorph_tpu_torch.visualizer import train as vt

    ucfg, vcfg, akw = vis_configs()
    tc0 = vt.VisualizerTrainConfig(adapter_mode=akw["mode"])
    _, init = vt.make_visualizer_train_step(tc0, ucfg, vcfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = init(0, device=dev)
    torch.cuda.synchronize()
    row = {"smi": smi, "init_s": time.perf_counter() - t,
           "params_m": [sum(p.numel() for p in state[k].parameters()) / 1e6
                        for k in ("adapter", "unet", "vae")],
           "state_gib": torch.cuda.memory_allocated() / GIB}
    g = torch.Generator(device=dev).manual_seed(14)

    def inputs(B):
        emb = torch.randn(B, tc0.num_tokens, 1152, generator=g, device=dev)
        img = torch.rand(B, VIS_TRAIN_RES, VIS_TRAIN_RES, 3, generator=g,
                         device=dev) * 2 - 1
        return emb / emb.norm(dim=-1, keepdim=True), img

    for name, n_steps in VIS_TRAIN_STEPS.items():
        tc = dataclasses.replace(tc0, unfreeze_unet=name == "unfreeze_unet")
        step, _ = vt.make_visualizer_train_step(tc, ucfg, vcfg)
        B, cuts, probe = fit_vis_batch(torch, dev, state, tc, ucfg, vcfg,
                                       inputs)
        emb, img = inputs(B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(n_steps):
            gen = torch.Generator(device=dev).manual_seed(i)
            t = time.perf_counter()
            state, loss = step(state, emb, img, gen)
            losses.append(float(loss))
            times.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() / GIB
        gen = torch.Generator(device=dev).manual_seed(n_steps)
        _, kernel_ms, busy_ms, wall_ms = profiled_spans(
            torch, lambda: step(state, emb, img, gen))
        flops = vis_train_flops(torch, ucfg, vcfg, akw, B,
                                name == "unfreeze_unet", VIS_TRAIN_RES)
        step_s = statistics.median(times[1:])
        r = dict(batch_size=B, probe_peak_gib=probe, step_s=times,
                 step_s_median=step_s,
                 images_per_s=B / step_s, peak_gib=peak, losses=losses,
                 profiled_step_wall_ms=wall_ms, kernel_ms=kernel_ms,
                 busy_ms=busy_ms, busy=busy_ms / wall_ms,
                 step_tflop=flops / 1e12, tflops=flops / step_s / 1e12,
                 share_of_989=flops / step_s / 1e12 / PEAK_BF16_TFLOPS)
        if cuts:
            r["reduced"] = {"batch_size": f"{tc0.batch_size} -> {B}",
                            "cuts": cuts}
        row[name] = r
        log(f"visualizer train 13b ({name})", json.dumps(r))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"visualizer train 13b ({name}): losses "
                                 f"{losses}")
        del emb, img
        free_memory(torch)
    del state
    free_memory(torch)
    return row


def write_png_shards(d: str, n_shards: int = 2, per: int = 8,
                     side: tuple = (384, 448)) -> list:
    """Tar shards of random PNGs (and a caption member each); the first
    shard also holds a corrupt image, which the CLI must skip."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(15)
    paths = []
    for s in range(n_shards):
        members = []
        for i in range(per):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (*side, 3), np.uint8)).save(
                buf, format="PNG")
            members.append((f"{s:02d}_{i:03d}.png", buf.getvalue()))
            members.append((f"{s:02d}_{i:03d}.txt", b"a caption"))
        if s == 0:
            members.insert(2, ("00_bad.png", b"\x89PNG\r\n\x1a\ntruncated"))
        path = os.path.join(d, f"shard_{s:02d}.tar")
        with tarfile.open(path, "w") as tf:
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        paths.append(path)
    return paths


def phase_vis_cli(torch, dev, batch: int) -> dict:
    """13c: `python -m metamorph_tpu_torch.visualizer.main` end to end on
    the card: two tar shards of PNGs (one corrupt member), a random
    SO400M SigLIP in HF layout (`siglip_params_to_hf`, fp32), 3 steps at
    `batch`, then the directory through `load_visualization`: the adapter
    trained, the UNet and VAE bitwise their seeds' init. Also the SigLIP
    encode's ms per image (fp32, `batch` images queued). Everything in a
    temporary directory, deleted whatever happens."""
    from metamorph_tpu_torch.config import MultimodalConfig, SiglipConfig
    from metamorph_tpu_torch.inference import loader
    from metamorph_tpu_torch.models.hf_import import siglip_params_to_hf
    from metamorph_tpu_torch.models.siglip import Siglip, vision_tower_forward
    from metamorph_tpu_torch.utils.safetensors_io import save_file
    from metamorph_tpu_torch.visualizer import train as vt

    d = tempfile.mkdtemp(prefix="chip_smoke_vis_train_")
    row = {"batch_size": batch}
    try:
        with open(os.path.join(d, "shards.json"), "w") as f:
            json.dump(write_png_shards(d), f)
        sc = SiglipConfig()
        sig = Siglip(sc, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        with torch.no_grad():
            for p in sig.parameters():
                p.normal_(0.0, 0.02, generator=gen)
        os.makedirs(os.path.join(d, "siglip"))
        t = time.perf_counter()
        row["siglip_bytes"] = save_file(
            siglip_params_to_hf(sig),
            os.path.join(d, "siglip", "model.safetensors"))
        row["siglip_save_s"] = time.perf_counter() - t
        mm = MultimodalConfig(num_image_tokens=64, normalize_vision=True)
        px = torch.rand(batch, sc.image_size, sc.image_size, 3, generator=gen,
                        device=dev) * 2 - 1
        with torch.no_grad():
            row["siglip_encode_ms_per_image"] = cuda_ms(
                lambda: vision_tower_forward(sig, sc, mm, px), calls=3,
                reps=3) / batch
        del sig, px
        free_memory(torch)

        out = os.path.join(d, "vis")
        cmd = [sys.executable, "-m", "metamorph_tpu_torch.visualizer.main",
               "--shards", os.path.join(d, "shards.json"),
               "--siglip", os.path.join(d, "siglip"), "--output-dir", out,
               "--batch-size", str(batch), "--total-steps", "3",
               "--save-steps", "3"]
        env = {**os.environ, "PYTHONPATH": ROOT}
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=900)
        row["cli_s"] = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"visualizer train 13c: the CLI exited "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        a, u, v, ucfg, vcfg, mode = loader.load_visualization(out, device=dev)
        want_u, want_v, _ = vis_configs()
        _, init = vt.make_visualizer_train_step(vt.VisualizerTrainConfig(),
                                                want_u, want_v)
        s0 = init(0, device=dev)

        def differ(tree, ref):
            want = dict(ref.named_parameters())
            return [n for n, p in tree.named_parameters()
                    if not torch.equal(p, want[n])]

        row.update(files=sorted(os.listdir(out)),
                   adapter_changed=len(differ(a, s0["adapter"])),
                   adapter_params=len(list(a.parameters())),
                   unet_changed=differ(u, s0["unet"]),
                   vae_changed=differ(v, s0["vae"]))
        log("visualizer train 13c", json.dumps(row))
        if (ucfg, vcfg, mode) != (want_u, want_v, "mlp") or \
                not row["adapter_changed"] or row["unet_changed"] or \
                row["vae_changed"] or "metrics.jsonl" not in row["files"]:
            raise AssertionError(f"visualizer train 13c: {row}")
        del a, u, v, s0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    free_memory(torch)
    return row


def host_memory_gib() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in GiB."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key = line.split(":")[0]
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(line.split()[1]) / 2**20
    return out


def copy_rates(torch, dev) -> dict:
    """Host <-> card copy rates of one pinned GiB (CUDA events, 5 copies
    each way queued)."""
    host = torch.empty(GIB, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(GIB, dtype=torch.uint8, device=dev)
    row = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        row[f"{name}_gb_per_s"] = GIB / 1e6 / cuda_ms(
            lambda: dst.copy_(src, non_blocking=True), calls=5, reps=3)
    return row


def phase_offload(torch, dev, train_row) -> dict:
    """5e: `offload_optimizer` on 5b's 8B stage-2 cut: the host probed
    (/proc/meminfo, the moments' bytes from the trainable mask, host <->
    card copy rates), then 3 steps with the moments in pinned host memory
    and 3 with them on the card, each from seed 0's weights on 5b's batch:
    losses and every parameter bitwise equal (checksums), the moments
    pinned, step s and device peak beside 5b's. Where the host cannot pin
    the moments, the LLaMA's layers are cut by a quarter at a time until
    it can, and each cut is logged with its error."""
    import dataclasses

    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.models.metamorph import MetaMorph
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.train import train_step as TS
    from metamorph_tpu_torch.train.optimizer import (make_optimizer,
                                                     trainable_mask)
    from metamorph_tpu_torch.train.profile_train import (packed_row,
                                                         stage2_one_card)

    cfg, reduced = stage2_one_card(4096)
    reduced = dict(reduced)

    def moment_bytes(c):
        m = MetaMorph(c, dtype=torch.bfloat16, device="meta")
        mask = trainable_mask(m, c.train)
        return 2 * sum(p.numel() * p.element_size()
                       for n, p in m.named_parameters() if mask[n])

    row = {"host": host_memory_gib(), "moment_gib": moment_bytes(cfg) / GIB,
           **copy_rates(torch, dev)}
    log("offload 5e: host", json.dumps(row))
    T, K, N = cfg.train.max_seq_len, cfg.mm.num_image_tokens, \
        cfg.train.max_images_per_batch
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)

    def run(offload: bool) -> dict:
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, offload_optimizer=offload))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = init_params(c, seed=0, device=dev, dtype=torch.bfloat16)
        state = TS.init_train_state(model, c)
        tx = make_optimizer(c.train, model)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 batch_to_arrays(packed_row(T, K, N, seed=21)).items()}
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        s = c.siglip.image_size
        pixels = torch.randn((N, s, s, 3), generator=gen, device=dev)
        for kern in kernels:
            kern.launches = 0
        times, losses = [], []
        for _ in range(OFFLOAD_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = TS.train_step(state, batch, pixels, c, tx)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        out = dict(step_s=times, losses=losses,
                   peak_gib=torch.cuda.max_memory_allocated() / GIB,
                   launches={k.symbol: k.launches for k in kernels},
                   sums={n: tensor_checksum(torch, p)
                         for n, p in model.named_parameters()})
        moments = [t for k in ("mu", "nu")
                   for t in state["opt_state"][k].values()]
        out["moments_pinned"] = all(t.is_pinned() for t in moments)
        out["moments_on_card"] = sum(t.is_cuda for t in moments)
        if offload:
            out["host_after_steps"] = host_memory_gib()
        del model, state, tx, batch, pixels, moments
        free_memory(torch)
        return out

    while True:
        try:
            off = run(True)
            break
        except RuntimeError as e:
            if "offload_optimizer: could not pin" not in str(e) or \
                    cfg.llama.num_layers == 1:
                raise
            err = str(e).splitlines()[0][:300]
        free_memory(torch)
        L = cfg.llama.num_layers * 3 // 4
        log(f"offload 5e: {err}; layers {cfg.llama.num_layers} -> {L}")
        reduced["llama.num_layers"] = L
        reduced.setdefault("pin_errors", []).append(err)
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, num_layers=L))
        row["moment_gib"] = moment_bytes(cfg) / GIB
    on_card = run(False)
    differ = [n for n in on_card["sums"]
              if on_card["sums"][n] != off["sums"][n]]
    row.update(reduced=reduced, steps=OFFLOAD_STEPS,
               on_card={k: v for k, v in on_card.items() if k != "sums"},
               offload={k: v for k, v in off.items() if k != "sums"},
               params_differing=len(differ), params=len(off["sums"]),
               step_s_median=statistics.median(off["step_s"][1:]),
               on_card_step_s_median=statistics.median(on_card["step_s"][1:]),
               train_main_step_s=train_row["step_s_median_2_4"],
               train_main_peak_gib=train_row["peak_mem_gib"],
               launches=off["launches"])
    log("offload 5e", json.dumps(row))
    if off["losses"] != on_card["losses"] or differ or \
            not off["moments_pinned"] or off["moments_on_card"] or \
            min(off["launches"].values()) <= 0:
        raise AssertionError(f"offload 5e: offloaded against on-card: "
                             f"losses {off['losses']} / {on_card['losses']}, "
                             f"{len(differ)} parameters differ "
                             f"({differ[:3]}), "
                             f"pinned {off['moments_pinned']}, launches "
                             f"{off['launches']}")
    return row


# ---------------------------------------------------------------------------
# phase 5f: the DeepSeek-V3 block's serving path (Kimi-VL-A3B's decoder)
# ---------------------------------------------------------------------------

MLA_MOE_CONFIG = os.path.join(ROOT, "benchmark", "configs",
                              "mm-kimivl-a3b.json")


def mla_moe_requests(np, image_embeds, n_text: int = 40, n_image: int = 8,
                     seed: int = 5) -> list:
    """The chat mix's shape: prompts lognormal about 1,020 tokens (sigma
    0.8, 32-3,000), 16-48 new tokens; image requests carry one image at
    position 10."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.exp(np.log(1020) + 0.8 * rng.standard_normal(
        n_text + n_image)), 32, 3000).astype(int)
    reqs = []
    for i, t in enumerate(lens):
        r = dict(prompt_ids=rng.integers(10, 128000, (t,)).astype(np.int32),
                 max_new_tokens=int(rng.integers(16, 49)), uid=f"r{i}")
        if i >= n_text:
            r.update(image_embeds=image_embeds,
                     image_positions=np.asarray([10]))
        reqs.append(r)
    return reqs


def phase_mla_moe(torch, dev) -> dict:
    """5f: MetaMorph on Kimi-VL-A3B's decoder (benchmark/configs/
    mm-kimivl-a3b.json: latent attention, 64 routed experts, top 6; seeded
    bf16 weights, SigLIP-SO400M) through ServeEngine at the chat cell's
    engine (128 slots x 4,096, 8 steps a tick), text and image requests at
    once, served eagerly and then with the plain ticks replayed from CUDA
    graphs: equal ids, every plain tick after each key's capture replayed,
    each step's expert counts summing to k per advancing row in every
    expert layer. Kernel G's and the grouped products' launches are read
    from the graphed run (`ran_on_card`; the counters reset just before
    it), and kernel G is held against `mla_decode_plain` on the query and
    latent rows of the eager run's first decode step at layer 3, with its
    device ms (a CUDA graph of 20 calls over three copies of the rows, so
    no launch finds its keys in L2), the plain version's ms and the
    bound of the rows' keys."""
    import numpy as np

    from benchmark.weights_mla_moe import fill_model_
    from metamorph_tpu_torch.config import MetaMorphConfig
    from metamorph_tpu_torch.inference.serve import Request, ServeEngine
    from metamorph_tpu_torch.models import mla_moe
    from metamorph_tpu_torch.models.metamorph import MetaMorph, encode_images
    from metamorph_tpu_torch.ops import mla_decode
    from metamorph_tpu_torch.ops.moe import GROUPED_MM

    with open(MLA_MOE_CONFIG) as f:
        cfg_d = json.load(f)
    cfg = MetaMorphConfig.from_dict(cfg_d)
    lc = cfg.llama
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        model = MetaMorph(cfg, dtype=torch.bfloat16, device=dev)
        fill_model_(model, cfg_d, 0)
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"5f: {lc.attention_kind} model built "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(0)
    s = cfg.siglip.image_size
    with torch.no_grad():
        pixels = torch.randn((1, s, s, 3), generator=gen, device=dev)
        image_embeds, _ = encode_images(model, cfg, pixels)
    reqs = mla_moe_requests(np, image_embeds)

    # kernel G's inputs and output at its first call of layer 3
    want_layer, seen = 3, {}
    kernel = mla_moe.mla_decode_attention

    def noting(q, cache, lengths, layer, d_v, scale):
        o = kernel(q, cache, lengths, layer, d_v, scale)
        if layer == want_layer and not seen:
            seen.update(q=q.clone(), rows=cache[layer].clone(),
                        lengths=lengths.clone(), out=o.clone(), scale=scale)
        return o

    def serve(graphed: bool):
        eng = ServeEngine(model, cfg, n_slots=128, max_cache_len=4096,
                          max_new_tokens_cap=512, steps_per_sync=8, seed=0)
        if not graphed:
            eng._capture = None
        mla_decode.MLA_DECODE.reset()
        GROUPED_MM.reset()
        for r in reqs:
            eng.submit(Request(**r))
        sums, n_moe = [], sum(map(lc.is_moe_layer, range(lc.num_layers)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            while eng.pending or any(u is not None for u in eng.slot_uid):
                eng.step()
                if eng.routes is not None:
                    sums.append(eng.routes.sum(axis=-1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        done = {c.uid: c for c in eng.completed}
        if sorted(done) != sorted(r["uid"] for r in reqs):
            raise AssertionError(f"5f: served {sorted(done)}")
        sums = np.concatenate(sums)          # [steps, L_moe]
        if sums.shape[1] != n_moe or (sums % lc.num_experts_per_tok).any() \
                or (sums != sums[:, :1]).any() or not sums.any():
            raise AssertionError(f"5f: expert counts per step and layer "
                                 f"are not k per advancing row: {sums}")
        out = dict(wall_s=wall, ticks=dict(eng.tick_counts),
                   new_tokens=sum(c.steps for c in done.values()),
                   launches={k.symbol: ran_on_card(k, eng)
                             for k in (mla_decode.MLA_DECODE, GROUPED_MM)},
                   host_calls={k.symbol: k.launches
                               for k in (mla_decode.MLA_DECODE, GROUPED_MM)},
                   graphs=len(eng._graphs), routed_picks=int(sums.sum()))
        del eng
        free_memory(torch)
        return done, out

    mla_moe.mla_decode_attention = noting
    try:
        eager, eager_row = serve(False)
    finally:
        mla_moe.mla_decode_attention = kernel
    graphed, graph_row = serve(True)
    for uid, c in eager.items():
        if not np.array_equal(c.ids, graphed[uid].ids):
            raise AssertionError(f"5f: {uid}: graphed ids differ from eager")
    t = graph_row["ticks"]
    if eager_row["ticks"]["plain_graphed"] != 0 or t["captures"] != \
            graph_row["graphs"] or t["plain_graphed"] != \
            t["plain"] - graph_row["graphs"] or not t["plain_graphed"]:
        raise AssertionError(f"5f: plain ticks not replayed: eager "
                             f"{eager_row['ticks']}, graphed {t}")
    for k, n in graph_row["launches"].items():
        if n <= 0 or eager_row["launches"][k] <= 0:
            raise AssertionError(f"5f: {k} did not run: {graph_row}")

    q, rows, lengths, scale = (seen[k] for k in ("q", "rows", "lengths",
                                                 "scale"))
    d_v = lc.kv_lora_rank
    t_plain = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t_plain[0].record()
    want = mla_decode.mla_decode_plain(q.float(), rows.float(), lengths, d_v,
                                       scale)
    t_plain[1].record()
    torch.cuda.synchronize()
    err = float((seen["out"].float() - want).abs().max())
    if not err <= DECODE_TOL:
        raise AssertionError(f"5f: kernel G off its plain version by {err}")
    copies = [rows[None]] + [rows[None].clone() for _ in range(2)]
    turn = [0]

    def call():
        turn[0] += 1
        mla_decode.mla_decode_attention(q, copies[turn[0] % 3], lengths, 0,
                                        d_v, scale)

    ms = cuda_graph_ms(call)
    B, H, Dl = q.shape
    keys = int(lengths.sum())
    b = bound(2 * Dl * keys + 2 * B * H * (Dl + d_v),
              2 * H * (Dl + d_v) * keys)
    del copies, rows, want, seen
    active = int((lengths > 1).sum())
    row = dict(
        model=lc.attention_kind, requests=len(reqs),
        image_requests=sum("image_embeds" in r for r in reqs),
        eager=eager_row, graphed=graph_row,
        tok_per_s_graphed=graph_row["new_tokens"] / graph_row["wall_s"],
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        kernel_g=dict(layer=want_layer, rows=B, rows_advancing=active,
                      keys=keys, max_abs_err=err, ms=ms,
                      plain_ms=t_plain[0].elapsed_time(t_plain[1]),
                      **b, **rates(b, ms)),
        ids_identical=True)
    log("5f: MLA + MoE serving path", json.dumps(row))
    del model
    free_memory(torch)
    return row


def mla_moe_kernels(row: dict) -> list:
    """The summary line's entries of phase 5f: kernel G (its launches on
    the serving path, and its error, time, plain time and bound on the
    path's own rows) and the grouped products' launches (PyTorch's
    `torch._grouped_mm`, no hand-written kernel)."""
    g = row["kernel_g"]

    def launches(symbol):
        return {"launches": row["graphed"]["launches"][symbol],
                "launches_by_path": {"serve_mla_moe": row["graphed"][
                    "launches"][symbol]}}

    return [
        {"name": "mla_decode_attn", "route": "triton",
         "source": "metamorph_tpu_torch/ops/mla_decode.py",
         "replaces": "none: the JAX package has no latent attention",
         **launches("mla_decode_attn_kernel"),
         "max_abs_err": g["max_abs_err"], "ms": g["ms"],
         "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "bound_share": g["bound_share"],
         "library_ms": None,
         "ms_method": "CUDA graph of 20 calls over three copies of the "
                      "rows, replay timed by CUDA events",
         "shape": {k: g[k] for k in ("rows", "rows_advancing", "keys")}},
        {"name": "grouped_mm", "route": "library: torch._grouped_mm",
         "source": "metamorph_tpu_torch/ops/moe.py",
         "replaces": "none: the JAX package has no routed experts",
         **launches("grouped_mm")},
    ]


# ---------------------------------------------------------------------------
# phase 14: multi-GPU training, on one card
# ---------------------------------------------------------------------------

UPDATE_SAMPLE = 1 << 16   # 14a: elements of each tensor's update compared
SHARDED_LOSS_RTOL = 1e-3  # 14a, when not bitwise: the losses
SHARDED_UPDATE_TOL = 2e-2  # 14a, when not bitwise: each sampled update,
                           # of its max |update|
RING_N, RING_CHUNK = 8, 2048   # 14b: configs/longctx_sp.json's ring (fsdp 8,
                               # T = 16,384: 2,048 positions a rank)
RING_HEADS = (32, 8, 128)      # 14b: H, KV, Dh of its LLaMA-3.1-8B
VIS_DP_LOSS_RTOL = 1e-5   # 14c, when not bitwise: the losses (13a's)
VIS_DP_ADAPTER_TOL = 4e-4  # 14c, when not bitwise: the adapter, absolute:
                           # 2 * lr * steps of Adam, lr 1e-4, 2 steps (13a's
                           # rule)
RING_TOL = 2e-2   # 14b: each row of o, dq, dk, dv against its own max |ref|
                  # (3c's rule): the ring's bf16 chunk outputs and gradients,
                  # summed over up to 8 chunks, against one kernel call


def one_rank_group(torch, dev, d: str) -> None:
    """A one-rank NCCL process group on `dev`, its rendezvous a FileStore
    in `d` (no port)."""
    from metamorph_tpu_torch.parallel import mesh as mesh_lib

    store = torch.distributed.FileStore(os.path.join(d, "store"), 1)
    mesh_lib.init_distributed(dev.type, store=store, rank=0, world_size=1,
                              device=dev)
    if dev.type == "cuda" and torch.distributed.get_backend() != "nccl":
        raise AssertionError("phase 14: the process group is not NCCL")


def nccl_kernels(table) -> dict:
    """NCCL's kernels in a profiler table: launches, device ms, names."""
    rows = [r for r in table if "nccl" in r["name"].lower()]
    return {"count": sum(r["calls"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "names": sorted({r["name"][:80] for r in rows})}


def reset_parallel_context() -> None:
    from metamorph_tpu_torch.parallel import context

    context.set_current_mesh(None)
    context.set_sequence_axis(None)


def phase_sharded_train(torch, dev, train_row) -> dict:
    """14a: `make_sharded_train_step` over the one-rank NCCL mesh (data 1,
    fsdp -1, tensor 1) of the stage-2 step at 8B + SO400M width, with 5b's
    config, seed and batch: FSDP2's wrapping and collectives, the global
    normalizers and metrics, the sharded norm and update. Its two steps
    are held to 5b's first two: bitwise (the losses, grad norms and every
    parameter's checksum), else the losses within SHARDED_LOSS_RTOL and
    each tensor's update within SHARDED_UPDATE_TOL; the log says which."""
    import dataclasses

    from metamorph_tpu_torch.config import MeshConfig
    from metamorph_tpu_torch.convert import init_params
    from metamorph_tpu_torch.multimodal.packing import batch_to_arrays
    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.parallel import mesh as mesh_lib
    from metamorph_tpu_torch.train.optimizer import local
    from metamorph_tpu_torch.train.profile_train import (packed_row,
                                                         stage2_one_card)
    from metamorph_tpu_torch.train.train_step import make_sharded_train_step

    cfg, _ = stage2_one_card(4096)
    cfg = dataclasses.replace(cfg, mesh=MeshConfig(data=1, fsdp=-1,
                                                   tensor=1))
    T, K, N = cfg.train.max_seq_len, cfg.mm.num_image_tokens, \
        cfg.train.max_images_per_batch
    mesh = mesh_lib.build_mesh(cfg.mesh, dev.type)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    step, tx, state = make_sharded_train_step(cfg, mesh, model)
    params = dict(state["params"].named_parameters())
    init_sample = {n: local(p).detach().reshape(-1)[:UPDATE_SAMPLE]
                   .float().cpu() for n, p in params.items()}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             batch_to_arrays(packed_row(T, K, N, seed=21)).items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = cfg.siglip.image_size
    pixels = torch.randn((N, s, s, 3), generator=gen, device=dev)
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
    for kern in kernels:
        kern.launches = 0
    steps, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch, pixels)
        steps.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = {k.symbol: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / GIB

    ref = train_row["step2"]
    ref_steps = [dict(loss=train_row["losses"][i],
                      grad_norm=train_row["grad_norms"][i]) for i in (0, 1)]
    sums = {n: tensor_checksum(torch, local(p)) for n, p in params.items()}
    bitwise = (set(sums) == set(ref)
               and all(steps[i][k] == ref_steps[i][k] for i in (0, 1)
                       for k in ("loss", "grad_norm"))
               and all(sums[n] == ref[n][0] for n in sums))
    worst = None
    if bitwise:
        held = "bitwise: losses, grad norms, every parameter's checksum"
    else:
        held = (f"losses within {SHARDED_LOSS_RTOL} relative, each tensor's "
                f"update (its first {UPDATE_SAMPLE} elements) within "
                f"{SHARDED_UPDATE_TOL} of its max |update|")
        worst = 0.0
        for n, p in params.items():
            got = (local(p).detach().reshape(-1)[:UPDATE_SAMPLE].float().cpu()
                   - init_sample[n])
            want = ref[n][1]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            worst = max(worst, err / scale if scale > 0 else err)
        losses_ok = all(
            abs(steps[i]["loss"] - ref_steps[i]["loss"])
            <= SHARDED_LOSS_RTOL * abs(ref_steps[i]["loss"]) for i in (0, 1))
        if not (losses_ok and worst <= SHARDED_UPDATE_TOL):
            raise AssertionError(
                f"sharded train 14a: steps {steps} against 5b's "
                f"{ref_steps}, worst update error {worst}")
    # a third step under the profiler, after the comparison: NCCL's
    # kernels and the busy share
    out = []
    table, kernel_ms, busy_ms, wall_ms = profiled_spans(
        torch, lambda: out.append(step(state, batch, pixels)))
    row = dict(mesh=mesh_lib.axis_sizes(mesh),
               backend=torch.distributed.get_backend(), held=held,
               bitwise=bitwise, worst_update_err=worst, step_s=times,
               one_card_step_s=train_row["step_s"][:2],
               peak_mem_gib=peak,
               one_card_peak_mem_gib=train_row["peak_mem_gib"],
               steps=steps, one_card_steps=ref_steps, launches=launches,
               nccl=nccl_kernels(table),
               profiled_step_3=dict(wall_ms=wall_ms, kernel_ms=kernel_ms,
                                    busy_ms=busy_ms, busy=busy_ms / wall_ms))
    log("sharded train 14a", json.dumps(row))
    for kern in kernels:
        if kern.launches <= 0:
            raise AssertionError(f"14a: kernel {kern.symbol} not launched")
    reset_parallel_context()
    del state, model, step, tx, params, batch, pixels, out
    free_memory(torch)
    return row


def row_rel_err(torch, got, ref) -> float:
    """max over rows (the last dim) of max|got - ref| / max|ref| of the
    row (3c's rule)."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1).clamp_min(1e-3)).max().item()


def phase_ring(torch, dev) -> dict:
    """14b: ring attention at configs/longctx_sp.json's layout (B 1,
    T 16,384 in 8 chunks of 2,048, H 32, KV 8, Dh 128, bf16): each of the
    8 ring positions in turn through `_ring_body`, forward and backward
    with a seeded cotangent, against kernels A/C/D causal over the whole
    T in one call; then the full chunk's kernels alone (non-causal
    T = S = 2,048 with lse, and with an lse cotangent), with bounds and
    SDPA's times."""
    import torch.nn.functional as F

    from metamorph_tpu_torch.ops import flash_attention as fa
    from metamorph_tpu_torch.parallel import ring_attention as R

    (H, KV, Dh), n, C = RING_HEADS, RING_N, RING_CHUNK
    B = 1
    T = n * C
    scale = Dh ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(1414)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, do = (randn(B, H, T, Dh), randn(B, KV, T, Dh),
                   randn(B, KV, T, Dh), randn(B, H, T, Dh))
    # the reference: one causal call over the whole sequence
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))

    def whole():
        o, _ = fa.flash_attention_with_lse(qr, kr, vr, causal=True)
        return (o.detach(), *torch.autograd.grad(o, (qr, kr, vr), do))

    o_ref, dq_ref, dk_ref, dv_ref = whole()
    whole_ms = cuda_ms(whole, calls=3, reps=3)

    # the ring: every position in turn, each chunk's gradients summed in
    # fp32 across positions as its owner sums them
    ks = [k[:, :, j * C:(j + 1) * C].float().requires_grad_()
          for j in range(n)]
    vs = [v[:, :, j * C:(j + 1) * C].float().requires_grad_()
          for j in range(n)]
    forms = []
    real = (fa._launch, fa._launch_dq, fa._launch_dkv)

    def recorded(i, fn):
        def wrapped(*a):
            forms.append((i, bool(a[-2])))   # (kernel, causal)
            return fn(*a)
        return wrapped

    fa._launch, fa._launch_dq, fa._launch_dkv = (
        recorded(i, f) for i, f in enumerate(real))
    # the ring times and checks on the card; the chunk timings below take
    # the kernels unwrapped
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV)
    for kern in kernels:
        kern.launches = 0
    outs, dqs, pos_ms = [], [], []
    try:
        for idx in range(n):
            sl = slice(idx * C, (idx + 1) * C)
            qi = q[:, :, sl].clone().requires_grad_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            o, _ = R._ring_body(qi, idx, n, R.chunks_source(
                ks, vs, idx, torch.bfloat16))
            o = o.to(torch.bfloat16)
            o.backward(do[:, :, sl])
            b.record()
            b.synchronize()
            pos_ms.append(a.elapsed_time(b))
            outs.append(o.detach())
            dqs.append(qi.grad)
    finally:
        fa._launch, fa._launch_dq, fa._launch_dkv = real
    launches = {kern.symbol: kern.launches for kern in kernels}

    # the last position (1 diagonal + 7 full chunks) again, profiled: where
    # its time goes (fresh chunks, so the checked gradients stay)
    def last_position():
        kf = [x.detach().clone().requires_grad_() for x in ks]
        vf = [x.detach().clone().requires_grad_() for x in vs]
        qi = q[:, :, (n - 1) * C:].clone().requires_grad_()
        o, _ = R._ring_body(qi, n - 1, n, R.chunks_source(
            kf, vf, n - 1, torch.bfloat16))
        o.to(torch.bfloat16).backward(do[:, :, (n - 1) * C:])

    table, kernel_ms, busy_ms, wall_ms = profiled_spans(torch, last_position)
    flash_ms = sum(r["ms"] for r in table if "flash" in r["name"])
    last = dict(wall_ms=wall_ms, kernel_ms=kernel_ms, busy_ms=busy_ms,
                flash_kernel_ms=flash_ms, launches=sum(r["calls"]
                                                       for r in table),
                top=[dict(name=r["name"][:60], calls=r["calls"], ms=r["ms"])
                     for r in table[:6]])
    err = dict(o=row_rel_err(torch, torch.cat(outs, 2), o_ref),
               dq=row_rel_err(torch, torch.cat(dqs, 2), dq_ref),
               dk=row_rel_err(torch, torch.cat([x.grad for x in ks], 2),
                              dk_ref),
               dv=row_rel_err(torch, torch.cat([x.grad for x in vs], 2),
                              dv_ref))
    expected = n + n * (n - 1) // 2         # diagonals + full chunks
    by_form = {name: {"causal": sum(1 for i, c in forms if i == j and c),
                      "non_causal": sum(1 for i, c in forms
                                        if i == j and not c)}
               for j, name in enumerate(("A", "C", "D"))}

    # the full chunk's kernels alone: non-causal T = S = C with lse (A)
    # and with an lse cotangent (C, D)
    qc, kc, vc, doc = q[:, :, :C], k[:, :, :C], v[:, :, :C], do[:, :, :C]
    lengths = torch.full((B,), C, dtype=torch.int32, device=dev)
    oc, lsec = fa._fwd(qc, kc, vc, lengths, False, scale)
    dlse = torch.randn((B, H, C), generator=gen, device=dev)
    delta = (doc.float() * oc.float()).sum(-1)
    dd = (delta - dlse).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (qc, kc, vc))
    pairs = C * C
    io = 2 * (2 * B * C * H * Dh + 2 * B * C * KV * Dh)
    b_a = bound(io + 4 * B * H * C, 4 * Dh * H * pairs)
    b_dq = bound(io + 8 * B * H * C + 2 * B * C * H * Dh, 6 * Dh * H * pairs)
    b_dkv = bound(io + 8 * B * H * C + 4 * B * C * KV * Dh,
                  8 * Dh * H * pairs)
    ms_a = cuda_ms(lambda: fa._fwd(qc, kc, vc, lengths, False, scale))
    ms_dq = cuda_ms(lambda: fa._launch_dq(qc, kc, vc, doc, lsec, dd, dq,
                                          lengths, False, scale))
    ms_dkv = cuda_ms(lambda: fa._launch_dkv(qc, kc, vc, doc, lsec, dd, dk,
                                            dv, lengths, False, scale))
    plain_a = cuda_ms(lambda: fa.flash_attention_plain(qc, kc, vc, lengths,
                                                       False), calls=3,
                      reps=3)
    plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        qc, kc, vc, oc, lsec, doc, dlse, lengths, False, scale), calls=3,
        reps=3)
    lib_a = library_fwd_ms(F, fa, qc, kc, vc, lengths, False)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qc, kc, vc))
    lo = F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lo, (ql, kl, vl), doc, retain_graph=True), calls=3, reps=3)
    chunk = dict(
        B=B, T=C, S=C, causal=False, lse=True, dlse=True,
        A=dict(ms=ms_a, plain_ms=plain_a, library_ms=lib_a, **b_a,
               **rates(b_a, ms_a)),
        C=dict(ms=ms_dq, plain_ms=plain_bwd, library_ms=lib_bwd, **b_dq,
               **rates(b_dq, ms_dq)),
        D=dict(ms=ms_dkv, plain_ms=plain_bwd, library_ms=lib_bwd, **b_dkv,
               **rates(b_dkv, ms_dkv)),
        note="C and D's plain_ms is the plain backward (dq, dk, dv "
             "together); library_ms of C and D is SDPA's backward "
             "(dq, dk, dv together, no lse cotangent)")
    row = dict(B=B, T=T, chunks=n, chunk=C, H=H, KV=KV, Dh=Dh,
               rel_err=err, tol=RING_TOL, position_ms=pos_ms,
               ring_ms_sum=sum(pos_ms), whole_call_ms=whole_ms,
               last_position_profiled=last,
               launches=launches, launches_expected=expected,
               launches_by_form=by_form, full_chunk=chunk)
    log("ring 14b", json.dumps(row))
    if max(err.values()) > RING_TOL:
        raise AssertionError(f"ring 14b disagrees with one call: {err}")
    if any(c != expected for c in launches.values()) or any(
            f != {"causal": n, "non_causal": expected - n}
            for f in by_form.values()):
        raise AssertionError(f"ring 14b: launches {launches}, by form "
                             f"{by_form}; {expected} each expected "
                             f"({n} causal), none for a skipped chunk")
    del q, k, v, do, qr, kr, vr, o_ref, dq_ref, dk_ref, dv_ref, ks, vs
    del outs, dqs, ql, kl, vl, lo
    free_memory(torch)
    return row


def phase_vis_dp(torch, dev) -> dict:
    """14c: the visualizer's data-parallel step (`mesh=` a one-rank NCCL
    mesh) at 13b's width, batch 2, 2 adapter-only steps, against the
    one-card step from the same state and draws, with cuDNN's
    deterministic algorithms (its default backward algorithms may sum in
    another order each run, so two runs differ in low bits): losses and
    the adapter's checksums bitwise, else the losses within
    VIS_DP_LOSS_RTOL and the adapter within VIS_DP_ADAPTER_TOL of its
    update; the log says which."""
    from torch.distributed.device_mesh import DeviceMesh

    from metamorph_tpu_torch.visualizer import train as vt

    ucfg, vcfg, akw = vis_configs()
    tc = vt.VisualizerTrainConfig(adapter_mode=akw["mode"])
    mesh = DeviceMesh(dev.type, torch.arange(1), mesh_dim_names=("data",))
    g = torch.Generator(device=dev).manual_seed(15)
    emb = torch.randn(2, tc.num_tokens, 1152, generator=g, device=dev)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    img = torch.rand(2, VIS_TRAIN_RES, VIS_TRAIN_RES, 3, generator=g,
                     device=dev) * 2 - 1
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for name, m in (("one_card", None), ("dp", mesh)):
        step, init = vt.make_visualizer_train_step(tc, ucfg, vcfg, mesh=m)
        state = init(0, device=dev)
        losses, times = [], []
        for i in range(2):
            gen = torch.Generator(device=dev).manual_seed(i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = step(state, emb, img, gen)
            losses.append(float(loss))
            times.append(time.perf_counter() - t)
        runs[name] = dict(
            losses=losses, step_s=times,
            sums={n: tensor_checksum(torch, p)
                  for n, p in state["adapter"].named_parameters()},
            adapter={n: p.detach().cpu()
                     for n, p in state["adapter"].named_parameters()})
        del state
        free_memory(torch)
    torch.backends.cudnn.deterministic = deterministic
    a, b = runs["one_card"], runs["dp"]
    equal = a["losses"] == b["losses"] and a["sums"] == b["sums"]
    worst = max((b["adapter"][n] - t).abs().max().item()
                for n, t in a["adapter"].items())
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                      a["losses"]))
    held = ("bitwise: losses and the adapter's checksums" if equal else
            f"losses within {VIS_DP_LOSS_RTOL}, adapter within "
            f"{VIS_DP_ADAPTER_TOL}")
    row = dict(batch=2, steps=2, held=held, equal_bitwise=equal,
               max_loss_rel_err=loss_err, max_adapter_abs_err=worst,
               **{k: {"losses": r["losses"], "step_s": r["step_s"]}
                  for k, r in runs.items()})
    log("visualizer dp 14c", json.dumps(row))
    if not equal and not (loss_err <= VIS_DP_LOSS_RTOL
                          and worst <= VIS_DP_ADAPTER_TOL):
        raise AssertionError(f"visualizer dp 14c differs from one card: "
                             f"{row}")
    return row


def phase_sharded_trainer(torch, dev) -> dict:
    """14d: `train()` under the process group (the sharded path) at
    2 layers of the 8B config's width, T = 1024: 2 steps unbroken, and
    1 step, a save and a resume to 2; the same final weights and moments,
    bit for bit."""
    import dataclasses
    import signal

    import numpy as np

    from metamorph_tpu_torch.train.profile_train import (packed_row,
                                                         stage2_one_card)
    from metamorph_tpu_torch.train.trainer import TrainerArgs, train

    cfg, _ = stage2_one_card(1024)
    cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, num_layers=2))
    T, K, N = 1024, cfg.mm.num_image_tokens, cfg.train.max_images_per_batch
    packed = packed_row(T, K, N, seed=41)
    s = cfg.siglip.image_size

    class Data:
        def __init__(self):
            self.state = {"step_in_epoch": 0}

        def state_dict(self):
            return dict(self.state)

        def load_state_dict(self, st):
            self.state = dict(st)

        def __iter__(self):
            while True:
                rng = np.random.default_rng(self.state["step_in_epoch"])
                self.state["step_in_epoch"] += 1
                yield packed, rng.normal(size=(N, s, s, 3)).astype(
                    np.float32)

    def run(d, total, save_steps):
        c = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, total_steps=total))
        t = time.perf_counter()
        out = train(c, TrainerArgs(output_dir=d, save_steps=save_steps,
                                   save_total_limit=1), Data(), device=dev)
        sums = {n: tensor_checksum(torch, p.to_local())
                for n, p in out["state"]["params"].named_parameters()}
        mu = {n: tensor_checksum(torch, m)
              for n, m in out["state"]["opt_state"]["mu"].items()}
        reset_parallel_context()
        del out["state"]
        free_memory(torch)
        return sums, mu, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as d:
        whole = run(os.path.join(d, "whole"), 2, 0)
        run(os.path.join(d, "resumed"), 1, 1)
        listing = sorted(os.listdir(os.path.join(d, "resumed")))
        ckpt_gib = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _, fs in os.walk(os.path.join(d, "resumed"))
            for f in fs) / GIB
        resumed = run(os.path.join(d, "resumed"), 2, 0)
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        signal.signal(sig, signal.SIG_DFL)
    equal = whole[0] == resumed[0] and whole[1] == resumed[1]
    row = dict(layers=2, T=T, equal_bitwise=equal, listing=listing,
               checkpoint_gib=ckpt_gib, whole_s=whole[2],
               resumed_s=resumed[2])
    log("sharded trainer 14d", json.dumps(row))
    if not equal or listing != ["metrics.jsonl", "step_1"]:
        raise AssertionError(f"sharded trainer 14d: {row}")
    return row


def phase_multi_gpu(torch, dev, train_row, smi: str) -> dict:
    """Phase 14 on the one card: a one-rank NCCL group, then 14a-14d; the
    group is destroyed at the end whatever happens."""
    t = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        one_rank_group(torch, dev, d)
        rows = {"14a": phase_sharded_train(torch, dev, train_row),
                "14b": phase_ring(torch, dev),
                "14c": phase_vis_dp(torch, dev),
                "14d": phase_sharded_trainer(torch, dev)}
    finally:
        reset_parallel_context()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)
    rows["smi"] = smi
    rows["phase_s"] = time.perf_counter() - t
    log(f"multi-GPU phase 14: {rows['phase_s']:.1f}s ({smi})")
    return rows


def kernel_summary(kernel_rows, bwd_rows, opt_rows, drafter_rows, main_row,
                   options_rows, decode_row, train_row, recipe_row,
                   weights_row, w8_rows, p11_launches, vis_launches,
                   offload_launches, multi_row) -> dict:
    """The summary line: one entry per kernel, its launches on the main
    paths (summed, and by path), its worst error, and its time, plain time,
    bound and library time at the main-path shape (kernels B and E also at
    the 1B drafter's head dim 64, under "forms"; kernel F at its decode
    shapes and one prefill shape)."""
    fl = kernel_rows["flash"][0]       # the main path's 2048-bucket shape
    de = kernel_rows["decode"][0]
    bw = bwd_rows[0]                   # causal T=4096, the train main path
    d8 = opt_rows["decode_int8"][0]    # 8 full 4096-token rows
    fe = next(r for r in opt_rows["chunk"]       # fill, offset 3840
              if (r["form"], r["dtype"]) == ("fill", "bf16"))
    ve = next(r for r in opt_rows["chunk"]       # verify, 8 rows
              if (r["form"], r["dtype"]) == ("verify", "bf16"))
    tl = train_row["launches"]
    rl = recipe_row["launches"]
    wl = weights_row["launches_total"]
    ol = {k: r["launches"] for k, r in options_rows.items()}
    dl = decode_row["launches"]

    ring = multi_row["14b"]

    def by_path(symbol, serve=0, decode=0, options=0, p11=0, vis=0):
        paths = {"serve": serve, "serve_options": options,
                 "decode_frontends": decode, "int8_prefix_eval": p11,
                 "visualizer": vis,
                 "train_main": tl.get(symbol, 0),
                 "sharded_train": multi_row["14a"]["launches"].get(symbol, 0),
                 "ring": ring["launches"].get(symbol, 0),
                 "offload": offload_launches.get(symbol, 0),
                 "recipe_data_path": rl.get(symbol, 0),
                 "weights": wl.get(symbol, 0)}
        return {"launches": sum(paths.values()),
                "launches_by_path": {k: v for k, v in paths.items() if v}}

    def timing(r, ms="ms", b=None):
        b = b or r
        out = {"ms": r[ms], "plain_ms": r["plain_ms"],
               "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
               "bound_share": b["bound_ms"] / r[ms],
               "library_ms": r["library_ms"]}
        if f"{ms}_alone" in r:       # one call alone too (not kernel E int8)
            out.update(ms_alone=r[f"{ms}_alone"],
                       library_ms_alone=r.get("library_ms_alone"))
        if "ms_queued" in r:         # kernels B and E: ms is device time
            out.update(ms_queued=r["ms_queued"],
                       library_ms_queued=r.get("library_ms_queued"),
                       ms_method=r["ms_method"])
        return out

    summary = {"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "metamorph_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "metamorph_tpu/ops/flash_attention.py:228, "
                     "metamorph_tpu/ops/flash_attention.py:287",
         **by_path("mm_flash_fwd_bf16", main_row["launches"]["flash_fwd"],
                   dl["flash_fwd"],
                   sum(ol[k]["mm_flash_fwd_bf16"]["total"] for k in ol),
                   p11_launches["flash_fwd"], vis_launches["flash_fwd"]),
         "max_abs_err": max(r["max_abs_err"] for r in kernel_rows["flash"]),
         **timing(fl),
         "forms": {**{f"causal_T{r['T']}": timing(r)
                      for r in kernel_rows["flash"][:2]},
                   "ring_full_chunk_T2048_noncausal_lse": timing(
                       ring["full_chunk"]["A"])}},
        {"name": "decode_attn", "route": "cuda",
         "source": "metamorph_tpu_torch/csrc/decode_attn.cu",
         "replaces": "metamorph_tpu/ops/decode_attention.py:191",
         **by_path("mm_decode_attn_bf16", main_row["launches"]["decode_attn"],
                   dl["decode_attn"],
                   ol["bf16"]["mm_decode_attn_bf16"]["total"],
                   p11_launches["decode_attn"], vis_launches["decode_attn"]),
         "max_abs_err": max(r["max_abs_err"] for r in kernel_rows["decode"]
                            + drafter_rows["decode"]),
         **timing(de),
         "forms": {"dh64_drafter": timing(drafter_rows["decode"][0])}},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "metamorph_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "metamorph_tpu/ops/flash_attention.py:499, "
                     "metamorph_tpu/ops/flash_attention.py:698",
         **by_path("mm_flash_bwd_dq_bf16"),
         "max_abs_err": max(r["max_abs_err"]["dq"] for r in bwd_rows),
         **timing(bw, "ms_dq", bw["bound_dq"]),
         "forms": {"ring_full_chunk_T2048_noncausal_dlse": timing(
             ring["full_chunk"]["C"])}},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "metamorph_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "metamorph_tpu/ops/flash_attention.py:529, "
                     "metamorph_tpu/ops/flash_attention.py:724",
         **by_path("mm_flash_bwd_dkv_bf16"),
         "max_abs_err": max(max(r["max_abs_err"]["dk"],
                                r["max_abs_err"]["dv"]) for r in bwd_rows),
         **timing(bw, "ms_dkv", bw["bound_dkv"]),
         "forms": {**{f"causal_T{r['T']}": timing(r, "ms_dkv",
                                                  r["bound_dkv"])
                      for r in bwd_rows[:2]},
                   "ring_full_chunk_T2048_noncausal_dlse": timing(
                       ring["full_chunk"]["D"])}},
        {"name": "decode_attn_int8", "route": "cuda",
         "source": "metamorph_tpu_torch/csrc/decode_attn.cu",
         "replaces": "metamorph_tpu/ops/decode_attention.py:191 "
                     "(int8 branch)",
         **by_path("mm_decode_attn_int8",
                   decode=dl["decode_attn_int8"],
                   options=ol["int8"]["mm_decode_attn_int8"]["total"],
                   p11=p11_launches["decode_attn_int8"]),
         "max_abs_err": max(r["max_abs_err"]
                            for r in opt_rows["decode_int8"]),
         **timing(d8)},
    ]}
    # kernel E: one C entry point per cache type; the wrapper counts the
    # verify form (chunk_attn.cu's kernel, G * C <= 16 packed rows) apart
    # from the fill form (chunk_fill.cu's kernel)
    for name, src, line, form, r in (
            ("chunk_attn", "chunk_attn.cu", 438, "verify", ve),
            ("chunk_fill", "chunk_fill.cu", 317, "fill", fe)):
        dh64 = drafter_rows.get(form, [])
        forms = {f"{x['dtype']}_off{x['offs'][0]}": timing(x)
                 for x in opt_rows["chunk"] if x["form"] == form}
        forms.update({"dh64_drafter": timing(x) for x in dh64})
        summary["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"metamorph_tpu_torch/csrc/{src}",
            "replaces": f"metamorph_tpu/ops/decode_attention.py:{line}",
            **by_path(f"mm_chunk_attn_{form}", decode=dl[f"chunk_{form}"],
                      options=sum(ol[k][f"mm_chunk_attn_{k}"]["forms"].get(
                          form, 0) for k in ("bf16", "int8")),
                      p11=p11_launches[f"chunk_{form}"]),
            "max_abs_err": max(x["max_abs_err"] for x in opt_rows["chunk"]
                               + dh64 if x.get("form") == form),
            **timing(r), "forms": forms})
    # kernel F: the main-path shape is the decode step's gate / up product
    # (M = 8 rows, K = 4096, N = 14336); library_ms is
    # torch._weight_int8pack_mm where PyTorch has a CUDA kernel for it (bf16
    # scales), else null; the bf16 matmul is a yardstick of another function
    f8 = next(r for r in w8_rows if (r["M"], r["K"], r["N"]) == (8, 4096,
                                                                 14336))

    def w8_timing(r):
        return {k: r[k] for k in ("form", "ms", "ms_method", "plain_ms",
                                  "bound_ms", "bound_by", "bound_share",
                                  "library_ms", "bf16_matmul_ms")}

    summary["kernels"].append({
        "name": "w8_matmul", "route": "cuda",
        "source": "metamorph_tpu_torch/csrc/w8_matmul.cu",
        "replaces": "metamorph_tpu/ops/quant.py:44 (quantized_matmul: no "
                    "Pallas site, XLA:TPU's fused int8 convert + dot)",
        **by_path("mm_w8_matmul", p11=p11_launches["w8_matmul"]),
        "max_abs_err": max(r["max_abs_err"] for r in w8_rows),
        "max_rel_err": max(r["rel_err"] for r in w8_rows),
        **w8_timing(f8),
        "library_note": f8["library_note"],
        "bf16_matmul_note": f8["bf16_matmul_note"],
        "forms": {f"M{r['M']}_K{r['K']}_N{r['N']}": w8_timing(r)
                  for r in w8_rows}})
    return summary


def check_no_spills(ptxas_log: str) -> None:
    """Kernels A, C, D, E's fill form and both forms of F keep their
    accumulators in registers: each of their entries in nvcc's `-Xptxas -v`
    output must spill nothing, and F's wgmma chains get no warpgroup wait
    injected by the compiler (C7517-C7520).
    (An empty log means this process reused an earlier build and has
    nothing to read.)"""
    spills, entry = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry is not None:
            spills[entry] = line.strip()
    if not ptxas_log:
        log("build: reused an earlier library; spills not read")
        return
    hot = {e: v for e, v in spills.items()
           if any(k in e for k in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                   "flash_bwd_dkv_kernel",
                                   "chunk_fill_kernel", "w8_gemv_kernel",
                                   "w8_tiled_kernel"))}
    bad = {e: v for e, v in hot.items()
           if "0 bytes spill stores, 0 bytes spill loads" not in v}
    if len(hot) < 15 or bad:
        raise AssertionError(f"kernels A/C/D/E-fill/F spill or were not "
                             f"found in the ptxas output: {bad or hot}")
    waits = [ln.strip() for ln in ptxas_log.splitlines()
             if "w8_" in ln and any(c in ln for c in ("C7517", "C7518",
                                                      "C7519", "C7520"))]
    if waits:
        raise AssertionError(f"kernel F: warpgroup waits injected: {waits}")
    log(f"build: kernels A, C, D, E's fill form and F, {len(hot)} entries, "
        f"no spills; no warpgroup wait injected in F")


def free_memory(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    if not os.path.isdir(os.path.join(ROOT, "metamorph_tpu_torch")):
        log("chip_smoke: metamorph_tpu_torch/ not found next to the script; "
            "run it from a checkout of the repository")
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from metamorph_tpu_torch.kernels._build import LIBRARY

    LIBRARY.build(verbose=True)
    log(f"build: nvcc {LIBRARY.build_seconds:.1f}s")
    for line in LIBRARY.ptxas_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "arning")):
            log("  ptxas:", line.strip())
    check_no_spills(LIBRARY.ptxas_log)

    kernel_rows = phase_kernels(torch, dev)
    bwd_rows = phase_bwd_kernels(torch, dev)
    free_memory(torch)
    opt_rows = phase_option_kernels(torch, dev)
    free_memory(torch)
    drafter_rows = phase_drafter_kernels(torch, dev)
    free_memory(torch)
    w8_rows = phase_w8_kernels(torch, dev)
    free_memory(torch)
    phase_reference(torch, dev)
    phase_reference_options(torch, dev)
    phase_train_reference(torch, dev)
    main_row, served = phase_main(torch, dev)
    options_rows = phase_serve_options(torch, dev, *served)
    decode_row = phase_decode_frontends(torch, dev, *served)
    int8_row = phase_int8_weights(torch, dev, *served, main_row)
    prefix_row = phase_prefix(torch, dev, *served[:3])
    tasks_bf16 = phase_eval_tasks(torch, dev, *served[:2], "bf16")
    vis_row = phase_visualizer(torch, dev, *served[:3], smi)
    free_memory(torch)
    model, cfg5, reqs, plain_run = served
    del served
    # phase 9's files (~20 GB): in the temp dir, deleted whatever happens
    weights_dir = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    try:
        sums = phase_weights_export(torch, dev, weights_dir, model, cfg5)
        del model
        free_memory(torch)
        train_row = phase_train_main(torch, dev)
        free_memory(torch)
        weights_row = phase_weights(torch, dev, weights_dir, sums, cfg5,
                                    reqs, plain_run, train_row)
    finally:
        shutil.rmtree(weights_dir, ignore_errors=True)
    if os.path.exists(weights_dir):
        raise AssertionError(f"could not delete {weights_dir}")
    del reqs, plain_run
    free_memory(torch)
    offload_row = phase_offload(torch, dev, train_row)
    phase_vis_train_check(torch, dev)
    vis_train_row = phase_vis_train(torch, dev, smi)
    phase_vis_cli(torch, dev, min(
        vis_train_row["adapter_only"]["batch_size"], VIS_CLI_BATCH))
    phase_trainer(torch, dev)
    recipe_row = phase_recipe_main(torch, dev, train_row)
    phase_recipe_small(torch, dev)
    free_memory(torch)
    multi_row = phase_multi_gpu(torch, dev, train_row, smi)
    free_memory(torch)
    mla_row = phase_mla_moe(torch, dev)

    p11 = {k: int8_row["launches"][k] + prefix_row["launches"][k]
           + tasks_bf16["launches"][k] for k in int8_row["launches"]}
    p11["flash_fwd"] += recipe_row["evaluate"]["launches"]["flash_fwd"]
    for k in ("w8_matmul", "flash_fwd", "chunk_fill", "chunk_verify"):
        if p11[k] <= 0:
            raise AssertionError(f"phase 11 never launched {k}: {p11}")
    log("int8, prefix and eval: launches", json.dumps(p11))
    summary = kernel_summary(kernel_rows, bwd_rows, opt_rows, drafter_rows,
                             main_row, options_rows, decode_row, train_row,
                             recipe_row, weights_row, w8_rows, p11,
                             vis_row["decode"]["launches"],
                             offload_row["launches"], multi_row)
    summary["kernels"].extend(mla_moe_kernels(mla_row))
    log(f"chip_smoke: wall {time.perf_counter() - t_start:.1f}s")
    log(smi)
    log(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
