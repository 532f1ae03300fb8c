"""PyTorch port, kernel H's host side on the CPU (`ops/adamw.py`,
`train/optimizer.py`): the table that replaces the walk over `_chunks`
(entries, work-block offsets, dtype runs, per-group lr and norm group),
the norm groups against `AdamW.global_norm`, the update's fp32 scalars,
and the rule that CPU tensors take the plain chain (no launch, the span's
counts saying so). The kernel itself runs only on the card:
tests/test_torch_cuda.py holds it bitwise to the plain chain."""

import numpy as np
import pytest
import torch
from torch import nn

from metamorph_tpu_torch.config import TrainConfig
from metamorph_tpu_torch.ops import adamw as ak
from metamorph_tpu_torch.train import optimizer as opt_lib

SHAPES = {"projector.w": (70000,), "llama.a": (64, 130), "llama.empty": (0,),
          "llama.b": (8192,), "siglip.c": (8193,), "vision_head.d": (3,)}


def _model(dtypes=None):
    gen = torch.Generator().manual_seed(0)
    model = nn.Module()
    for n, shape in SHAPES.items():
        parent, leaf = n.split(".")
        if not hasattr(model, parent):
            setattr(model, parent, nn.Module())
        dtype = (dtypes or {}).get(n, torch.float32)
        p = nn.Parameter(torch.randn(shape, generator=gen).to(dtype))
        setattr(getattr(model, parent), leaf, p)
        p.grad = torch.randn(shape, generator=gen).to(dtype)
    return model


def _tx(model, **kw):
    cfg = TrainConfig(vision_tower_lr=2e-4, mm_projector_lr=3e-4,
                      warmup_ratio=0.1, total_steps=100, **kw)
    return opt_lib.AdamW(cfg, model)


@pytest.mark.parametrize("offload", [False, True])
def test_table_matches_the_chunk_walk(monkeypatch, offload):
    """The table over a model's trainable parameters against the walk over
    `_chunks` that the plain update makes (CHUNK cut to 2**14, so the
    larger tensors cut into several chunks): each entry starts where the
    tensor's first chunk starts and covers its chunks' elements, its lr
    is the fp32 of the chunks' lr, its work blocks follow the previous
    entry's; the empty tensor is left out; the norm groups are the
    `norm_groups` in first-seen order; bf16 entries form a second run."""
    monkeypatch.setattr(opt_lib, "CHUNK", 1 << 14)
    model = _model({"llama.b": torch.bfloat16})
    tx = _tx(model, offload_optimizer=offload)
    state = tx.init(model)
    state["count"] = 20
    g1, g2 = object(), object()
    tx.norm_groups = {"llama.a": g1, "llama.b": g2, "siglip.c": g1}
    items, groups = tx.table_items(tx.trainable(model), state)
    assert groups == [None, g1, g2]
    table = ak.build_table(items, len(groups))

    walk = {}
    for name, p in tx.trainable(model):
        lr = tx.schedules[tx.labels[name]](20)
        chunks = list(zip(opt_lib._chunks(p), opt_lib._chunks(p.grad)))
        walk[p.data_ptr()] = (name, lr, chunks)
    names = [walk[int(e["p"])][0] for e in table.entries]
    assert names == ["projector.w", "llama.a", "siglip.c", "vision_head.d",
                     "llama.b"]
    assert table.runs == [(0, 0, 4, 0, 14), (7, 4, 5, 14, 15)]
    blk = 0
    for e, (p, g, mu, nu) in zip(table.entries, table.tensors):
        name, lr, chunks = walk[int(e["p"])]
        assert int(e["g"]) == chunks[0][1].data_ptr() == g.data_ptr()
        assert int(e["numel"]) == sum(c.numel() for c, _ in chunks)
        assert e["lr"] == np.float32(lr) and lr > 0
        assert int(e["group"]) == groups.index(tx.norm_groups.get(name))
        assert int(e["blk"]) == blk
        assert int(e["g_bf16"]) == (g.dtype == torch.bfloat16)
        blk += -(-int(e["numel"]) // ak.BLOCK)
        if offload:
            assert e["mu"] == e["nu"] == 0 and mu is None
        else:
            assert int(e["mu"]) == state["mu"][name].data_ptr()
            assert int(e["nu"]) == state["nu"][name].data_ptr()
    assert table.n_blocks == blk == 15
    assert table.elements == sum(p.numel() for p in model.parameters())
    assert len(set(tx.labels[walk[int(e["p"])][0]] for e in table.entries
                   )) == 3


def test_table_refuses_what_the_kernel_does_not_take():
    p = torch.zeros(10)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ak.build_table([(p.half(), p, p, p, 1.0, 0)], 1)
    with pytest.raises(ValueError, match="contiguous"):
        ak.build_table([(p, torch.zeros(10, 2)[:, 0], p, p, 1.0, 0)], 1)
    with pytest.raises(ValueError, match="elements"):
        ak.build_table([(p, p, torch.zeros(9), p, 1.0, 0)], 1)
    with pytest.raises(ValueError, match="differ in dtype"):
        ak.build_table([(p, p, p, p.bfloat16(), 1.0, 0)], 1)
    with pytest.raises(ValueError, match="norm group"):
        ak.build_table([(p, p, p, p, 1.0, 1)], 1)


def test_table_groups_partition_the_gradients():
    """The norm groups of a table, as kernel H's reduction sums them (the
    blocks of each entry whose group is k): every gradient in exactly one
    group, the one its item names; each group's work blocks are its
    entries' own, contiguous per entry and disjoint across the table; each
    group's fp64 sum of squares is the sum over its items, and the sqrt
    of the groups' total is the plain `global_norm` to fp32
    summation-order error."""
    model = _model({"llama.b": torch.bfloat16})
    tx = _tx(model)
    state = tx.init(model)
    want = tx.global_norm(model)
    items, _ = tx.table_items(tx.trainable(model), state)
    regroup = [(*it[:5], i % 3) for i, it in enumerate(items)]
    table = ak.build_table(regroup, 3)
    by_ptr = {it[1].data_ptr(): i % 3 for i, it in enumerate(items)
              if it[1].numel()}
    assert sorted(int(e["g"]) for e in table.entries) == sorted(by_ptr)
    covered = np.zeros(table.n_blocks, dtype=int)
    sums = [0.0] * 3
    for e, (_, g, _, _) in zip(table.entries, table.tensors):
        k = int(e["group"])
        assert k == by_ptr[g.data_ptr()]
        n_blk = -(-g.numel() // ak.BLOCK)
        covered[int(e["blk"]):int(e["blk"]) + n_blk] += 1
        sums[k] += g.double().square().sum().item()
    assert (covered == 1).all()
    for k in range(3):
        ref = sum(it[1].double().square().sum().item()
                  for i, it in enumerate(items) if i % 3 == k)
        assert sums[k] == pytest.approx(ref, rel=1e-12) and ref > 0
    assert abs(sum(sums) ** 0.5 - want.item()) <= 1e-6 * want.item()


def test_scalars_are_the_fp32_values_pytorch_uses():
    """A host scalar operand enters PyTorch's CUDA kernels cast to fp32,
    and a division by one as a product with its fp64 reciprocal cast to
    fp32: the scalars hold exactly those values (at count 0 with b2 0.999
    that is 1000.0, where 1 / fp32(bc2) would be 999.99994)."""
    f = np.float32
    sc = ak.scalars(7, 0.9, 0.95, 1e-8, 0.1, 1.0)
    assert sc.c1 == f(1 - 0.9) and sc.b1 == f(0.9)
    assert sc.c2 == f(1 - 0.95) and sc.b2 == f(0.95)
    assert sc.inv_bc1 == f(1 / (1 - 0.9 ** 8))
    assert sc.inv_bc2 == f(1 / (1 - 0.95 ** 8))
    assert ak.scalars(0, 0.9, 0.999, 1e-8, 0.0, None).inv_bc2 == 1000.0
    assert sc.eps == f(1e-8) and sc.wd == f(0.1) and sc.max_norm == f(1.0)
    assert (sc.has_wd, sc.clip) == (1, 1)
    plain = ak.scalars(0, 0.9, 0.999, 1e-8, 0.0, None)
    assert (plain.has_wd, plain.clip, plain.max_norm) == (0, 0, 0.0)
    assert ak.dtype_code(torch.zeros(1, dtype=torch.bfloat16),
                         torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16)
                         ) == 5


@pytest.mark.parametrize("offload", [False, True])
def test_cpu_tensors_take_the_plain_chain(monkeypatch, offload):
    """AdamW and PlainAdamW on CPU tensors: every chunk through
    `adamw_chunk_`, no launch of kernel H, and `AdamW.counts` (the
    `train.optimizer` span's attrs) naming the plain chain alone."""
    calls = []
    real = opt_lib.adamw_chunk_

    def counted(p, *a):
        calls.append(p.numel())
        return real(p, *a)

    monkeypatch.setattr(opt_lib, "adamw_chunk_", counted)
    n0 = ak.launches()
    model = _model()
    tx = _tx(model, offload_optimizer=offload)
    state = tx.init(model)
    tx.update(model, state)
    total = sum(p.numel() for p in model.parameters())
    assert tx.counts == dict(kernel_h_elements=0, plain_elements=total,
                             kernel_h_launches=0)
    assert sum(calls) == total
    calls.clear()
    ptx = opt_lib.PlainAdamW(lambda c: 1e-3)
    ptx.update(model, ptx.init(model))
    assert sum(calls) == total and ak.launches() == n0
