"""PyTorch port, the span recorder (`utils/trace.py`) and the spans in
the serve engine and the train step, on the CPU with tiny fp32 models:
tracing off records nothing and changes no output bit; tracing on nests
each phase under its tick or step, and carries the admissions' shapes
(their positions and real tokens equal to hand sums) and the requests'
uids; the buffer's cap drops and counts."""

import sys
import threading

import numpy as np
import pytest
import torch

from metamorph_tpu_torch.config import (LlamaConfig, MetaMorphConfig,
                                        MultimodalConfig, SiglipConfig,
                                        TrainConfig)
from metamorph_tpu_torch.constants import (IGNORE_INDEX, IM_START_TOKEN_ID,
                                           IMAGE_TOKEN_INDEX)
from metamorph_tpu_torch.convert import init_params
from metamorph_tpu_torch.inference.serve import Request, ServeEngine
from metamorph_tpu_torch.multimodal.packing import (batch_to_arrays,
                                                    pack_sequences)
from metamorph_tpu_torch.train import optimizer as opt_lib
from metamorph_tpu_torch.train import train_step as TS
from metamorph_tpu_torch.utils import trace

K = 4
CFG = MetaMorphConfig(
    llama=LlamaConfig.tiny(), siglip=SiglipConfig.tiny(),
    mm=MultimodalConfig(num_image_tokens=K),
    train=TrainConfig(max_seq_len=24, batch_size=4, max_images_per_batch=4,
                      remat=False, learning_rate=1e-3, grad_accum_steps=2,
                      total_steps=20))
ENGINE = dict(n_slots=4, max_cache_len=128, max_new_tokens_cap=8,
              max_images=1, prefill_buckets=(16, 32, 64), steps_per_sync=4)
LENS = (5, 9, 14, 20, 30, 40, 70)       # buckets 16, 16, 16, 32, 32, 64, 128
IMAGE_AT = 3


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def model():
    return init_params(CFG, seed=0, device="cpu", dtype=torch.float32)


def _requests():
    rng = np.random.default_rng(3)
    D = CFG.llama.hidden_size
    out = []
    for i, n in enumerate(LENS):
        kw = {}
        if i == IMAGE_AT:
            kw = dict(image_embeds=rng.normal(size=(1, K, D)).astype(
                np.float32) * 0.02, image_positions=np.asarray([2]))
        out.append(Request(prompt_ids=rng.integers(10, 1000, n).astype(
            np.int32), max_new_tokens=3 + i % 4, uid=f"r{i}", **kw))
    return out


def _serve(model):
    eng = ServeEngine(model, CFG, seed=0, **ENGINE)
    for r in _requests():
        eng.submit(r)
    done = {c.uid: c for c in eng.run()}
    return eng, done


def _batch(seed, first, short):
    """Rows of a bos, a text token, <image_start>, an answer image,
    <image_end> and two text tokens; the first `short` rows lack the
    last."""
    ids, labs = [], []
    for b in range(4):
        n = 6 if b < short else 7
        ids.append([first, 2 + b, IM_START_TOKEN_ID, IMAGE_TOKEN_INDEX,
                    128257, 7, 8][:n])
        labs.append([IGNORE_INDEX, IGNORE_INDEX, IM_START_TOKEN_ID, 0,
                     128257, 7, 8][:n])
    arrays = batch_to_arrays(pack_sequences(ids, labs, K, 24, 4))
    pixels = np.random.default_rng(seed).normal(
        size=(4, 28, 28, 3)).astype(np.float32)
    return arrays, pixels


def _accum_steps(n_steps=2):
    """Two steps of two microbatches on a fresh model; returns the step
    metrics and the parameters after."""
    (a0, p0), (a1, p1) = _batch(0, 1, 1), _batch(1, 9, 3)
    stacked = {k: torch.from_numpy(np.stack([a0[k], a1[k]])) for k in a0}
    pixels = torch.from_numpy(np.stack([p0, p1]))
    model = init_params(CFG, seed=1, device="cpu", dtype=torch.float32)
    state = TS.init_train_state(model, CFG)
    tx = opt_lib.make_optimizer(CFG.train, model)
    metrics = []
    for _ in range(n_steps):
        state, m = TS.accum_train_step(state, stacked, pixels, CFG, tx)
        metrics.append({k: v.clone() for k, v in m.items()})
    return metrics, dict(model.named_parameters())


def _by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_off_is_one_shared_object_and_records_nothing(model):
    assert not trace.enabled()
    assert trace.span("a", x=1) is trace.span("b")
    with trace.span("a") as sp:
        sp.set(y=2)
    _serve(model)
    _accum_steps(1)
    assert trace.drain() == [] and trace.dropped() == 0


def test_serve_outputs_are_bitwise_the_same_traced(model):
    _, off = _serve(model)
    trace.enable()
    eng, on = _serve(model)
    trace.disable()
    assert trace.drain()
    assert sorted(off) == sorted(on) == sorted(f"r{i}"
                                                for i in range(len(LENS)))
    for uid in off:
        np.testing.assert_array_equal(off[uid].ids, on[uid].ids)
        np.testing.assert_array_equal(off[uid].image_embeds,
                                      on[uid].image_embeds)
    assert eng.tick_counts == _serve(model)[0].tick_counts


def test_serve_spans_nest_carry_uids_and_match_the_counters(model):
    """The admissions' positions and real tokens (the counts a reader of
    padding takes from `serve.admit`) against hand sums."""
    trace.enable()
    eng, done = _serve(model)
    spans = trace.drain()
    assert all(s["t1"] is not None and s["t1"] >= s["t0"] for s in spans)
    by_id = {s["id"]: s for s in spans}
    steps = _by_name(spans, "serve.step")
    assert steps
    step_ids = {s["id"] for s in steps}
    assert all(s["parent"] is None for s in steps)
    for name in ("serve.harvest", "serve.admit", "serve.decode",
                 "serve.snapshot"):
        got = _by_name(spans, name)
        assert got, name
        for s in got:
            assert s["parent"] in step_ids, name
            p = by_id[s["parent"]]
            assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
    for s in _by_name(spans, "serve.harvest.wait"):
        assert by_id[s["parent"]]["name"] == "serve.harvest"
    # one harvest and one snapshot a tick
    assert len(_by_name(spans, "serve.harvest")) == len(steps)
    assert len(_by_name(spans, "serve.snapshot")) == len(steps)
    decodes = _by_name(spans, "serve.decode")
    assert len(decodes) == eng.tick_counts["plain"]
    assert all(d["attrs"]["program"] == "plain"
               and d["attrs"]["graph"] is False    # a CPU engine
               and d["attrs"]["steps"] == 4
               and 1 <= d["attrs"]["rows"] <= 4 for d in decodes)

    # admissions: their shapes, and their positions and tokens as hand
    # sums
    reqs = _requests()
    admits = _by_name(spans, "serve.admit")
    assert len(admits) == eng.tick_counts["prefill"]
    lens = {r.uid: r.prompt_len for r in reqs}
    for a in admits:
        at = a["attrs"]
        assert at["rows"] == len(at["uids"]) == len(at["lens"])
        assert at["lens"] == [lens[u] for u in at["uids"]]
        assert all(n <= at["bucket"] for n in at["lens"])
        assert at["image"] == [u == f"r{IMAGE_AT}" for u in at["uids"]]
    assert sorted(u for a in admits for u in a["attrs"]["uids"]) \
        == sorted(lens)
    assert sum(a["attrs"]["bucket"] * a["attrs"]["rows"] for a in admits) \
        == 16 + 16 + 16 + 32 + 32 + 64 + 128
    assert sum(n for a in admits for n in a["attrs"]["lens"]) \
        == 5 + 9 + 14 + 20 + 30 + 40 + 70

    # each request's uid in its submit, admit and harvest spans, in order
    for uid in lens:
        sub = [s for s in _by_name(spans, "serve.submit")
               if s["attrs"]["uid"] == uid]
        adm = [s for s in admits if uid in s["attrs"]["uids"]]
        har = [s for s in _by_name(spans, "serve.harvest")
               if uid in s["attrs"]["uids"]]
        assert len(sub) == len(adm) == len(har) == 1, uid
        assert sub[0]["t1"] <= adm[0]["t0"] < har[0]["t0"]
    assert sorted(done) == sorted(lens)


def test_accum_train_step_is_bitwise_the_same_traced():
    m_off, p_off = _accum_steps()
    trace.enable()
    m_on, p_on = _accum_steps()
    trace.disable()
    assert trace.drain()
    for a, b in zip(m_off, m_on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for n in p_off:
        assert torch.equal(p_off[n], p_on[n]), n


def test_accum_train_step_spans():
    trace.enable()
    _accum_steps(n_steps=1)
    spans = trace.drain()
    names = [s["name"] for s in spans]
    assert names == ["train.forward", "train.backward", "train.forward",
                     "train.backward", "train.optimizer", "train.grad_norm"]
    fwd = _by_name(spans, "train.forward")
    bwd = _by_name(spans, "train.backward")
    assert [s["attrs"]["index"] for s in fwd] == [0, 1]
    assert [s["attrs"]["index"] for s in bwd] == [0, 1]
    assert all(s["attrs"] == {"index": s["attrs"]["index"]}
               for s in fwd + bwd)
    opt, gn = _by_name(spans, "train.optimizer")[0], \
        _by_name(spans, "train.grad_norm")[0]
    assert gn["parent"] == opt["id"] and opt["parent"] is None
    assert opt["t0"] <= gn["t0"] <= gn["t1"] <= opt["t1"]
    assert all(a["t1"] <= b["t0"] for a, b in zip(spans[:4], spans[1:5]))


def test_cap_drops_and_counts_and_drain_clears(monkeypatch):
    monkeypatch.setattr(trace, "_CAP", 3)
    trace.enable()
    with trace.span("outer"):
        for i in range(5):
            with trace.span("inner", i=i):
                pass
    assert trace.dropped() == 3
    spans = trace.drain()
    assert [s["name"] for s in spans] == ["outer", "inner", "inner"]
    assert [s["attrs"]["i"] for s in spans[1:]] == [0, 1]
    assert all(s["parent"] == spans[0]["id"] for s in spans[1:])
    assert trace.drain() == [] and trace.dropped() == 0
    with trace.span("again", n=7) as sp:
        sp.set(found=[1, 2])
    again = trace.drain()
    assert [s["name"] for s in again] == ["again"]
    assert again[0]["attrs"] == {"n": 7, "found": [1, 2]}
    trace.disable()
    with trace.span("off"):
        pass
    assert trace.drain() == []


def test_threads_keep_their_own_parents():
    """More threads than cores, switching often: every span is kept once,
    with the parent its own thread opened around it."""
    n_threads, n_outer = 16, 200
    trace.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_outer):
                with trace.span("outer", k=k, i=i):
                    with trace.span("inner", k=k, i=i):
                        pass

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = trace.drain()
    assert len(spans) == 2 * n_threads * n_outer
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "inner":
            p = by_id[s["parent"]]
            assert p["name"] == "outer" and p["thread"] == s["thread"]
            assert p["attrs"] == s["attrs"]
        else:
            assert s["parent"] is None
