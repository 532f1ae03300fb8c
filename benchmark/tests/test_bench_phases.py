"""The phase readers (`benchmark/phases.py`) on hand-made records: a
traced serving slice and a traced training step with program spans,
idle gaps and launch records placed by hand on the host clock;
the launch-keeping trace on a hand-made profile; and the tiny cells on
the CPU with the program's tracer on, off, and left alone by a
`--trace 0` run."""

from types import SimpleNamespace

import pytest

from benchmark import phases
from benchmark.tests.tiny import tiny_ctx

MS = 1_000_000                          # ns


def _span(sid, name, t0, t1, parent=None, **attrs):
    return dict(id=sid, name=name, t0=t0 * MS, t1=t1 * MS, parent=parent,
                thread=1, attrs=attrs)


def serve_records():
    # before the slice (t < 0): one tick; the slice is [0, 100) ms with
    # one tick (0-80) and four gaps of 10 ms
    spans = [_span(6, "serve.step", -200, -100),
             _span(9, "serve.harvest", -200, -199, 6, uids=[]),
             _span(8, "serve.admit", -199, -179, 6, bucket=512, rows=2,
                   lens=[300, 100]),
             _span(7, "serve.decode", -179, -109, 6, program="plain",
                   steps=8, rows=3),
             _span(0, "serve.step", 0, 80),
             _span(1, "serve.harvest", 0, 15, 0, uids=[4]),
             _span(2, "serve.harvest.wait", 2, 12, 1),
             _span(3, "serve.admit", 15, 40, 0, bucket=64, rows=1,
                   lens=[1]),
             _span(4, "serve.decode", 40, 78, 0, program="plain", steps=8,
                   rows=4),
             _span(5, "serve.snapshot", 78, 80, 0)]
    trace = dict(t0=0, t1=100 * MS, events=[], busy=[],
                 gaps=[(0, 10 * MS), (20 * MS, 30 * MS), (50 * MS, 60 * MS),
                       (90 * MS, 100 * MS)])
    return dict(kind="serve", program_spans=spans, trace=trace,
                spans=[dict(name="tick", t0=80 * MS, t1=100 * MS)])


def train_records():
    # an untraced step (0-100 ms), then a traced one (100-200 ms)
    spans = []
    for k, base in enumerate((0, 100)):
        i = 10 * k
        spans += [_span(i, "train.forward", base, base + 20, index=0),
                  _span(i + 1, "train.backward", base + 20, base + 50,
                        index=0),
                  _span(i + 2, "train.optimizer", base + 50, base + 90),
                  _span(i + 3, "train.grad_norm", base + 50, base + 60,
                        i + 2)]
    trace = dict(t0=100 * MS, t1=200 * MS,
                 events=[("fwd_gemm", 101 * MS, 1 * MS),
                         ("adam_elementwise", 170 * MS, 5 * MS),
                         ("adam_elementwise", 185 * MS, 10 * MS)],
                 launches=[100 * MS + MS // 2, 155 * MS, 165 * MS],
                 busy=[], gaps=[(102 * MS, 120 * MS), (130 * MS, 150 * MS),
                                (152 * MS, 158 * MS), (195 * MS, 200 * MS)])
    steps = [dict(t0=0, t1=100 * MS, traced=False),
             dict(t0=100 * MS, t1=200 * MS, traced=True)]
    bench = [dict(name="accum_train_step", t0=0, t1=95 * MS),
             dict(name="accum_train_step", t0=100 * MS, t1=190 * MS),
             dict(name="wait for the card", t0=190 * MS, t1=200 * MS)]
    return dict(kind="train", program_spans=spans, trace=trace, steps=steps,
                spans=bench)


def test_serve_readers_by_hand():
    r = phases.read(serve_records())
    assert r["decode_host_ms"] == pytest.approx(70 / 8)
    assert r["admit_host_ms"] == pytest.approx(20)
    assert r["harvest_host_ms"] == pytest.approx(1)
    assert r["idle_in_decode_pct"] == pytest.approx(10)
    assert r["idle_in_admit_pct"] == pytest.approx(10)
    # the admission before the slice alone
    assert r["prefill_pad_pct"] == pytest.approx(100 * 624 / 1024)
    assert r["step_covered_pct"] == pytest.approx(91)
    split = phases.idle_by_phase(serve_records())
    assert split == {
        "serve.step > serve.harvest > serve.harvest.wait": 10 * MS,
        "serve.step > serve.admit": 10 * MS,
        "serve.step > serve.decode": 10 * MS,
        "bench: tick": 10 * MS}


def test_train_readers_by_hand():
    r = phases.read(train_records())
    assert r["optimizer_host_ms.train"] == pytest.approx(40)
    assert r["optimizer_device_ms.train"] == pytest.approx(15)
    assert r["idle_in_optimizer_pct.train"] == pytest.approx(6)
    assert r["idle_in_fwd_bwd_pct.train"] == pytest.approx(38)
    assert r["step_covered_pct.train"] == pytest.approx(100 * 90 / 95)
    assert phases.idle_by_phase(train_records())[
        "bench: wait for the card"] == 5 * MS


def test_readers_without_what_they_read():
    bare = dict(kind="serve", program_spans=[], trace=None, spans=[])
    assert all(v is None for v in phases.read(bare).values())
    rec = train_records()
    rec["trace"]["launches"] = [None, None, None]
    assert phases.optimizer_device_ms(rec) is None
    del rec["trace"]["launches"]
    assert phases.optimizer_device_ms(rec) is None
    assert phases.idle_in_pct(dict(kind="train", trace=None,
                                   program_spans=[]), ("x",)) is None
    # a run with the tracer off: the trace and the steps, no spans
    off = dict(train_records(), program_spans=[])
    assert all(v is None for v in phases.read(off).values())


class _Event:
    def __init__(self, name, start, dur, corr, device):
        self._v = (name, start, dur, corr, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def test_launch_trace_pairs_each_kernel_with_its_launch():
    """Device clock = host clock + 10,000 ns: the marker fill launched
    at host 1,000 starts at 11,000; each kernel gets its runtime call's
    host time, one without a call None."""
    fake_torch = SimpleNamespace(
        cuda=SimpleNamespace(synchronize=lambda: None),
        autograd=SimpleNamespace(DeviceType=SimpleNamespace(CUDA="gpu")))
    events = [_Event("fill_kernel", 11_000, 10, 1, "gpu"),
              _Event("cudaLaunchKernel", 11_900, 5, 7, "cpu"),
              _Event("gemm_kernel", 12_000, 100, 7, "gpu"),
              _Event("cuLaunchKernelEx", 12_950, 5, 8, "cpu"),
              _Event("cudaStreamSynchronize", 12_990, 5, 9, "cpu"),
              _Event("elementwise_kernel", 13_000, 50, 8, "gpu"),
              _Event("lonely_kernel", 14_000, 20, 10, "gpu")]
    class Prof:
        profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))

        def __exit__(self, *a):
            return False

    tr = phases.LaunchTrace(fake_torch)
    tr.prof, tr._t_mark, tr.t0 = Prof(), 1_000, 1_500
    tr.stop()
    assert [e[0] for e in tr.events] == ["gemm_kernel", "elementwise_kernel",
                                         "lonely_kernel"]
    assert [e[1] for e in tr.events] == [2_000, 3_000, 4_000]
    rec = tr.record()
    assert rec["launches"] == [1_900, 2_950, None]
    assert rec["events"] == tr.events


@pytest.mark.parametrize("workload", ["nemo12b-chat", "ministral8b-sft"])
def test_tiny_cell_with_the_tracer_on_and_off(workload):
    from metamorph_tpu_torch.utils import trace

    ctx, cell = tiny_ctx(workload)
    res = phases.run(ctx, cell, spans=True)
    assert not trace.enabled() and trace.drain() == []
    rec = res["records"]
    names = {s["name"] for s in rec["program_spans"]}
    got = phases.read(rec)
    if workload == "nemo12b-chat":
        assert {"serve.submit", "serve.step", "serve.harvest",
                "serve.admit", "serve.decode", "serve.snapshot"} <= names
        assert 0 <= got["prefill_pad_pct"] < 100
        for k in ("decode_host_ms", "admit_host_ms", "harvest_host_ms"):
            assert got[k] > 0, k
        assert got["step_covered_pct"] > 90
        # the window's spans only: set-up's warm requests are not in them
        assert all(not str(s["attrs"].get("uid", "")).startswith("warm")
                   for s in rec["program_spans"])
    else:
        assert {"train.forward", "train.backward", "train.optimizer",
                "train.grad_norm"} == names
        assert got["optimizer_host_ms.train"] > 0
        assert got["step_covered_pct.train"] > 90
    ctx, cell = tiny_ctx(workload)
    off = phases.run(ctx, cell, spans=False)
    assert off["records"]["program_spans"] == []
    assert not trace.enabled()


def test_a_trace_0_run_leaves_the_tracer_off():
    from benchmark.run import run_cell
    from metamorph_tpu_torch.utils import trace

    ctx, cell = tiny_ctx("nemo12b-chat")
    line = run_cell(ctx, cell, dict(platform="cpu", kind="cpu", count=1))
    assert line["correct"]
    assert not trace.enabled() and trace.drain() == []
