"""PyTorch port, the front ends: `demo`, `serve_cli` and `serve_http` on the
CPU, held to the JAX package's on the same checkpoint and requests.

The checkpoint is written from seeded fp32 JAX weights (tiny LLaMA +
SigLIP, K=4) by the JAX package's `export_hf`. Both packages load it in
fp32 (each loader is wrapped to ask for float32; their CLIs load bf16),
the tokenizer is the stub of tests/test_e2e_demo.py, and each CLI's
`main` runs end to end: the same text and the same number of generated
image tokens. The HTTP server answers on 127.0.0.1:0 (no network) with
the ids JAX's server gives for the same greedy requests. Without a card
the entry points raise unless told `--device cpu`."""

import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metamorph_tpu.config import LlamaConfig as JLlamaConfig
from metamorph_tpu.config import MetaMorphConfig as JConfig
from metamorph_tpu.config import MultimodalConfig as JMM
from metamorph_tpu.config import SiglipConfig as JSiglipConfig
from metamorph_tpu.config import TrainConfig as JTrainConfig
from metamorph_tpu.inference import decode as jdecode
from metamorph_tpu.inference import demo as jdemo
from metamorph_tpu.inference import loader as jloader
from metamorph_tpu.inference import serve_cli as jcli
from metamorph_tpu.inference.serve import ServeEngine as JServeEngine
from metamorph_tpu.inference.serve_http import \
    MetaMorphHTTPServer as JHTTPServer
from metamorph_tpu.models import metamorph as JM
from metamorph_tpu_torch.config import MetaMorphConfig
from metamorph_tpu_torch.convert import from_jax_params
from metamorph_tpu_torch.inference import demo, loader, serve_cli, serve_http
from metamorph_tpu_torch.inference.serve import ServeEngine
from tests.test_e2e_demo import _FakeTransformers

JCFG = JConfig(llama=JLlamaConfig.tiny(vocab_size=128258),
               siglip=JSiglipConfig.tiny(), mm=JMM(num_image_tokens=4),
               train=JTrainConfig(max_seq_len=64))
CFG = MetaMorphConfig.from_dict(JCFG.to_dict())


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_metamorph_params(jax.random.PRNGKey(0), JCFG,
                                    dtype=jnp.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory, jax_params):
    """The exported checkpoint, a drafter in HF layout, and a test image."""
    from PIL import Image
    from safetensors.numpy import save_file

    from metamorph_tpu.models.hf_import import (llama_config_to_hf,
                                                llama_params_to_hf)
    from metamorph_tpu.models.llama import init_llama_params
    from metamorph_tpu.train.checkpoint import export_hf

    d = tmp_path_factory.mktemp("frontends")
    export_hf(str(d / "model"), jax_params, JCFG)
    dcfg = JLlamaConfig.tiny(vocab_size=JCFG.llama.vocab_size)
    dparams = init_llama_params(jax.random.PRNGKey(5), dcfg, jnp.float32)
    (d / "draft").mkdir()
    save_file({k: np.ascontiguousarray(np.asarray(v)) for k, v in
               llama_params_to_hf(dparams, dcfg).items()},
              str(d / "draft" / "model.safetensors"))
    (d / "draft" / "config.json").write_text(
        json.dumps(llama_config_to_hf(dcfg)))
    img = d / "cat.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (60, 80, 3)).astype(np.uint8)).save(img)
    return d


@pytest.fixture
def fp32_and_fake_tokenizer(monkeypatch):
    """Both loaders in fp32, transformers stubbed, JAX's `generate` output
    kept (its demo prints only the text)."""
    jload, tload = jloader.load_pretrained_model, loader.load_pretrained_model
    monkeypatch.setattr(jloader, "load_pretrained_model",
                        lambda p, dtype=None, **kw: jload(
                            p, dtype=jnp.float32, **kw))
    monkeypatch.setattr(loader, "load_pretrained_model",
                        lambda p, dtype=None, **kw: tload(
                            p, dtype=torch.float32, **kw))
    monkeypatch.setitem(sys.modules, "transformers", _FakeTransformers())
    seen = {}
    jgen = jdecode.generate

    def keep(*a, **kw):
        seen["out"] = jgen(*a, **kw)
        return seen["out"]

    monkeypatch.setattr(jdecode, "generate", keep)
    return seen


def _both_demos(capsys, seen, argv):
    jdemo.main(argv)
    jtext = capsys.readouterr().out.strip()
    res = demo.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    return jtext, int(seen["out"]["n_image_tokens"]), res


DEMO_CASES = {
    "square": [],
    "pad": ["--image-aspect-ratio", "pad"],
    "spec": ["--spec-k", "4"],
    "draft": ["--spec-k", "3", "--draft-model", "{d}/draft"],
}


@pytest.mark.parametrize("case", sorted(DEMO_CASES))
def test_demo_main_matches_jax(files, fp32_and_fake_tokenizer, capsys, case):
    argv = ["--model-path", str(files / "model"), "--tokenizer", "fake",
            "--image", str(files / "cat.png"), "--prompt", "what is it",
            "--max-new-tokens", "7"]
    argv += [a.format(d=files) for a in DEMO_CASES[case]]
    jtext, jn_img, res = _both_demos(capsys, fp32_and_fake_tokenizer, argv)
    assert res["text"] == jtext and res["n_image_tokens"] == jn_img
    assert len(res["ids"]) > 0


def test_demo_anyres_matches_jax(monkeypatch, capsys, files):
    """The anyres branch (spatial_unpad, learned newline row) on in-memory
    weights: the exported files hold no newline row, so each loader is
    replaced by the same weights."""
    from tests.test_torch_anyres import anyres_jcfg, port_cfg

    jcfg = anyres_jcfg()
    params = JM.init_metamorph_params(jax.random.PRNGKey(3), jcfg,
                                      dtype=jnp.float32)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    monkeypatch.setattr(jloader, "load_pretrained_model",
                        lambda *a, **kw: (params, jcfg))
    monkeypatch.setattr(loader, "load_pretrained_model",
                        lambda *a, **kw: (model, port_cfg(jcfg)))
    monkeypatch.setitem(sys.modules, "transformers", _FakeTransformers())
    seen = {}
    jgen = jdecode.generate
    monkeypatch.setattr(jdecode, "generate",
                        lambda *a, **kw: seen.setdefault("out",
                                                         jgen(*a, **kw)))
    argv = ["--model-path", "unused", "--tokenizer", "fake", "--image",
            str(files / "cat.png"), "--prompt", "describe",
            "--max-new-tokens", "5", "--image-aspect-ratio", "anyres"]
    jtext, jn_img, res = _both_demos(capsys, seen, argv)
    assert res["text"] == jtext and res["n_image_tokens"] == jn_img


def _requests_file(files, name="reqs.jsonl"):
    path = files / name
    with open(path, "w") as f:
        f.write(json.dumps({"prompt": "what is it", "uid": "img1",
                            "image": str(files / "cat.png"),
                            "max_new_tokens": 5}) + "\n")
        f.write(json.dumps({"prompt": "hello there", "image": None,
                            "uid": "txt1", "max_new_tokens": 4}) + "\n")
        f.write(json.dumps({"prompt": "a longer question about the "
                                      "weather today", "uid": "txt2"}) + "\n")
    return path


@pytest.mark.parametrize("extra", [[], ["--spec-k", "4"],
                                   ["--spec-k", "4", "--draft-model",
                                    "{d}/draft"], ["--int8"]])
def test_serve_cli_main_matches_jax(files, fp32_and_fake_tokenizer, extra):
    reqs = _requests_file(files)
    outs = []
    for mod, tag, dev in ((jcli, "jax", []), (serve_cli, "port",
                                               ["--device", "cpu"])):
        out = files / f"out_{tag}.jsonl"
        rc = mod.main(["--model-path", str(files / "model"), "--tokenizer",
                       "fake", "--requests", str(reqs), "--out", str(out),
                       "--n-slots", "2", "--max-cache-len", "64",
                       "--max-new-tokens", "6"]
                      + [a.format(d=files) for a in extra] + dev)
        assert rc == 0
        outs.append([json.loads(line) for line in open(out)])
    jrows, rows = outs
    assert [r["uid"] for r in rows] == ["img1", "txt1", "txt2"]
    assert rows == jrows


def test_serve_cli_run_without_transformers(files, monkeypatch):
    """The work function with plain callables: no HF files, no
    transformers (whose import fails here, with a clear error from
    `main`)."""
    from chip_smoke import word_tokenize

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        serve_cli.main(["--model-path", str(files / "model"), "--tokenizer",
                        "x", "--requests", "r", "--out", "o", "--device",
                        "cpu"])
    model, cfg = loader.load_pretrained_model(str(files / "model"),
                                              dtype=torch.float32,
                                              device="cpu")
    args = serve_cli.parse_args(["--model-path", "-", "--tokenizer", "-",
                                 "--requests", "-", "--out", "-",
                                 "--n-slots", "2", "--max-cache-len", "64",
                                 "--max-new-tokens", "6"])
    rows = [json.loads(line) for line in open(_requests_file(files))]
    out = serve_cli.run(model, cfg, rows, word_tokenize,
                        lambda ids: " ".join(map(str, ids)), 128000, args)
    assert [r["uid"] for r in out] == ["img1", "txt1", "txt2"]
    for r, budget in zip(out, (5, 4, 6)):
        assert 1 <= r["steps"] <= budget and isinstance(r["text"], str)


# ---- the HTTP server --------------------------------------------------------

ENGINE = dict(n_slots=2, max_cache_len=64, max_new_tokens_cap=16,
              max_images=2, prefill_buckets=(8, 16), steps_per_sync=2)


def _decode_ids(ids):
    return " ".join(map(str, ids))


@pytest.fixture(scope="module")
def servers(jax_params):
    """The port's server and JAX's, on the same weights."""
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    srv = serve_http.MetaMorphHTTPServer(ServeEngine(model, CFG, **ENGINE),
                                         port=0, decode=_decode_ids)
    jsrv = JHTTPServer(JServeEngine(jax_params, JCFG, **ENGINE), port=0,
                       decode=_decode_ids)
    srv.start()
    jsrv.start()
    yield srv, jsrv
    srv.stop()
    jsrv.stop()


def _post(srv, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _health(srv):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health",
                                timeout=30) as r:
        return json.loads(r.read())


def _ids(seed, n=6):
    return np.random.default_rng(seed).integers(10, 1000, n).tolist()


def _stream(srv, body):
    lines = []
    with _post(srv, dict(body, stream=True)) as r:
        for line in r:
            if line.strip():
                lines.append(json.loads(line))
    return lines


def test_http_completion_matches_jax_and_health(servers):
    srv, jsrv = servers
    for seed, n in ((0, 6), (1, 9)):
        body = {"prompt_ids": _ids(seed, n), "max_new_tokens": 7}
        with _post(srv, body) as r:
            out = json.loads(r.read())
        with _post(jsrv, body) as r:
            ref = json.loads(r.read())
        assert out["ids"] == ref["ids"] and out["steps"] == ref["steps"]
        assert out["text"] == _decode_ids(out["ids"]) and out["serve_s"] > 0
    h = _health(srv)
    assert h["ok"] and h["slots_free"] == 2 and h["pending"] == 0


def test_http_streaming_matches_completion(servers):
    srv, jsrv = servers
    body = {"prompt_ids": _ids(1), "max_new_tokens": 8}
    with _post(srv, body) as r:
        ref = json.loads(r.read())
    lines = _stream(srv, body)
    assert lines[-1]["done"] is True
    streamed = [t for line in lines[:-1] for t in line["ids"]]
    assert streamed == ref["ids"] == lines[-1]["ids"]
    assert len(lines) > 2             # arrived in several chunks
    assert "text" in lines[0]         # decoded incrementally
    jlines = _stream(jsrv, body)
    assert [t for line in jlines[:-1] for t in line["ids"]] == streamed


def test_http_concurrent_requests(servers):
    """Four requests in flight on a 2-slot engine, half of them streaming,
    from four client threads: each gets the ids it gets alone."""
    srv, _ = servers
    results = {}

    def go(seed):
        body = {"prompt_ids": _ids(seed), "max_new_tokens": 6}
        if seed % 2:
            lines = _stream(srv, body)
            results[seed] = [t for line in lines[:-1] for t in line["ids"]]
            assert results[seed] == lines[-1]["ids"]
        else:
            with _post(srv, body) as r:
                results[seed] = json.loads(r.read())["ids"]

    ts = [threading.Thread(target=go, args=(s,)) for s in (2, 3, 4, 5)]
    [t.start() for t in ts]
    [t.join(timeout=300) for t in ts]
    assert sorted(results) == [2, 3, 4, 5]
    for seed in (2, 3):
        with _post(srv, {"prompt_ids": _ids(seed),
                         "max_new_tokens": 6}) as r:
            assert json.loads(r.read())["ids"] == results[seed]
    assert _health(srv)["slots_free"] == 2


def test_http_sampling_request(servers):
    srv, _ = servers
    with _post(srv, {"prompt_ids": _ids(4), "max_new_tokens": 6,
                     "temperature": 0.9, "top_p": 0.9}) as r:
        out = json.loads(r.read())
    assert len(out["ids"]) == 6


def test_http_errors(servers):
    srv, _ = servers
    for bad in ({}, {"prompt": "no tokenizer"},
                {"prompt_ids": _ids(5), "max_new_tokens": 9999},
                {"prompt_ids": [], "max_new_tokens": 4}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, bad)
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/nope", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 404


def test_http_main_serves_and_stops(files, fp32_and_fake_tokenizer):
    """`main` on port 0 without blocking: a prompt goes through the stub
    tokenizer; the server stops cleanly."""
    srv = serve_http.main(["--model-path", str(files / "model"),
                           "--tokenizer", "fake", "--port", "0",
                           "--max-cache-len", "64", "--max-new-tokens", "8",
                           "--device", "cpu"], block=False)
    try:
        with _post(srv, {"prompt": "hello there", "max_new_tokens": 3}) as r:
            out = json.loads(r.read())
        assert len(out["ids"]) == 3 and isinstance(out["text"], str)
    finally:
        srv.stop()
    assert not srv.sched.is_alive()


# ---- refusals ---------------------------------------------------------------

def test_shared_prefix_refuses_chunked_fill(jax_params):
    """A shared prefix refuses chunked fill, as in JAX. Every front-end
    option is ported: `--int8` and `--system-prompt` run
    (tests/test_torch_quant.py, tests/test_torch_prefix.py, the serve CLI
    case above), `--visualizer` renders (tests/test_torch_visualizer_io.py)."""
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), CFG,
                            device="cpu")
    with pytest.raises(ValueError, match="fill_chunk"):
        ServeEngine(model, CFG, shared_prefix_ids=[1, 2, 3], fill_chunk=8,
                    **ENGINE)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_entry_points_need_a_card_unless_told_cpu(files,
                                                  fp32_and_fake_tokenizer):
    common = ["--model-path", str(files / "model"), "--tokenizer", "fake"]
    for call in (lambda: demo.main(common + ["--image", "x.png"]),
                 lambda: serve_cli.main(common + ["--requests", "r",
                                                  "--out", "o"]),
                 lambda: serve_http.main(common, block=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
