"""HTTP serving front end over the continuous-batching engine (counterpart
of `metamorph_tpu/inference/serve_http.py`). Standard library only:

  * POST /v1/completions
        {"prompt": str | "prompt_ids": [int], "max_new_tokens": int?,
         "temperature": float?, "top_p": float?, "stream": bool?}
    Not streaming -> one JSON object. Streaming -> `application/x-ndjson`:
    one {"ids": [...], "text": ...} line per sync chunk as the engine
    generates, then a final {"done": true, ...} line.
  * GET /health -> {"ok": true, "slots_free": N, "pending": M}

Threads: ONE scheduler thread owns the ServeEngine (submission inbox ->
`eng.step()` loop -> per-request sink queues) and selects the engine's CUDA
device itself, so every kernel launch, the kernels' workspaces and their
launch counters stay on that thread. HTTP handler threads
(ThreadingHTTPServer) touch only thread-safe queues. Streaming rides the
engine's `on_token` callback.

    python -m metamorph_tpu_torch.inference.serve_http --model-path CKPT \
        --tokenizer HF_TOKENIZER_DIR [--port 8000] [--spec-k 4
        [--draft-model DIR]] [--int8] [--system-prompt TEXT] [--device cuda]

The flags are the JAX CLI's, plus `--device`. `--int8` serves int8
decoder linears and lm head (kernel F); `--system-prompt` encodes the text
with the tokenizer's special tokens as the engine's shared prefix, whose
KV is computed once, and then encodes each request's prompt WITHOUT
special tokens: a request is the prefix's suffix, and a BOS spliced in at
position P would diverge from the same prompt served whole.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from metamorph_tpu_torch.inference.serve import Request, ServeEngine


class _Scheduler(threading.Thread):
    """Single owner of the ServeEngine: drains the submission inbox, steps
    the engine while work exists, and routes stream tokens and completions
    to each request's sink queue."""

    def __init__(self, engine: ServeEngine):
        super().__init__(daemon=True)
        self.eng = engine
        self.eng.on_token = self._on_token
        self.inbox: "queue.Queue" = queue.Queue()
        self._sinks: Dict[Any, queue.Queue] = {}
        self._stream: Dict[Any, bool] = {}
        self._stopping = threading.Event()
        self._uid = 0
        self._lock = threading.Lock()

    def next_uid(self) -> str:
        with self._lock:
            self._uid += 1
            return f"req-{self._uid}"

    def _on_token(self, uid, ids: np.ndarray) -> None:
        if self._stream.get(uid):
            self._sinks[uid].put(("tokens", ids))

    def submit(self, req: Request, stream: bool) -> queue.Queue:
        sink: queue.Queue = queue.Queue()
        self.inbox.put((req, stream, sink))
        return sink

    def shutdown(self) -> None:
        self._stopping.set()
        self.inbox.put(None)  # wake the loop

    def _busy(self) -> bool:
        return bool(self.eng.pending
                    or any(u is not None for u in self.eng.slot_uid))

    def run(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.set_device(self.eng.device)
        while not self._stopping.is_set():
            # drain submissions; block when idle (no busy-spin)
            try:
                item = self.inbox.get(block=not self._busy(), timeout=1.0)
            except queue.Empty:
                item = False
            while item is not False:
                if item is None:
                    break
                req, stream, sink = item
                self._sinks[req.uid] = sink
                self._stream[req.uid] = stream
                try:
                    self.eng.submit(req)
                except ValueError as e:          # invalid request -> 400
                    self._sinks.pop(req.uid), self._stream.pop(req.uid)
                    sink.put(("error", str(e)))
                try:
                    item = self.inbox.get_nowait()
                except queue.Empty:
                    item = False
            if self._stopping.is_set():
                break
            if self._busy():
                self.eng.step()
                for c in self.eng.completed:
                    s = self._sinks.pop(c.uid, None)
                    self._stream.pop(c.uid, None)
                    if s is not None:
                        s.put(("done", c))
                self.eng.completed.clear()
        # unblock anyone still waiting
        for s in self._sinks.values():
            s.put(("error", "server shutting down"))


class MetaMorphHTTPServer:
    """Owns the scheduler thread and a ThreadingHTTPServer. `encode` /
    `decode` are optional tokenizer callables (str -> list[int] /
    list[int] -> str); without `encode`, requests must carry
    `prompt_ids`."""

    def __init__(self, engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = 0,
                 encode: Optional[Callable[[str], list]] = None,
                 decode: Optional[Callable[[list], str]] = None,
                 default_max_new: int = 256):
        self.sched = _Scheduler(engine)
        self.encode, self.decode = encode, decode
        self.default_max_new = default_max_new
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):           # quiet
                pass

            def _json(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/health":
                    return self._json(404, {"error": "not found"})
                eng = outer.sched.eng
                self._json(200, {
                    "ok": True,
                    "slots_free": eng.slot_uid.count(None),
                    "pending": len(eng.pending)})

            def do_POST(self):
                if self.path != "/v1/completions":
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError):
                    return self._json(400, {"error": "bad JSON body"})
                try:
                    req, stream = outer._build_request(body)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                sink = outer.sched.submit(req, stream)
                if not stream:
                    kind, payload = sink.get()
                    if kind == "error":
                        return self._json(400, {"error": payload})
                    return self._json(200, outer._completion_json(payload))
                # streaming: ndjson chunks as the engine generates
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):X}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                while True:
                    kind, payload = sink.get()
                    if kind == "tokens":
                        ids = [int(t) for t in payload]
                        obj = {"ids": ids}
                        if outer.decode is not None:
                            obj["text"] = outer.decode(ids)
                        chunk(obj)
                    elif kind == "error":
                        chunk({"done": True, "error": payload})
                        break
                    else:                        # done
                        out = outer._completion_json(payload)
                        out["done"] = True
                        chunk(out)
                        break
                self.wfile.write(b"0\r\n\r\n")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def _build_request(self, body: dict):
        if "prompt_ids" in body:
            ids = np.asarray(body["prompt_ids"], np.int32)
        elif "prompt" in body:
            if self.encode is None:
                raise ValueError("server has no tokenizer; send prompt_ids")
            ids = np.asarray(self.encode(body["prompt"]), np.int32)
        else:
            raise ValueError("body needs 'prompt' or 'prompt_ids'")
        if ids.ndim != 1 or ids.size == 0:
            raise ValueError("prompt must be a non-empty 1-D id list")
        req = Request(
            prompt_ids=ids,
            max_new_tokens=int(body.get("max_new_tokens",
                                        self.default_max_new)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            uid=self.sched.next_uid())
        return req, bool(body.get("stream", False))

    def _completion_json(self, c) -> dict:
        ids = [int(t) for t in c.ids]
        out = {"uid": c.uid, "ids": ids,
               "n_image_tokens": int(c.image_embeds.shape[0]),
               "steps": int(c.steps),
               "queue_s": round(c.queue_s, 4), "serve_s": round(c.serve_s, 4)}
        if self.decode is not None:
            out["text"] = self.decode(ids)
        return out

    def start(self) -> None:
        self.sched.start()
        self._serve_thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.sched.shutdown()
        self.sched.join()


def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model-path", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--siglip", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-cache-len", type=int, default=4096)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 decode (kernel F)")
    p.add_argument("--kv-int8", action="store_true")
    p.add_argument("--spec-k", type=int, default=0)
    p.add_argument("--draft-model", default=None)
    p.add_argument("--system-prompt", default=None,
                   help="fixed prefix text: its KV is computed once and "
                        "reused for every request (requests then carry "
                        "only their own prompt)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def build_server(model, cfg, encode: Callable[[str], list],
                 decode: Callable[[list], str], args,
                 draft=None, prefix_ids=None) -> MetaMorphHTTPServer:
    """The engine the CLI flags in `args` describe, on the model's device,
    behind a (not yet started) server. `prefix_ids` (the encoded system
    prompt) becomes the engine's shared prefix; `encode` must then give
    the requests' suffix ids (no special tokens)."""
    eng = ServeEngine(model, cfg, n_slots=args.n_slots,
                      max_cache_len=args.max_cache_len,
                      max_new_tokens_cap=args.max_new_tokens, seed=args.seed,
                      kv_int8=args.kv_int8, spec_k=args.spec_k, draft=draft,
                      shared_prefix_ids=prefix_ids)
    return MetaMorphHTTPServer(eng, host=args.host, port=args.port,
                               encode=encode, decode=decode,
                               default_max_new=args.max_new_tokens)


def main(argv=None, block: bool = True):
    """Load, build and start the server; with `block`, serve until
    interrupted. Returns the server."""
    import sys

    args = parse_args(argv)

    from metamorph_tpu_torch.inference.demo import load_hf_tokenizer
    from metamorph_tpu_torch.inference.serve_cli import _load_draft, load_model

    model, cfg = load_model(args)
    tok = load_hf_tokenizer(args.tokenizer, "the HTTP server")
    prefix = None
    if args.system_prompt:
        prefix = np.asarray(tok(args.system_prompt).input_ids, np.int32)
        encode = lambda s: tok(s, add_special_tokens=False).input_ids
    else:
        encode = lambda s: tok(s).input_ids
    srv = build_server(model, cfg, encode,
                       lambda ids: tok.decode(ids, skip_special_tokens=True),
                       args, draft=_load_draft(args, model),
                       prefix_ids=prefix)
    srv.start()
    print(f"serving on http://{args.host}:{srv.port}", file=sys.stderr)
    if block:
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            srv.stop()
    return srv


if __name__ == "__main__":
    main()
