"""HTTP front end over the continuous batcher (port of qtpu/serve/http.py).

Standard library only: a ThreadingHTTPServer accepts POST /generate; one
engine thread drives ContinuousBatcher.step(), and it alone touches the
device and the batcher (a CUDA graph must not be captured or replayed while
another thread launches work), while request threads enqueue and wait.

Lock discipline: request threads hand work over through a small inbox
guarded by `_lock`, and `/health` reads a metrics snapshot the engine
refreshes after every step; neither waits for a device step to finish.
Capture the engine's decode graphs before the front end starts
(`batcher.warmup()`), or let the engine thread capture them at first use.

API (qtpu's):
  POST /generate  {"prompt_ids": [..], "max_new_tokens": N, "temperature": T}
                  -> {"tokens": [..], "ttft_s": .., "tokens_per_second": ..}
  GET  /health    -> {"status": "ok", ...metrics}
A body that is not JSON or lacks integer prompt_ids inside the vocabulary
is answered 400 (checked on the request thread, so a bad body never
reaches the engine), an unknown path 404, a request not done within the
timeout 504.

Start: python -m qtpu_torch.serve --http PORT [model/quant flags as usual].
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


@dataclass
class _Pending:
    """A submission in flight from a request thread to the engine thread."""

    prompt_ids: list
    max_new_tokens: int
    temperature: float
    accepted: threading.Event = field(default_factory=threading.Event)
    req: object = None  # set by the engine thread, then `accepted` fires


class ServingFrontend:
    def __init__(self, batcher):
        self.batcher = batcher
        self._lock = threading.Lock()  # guards _inbox and _metrics only
        self._inbox: list[_Pending] = []
        self._metrics: dict = {"requests": 0}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._engine_loop, daemon=True)
        self._thread.start()

    def _engine_loop(self):
        while not self._stop.is_set():
            with self._lock:
                pending, self._inbox = self._inbox, []
            for p in pending:
                p.req = self.batcher.submit(p.prompt_ids, max_new_tokens=p.max_new_tokens,
                                            temperature=p.temperature)
                p.accepted.set()
            b = self.batcher
            busy = bool(b.queue) or bool(b.prefilling) or bool(b.active)
            if busy:
                b.step()  # device work, no lock held
            with self._lock:
                self._metrics = b.metrics()
            if not busy:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    def metrics(self) -> dict:
        with self._lock:
            return dict(self._metrics)

    def submit_and_wait(self, prompt_ids, max_new_tokens=32, temperature=0.0, timeout_s=300.0):
        p = _Pending(list(prompt_ids), int(max_new_tokens), float(temperature))
        with self._lock:
            self._inbox.append(p)
        self._wake.set()
        deadline = time.time() + timeout_s
        if not p.accepted.wait(timeout=timeout_s):
            return None
        # the engine thread alone writes the request; `done` flips last
        while not p.req.done and time.time() < deadline:
            time.sleep(0.01)
        return p.req

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)


def make_server(frontend: ServingFrontend, port: int = 0) -> ThreadingHTTPServer:
    """The HTTP server over `frontend` on 127.0.0.1:port (0: any free port;
    the bound one is server.server_address[1])."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok", **frontend.metrics()})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                prompt = [int(t) for t in payload["prompt_ids"]]
                vocab = frontend.batcher.cfg.vocab_size
                if not all(0 <= t < vocab for t in prompt):
                    raise ValueError(f"prompt ids outside [0, {vocab})")
                req = frontend.submit_and_wait(
                    prompt,
                    max_new_tokens=int(payload.get("max_new_tokens", 32)),
                    temperature=float(payload.get("temperature", 0.0)),
                )
            except (KeyError, TypeError, ValueError) as e:  # JSONDecodeError is a ValueError
                self._json(400, {"error": f"bad request: {e}"})
                return
            if req is None or not req.done:
                self._json(504, {"error": "generation timed out"})
                return
            self._json(200, {
                "tokens": req.output,
                "ttft_s": round(req.ttft, 4),
                "tokens_per_second": (round(req.tokens_per_second, 2)
                                      if len(req.output) > 1 else None),
            })

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)
