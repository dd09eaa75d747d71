"""The port's HTTP front end (qtpu_torch/serve/http.py) on the CPU: a live
server over the port's engine against the port's greedy_generate, the same
request through qtpu's front end on qtpu's engine with the same packed
bytes, and `python -m qtpu_torch.serve --http`."""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models.config import TINY_TEST as J_TINY
from qtpu_torch.convert import params_to_numpy
from qtpu_torch.models import TINY_TEST, llama
from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
from qtpu_torch.serve import kvcache as tkv
from qtpu_torch.serve.__main__ import main as serve_main
from qtpu_torch.serve.batching import ContinuousBatcher
from qtpu_torch.serve.decode import greedy_generate
from qtpu_torch.serve.http import ServingFrontend, ThreadingHTTPServer, make_server

CFG = TINY_TEST
PROMPT = [int(t) for t in np.random.default_rng(7).integers(0, CFG.vocab_size, 11)]
NEW = 6
# the engine counters the port's metrics add to qtpu's
PORT_ONLY_METRICS = {"prefill_calls", "decode_steps"}


@pytest.fixture(scope="module")
def packed():
    params = llama.init_params(CFG, seed=0, device="cpu")
    return fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64}))


def _call(port, method, path, body=None):
    """(status, JSON body) of one request to 127.0.0.1:port (no proxy)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


class _Served:
    """A front end and its server on a free port, serving on a thread."""

    def __init__(self, frontend_cls, server_fn, batcher):
        self.frontend = frontend_cls(batcher)
        self.server = server_fn(self.frontend, 0)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        kwargs={"poll_interval": 0.05}, daemon=True)
        self._thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)
        self.frontend.shutdown()


def _greedy(params, qmeta):
    cache = tkv.init_cache(CFG, 1, 64, quantized=True, device="cpu")
    toks, _ = greedy_generate(params, torch.as_tensor([PROMPT], dtype=torch.int32), cache, CFG,
                              NEW, qmeta)
    return toks[0].tolist()


def test_port_and_qtpu_front_ends_answer_alike(packed):
    """The port's server: the tokens of greedy_generate, /health counting 1
    request, 400 on {} and on ids outside the vocabulary, 404 on an unknown
    path. qtpu's server on qtpu's engine with the same packed bytes answers
    the same request with the same keys and types, and /health with the
    same keys (the port's adds its engine counters)."""
    from qtpu.serve.batching import ContinuousBatcher as JBatcher
    from qtpu.serve.http import ServingFrontend as JFrontend
    from qtpu.serve.http import make_server as j_make_server

    params, qmeta = packed
    eng = ContinuousBatcher(params, CFG, qmeta=qmeta, max_batch=2, max_seq_len=64,
                            kv_dtype="int8", device="cpu")
    eng.warmup()
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params))
    jeng = JBatcher(jparams, J_TINY, qmeta=qmeta, max_batch=2, max_seq_len=64, kv_dtype="int8")
    port, ref = _Served(ServingFrontend, make_server, eng), _Served(JFrontend, j_make_server, jeng)
    try:
        body = {"prompt_ids": PROMPT, "max_new_tokens": NEW, "temperature": 0.0}
        code, got = _call(port.port, "POST", "/generate", body)
        jcode, want = _call(ref.port, "POST", "/generate", body)
        assert code == jcode == 200
        assert got["tokens"] == _greedy(params, qmeta)
        assert set(got) == set(want) == {"tokens", "ttft_s", "tokens_per_second"}
        for k in got:
            assert type(got[k]) is type(want[k]), (k, got[k], want[k])
        assert all(type(t) is int for t in got["tokens"] + want["tokens"])
        assert len(want["tokens"]) == NEW
        code, health = _call(port.port, "GET", "/health")
        jcode, jhealth = _call(ref.port, "GET", "/health")
        assert code == jcode == 200 and health["status"] == jhealth["status"] == "ok"
        assert health["requests"] == jhealth["requests"] == 1
        assert set(health) == set(jhealth) | PORT_ONLY_METRICS
        for p in (port, ref):
            assert _call(p.port, "POST", "/generate", {})[0] == 400
            assert _call(p.port, "GET", "/nope")[0] == 404
            assert _call(p.port, "POST", "/nope", body)[0] == 404
        assert _call(port.port, "POST", "/generate", {"prompt_ids": [CFG.vocab_size]})[0] == 400
        assert _call(port.port, "POST", "/generate", {"prompt_ids": ["a"]})[0] == 400
        assert _call(port.port, "GET", "/health")[1]["requests"] == 1  # none reached the engine
    finally:
        port.close()
        ref.close()


def test_serve_cli_http_answers_requests(monkeypatch, capsys):
    """main(["--http", "0", ...]) warms the engine and serves: a request
    to the server it opened is answered, then the server and the engine
    thread are shut down (serve_forever runs on a thread here and stops
    after the request)."""
    serve = ThreadingHTTPServer.serve_forever
    answers = []

    def serve_one(self, *a, **k):
        t = threading.Thread(target=serve, args=(self,), kwargs={"poll_interval": 0.05})
        t.start()
        try:
            answers.append(_call(self.server_address[1], "POST", "/generate",
                                 {"prompt_ids": PROMPT, "max_new_tokens": 3}))
            answers.append(_call(self.server_address[1], "GET", "/health"))
        finally:
            self.shutdown()
            t.join()

    monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", serve_one)
    assert serve_main(["--device", "cpu", "--kv", "int8", "--batch", "2", "--http", "0"]) == 0
    out = capsys.readouterr().out
    assert "engine warmup" in out and "serving on http://127.0.0.1:" in out
    (code, got), (hcode, health) = answers
    assert code == 200 and len(got["tokens"]) == 3
    assert hcode == 200 and health["requests"] == 1
