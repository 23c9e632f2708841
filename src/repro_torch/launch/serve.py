"""OpenAI-compatible streaming HTTP front end over the NALAR engine pool
(the port of the JAX package's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --port 8080 --replicas 2
    curl -N localhost:8080/v1/chat/completions -d '{
        "model": "nalar-llm", "stream": true,
        "messages": [{"role": "user", "content": "hello there"}]}'

The launcher builds the pooled runtime (``build_pool_runtime``: N real
``InferenceEngine`` replicas behind one ``llm`` agent type) and serves
``/v1/chat/completions`` on stdlib ``http.server`` threads — no new
dependency.  ``"stream": true`` answers with Server-Sent Events riding the
token-streaming data plane: the engine step loop emits per-slot chunks,
the bridge appends them to the request's future, and the handler forwards
each increment the moment ``Future.wait_streamed`` wakes.  The delta loop
tracks how many tokens it has already sent, so a mid-stream retry (which
truncates the chunk log back to the attempt boundary and re-streams) never
duplicates or reorders client-visible text — the concatenated deltas are
byte-identical to the non-streaming response for the same prompt.

Wire format follows SNIPPETS §3's event-envelope conventions: every SSE
frame carries an ``id:`` line plus an in-payload monotonically increasing
``seq`` (client-side idempotency / resume marker), a typed ``object``
field, and is schema-validated at publish time — malformed events fail the
producer, not the consumer.  JSON over binary: events are tiny and
debuggability wins.

Tokens are hash ids (``hash_tokenize``), not real BPE, so "text" on the
wire is the canonical decimal spelling of each token id — deterministic,
reversible, honest about the reproduction's text model.

``--selftest`` starts the server on an ephemeral port, drives it with a
real network client (urllib over TCP), and asserts incremental delivery
plus streamed == non-streamed byte equality.  The replicas run on the CUDA
card unless ``--device cpu`` asks for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --selftest
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from ..device import DeviceLike
from ..workloads.router import build_pool_runtime

#: required envelope keys, checked at publish time (SNIPPETS §3: validate
#: where events are produced so schema drift cannot reach consumers)
_ENVELOPE_KEYS = ("id", "object", "created", "model", "seq", "choices")


def detokenize(tokens: List[int]) -> str:
    """Token ids -> wire text (space-joined decimal ids; see module doc)."""
    return " ".join(str(int(t)) for t in tokens)


class OpenAIFrontend:
    """The serving surface: owns the pooled runtime and turns HTTP chat
    completions into NALAR driver requests against the ``llm`` stub."""

    def __init__(self, runtime, agent: str = "llm",
                 model_name: str = "nalar-llm",
                 default_max_tokens: int = 32,
                 request_timeout: float = 120.0) -> None:
        self.rt = runtime
        self.agent = agent
        self.model_name = model_name
        self.default_max_tokens = default_max_tokens
        self.request_timeout = request_timeout

    # ------------------------------------------------------------ submission
    def launch(self, prompt: str, *, max_tokens: int,
               temperature: float = 0.0,
               session: Optional[str] = None):
        """Submit one generation as a NALAR request; returns the Future.

        The driver thread blocks on the future (keeping request telemetry
        honest: the request record closes when generation does) while the
        HTTP handler thread consumes the same future's stream."""
        box: Dict[str, Any] = {}
        ready = threading.Event()

        def driver() -> None:
            fut = self.rt.stub(self.agent).generate(
                prompt, _hint={"out_tokens": max_tokens,
                               "temperature": temperature})
            box["fut"] = fut
            ready.set()
            try:
                fut.value(timeout=self.request_timeout)
            except BaseException:   # noqa: BLE001 — handler surfaces errors
                pass

        self.rt.submit_request(driver, session=session)
        if not ready.wait(timeout=30.0):
            raise RuntimeError("driver thread failed to start")
        return box["fut"]

    def serve(self, host: str = "127.0.0.1", port: int = 8080):
        server = _Server((host, port), _Handler)
        server.frontend = self
        return server


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    frontend: OpenAIFrontend


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # silence the default per-request stderr log line
    def log_message(self, fmt: str, *args: Any) -> None:  # noqa: A003
        pass

    # -------------------------------------------------------------- plumbing
    def _json(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _publish_event(self, seq: int, payload: Dict[str, Any]) -> None:
        """One SSE frame, envelope-validated at publish time."""
        missing = [k for k in _ENVELOPE_KEYS if k not in payload]
        if missing:
            raise ValueError(f"malformed stream event, missing {missing}")
        self.wfile.write(
            f"id: {seq}\ndata: {json.dumps(payload)}\n\n".encode())
        self.wfile.flush()

    def _envelope(self, fut, seq: int, **fields: Any) -> Dict[str, Any]:
        fe = self.server.frontend
        return {"id": f"chatcmpl-{fut.fid}", "created": int(time.time()),
                "model": fe.model_name, "seq": seq, **fields}

    # -------------------------------------------------------------- endpoints
    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        fe = self.server.frontend
        if self.path == "/healthz":
            self._json(200, {"status": "ok"})
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": fe.model_name, "object": "model",
                 "owned_by": "nalar"}]})
        else:
            self._json(404, {"error": {"message": f"no route {self.path}"}})

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        if self.path != "/v1/chat/completions":
            self._json(404, {"error": {"message": f"no route {self.path}"}})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            messages = body.get("messages") or []
            prompt = "\n".join(
                f"{m.get('role', 'user')}: {m.get('content', '')}"
                for m in messages)
            if not prompt:
                raise ValueError("messages must be a non-empty list")
            max_tokens = int(body.get("max_tokens",
                                      self.server.frontend.default_max_tokens))
            temperature = float(body.get("temperature", 0.0))
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            self._json(400, {"error": {"message": str(e)}})
            return

        fe = self.server.frontend
        fut = fe.launch(prompt, max_tokens=max_tokens,
                        temperature=temperature,
                        session=body.get("user") or None)
        if body.get("stream"):
            self._stream_completion(fut)
        else:
            self._blocking_completion(fut)

    def _blocking_completion(self, fut) -> None:
        fe = self.server.frontend
        try:
            result = fut.value(timeout=fe.request_timeout)
        except BaseException as e:  # noqa: BLE001 — wire fault reporting
            self._json(500, {"error": {"message": str(e),
                                       "type": type(e).__name__}})
            return
        tokens = list(result.tokens)
        self._json(200, {
            "id": f"chatcmpl-{fut.fid}", "object": "chat.completion",
            "created": int(time.time()), "model": fe.model_name,
            "choices": [{"index": 0, "finish_reason": "stop",
                         "message": {"role": "assistant",
                                     "content": detokenize(tokens)}}],
            "usage": {"prompt_tokens": result.prompt_tokens,
                      "completion_tokens": len(tokens),
                      "total_tokens": result.prompt_tokens + len(tokens)}})

    def _stream_completion(self, fut) -> None:
        fe = self.server.frontend
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()

        seq = 0
        self._publish_event(seq, self._envelope(
            fut, seq, object="chat.completion.chunk",
            choices=[{"index": 0, "finish_reason": None,
                      "delta": {"role": "assistant", "content": ""}}]))
        # Delta loop over the future's chunk log.  ``sent`` counts tokens
        # already on the wire: a retry that rewinds the log re-streams from
        # the attempt boundary, and waiting for ``sent + 1`` naturally
        # skips what the client already has (greedy decode regenerates the
        # identical prefix), so the client never sees duplicates.
        sent = 0
        err: Optional[BaseException] = None
        try:
            while True:
                fut.wait_streamed(sent + 1, timeout=fe.request_timeout)
                cur = fut.partial()
                if len(cur) > sent:
                    text = detokenize(cur[sent:])
                    if sent:
                        text = " " + text
                    sent = len(cur)
                    seq += 1
                    self._publish_event(seq, self._envelope(
                        fut, seq, object="chat.completion.chunk",
                        choices=[{"index": 0, "finish_reason": None,
                                  "delta": {"content": text}}]))
                if fut.available:
                    fut.value()     # raises if the generation failed
                    break
        except BaseException as e:  # noqa: BLE001 — wire fault reporting
            err = e
        seq += 1
        if err is None:
            final = {"index": 0, "delta": {}, "finish_reason": "stop"}
            self._publish_event(seq, self._envelope(
                fut, seq, object="chat.completion.chunk", choices=[final]))
        else:
            self._publish_event(seq, self._envelope(
                fut, seq, object="error", choices=[],
                error={"message": str(err), "type": type(err).__name__}))
        self.wfile.write(b"data: [DONE]\n\n")
        self.wfile.flush()


# ------------------------------------------------------------------ selftest
def _client_request(port: int, payload: Dict[str, Any]):
    """Real network client (urllib over TCP).  Non-streaming -> parsed JSON;
    streaming -> list of SSE event payloads in arrival order."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=180) as resp:
        if not payload.get("stream"):
            return json.loads(resp.read())
        events = []
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                data = line[len("data: "):]
                if data == "[DONE]":
                    break
                events.append(json.loads(data))
        return events


def selftest(replicas: int = 2, max_new: int = 24,
             device: DeviceLike = None) -> None:
    """Start the endpoint, drive it over real TCP, assert the streaming
    contract: incremental delivery, monotonic event seq, and streamed
    deltas concatenating byte-identically to the non-streaming answer."""
    rt = build_pool_runtime(replicas=replicas, max_batch=4,
                            max_new_tokens=max_new, device=device)
    rt.start()
    fe = OpenAIFrontend(rt, default_max_tokens=max_new)
    server = fe.serve(port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"[serve.selftest] endpoint up on 127.0.0.1:{port}")
    try:
        msgs = [{"role": "user", "content": "stream me a careful answer"}]
        full = _client_request(port, {"model": "nalar-llm", "messages": msgs,
                                      "max_tokens": max_new})
        text = full["choices"][0]["message"]["content"]
        assert full["usage"]["completion_tokens"] > 1, full

        events = _client_request(port, {"model": "nalar-llm",
                                        "messages": msgs, "stream": True,
                                        "max_tokens": max_new})
        deltas = [e["choices"][0]["delta"].get("content", "")
                  for e in events if e["object"] == "chat.completion.chunk"
                  and e["choices"][0]["delta"].get("content")]
        assert len(deltas) > 1, (
            f"no incremental delivery: {len(deltas)} content events")
        seqs = [e["seq"] for e in events]
        assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs), seqs
        assert events[-1]["choices"][0]["finish_reason"] == "stop", events[-1]
        streamed_text = "".join(deltas)
        assert streamed_text == text, (
            f"streamed != non-streamed:\n  {streamed_text!r}\n  {text!r}")
        print(f"[serve.selftest] PASS: {len(deltas)} incremental events, "
              f"{full['usage']['completion_tokens']} tokens, streamed text "
              f"byte-identical to the non-streaming path")
    finally:
        server.shutdown()
        rt.shutdown()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--arch", default="qwen3_0_6b")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--max-new", type=int, default=32,
                   help="default max_tokens when the request omits it")
    p.add_argument("--device", default="cuda",
                   help="where the replicas run: cuda (the default) or cpu")
    p.add_argument("--selftest", action="store_true",
                   help="ephemeral-port endpoint + real-client assertions")
    args = p.parse_args()

    if args.selftest:
        selftest(replicas=args.replicas, max_new=min(args.max_new, 24),
                 device=args.device)
        return

    rt = build_pool_runtime(replicas=args.replicas, arch=args.arch,
                            max_batch=args.max_batch, max_seq=args.max_seq,
                            max_new_tokens=args.max_new, device=args.device)
    rt.start()
    fe = OpenAIFrontend(rt, default_max_tokens=args.max_new)
    server = fe.serve(host=args.host, port=args.port)
    print(f"[launch.serve] /v1/chat/completions on "
          f"http://{args.host}:{server.server_address[1]} "
          f"({args.replicas}x {args.arch} replicas on {args.device}; "
          f"stream=true for SSE)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        rt.shutdown()


if __name__ == "__main__":
    main()
