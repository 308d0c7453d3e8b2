"""Stdlib-only HTTP front-end for ``InferenceServer`` (port of
``deepspeed_tpu/serving/frontend.py``).

Reference analog: MII's REST/gRPC front door, reduced to what the standard
library provides (``http.server.ThreadingHTTPServer`` — one thread per
connection, fine for the request rates a single engine can absorb; a
production deployment would terminate HTTP elsewhere and speak to the serve
loop directly).

Endpoints:
  POST /generate  {"prompt_tokens": [..], "max_new_tokens": N,
                   "timeout_s": S, "priority": P, "stream": false}
      -> 200 {"uid", "tokens", "finish_reason", ...}
      -> with "stream": true, chunked JSON-lines: one {"token": t} per
         generated token, then a final {"done": true, ...} record
      -> 429 + Retry-After on backpressure (queue/KV watermark) AND when
         the degradation ladder sheds; 503 while draining or degraded
  GET /metrics    Prometheus text format
  GET /healthz    200 {"status": "serving", "level": "healthy" |
                  "brownout" | "shed", ...} / 503 otherwise ("level" +
                  "level_reason" expose the degradation ladder; brownout
                  and shed still answer 200 — the replica is alive, it is
                  shedding per-request, so LBs should keep it in rotation).
                  Carries the fleet router's signals too: ``replica_id``,
                  ``prefix_cache_blocks`` (affinity), ``draining``
                  (retirement)
  POST /admin/drain {"handoff_path": P?, "quantize": C?}
      -> 202; background: drain, stop the serve loop, export the warm
         prefix cache to P (fleet retirement — the successor adopts it),
         then fire ``on_retired`` (the fleet worker exits there)
  POST /admin/adopt {"handoff_path": P}
      -> 200 once the serve loop (the engine-owning thread) has imported P
         between ticks; 501 while the engine cannot import handoffs, 503
         once the server has stopped, 500 if the import fails

Slow/malformed-client hardening: a declared Content-Length over
``max_body_bytes`` is refused with 413 WITHOUT reading the body (the
connection closes — draining a hostile body is exactly the wedge); a
body that stalls past ``read_timeout_s`` (socket-level deadline) or
arrives short gets 408. Either way the handler thread is released —
the accept loop never inherits a wedged connection.
"""

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from deepspeed_tpu_torch.serving.request import RequestState
from deepspeed_tpu_torch.serving.server import (BackpressureError,
                                                InferenceServer,
                                                ServerClosedError)
from deepspeed_tpu_torch.utils.logging import logger


class ServingFrontend:
    """Binds an ``InferenceServer`` to a localhost HTTP socket. ``port=0``
    picks an ephemeral port (tests); read it back from ``.port``."""

    def __init__(self, server: InferenceServer, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 120.0,
                 max_body_bytes: int = 1 << 20,
                 read_timeout_s: float = 30.0,
                 drain_timeout_s: float = 30.0):
        self.serving = server
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        self.read_timeout_s = read_timeout_s
        self.drain_timeout_s = drain_timeout_s
        # fleet hook: called after an admin-initiated drain+retire
        # completes (the fleet worker exits its process there)
        self.on_retired: Optional[Callable[[], None]] = None
        # monotonic stamp of the last /healthz poll: /healthz reports the
        # gap since the PREVIOUS poll (last_poll_age_s) so the router's
        # blind window between polls is measured, not assumed
        self._last_healthz_mono: Optional[float] = None
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # socket-level read deadline: applies to every blocking read
            # on the connection (request line, headers, body), so a
            # stalled client times out instead of parking this handler
            # thread and its keep-alive socket forever
            timeout = read_timeout_s

            def log_message(self, fmt, *args):   # route to our logger
                logger.debug("frontend: " + fmt % args)

            def _json(self, code: int, payload: dict, headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    now = time.monotonic()
                    prev = frontend._last_healthz_mono
                    frontend._last_healthz_mono = now
                    h = frontend.serving.health()
                    # seconds since the PREVIOUS poll (None on the first):
                    # the router's own blind window, measured replica-side
                    h["last_poll_age_s"] = (round(now - prev, 6)
                                            if prev is not None else None)
                    self._json(200 if h["ok"] else 503, h)
                elif self.path == "/metrics":
                    body = frontend.serving.metrics.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                try:
                    clen = int(self.headers.get("Content-Length", 0) or 0)
                except ValueError:
                    self.close_connection = True
                    self._json(400, {"error": "bad Content-Length"})
                    return
                if clen > frontend.max_body_bytes:
                    # refuse WITHOUT reading: draining an oversized body
                    # is exactly the wedge this cap exists to prevent —
                    # the connection closes with the 413 instead
                    self.close_connection = True
                    self._json(413, {"error": f"body of {clen} bytes over "
                                              f"cap {frontend.max_body_bytes}"})
                    return
                try:
                    # drain the body FIRST: responding with unread body
                    # bytes on the socket corrupts the next keep-alive
                    # request (the socket deadline bounds this read)
                    raw = self.rfile.read(clen)
                except (socket.timeout, OSError):
                    self.close_connection = True
                    try:
                        self._json(408, {"error": "request body read "
                                                  "timed out"})
                    except OSError:
                        pass    # client already gone
                    return
                if len(raw) < clen:
                    # client hung up (or stalled to EOF) mid-body
                    self.close_connection = True
                    self._json(408, {"error": "short request body"})
                    return
                if self.path.startswith("/admin/"):
                    self._admin(raw)
                    return
                if self.path != "/generate":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                try:
                    body = json.loads(raw or b"{}")
                    prompt = body["prompt_tokens"]
                except (ValueError, KeyError, TypeError) as e:
                    # TypeError: valid JSON that isn't an object
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                # trace-ID contract: the X-Dstpu-Trace header wins (the
                # router's propagation channel); a body field is the
                # fallback for clients that cannot set headers
                trace_id = (self.headers.get("X-Dstpu-Trace")
                            or body.get("trace_id"))
                try:
                    req = frontend.serving.submit(
                        prompt,
                        max_new_tokens=body.get("max_new_tokens"),
                        timeout_s=body.get("timeout_s"),
                        priority=body.get("priority", 0),
                        trace_id=trace_id)
                except (TypeError, ValueError) as e:
                    # type-malformed payloads (non-list prompt, string
                    # max_new_tokens, ...) are client errors, not 500s
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                except BackpressureError as e:
                    self._json(429, {"error": str(e),
                                     "retry_after_s": e.retry_after_s},
                               headers=[("Retry-After",
                                         f"{e.retry_after_s:.0f}")])
                    return
                except ServerClosedError as e:
                    self._json(503, {"error": str(e)})
                    return
                if body.get("stream"):
                    self._stream_response(req)
                else:
                    try:
                        req.result(timeout=frontend.request_timeout_s)
                    except TimeoutError:
                        # a 200 here would pass truncated output off as
                        # success; 504 lets the caller retry deliberately
                        req.cancel()
                        req.wait(timeout=5.0)
                        self._json(504, req.describe()
                                   | {"tokens": req.tokens,
                                      "error": "generation timed out "
                                               "server-side"})
                        return
                    # status mirrors the terminal state: only a normal
                    # finish is a 200 — FAILED/TIMED_OUT with a 200 would
                    # pass a broken or truncated generation off as success
                    code = {RequestState.FINISHED: 200,
                            RequestState.TIMED_OUT: 504,
                            RequestState.FAILED: 500}.get(req.state, 200)
                    self._json(code, req.describe() | {"tokens": req.tokens})

            def _admin(self, raw: bytes):
                try:
                    body = json.loads(raw or b"{}")
                    if not isinstance(body, dict):
                        raise TypeError("payload must be a JSON object")
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": f"bad request: {e!r}"})
                    return
                if self.path == "/admin/adopt":
                    path = body.get("handoff_path")
                    if not isinstance(path, str) or not path:
                        self._json(400, {"error": "handoff_path required"})
                        return
                    try:
                        frontend.serving.adopt_prefix_handoff(path)
                    except (ValueError, AttributeError) as e:
                        self._json(400, {"error": f"cannot adopt: {e!r}"})
                        return
                    except NotImplementedError as e:
                        self._json(501, {"error": f"cannot adopt: {e!r}"})
                        return
                    except ServerClosedError as e:
                        self._json(503, {"error": f"cannot adopt: {e!r}"})
                        return
                    except Exception as e:
                        # a failed import or a timed-out wait still answers
                        self._json(500, {"error": f"cannot adopt: {e!r}"})
                        return
                    self._json(200, {"adopted": True, "handoff_path": path})
                elif self.path == "/admin/drain":
                    handoff = body.get("handoff_path")
                    threading.Thread(
                        target=frontend._drain_and_retire,
                        args=(handoff, body.get("quantize")),
                        name="dstpu-frontend-drain", daemon=True).start()
                    # 202: retirement runs in the background — watch
                    # /healthz flip to draining, then stopped
                    self._json(202, {"draining": True,
                                     "handoff_path": handoff})
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def _stream_response(self, req):
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonlines")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(data):x}\r\n".encode()
                                     + data + b"\r\n")
                    self.wfile.flush()

                try:
                    for tok in req.stream(timeout=frontend.request_timeout_s):
                        chunk({"token": tok})
                    chunk({"done": True} | req.describe())
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:
                    # per-token timeout or client gone: free the engine slot
                    # and try to terminate the chunked stream so a live
                    # client isn't left waiting on a response that never
                    # ends; either way this connection is done
                    req.cancel()
                    try:
                        chunk({"done": True, "error": "stream aborted"}
                              | req.describe())
                        self.wfile.write(b"0\r\n\r\n")
                    except Exception:
                        pass
                    self.close_connection = True

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _drain_and_retire(self, handoff_path: Optional[str],
                          quantize: Optional[str]) -> None:
        """Admin-initiated retirement: drain + stop the serve loop, export
        the warm prefix chains for the successor, fire ``on_retired``."""
        try:
            self.serving.stop(drain_timeout=self.drain_timeout_s)
            if handoff_path:
                # write-then-rename: the file's existence is the router's
                # "handoff complete" signal, so it must appear atomically
                part = handoff_path + ".part"
                self.serving.export_prefix_handoff(part, quantize=quantize)
                os.replace(part, handoff_path)
        except Exception:
            logger.exception("frontend: drain/retire failed")
        cb = self.on_retired
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("frontend: on_retired callback failed")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingFrontend":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="dstpu-frontend", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
