"""HTTP gateway for the port's NavServer: network-facing serving
(counterpart of `etpnav_tpu/serving_http.py`, with the same wire format
byte for byte, so a client of either package talks to a server of the
other).

The reference's only inference surface is the offline leaderboard writer
(ss_trainer_ETP.py:643-756); `etpnav_tpu_torch.serving.NavServer` adds
the push-model session API, and this module puts it on the wire with
zero dependencies beyond the standard library. Concurrent HTTP requests
land in NavServer's dynamic batcher, so independent clients' steps
coalesce into one batch on the card exactly as in-process callers do.

Protocol (JSON unless noted):

  GET    /healthz              -> {"ok": true}
  GET    /stats                -> NavServer.stats() counters
  POST   /sessions             <- {"instruction_tokens": [int, ...]}
                               -> {"sid": int}
  POST   /sessions/<sid>/step  <- body: ``.npz`` archive (npz content
                                  type free-form) with arrays
                                  rgb (12,H,W,3) uint8, depth (12,h,w,1)
                                  float32, pos (3,) and ori_xyzw (4,)
                               -> {"action": ..., "done": bool,
                                   "stop_prob": float, "num_nodes": int,
                                   "num_ghosts": int}
  DELETE /sessions/<sid>       -> {"steps": int, "history": [...]}

Observations ride ``numpy.savez`` archives rather than JSON: base64'ing
~5 MB of RGB-D per step would triple the wire size and add two host
passes; npz stays binary, self-describing, and stdlib-decodable
(``np.load``, ``allow_pickle=False``).

Error mapping: 400 malformed request/shape, 404 unknown session,
409 session already stopped / step already in flight, 503 server shut
down, 504 step timeout (the session may be poisoned — see
NavServer.step's fatal-timeout contract).

Action dicts carry numpy positions; ``to_jsonable`` flattens them for
the wire and ``HttpNavClient`` restores numpy views so the result plugs
straight into the env layer (``env.step([res["action"]])``).
"""

from __future__ import annotations

import io
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

import numpy as np

from etpnav_tpu_torch.serving import NavServer

_STEP_RE = re.compile(r"^/sessions/(\d+)/step$")
_SESSION_RE = re.compile(r"^/sessions/(\d+)$")
_MAX_BODY = 256 * 1024 * 1024


def to_jsonable(x: Any) -> Any:
    """Numpy scalars/arrays -> plain Python (tuples become lists)."""
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def action_from_wire(action: dict) -> dict:
    """Inverse of to_jsonable for env-action dicts: position fields back
    to float64 arrays, back_path entries back to (node, pos) tuples —
    the exact structure build_env_action emits (training/rollout.py)."""
    out = dict(action)
    for key in ("stop_pos", "front_pos", "ghost_pos"):
        if out.get(key) is not None:
            out[key] = np.asarray(out[key], np.float64)
    if out.get("back_path") is not None:
        out["back_path"] = [(int(v), np.asarray(p, np.float64))
                            for v, p in out["back_path"]]
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "etpnav-tpu"
    nav: NavServer = None          # set by make_http_server

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):   # route through logging, not stderr
        import logging
        logging.getLogger("etpnav_tpu_torch.serving.http").debug(
            "%s %s", self.address_string(), fmt % args)

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str):
        self._reply(code, {"error": msg})

    def _body(self) -> Optional[bytes]:
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            self.close_connection = True   # body length unknown: resync
            self._error(400, "malformed Content-Length")
            return None
        if n > _MAX_BODY:
            # the unread body would desync this keep-alive connection's
            # next request line — drop the connection after replying
            self.close_connection = True
            self._error(400, f"body too large ({n} bytes)")
            return None
        return self.rfile.read(n)

    def _dispatch(self, fn):
        """Run a NavServer call, mapping its exception contract to HTTP
        statuses (module docstring)."""
        try:
            code, payload = fn()
        except KeyError as e:
            return self._error(404, f"unknown session {e}")
        except ValueError as e:
            return self._error(400, str(e))
        except TimeoutError as e:
            return self._error(504, str(e))
        except RuntimeError as e:
            # only NavServer's known session-protocol errors are client
            # faults; any other RuntimeError (e.g. a CUDA error) is a
            # server fault and must surface as 500, not 409
            msg = str(e)
            if "shut down" in msg:
                return self._error(503, msg)
            if "already stopped" in msg or "already has a step" in msg:
                return self._error(409, msg)
            return self._error(500, f"RuntimeError: {msg}")
        except Exception as e:     # noqa: BLE001 — wire boundary
            return self._error(500, f"{type(e).__name__}: {e}")
        self._reply(code, payload)

    # -- routes -------------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            return self._reply(200, {"ok": True})
        if self.path == "/stats":
            return self._dispatch(lambda: (200, self.nav.stats()))
        self._error(404, f"no route {self.path}")

    def do_POST(self):
        body = self._body()
        if body is None:
            return
        if self.path == "/sessions":
            return self._dispatch(lambda: self._create(body))
        m = _STEP_RE.match(self.path)
        if m:
            sid = int(m.group(1))
            return self._dispatch(lambda: self._step(sid, body))
        self._error(404, f"no route {self.path}")

    def do_DELETE(self):
        m = _SESSION_RE.match(self.path)
        if not m:
            return self._error(404, f"no route {self.path}")
        sid = int(m.group(1))
        self._dispatch(
            lambda: (200, to_jsonable(self.nav.close_session(sid))))

    # -- handlers ------------------------------------------------------------

    def _create(self, body: bytes) -> Tuple[int, dict]:
        try:
            req = json.loads(body)
            tokens = np.asarray(req["instruction_tokens"], np.int32)
        except (json.JSONDecodeError, KeyError, TypeError,
                OverflowError) as e:
            raise ValueError(f"bad create-session request: {e}") from e
        if tokens.ndim != 1 or tokens.size == 0:
            raise ValueError("instruction_tokens must be a non-empty "
                             "1-d int list")
        return 200, {"sid": self.nav.create_session(tokens)}

    def _step(self, sid: int, body: bytes) -> Tuple[int, dict]:
        try:
            with np.load(io.BytesIO(body), allow_pickle=False) as z:
                obs = {k: z[k] for k in ("rgb", "depth", "pos",
                                         "ori_xyzw")}
        except Exception as e:      # noqa: BLE001 — malformed archive
            raise ValueError(f"step body must be an npz archive with "
                             f"rgb/depth/pos/ori_xyzw: {e}") from e
        res = self.nav.step(sid, obs["rgb"], obs["depth"], obs["pos"],
                            obs["ori_xyzw"])
        return 200, to_jsonable(res)


def make_http_server(nav: NavServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind a threaded HTTP server over a NavServer. port=0 picks a free
    port (``server.server_address[1]``). Caller owns serve_forever /
    shutdown; ``serve`` below runs the standard lifecycle."""
    handler = type("BoundHandler", (_Handler,), {"nav": nav})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def serve(nav: NavServer, host: str = "0.0.0.0", port: int = 8080,
          *, warmup: bool = True, block: bool = True
          ) -> ThreadingHTTPServer:
    """Production entry: warm the device programs (the first call builds
    the CUDA kernels), bind, serve."""
    if warmup:
        nav.warmup()
    httpd = make_http_server(nav, host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    if block:
        try:
            t.join()
        except KeyboardInterrupt:
            httpd.shutdown()
            nav.shutdown()
    return httpd


class HttpNavClient:
    """Minimal stdlib client; also the reference wire-format encoder.

    Step results come back with ``action`` restored to env-layer form
    (numpy positions), so driving an env over HTTP is the same loop as
    in-process serving (tests/test_serving_http.py)."""

    def __init__(self, base_url: str, timeout: float = 600.0):
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    def _req(self, method: str, path: str, data: Optional[bytes] = None,
             content_type: str = "application/json") -> dict:
        import urllib.error
        import urllib.request
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": content_type} if data else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            detail = e.read()
            try:
                detail = json.loads(detail)["error"]
            except Exception:       # noqa: BLE001 — non-JSON error body
                detail = detail.decode(errors="replace")
            raise HttpNavError(e.code, detail) from None

    def healthz(self) -> dict:
        return self._req("GET", "/healthz")

    def stats(self) -> dict:
        return self._req("GET", "/stats")

    def create_session(self, instruction_tokens) -> int:
        tokens = np.asarray(instruction_tokens).tolist()
        return self._req(
            "POST", "/sessions",
            json.dumps({"instruction_tokens": tokens}).encode())["sid"]

    def step(self, sid: int, rgb, depth, pos, ori_xyzw) -> dict:
        buf = io.BytesIO()
        np.savez(buf, rgb=np.asarray(rgb, np.uint8),
                 depth=np.asarray(depth, np.float32),
                 pos=np.asarray(pos, np.float64),
                 ori_xyzw=np.asarray(ori_xyzw, np.float64))
        res = self._req("POST", f"/sessions/{sid}/step", buf.getvalue(),
                        content_type="application/x-npz")
        res["action"] = action_from_wire(res["action"])
        return res

    def close_session(self, sid: int) -> dict:
        return self._req("DELETE", f"/sessions/{sid}")


class HttpNavError(RuntimeError):
    def __init__(self, code: int, detail: str):
        super().__init__(f"HTTP {code}: {detail}")
        self.code = code
        self.detail = detail
