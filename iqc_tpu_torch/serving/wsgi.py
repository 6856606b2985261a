"""Minimal WSGI micro-framework (standard library only).

Provides what the serving layer needs from Flask: routing with methods,
JSON request/response helpers, multipart/form-data file uploads, error
handlers, a threaded server, and RFC 6455 WebSocket routes (the
bidirectional real-time channel of the dashboard).
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import select
import struct
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs
from wsgiref.simple_server import (
    ServerHandler, WSGIServer, WSGIRequestHandler, make_server,
)
from socketserver import ThreadingMixIn


class Request:
    def __init__(self, environ: Dict[str, Any]):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = {
            k: v[0] for k, v in parse_qs(environ.get("QUERY_STRING", "")).items()
        }
        self.content_type = environ.get("CONTENT_TYPE", "")
        self.remote_addr = environ.get("REMOTE_ADDR", "")
        try:
            self.content_length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            self.content_length = 0
        self._body: Optional[bytes] = None
        self._files: Optional[Dict[str, List[Tuple[str, bytes]]]] = None
        self._form: Optional[Dict[str, str]] = None

    def header(self, name: str, default: str = "") -> str:
        """Request header by case-insensitive name (WSGI HTTP_* environ)."""
        key = "HTTP_" + name.upper().replace("-", "_")
        return self.environ.get(key, default)

    @property
    def body(self) -> bytes:
        if self._body is None:
            stream = self.environ.get("wsgi.input")
            self._body = stream.read(self.content_length) if stream and self.content_length else b""
        return self._body

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None

    # -- multipart/form-data ---------------------------------------------------

    def _parse_multipart(self) -> None:
        self._files = {}
        self._form = {}
        m = re.search(r'boundary="?([^";]+)"?', self.content_type)
        if not m:
            return
        boundary = m.group(1).encode()
        delim = b"--" + boundary
        for part in self.body.split(delim):
            part = part.strip(b"\r\n")
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" not in part:
                continue
            header_blob, content = part.split(b"\r\n\r\n", 1)
            headers = {}
            for line in header_blob.split(b"\r\n"):
                if b":" in line:
                    k, v = line.split(b":", 1)
                    headers[k.decode().lower().strip()] = v.decode().strip()
            disp = headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            if not name_m:
                continue
            field = name_m.group(1)
            if file_m:
                self._files.setdefault(field, []).append((file_m.group(1), content))
            else:
                self._form[field] = content.decode("utf-8", "replace")

    @property
    def files(self) -> Dict[str, List[Tuple[str, bytes]]]:
        if self._files is None:
            if self.content_type.startswith("multipart/form-data"):
                self._parse_multipart()
            else:
                self._files, self._form = {}, {}
        return self._files

    @property
    def form(self) -> Dict[str, str]:
        self.files  # trigger parse
        return self._form or {}

    def file(self, field: str) -> Optional[Tuple[str, bytes]]:
        entries = self.files.get(field)
        return entries[0] if entries else None


class Response:
    """body is bytes (buffered, Content-Length set) OR an iterable of bytes
    chunks (streamed to the client as produced — SSE/chunked responses)."""

    def __init__(self, body, status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[List[Tuple[str, str]]] = None):
        self.body = body
        self.status = status
        self.headers = [("Content-Type", content_type)] + (headers or [])


def jsonify(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data, default=str).encode("utf-8"), status=status)


def html(text: str, status: int = 200) -> Response:
    return Response(text.encode("utf-8"), status=status, content_type="text/html; charset=utf-8")


# -- WebSocket (RFC 6455) ------------------------------------------------------

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def ws_accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a client's Sec-WebSocket-Key."""
    digest = hashlib.sha1((client_key + _WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


class WebSocket:
    """Server side of one upgraded connection: frame codec over the raw
    socket. Text frames carry JSON event payloads; ping/pong/close are
    handled inline. Fragmented messages are reassembled (continuation
    frames), which is all a browser peer requires."""

    # bound on one reassembled message: a peer-declared 64-bit frame length
    # (or unbounded continuation fragments) must not grow server memory
    MAX_MESSAGE_BYTES = 16 << 20

    def __init__(self, sock, mask_outgoing: bool = False,
                 prebuffer: bytes = b"",
                 max_message_bytes: Optional[int] = None):
        self.sock = sock
        self.open = True
        self._mask_outgoing = mask_outgoing  # client endpoints must mask
        self._sendlock = threading.Lock()
        self._fragments: List[bytes] = []
        self._frag_bytes = 0
        self._frag_opcode = 0
        self.max_message_bytes = max_message_bytes or self.MAX_MESSAGE_BYTES
        # bytes read past the handshake (frames coalesced with the 101)
        self._rbuf = prebuffer

    # -- send ------------------------------------------------------------------

    def send(self, data, opcode: Optional[int] = None) -> None:
        if not self.open:
            return
        if opcode is None:
            opcode = 0x1 if isinstance(data, str) else 0x2
        payload = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        head = bytes([0x80 | opcode])
        mask_bit = 0x80 if self._mask_outgoing else 0
        n = len(payload)
        if n < 126:
            head += bytes([mask_bit | n])
        elif n < 1 << 16:
            head += bytes([mask_bit | 126]) + struct.pack(">H", n)
        else:
            head += bytes([mask_bit | 127]) + struct.pack(">Q", n)
        if self._mask_outgoing:
            key = struct.pack(">I", threading.get_ident() & 0xFFFFFFFF)
            payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
            head += key
        try:
            with self._sendlock:
                self.sock.sendall(head + payload)
        except OSError:
            self.open = False

    def send_json(self, obj: Any) -> None:
        self.send(json.dumps(obj, default=str))

    # -- receive ---------------------------------------------------------------

    def _read_exact(self, n: int) -> Optional[bytes]:
        buf = b""
        if self._rbuf:
            buf, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        while len(buf) < n:
            try:
                chunk = self.sock.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def recv(self, timeout: Optional[float] = None):
        """Next text (str) or binary (bytes) message; None when the timeout
        expires with no data or the connection closed (check .open)."""
        while self.open:
            if timeout is not None and not self._rbuf:
                ready, _, _ = select.select([self.sock], [], [], timeout)
                if not ready:
                    return None
            head = self._read_exact(2)
            if head is None:
                self.open = False
                return None
            fin = head[0] & 0x80
            opcode = head[0] & 0x0F
            masked = head[1] & 0x80
            n = head[1] & 0x7F
            if n == 126:
                ext = self._read_exact(2)
                if ext is None:
                    self.open = False
                    return None
                n = struct.unpack(">H", ext)[0]
            elif n == 127:
                ext = self._read_exact(8)
                if ext is None:
                    self.open = False
                    return None
                n = struct.unpack(">Q", ext)[0]
            if n + self._frag_bytes > self.max_message_bytes:
                # peer-declared length over the cap: refuse before reading
                self.close(code=1009)  # 1009 = message too big
                return None
            key = b"\x00" * 4
            if masked:
                key = self._read_exact(4)
                if key is None:
                    self.open = False
                    return None
            payload = self._read_exact(n) if n else b""
            if payload is None:
                self.open = False
                return None
            if masked:
                payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
            if opcode == 0x8:  # close: echo + shut
                self.close()
                return None
            if opcode == 0x9:  # ping -> pong
                self.send(payload, opcode=0xA)
                continue
            if opcode == 0xA:  # unsolicited pong
                continue
            if opcode in (0x1, 0x2) and not fin:  # fragmented start
                self._fragments = [payload]
                self._frag_bytes = len(payload)
                self._frag_opcode = opcode
                continue
            if opcode == 0x0:  # continuation
                self._fragments.append(payload)
                self._frag_bytes += len(payload)
                if not fin:
                    continue
                payload = b"".join(self._fragments)
                opcode = self._frag_opcode
                self._fragments = []
                self._frag_bytes = 0
            if opcode == 0x1:
                return payload.decode("utf-8", "replace")
            return payload
        return None

    def close(self, code: int = 1000) -> None:
        if self.open:
            try:
                with self._sendlock:
                    self.sock.sendall(
                        bytes([0x88, 0x82 if self._mask_outgoing else 0x02])
                        + (b"\x00\x00\x00\x00" if self._mask_outgoing else b"")
                        + struct.pack(">H", code)
                    )
            except OSError:
                pass
        self.open = False
        try:
            self.sock.close()
        except OSError:
            pass


def ws_connect(host: str, port: int, path: str = "/ws",
               headers: Optional[Dict[str, str]] = None,
               timeout: float = 10.0) -> WebSocket:
    """Tiny WebSocket *client* (tests / ops tooling): handshake + masked
    frames per RFC 6455 5.1."""
    import socket as _socket

    sock = _socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(hashlib.sha1(str(id(sock)).encode()).digest()[:16])
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    sock.sendall(
        (
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key.decode()}\r\n"
            f"Sec-WebSocket-Version: 13\r\n{extra}\r\n"
        ).encode("ascii")
    )
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        if not chunk:
            raise ConnectionError("websocket handshake failed: peer closed")
        resp += chunk
    head, leftover = resp.split(b"\r\n\r\n", 1)
    status = head.split(b"\r\n", 1)[0]
    if b"101" not in status:
        sock.close()
        raise ConnectionError(f"websocket handshake rejected: {status!r}")
    expect = ws_accept_key(key.decode())
    if expect.encode() not in head:
        sock.close()
        raise ConnectionError("websocket handshake: bad Sec-WebSocket-Accept")
    # frames that arrived coalesced with the 101 response stay readable
    return WebSocket(sock, mask_outgoing=True, prebuffer=leftover)


_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class App:
    """Route table + WSGI callable. Routes support <param> path segments."""

    def __init__(self, name: str = "app"):
        self.name = name
        self._routes: List[Tuple[re.Pattern, Tuple[str, ...], Callable]] = []
        self._ws_routes: List[Tuple[re.Pattern, Callable]] = []
        self._error_handlers: Dict[int, Callable] = {}
        self.before_request: List[Callable[[Request], Optional[Response]]] = []
        self.after_request: List[Callable[[Request, Response], None]] = []
        # WebSocket handshake auth (the upgrade is dispatched pre-WSGI in
        # the request handler, so before_request hooks never see it):
        # fn(headers, raw_path) -> bool; None = open
        self.ws_auth: Optional[Callable[[Any, str], bool]] = None

    def route(self, path: str, methods: Tuple[str, ...] = ("GET",)):
        pattern = re.compile(
            "^" + re.sub(r"<([a-zA-Z_]+)>", r"(?P<\1>[^/]+)", path) + "$"
        )

        def deco(fn):
            self._routes.append((pattern, tuple(m.upper() for m in methods), fn))
            return fn

        return deco

    def websocket(self, path: str):
        """Register a WebSocket handler ``fn(ws: WebSocket, req: Request)``
        for GET-with-Upgrade requests on ``path`` (served by the dev server's
        handler before WSGI — WSGI itself cannot speak 101)."""
        pattern = re.compile(
            "^" + re.sub(r"<([a-zA-Z_]+)>", r"(?P<\1>[^/]+)", path) + "$"
        )

        def deco(fn):
            self._ws_routes.append((pattern, fn))
            return fn

        return deco

    def match_websocket(self, path: str) -> Optional[Tuple[Callable, Dict[str, str]]]:
        for pattern, fn in self._ws_routes:
            m = pattern.match(path)
            if m:
                return fn, m.groupdict()
        return None

    def errorhandler(self, status: int):
        def deco(fn):
            self._error_handlers[status] = fn
            return fn

        return deco

    def _error(self, status: int, message: str = "") -> Response:
        handler = self._error_handlers.get(status)
        if handler:
            return handler(message)
        return jsonify({"error": message or _STATUS_TEXT.get(status, "error")}, status)

    def __call__(self, environ, start_response):
        req = Request(environ)
        try:
            resp = self._dispatch(req)
        except Exception:
            traceback.print_exc()
            resp = self._error(500, "Internal server error")
        if isinstance(resp, tuple):  # (data, status)
            resp = jsonify(resp[0], resp[1])
        elif not isinstance(resp, Response):
            resp = jsonify(resp)
        for hook in self.after_request:
            try:
                hook(req, resp)
            except Exception:  # response hooks must never kill a reply
                traceback.print_exc()
        status_line = f"{resp.status} {_STATUS_TEXT.get(resp.status, 'OK')}"
        if isinstance(resp.body, bytes):
            headers = resp.headers + [("Content-Length", str(len(resp.body)))]
            start_response(status_line, headers)
            return [resp.body]
        # iterator body: stream chunks as the handler produces them (no
        # Content-Length; connection close delimits): live SSE
        start_response(status_line, resp.headers)
        return resp.body

    def _dispatch(self, req: Request):
        for hook in self.before_request:
            early = hook(req)
            if early is not None:
                return early
        path_matched = False
        for pattern, methods, fn in self._routes:
            m = pattern.match(req.path)
            if not m:
                continue
            path_matched = True
            if req.method not in methods:
                continue
            return fn(req, **m.groupdict())
        if path_matched:
            return self._error(405, "Method not allowed")
        return self._error(404, f"Endpoint {req.path} not found")


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True


class _ReusePortWSGIServer(_ThreadingWSGIServer):
    """SO_REUSEPORT before bind: the kernel load-balances connections across
    every process bound to the port — the preforked-worker substrate for
    serve(reuse_port=True) (reference: gunicorn x4 eventlet workers,
    Dockerfile:96)."""

    def server_bind(self):
        import socket

        self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        super().server_bind()


class _QuietHandler(WSGIRequestHandler):
    """Quiet request handler that additionally intercepts WebSocket
    upgrades before WSGI (WSGI cannot emit 101 + hijack the socket)."""

    def log_message(self, fmt, *args):  # pragma: no cover
        pass

    def handle(self):
        # mirror of wsgiref.simple_server.WSGIRequestHandler.handle with a
        # WebSocket branch between parse_request and the WSGI dispatch
        self.raw_requestline = self.rfile.readline(65537)
        if len(self.raw_requestline) > 65536:
            self.requestline = ""
            self.request_version = ""
            self.command = ""
            self.send_error(414)
            return
        if not self.parse_request():
            return

        app = self.server.get_app()
        if (
            isinstance(app, App)
            and "websocket" in self.headers.get("Upgrade", "").lower()
            and "upgrade" in self.headers.get("Connection", "").lower()
        ):
            path = self.path.split("?", 1)[0]
            match = app.match_websocket(path)
            key = self.headers.get("Sec-WebSocket-Key")
            if match and key and app.ws_auth is not None \
                    and not app.ws_auth(self.headers, self.path):
                self.send_error(401)
                return
            if match and key:
                fn, params = match
                self.close_connection = True
                accept = ws_accept_key(key)
                self.wfile.write(
                    (
                        "HTTP/1.1 101 Switching Protocols\r\n"
                        "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                        f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
                    ).encode("ascii")
                )
                self.wfile.flush()
                ws = WebSocket(self.connection)
                req = Request(self.get_environ())
                try:
                    fn(ws, req, **params)
                except Exception:  # handler bugs must not kill the server
                    traceback.print_exc()
                finally:
                    ws.close()
                return
            # upgrade requested on a non-ws path: fall through to WSGI (404)

        handler = ServerHandler(
            self.rfile, self.wfile, self.get_stderr(), self.get_environ(),
            multithread=False,
        )
        handler.request_handler = self
        handler.run(app)


def serve(app: App, host: str = "0.0.0.0", port: int = 5000, background: bool = False,
          reuse_port: bool = False, ssl_cert: Optional[str] = None,
          ssl_key: Optional[str] = None):
    """Threaded WSGI server; with reuse_port=True several processes can bind
    the same port and the kernel load-balances (see serving/app.py --workers
    for the preforked supervisor).

    Process model on a GPU: run one process per card. Request concurrency
    comes from this threaded server plus the batch-coalescing worker queue
    (QualityControlSystem.start_processing_worker): device batching replaces
    process fan-out. Multi-worker mode exists for CPU-only and demo-mode
    deployments where requests are host-bound."""
    server = make_server(
        host, port, app,
        server_class=_ReusePortWSGIServer if reuse_port else _ThreadingWSGIServer,
        handler_class=_QuietHandler)
    if ssl_cert and ssl_key:
        # TLS termination (reference security.ssl block, config.yaml:266-271
        # — declared there, never read; typically a proxy's job, but
        # single-box industrial deployments want it on the server itself)
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(ssl_cert, ssl_key)
        # Defer the handshake to the per-connection handler thread: with
        # do_handshake_on_connect=True the handshake runs inside accept()
        # on the single accept loop, so one stalled client (TCP open, no
        # ClientHello) would block ALL new connections.
        server.socket = ctx.wrap_socket(server.socket, server_side=True,
                                        do_handshake_on_connect=False)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    return server
