"""Shared JSON-lines TCP server scaffolding for cluster agents.

One request per line, one JSON reply per line, one thread per connection,
optional TLS termination on accept. Both the production Kafka agent
(executor.kafka_agent.ClusterAgentServer) and the protocol-level test fake
(testing.fake_agent.FakeClusterAgent) speak the same wire protocol
(executor/tcp_driver.py module docstring); sharing the transport layer keeps
them from diverging — a framing or TLS change lands in exactly one place and
the fake the test suite validates against stays representative of the
production server.
"""

from __future__ import annotations

import json
import socketserver
import threading
from typing import Callable, Dict, Optional, Tuple


class DropConnection(Exception):
    """Raised by a dispatch to close the client connection WITHOUT replying —
    the transport-level fault surface (testing/faults.py injects it to
    exercise client reconnect paths; a production agent may use it to shed a
    misbehaving peer)."""


class JsonLinesServer:
    """Threaded JSON-lines TCP server around a `dispatch(dict) -> dict`.

    Dispatch exceptions are answered as {"ok": False, "error": repr(e)} —
    a malformed request must not kill the connection thread silently —
    except DropConnection, which severs the connection unanswered.
    `ssl_context` (server-side) wraps each accepted connection in TLS.
    """

    def __init__(self, dispatch: Callable[[Dict], Dict], host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None, name: str = "json-lines-agent"):
        self._name = name

        class Handler(socketserver.StreamRequestHandler):
            def setup(self):
                if ssl_context is not None:
                    self.request = ssl_context.wrap_socket(
                        self.request, server_side=True
                    )
                super().setup()

            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        resp = dispatch(json.loads(line))
                    except DropConnection:
                        return
                    except Exception as e:
                        resp = {"ok": False, "error": repr(e)}
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def start(self) -> "JsonLinesServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=self._name, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
