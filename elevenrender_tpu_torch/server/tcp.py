"""Headless TCP render server, port 5557 by default.

Port of ``elevenrender_tpu/server/tcp.py`` (the reference's
main.cpp:190-240): one client at a time, a fresh ``CommandSession`` per
connection, an OK handshake on connect, then messages until a
``close_session`` status.  A client that disconnects or sends a header
that cannot be parsed loses its session; the server accepts the next.

Run: ``python3 -m elevenrender_tpu_torch.server.tcp [--port 5557]
[--host 0.0.0.0]``.  Scenes render on the device the client's config
names, cuda:0 when it names none.
"""

from __future__ import annotations

import socket

from ..utils.logging import get_logger
from .commands import CommandSession
from .protocol import Message, read_message, write_message

log = get_logger()

DEFAULT_PORT = 5557


class RenderServer:
    def __init__(self, host: str = "0.0.0.0", port: int = DEFAULT_PORT):
        self.host = host
        self.port = port
        self._sock: socket.socket | None = None
        self._running = False

    def serve_forever(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self._sock.listen(1)
        self._running = True
        log.info("Acceptor started on %s:%d", self.host, self.port)

        while self._running:
            log.info("Awaiting for a connection")
            try:
                conn, addr = self._sock.accept()
            except OSError:
                break
            log.info("Connected: %s", addr)
            try:
                self.serve_client(conn)
            except (ConnectionError, OSError) as e:
                log.info("Client disconnected: %s", e)
            except ValueError as e:
                # A malformed header: the stream cannot be resynced.
                log.error("Protocol error, closing session: %s", e)
            finally:
                conn.close()
            log.info("Disconnected")

    def serve_client(self, conn: socket.socket) -> None:
        session = CommandSession(
            send=lambda msg: write_message(conn, msg),
            recv=lambda: read_message(conn))
        write_message(conn, Message.ok())  # handshake

        while True:
            msg = read_message(conn)
            if msg.type == "command":
                session.handle_command(msg.get_string_data())
            elif msg.type == "status":
                if msg.get_string_data() == "close_session":
                    log.info("Closing session")
                    break
                log.error("Expected a command, got status: %s",
                          msg.get_string_data())
            else:
                log.error("Unexpected message type: %s", msg.type)

    def shutdown(self) -> None:
        """Stop accepting: wakes the acceptor, which then returns."""
        self._running = False
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # not connected: close alone ends the accept
            self._sock.close()


def main(argv=None) -> None:
    import argparse
    p = argparse.ArgumentParser(
        description="ElevenRender render server on PyTorch and CUDA")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--host", default="0.0.0.0")
    args = p.parse_args(argv)
    RenderServer(args.host, args.port).serve_forever()


if __name__ == "__main__":
    main()
