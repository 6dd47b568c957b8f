"""Wire protocol: 1024-byte JSON header + raw payload.  The port's copy
of ``elevenrender_tpu/server/protocol.py``.

Exact format parity with the reference so existing clients (the Blender
plug-in) work unchanged:
- header: JSON {"type", "data_format", "data_size"} zero-padded to 1024
  bytes (MESSAGE_HEADER_SIZE, Managers.h:14; padding TCPInterface.cpp:11),
- types: none|command|status|data (Managers.cpp:42-61),
- formats: none|float3|float4|string|json (Managers.cpp:82-104),
- then data_size raw bytes (TCPInterface.cpp:45-50).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

MESSAGE_HEADER_SIZE = 1024
# Largest accepted payload (2 GiB): a 16k x 16k float4 texture is ~4 GiB,
# but single messages beyond this are rejected as hostile/corrupt.
MAX_DATA_SIZE = 2 << 30

TYPES = ("none", "command", "status", "data")
FORMATS = ("none", "float3", "float4", "string", "json")


@dataclasses.dataclass
class Message:
    type: str = "none"
    data_format: str = "none"
    data: bytes = b""

    # -- constructors (Managers.h:113-129) --------------------------------
    @staticmethod
    def ok() -> "Message":
        return Message("status", "string", b"ok")

    @staticmethod
    def close_session() -> "Message":
        return Message("status", "string", b"close_session")

    @staticmethod
    def command(cmd: str) -> "Message":
        return Message("command", "string", cmd.encode())

    @staticmethod
    def json_msg(obj: dict, type: str = "data") -> "Message":
        return Message(type, "json", json.dumps(obj).encode())

    @staticmethod
    def float_data(arr: np.ndarray, fmt: str = "float4") -> "Message":
        return Message("data", fmt,
                       np.ascontiguousarray(arr, np.float32).tobytes())

    # -- payload accessors (Managers.cpp:130-164) --------------------------
    def get_string_data(self) -> str:
        return self.data.split(b"\x00", 1)[0].decode("utf-8", "replace")

    def get_json_data(self) -> dict:
        return json.loads(self.get_string_data())

    def get_float_data(self) -> np.ndarray:
        return np.frombuffer(self.data, np.float32)

    # -- header (Managers.cpp:167-177 / 6-17) ------------------------------
    def header_bytes(self) -> bytes:
        hdr = json.dumps({
            "type": self.type,
            "data_format": self.data_format,
            "data_size": len(self.data),
        }).encode()
        if len(hdr) > MESSAGE_HEADER_SIZE:
            raise ValueError("TCP header size exceeded")
        return hdr + b"\x00" * (MESSAGE_HEADER_SIZE - len(hdr))

    @staticmethod
    def parse_header(raw: bytes) -> tuple["Message", int]:
        """Raises ValueError on a malformed or hostile header (bad JSON,
        negative or absurd data_size) — the stream cannot be resynced
        after a corrupt header, so the session must close; the acceptor
        survives and re-accepts (tcp.py).  The reference reads data_size
        blindly (TCPInterface.cpp:45-50) — a DoS hardening superset."""
        try:
            obj = json.loads(raw.split(b"\x00", 1)[0].decode("utf-8"))
            size = int(obj.get("data_size", 0))
        except (ValueError, UnicodeDecodeError, AttributeError) as e:
            raise ValueError(f"malformed message header: {e}") from e
        if not isinstance(obj, dict):
            raise ValueError("malformed message header: not a JSON object")
        if size < 0 or size > MAX_DATA_SIZE:
            raise ValueError(f"unreasonable data_size {size}")
        msg = Message(type=str(obj.get("type", "none")),
                      data_format=str(obj.get("data_format", "none")))
        return msg, size


# -- sync socket IO (client-side helper + tests) ---------------------------

def write_message(sock, msg: Message) -> None:
    sock.sendall(msg.header_bytes())
    if msg.data:
        sock.sendall(msg.data)


def _read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("EOF")
        buf += chunk
    return buf


def read_message(sock) -> Message:
    msg, size = Message.parse_header(_read_exact(sock, MESSAGE_HEADER_SIZE))
    if size:
        msg.data = _read_exact(sock, size)
    return msg
