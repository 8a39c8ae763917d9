"""Gateway wire protocol (counterpart of daft_tpu/gateway/protocol.py, byte
for byte: a reference client reads the port's server and the other way
round): length-framed TCP, explicit length prefixes, no pickle (gateway
clients are untrusted: nothing on this wire is ever unpickled).

Frame layout (everything big-endian)::

    +----------------+-----+----------------------+
    | length: u32    | tag | payload (length - 1) |
    +----------------+-----+----------------------+

``tag`` is one byte: ``J`` — a UTF-8 JSON control object (requests, replies,
typed errors); ``B`` — a binary payload chunk (one self-contained compressed
Arrow IPC stream holding one result batch, written and read by the port's
own io/arrow_ipc.py). A fetch reply is zero or more
``B`` frames followed by one terminal ``J`` frame; every other exchange is
one ``J`` request -> one ``J`` reply.

Verbs (client -> server, all ``J``)::

    {"verb": "hello", "tenant": t, "token": s}   auth; must be first
    {"verb": "prepare", "sql": q}                -> {"ok", "handle", ...}
    {"verb": "execute", "sql"|"handle": ...}     -> {"ok", "query_id", ...}
    {"verb": "fetch", "query_id": id}            -> B* then {"ok", "done", ...}
    {"verb": "cancel", "query_id": id}           -> {"ok", "cancelled"}
    {"verb": "stats"}                            -> {"ok", "metrics", ...}
    {"verb": "bye"}                              closes the connection

Error replies are ``{"ok": false, "code": c, "error": msg}`` with a stable
code vocabulary (``bad_token``, ``bad_frame``, ``frame_too_large``,
``unknown_handle``, ``unknown_query``, ``over_capacity``, ``cancelled``,
``exec_error``, ``bad_request``, ``unknown_verb``) so clients branch on the
code, never on message text.

Defensive bounds: frames larger than ``DAFT_TPU_GATEWAY_MAX_FRAME`` are
refused with a typed error before any allocation (a bogus length prefix can
never balloon server memory), and a connection that dies mid-frame raises a
clean :class:`WireError` instead of feeding a torn payload downstream.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils.env import env_int, env_str

TAG_JSON = b"J"
TAG_BINARY = b"B"

_LEN = struct.Struct(">I")


def max_frame_bytes() -> int:
    """DAFT_TPU_GATEWAY_MAX_FRAME: largest frame either side accepts (bytes);
    floor 64 KiB so a control frame always fits."""
    return env_int("DAFT_TPU_GATEWAY_MAX_FRAME", 64 * 1024 * 1024,
                   lo=64 * 1024)


class WireError(Exception):
    """A typed wire-protocol failure. ``code`` is from the stable error
    vocabulary above; raised client-side for error replies and server-side
    for malformed traffic (the server answers it as a typed error frame)."""

    def __init__(self, code: str, message: str):
        self.code = code
        super().__init__(message)


# GatewayError is the client-facing name for the same condition — one class
# so `except GatewayError as e: e.code` works symmetrically on either side.
GatewayError = WireError


def parse_token_map(raw: Optional[str] = None) -> Dict[str, str]:
    """DAFT_TPU_GATEWAY_TOKENS -> {tenant: token}. Format:
    ``tenant:token,tenant2:token2``. An empty/unset map selects OPEN mode
    (any tenant accepted — development and tests only; production deployments
    set the map). Malformed entries are skipped, not fatal: a typo'd entry
    locks out one tenant, never the whole gateway."""
    raw = env_str("DAFT_TPU_GATEWAY_TOKENS", "") if raw is None else raw
    out: Dict[str, str] = {}
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry or ":" not in entry:
            continue
        tenant, token = entry.split(":", 1)
        if tenant:
            out[tenant] = token
    return out


# ---- framing ------------------------------------------------------------------------

def send_frame(sock, tag: bytes, payload: bytes) -> None:
    """One frame on the wire. sendall provides the stream's backpressure: a
    client that stops reading stalls the server's send buffer, which stalls
    the fetch loop — no unbounded server-side buffering."""
    sock.sendall(_LEN.pack(len(payload) + 1) + tag)
    if payload:
        sock.sendall(payload)


def send_json(sock, obj: dict) -> None:
    send_frame(sock, TAG_JSON, json.dumps(obj).encode())


def send_error(sock, code: str, message: str) -> None:
    send_json(sock, {"ok": False, "code": code, "error": message})


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise WireError(
                "bad_frame",
                f"connection closed mid-frame ({len(buf)} of {n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock, max_frame: Optional[int] = None) -> Tuple[bytes, bytes]:
    """Read one frame -> (tag, payload). Raises EOFError on a clean
    between-frames close (the peer said everything it had to say) and
    :class:`WireError` on truncation or an oversized/underssized length
    prefix — torn frames never propagate as data."""
    head = b""
    try:
        head = sock.recv(_LEN.size)
    except OSError as e:
        raise WireError("bad_frame", f"socket error reading frame: {e}")
    if not head:
        raise EOFError("connection closed")
    if len(head) < _LEN.size:
        head += _recv_exact(sock, _LEN.size - len(head))
    (length,) = _LEN.unpack(head)
    cap = max_frame_bytes() if max_frame is None else max_frame
    if length > cap:
        raise WireError("frame_too_large",
                        f"frame of {length} bytes exceeds the "
                        f"{cap}-byte cap (DAFT_TPU_GATEWAY_MAX_FRAME)")
    if length < 1:
        raise WireError("bad_frame", "zero-length frame (missing tag byte)")
    body = _recv_exact(sock, length)
    return body[:1], body[1:]


def recv_json(sock, max_frame: Optional[int] = None) -> dict:
    tag, payload = recv_frame(sock, max_frame)
    if tag != TAG_JSON:
        raise WireError("bad_frame",
                        f"expected a JSON control frame, got tag {tag!r}")
    try:
        obj = json.loads(payload.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise WireError("bad_frame", f"undecodable control frame: {e}")
    if not isinstance(obj, dict):
        raise WireError("bad_frame", "control frame must be a JSON object")
    return obj


# ---- Arrow IPC payload codec ------------------------------------------------------

def encode_result_chunks(parts: List) -> List[bytes]:
    """MicroPartitions -> wire chunks: one self-contained Arrow IPC stream
    per non-empty batch, in ExecutionConfig.shuffle_compression's codec
    (it travels in the IPC message headers, so the client negotiates
    nothing). Per-batch framing bounds every frame by the engine's morsel
    size and lets the client decode chunk k while chunk k+1 is on the
    wire."""
    from ..config import execution_config
    from ..io.arrow_ipc import encode_stream

    compression = execution_config().shuffle_compression
    return [encode_stream([b], b.schema, compression)
            for part in parts for b in part.batches if b.num_rows > 0]


def decode_result_chunk(payload: bytes) -> Iterator:
    """One wire chunk -> the port's RecordBatches (the codec rides the
    message headers)."""
    from ..io.arrow_ipc import iter_ipc_batches

    yield from iter_ipc_batches(payload)
