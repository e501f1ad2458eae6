"""Wire framing of the data-plane daemon — the frozen v1 protocol.

The port's copy of ``spark_rapids_ml_tpu/serve/protocol.py``, byte for
byte on the wire. Every message is a 4-byte big-endian length prefix and a
payload. A request is one JSON frame, optionally followed by one Arrow IPC
stream frame (``feed``, ``transform``) or by one raw little-endian frame
per array its ``arrays`` spec lists (``feed_raw``, ``ensure_model``). A
response is one JSON frame, optionally followed by one raw frame per array
in its ``arrays`` spec (``finalize``, ``export_state``, ``transform``).
``MAX_FRAME`` bounds a malformed or hostile length prefix.

Every request carries ``"v"``; the daemon rejects a mismatch with a
message naming the version it speaks. ``ping`` is version-exempt and
echoes the server version. ``docs/protocol.md`` is the op-by-op contract
and ``tests/fixtures/protocol_v1*.bin`` the recorded transcripts both
packages' daemons replay.

``send_frame`` is the ``wire.send_frame`` fault site (utils/faults.py): a
``partial`` rule promises the whole frame, sends a prefix, closes the
socket and raises ``InjectedDrop``, as a peer dying mid-frame would. An
unfaulted frame's bytes are unchanged. The reference's wire byte counters
are not part of this copy.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.utils import faults

#: Frozen wire-protocol version: bumped only by a breaking change to an
#: existing op's frames or semantics; new ops are additive under it.
PROTOCOL_VERSION = 1

MAX_FRAME = 1 << 31  # 2 GB: one Spark partition's batch fits comfortably

#: Frames up to this size go out as ONE buffer (prefix + payload, one
#: syscall); larger frames skip the concatenation copy.
_SEND_COALESCE_MAX = 1 << 20

_LEN = struct.Struct(">I")


class ProtocolError(RuntimeError):
    pass


class FrameTooLarge(ProtocolError):
    """Sender-side MAX_FRAME rejection: deterministic (the payload will
    never fit), so retry loops surface it instead of replaying."""


def send_frame(sock, payload: bytes) -> None:
    if len(payload) > MAX_FRAME:
        # fail fast on the sender instead of shipping GBs the peer rejects
        raise FrameTooLarge(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME {MAX_FRAME}; "
            "split the batch"
        )
    faults.checkpoint("wire.send_frame")
    cut = faults.truncation("wire.send_frame", len(payload))
    if cut is not None:
        # Promise the whole frame, deliver a prefix, die: the peer sees what
        # a process death mid-frame leaves on the wire.
        sock.sendall(_LEN.pack(len(payload)))
        sock.sendall(payload[:cut])
        try:
            sock.close()
        except OSError:
            pass
        raise faults.InjectedDrop(f"injected fault: frame truncated at {cut}/{len(payload)} bytes")
    if len(payload) <= _SEND_COALESCE_MAX:
        sock.sendall(_LEN.pack(len(payload)) + payload)
    else:
        sock.sendall(_LEN.pack(len(payload)))
        sock.sendall(payload)


def recv_exact(sock, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None  # peer closed
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock) -> Optional[bytes]:
    header = recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME {MAX_FRAME}")
    return recv_exact(sock, n)


def send_json(sock, obj: Dict[str, Any]) -> None:
    send_frame(sock, json.dumps(obj).encode())


def recv_json(sock) -> Optional[Dict[str, Any]]:
    frame = recv_frame(sock)
    if frame is None:
        return None
    try:
        obj = json.loads(frame)
    except ValueError as e:
        raise ProtocolError(f"bad JSON frame: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"expected JSON object, got {type(obj).__name__}")
    return obj


def send_arrays(sock, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    """JSON header (meta + array specs) then one raw frame per array."""
    spec = [
        {"name": k, "dtype": str(v.dtype), "shape": list(v.shape)}
        for k, v in arrays.items()
    ]
    send_json(sock, {**meta, "arrays": spec})
    for v in arrays.values():
        send_frame(sock, np.ascontiguousarray(v).tobytes())


def recv_arrays(sock, header: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for spec in header.get("arrays", []):
        frame = recv_frame(sock)
        if frame is None:
            raise ProtocolError("connection closed mid-array")
        arr = np.frombuffer(frame, dtype=np.dtype(spec["dtype"]))
        # frombuffer over the received bytes is read-only; callers own the
        # result (model coefficients) and may mutate it: copy.
        out[spec["name"]] = arr.reshape(spec["shape"]).copy()
    return out
