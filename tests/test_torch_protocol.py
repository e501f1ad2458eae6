"""The PyTorch port's wire protocol against the JAX package's frozen v1.

* Framing: the port's ``send_*`` and the reference's write identical bytes
  over a socket pair, and each side's ``recv_*`` reads the other's output.
* The frozen transcripts (``tests/fixtures/protocol_v1*.bin``): the port's
  daemon replays the PCA prefix of each, request frames as recorded, and
  answers every checked field as the reference's generator expects, with
  the reference test's numeric checks (``pc`` against a float64 oracle at
  atol 1e-8, eager against partitioned at 1e-12, the served transform at
  1e-10). The replay stops at the first request outside the port's slice
  (another algo, or an op the port's daemon does not serve yet). The PCA
  and serving prefixes replay with the serving scheduler on (the default)
  and off: the default must not change a byte of the answers' fields.
"""

import json
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.serve import protocol as jax_protocol
from spark_rapids_ml_tpu_torch import config
from spark_rapids_ml_tpu_torch.serve import DataPlaneDaemon
from spark_rapids_ml_tpu_torch.serve import protocol
from tests.make_protocol_golden import (
    FIXTURE,
    FIXTURE_MULTIHOST,
    FIXTURE_SERVING,
    golden_matrix,
    golden_pc,
    multihost_transcript_frames,
    serving_transcript_frames,
    transcript_frames,
)

torch.set_num_threads(2)

_MESSAGES = {
    "json": ("json", {"v": 1, "op": "feed", "job": "j", "partition": None, "ü": [1.5, 2]}),
    "frame": ("frame", b"\x00\x01payload" * 3),
    "big_frame": ("frame", bytes(range(256)) * 5000),  # past the coalescing size
    "arrays": ("arrays", {"pc": np.arange(6.0).reshape(3, 2),
                          "x": np.arange(12, dtype=np.float32).reshape(4, 3),
                          "n": np.asarray([7], np.int64)}),
}


def _send(mod, sock, kind, msg):
    if kind == "json":
        mod.send_json(sock, msg)
    elif kind == "frame":
        mod.send_frame(sock, msg)
    else:
        mod.send_arrays(sock, msg, {"ok": True, "rows": 4})


def _recv(mod, sock, kind):
    if kind == "json":
        return mod.recv_json(sock)
    if kind == "frame":
        return mod.recv_frame(sock)
    header = mod.recv_json(sock)
    return header, mod.recv_arrays(sock, header)


def _sending(mod, sock, kind, msg) -> threading.Thread:
    """Send on a thread: a frame past the socket buffer blocks its writer
    until the other end reads."""

    def send():
        _send(mod, sock, kind, msg)
        sock.shutdown(socket.SHUT_WR)

    t = threading.Thread(target=send, daemon=True)
    t.start()
    return t


def _written(mod, kind, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        b.settimeout(10)
        t = _sending(mod, a, kind, msg)
        chunks = []
        while chunk := b.recv(1 << 20):
            chunks.append(chunk)
        t.join(timeout=10)
        assert not t.is_alive()
        return b"".join(chunks)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("name", sorted(_MESSAGES))
def test_port_and_reference_write_identical_bytes(name):
    kind, msg = _MESSAGES[name]
    assert _written(protocol, kind, msg) == _written(jax_protocol, kind, msg)


@pytest.mark.parametrize("name", sorted(_MESSAGES))
@pytest.mark.parametrize("sender, receiver", [(protocol, jax_protocol), (jax_protocol, protocol)],
                         ids=["port_to_reference", "reference_to_port"])
def test_each_side_reads_the_other(name, sender, receiver):
    kind, msg = _MESSAGES[name]
    a, b = socket.socketpair()
    try:
        b.settimeout(10)
        t = _sending(sender, a, kind, msg)
        got = _recv(receiver, b, kind)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()
    if kind == "arrays":
        header, arrays = got
        assert header["ok"] is True and header["rows"] == 4
        assert list(arrays) == list(msg)
        for key, want in msg.items():
            assert arrays[key].dtype == want.dtype
            np.testing.assert_array_equal(arrays[key], want)
            arrays[key][...] = 0  # copy-on-receive: the caller owns them
    else:
        assert got == msg


class _Huge:
    """A payload that claims more than MAX_FRAME bytes (nothing allocated)."""

    def __len__(self):
        return protocol.MAX_FRAME + 1


@pytest.mark.parametrize("mod", [protocol, jax_protocol], ids=["port", "reference"])
def test_frame_too_large_raised_by_sender(mod):
    a, b = socket.socketpair()
    try:
        with pytest.raises(mod.FrameTooLarge, match="MAX_FRAME"):
            mod.send_frame(a, _Huge())
        assert issubclass(mod.FrameTooLarge, mod.ProtocolError)
    finally:
        a.close()
        b.close()


def test_oversized_prefix_and_bad_json_raise_protocol_error():
    a, b = socket.socketpair()
    try:
        b.settimeout(10)
        a.sendall(struct.pack(">I", protocol.MAX_FRAME + 1))
        with pytest.raises(protocol.ProtocolError, match="exceeds MAX_FRAME"):
            protocol.recv_frame(b)
    finally:
        a.close()
        b.close()
    for payload, match in ((b"{not json", "bad JSON"), (b"[1, 2]", "expected JSON object")):
        a, b = socket.socketpair()
        try:
            b.settimeout(10)
            protocol.send_frame(a, payload)
            with pytest.raises(protocol.ProtocolError, match=match):
                protocol.recv_json(b)
        finally:
            a.close()
            b.close()


def test_constants_are_the_frozen_ones():
    assert protocol.PROTOCOL_VERSION == jax_protocol.PROTOCOL_VERSION == 1
    assert protocol.MAX_FRAME == jax_protocol.MAX_FRAME == 1 << 31
    assert protocol._SEND_COALESCE_MAX == jax_protocol._SEND_COALESCE_MAX


# ---------------------------------------------------------------------------
# Frozen transcripts
# ---------------------------------------------------------------------------

#: Ops of the port's daemon; with "algo" absent or "pca".
_SLICE_OPS = {"ping", "feed", "feed_raw", "commit", "status", "drop", "finalize",
              "export_state", "ensure_model", "model_status", "transform", "drop_model"}


def _recorded_requests(path):
    """The committed byte stream, frame by frame (4-byte big-endian
    prefix), grouped into (request JSON, its frames' bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    frames, i = [], 0
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        frames.append(data[i:i + 4 + n])
        i += 4 + n
    assert i == len(data), "fixture truncated mid-frame"
    requests, i = [], 0
    while i < len(frames):
        req = json.loads(frames[i][4:])
        if req["op"] in ("feed", "seed", "transform", "kneighbors"):
            extra = 1
        else:
            extra = len(req.get("arrays") or [])
        requests.append((req, b"".join(frames[i:i + 1 + extra])))
        i += 1 + extra
    return requests


def _replay_prefix(path, expect, n_expected, batching=None):
    """Send the recorded requests up to the first one outside the slice to a
    port daemon on the CPU (float64; ``batching``: its serving scheduler,
    None the config default) and check the generator's expectations for
    them; returns the array payloads of the "arrays" responses."""
    requests = _recorded_requests(path)
    assert len(requests) == len(expect)
    stop = next(i for i, (req, _) in enumerate(requests)
                if req["op"] not in _SLICE_OPS or req.get("algo", "pca") != "pca")
    assert stop == n_expected
    with config.option("compute_dtype", "float64"), config.option("accum_dtype", "float64"):
        with DataPlaneDaemon(device="cpu", serve_batching=batching) as daemon:
            sock = socket.create_connection(daemon.address, timeout=60)
            try:
                sock.sendall(b"".join(raw for _, raw in requests[:stop]))
                results = []
                for kind, checks in expect[:stop]:
                    resp = protocol.recv_json(sock)
                    assert resp is not None, "daemon closed mid-transcript"
                    for key, want in checks.items():
                        assert resp.get(key) == want, f"response {resp}: {key}={want!r}"
                    if kind == "arrays":
                        results.append(protocol.recv_arrays(sock, resp))
            finally:
                sock.close()
    return results


def _pc_oracle(k):
    x = golden_matrix()
    xc = x - x.mean(axis=0)
    evals, evecs = np.linalg.eigh(xc.T @ xc / (x.shape[0] - 1))
    return evecs[:, np.argsort(evals)[::-1][:k]]


@pytest.mark.parametrize("batching", [True, False], ids=["batching_on", "batching_off"])
def test_replay_golden_transcript_pca_prefix(batching):
    """protocol_v1.bin from ping to the two PCA finalizes (10 responses),
    stopping before the kmeans seed."""
    _, expect = transcript_frames()
    eager, part = _replay_prefix(FIXTURE, expect, 10, batching)
    for arrays in (eager, part):
        assert arrays["pc"].shape == (3, 2)
        np.testing.assert_allclose(np.abs(arrays["pc"]), np.abs(_pc_oracle(2)), atol=1e-8)
    np.testing.assert_allclose(eager["pc"], part["pc"], atol=1e-12)
    assert set(eager) == {"pc", "explained_variance", "sigma", "mean"}


@pytest.mark.parametrize("batching", [True, False], ids=["batching_on", "batching_off"])
def test_replay_serving_transcript_pca_prefix(batching):
    """protocol_v1_serving.bin: both ensure_models, model_status and the
    transform (4 responses), stopping before the knn feed."""
    _, expect = serving_transcript_frames()
    (out,) = _replay_prefix(FIXTURE_SERVING, expect, 4, batching)
    np.testing.assert_allclose(out["output"], golden_matrix() @ golden_pc(), atol=1e-10)


def test_replay_multihost_transcript_pca_prefix():
    """protocol_v1_multihost.bin: the feed_raw PCA jobs and commits,
    export_state and both finalizes (8 responses), stopping before the
    linreg feed_raw."""
    _, expect = multihost_transcript_frames()
    export, raw, raw2 = _replay_prefix(FIXTURE_MULTIHOST, expect, 8)
    x = golden_matrix()
    assert float(export["s0"]) == 8.0
    np.testing.assert_allclose(export["s1"], x.sum(axis=0), atol=1e-12)
    np.testing.assert_allclose(export["s2"], x.T @ x, atol=1e-12)
    np.testing.assert_allclose(raw["pc"], raw2["pc"], atol=1e-12)
    np.testing.assert_allclose(np.abs(raw["pc"]), np.abs(_pc_oracle(2)), atol=1e-8)
