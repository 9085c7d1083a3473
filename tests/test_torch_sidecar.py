"""The port's sidecar server on the CPU: ``SidecarServer`` serving
``TorchBackend(device="cpu")`` over the framed protocol, driven by the
reference's ``GrpcBackend`` (what a node runs with ``CMTPU_BACKEND=grpc``)
and by the port's copy of it. Bitmaps equal the in-process ones bit for
bit, unary and streamed; roots equal the oracle; a bad request fails alone;
an oversized frame draws an error on a connection that survives it;
requests from several connections coalesce; ``CMTPU_SIDECAR_DEVICE`` takes
``torch`` or ``cpu`` and nothing else; ``shutdown()`` ends every thread the
server started. Servers bind port 0 and are dialled at ``bound_addr``.
Batches stay at 16 signatures or fewer (the plain path on the CPU)."""

import functools
import hashlib
import os
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from cometbft_tpu.sidecar.service import GrpcBackend as RefGrpcBackend
from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.sidecar import service
from cometbft_tpu_torch.sidecar.backend import TorchBackend, device_backend
from cometbft_tpu_torch.sidecar.service import GrpcBackend, SidecarServer
from cometbft_tpu_torch.wire import proto

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
CLIENTS = {"reference": RefGrpcBackend, "port": GrpcBackend}


@pytest.fixture(autouse=True)
def _one_thread():
    """Eight PyTorch threads a worker oversubscribe the cores under xdist."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def server():
    srv = SidecarServer("127.0.0.1:0", backend=TorchBackend(device="cpu")).start()
    yield srv
    srv.shutdown()


@functools.lru_cache(maxsize=None)
def _signed(n, tag=b"sidecar"):
    seeds = [hashlib.sha256(b"%s-key-%d" % (tag, i)).digest() for i in range(n)]
    pubs = [pure.public_key(s) for s in seeds]
    msgs = [b"%s-vote-%d" % (tag, i) for i in range(n)]
    return pubs, msgs, [pure.sign(s, p, m) for s, p, m in zip(seeds, pubs, msgs)]


def _corrupt(sigs, bad):
    sigs = list(sigs)
    for i in bad:
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    return sigs


def _raw_call(sock, req_id, method, payload=b""):
    req = service._encode_request(req_id, method, payload)
    sock.sendall(struct.pack(">I", len(req)) + req)
    return proto.decode_fields(service.read_frame(sock))


def test_ping_capabilities(server):
    host, port = server.bound_addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as sock:
        fields = _raw_call(sock, 3, "Ping")
    assert proto.get_uvarint(fields, 1) == 3 and proto.get_bool(fields, 2)
    pong = proto.decode_fields(proto.get_bytes(fields, 4))
    assert proto.get_bytes(pong, 1) == b"pong"
    assert proto.get_uvarint(pong, 2) == 1  # mesh width
    assert proto.get_uvarint(pong, 3) == 1  # streaming
    assert proto.get_uvarint(pong, 4) == ek.preferred_stream_chunk() == 1024
    for make in CLIENTS.values():
        client = make(server.bound_addr, timeout_s=60)
        try:
            assert client.ping() and client.mesh_width() == 1
            assert client.counters()["streaming"] is True and client.chunk_size() == 1024
        finally:
            client.close()


@pytest.mark.parametrize("client_kind", sorted(CLIENTS))
def test_batch_verify_unary_and_streamed(server, monkeypatch, client_kind):
    """Unary, then streamed in chunks of 4 with corrupted lanes on both
    sides of a chunk edge: the in-process bitmap, bit for bit."""
    pubs, msgs, sigs = _signed(10)
    bad = _corrupt(sigs, (3, 4, 9))
    local = TorchBackend(device="cpu")
    want_good, want_bad = local.batch_verify(pubs, msgs, sigs), local.batch_verify(pubs, msgs, bad)
    assert want_good == (True, [True] * 10)
    assert want_bad == (False, [i not in (3, 4, 9) for i in range(10)])
    client = CLIENTS[client_kind](server.bound_addr, timeout_s=120)
    try:
        assert client.batch_verify(pubs[:8], msgs[:8], bad[:8]) == (False, want_bad[1][:8])
        assert client.counters()["unary_calls"] == 1
        monkeypatch.setenv("CMTPU_SIDECAR_CHUNK", "4")
        assert client.batch_verify(pubs, msgs, bad) == want_bad
        assert client.batch_verify(pubs, msgs, sigs) == want_good
        c = client.counters()
        assert c["unary_calls"] == 1 and c["streamed_calls"] == 2 and c["streamed_chunks"] == 6
    finally:
        client.close()


@pytest.mark.parametrize("client_kind", sorted(CLIENTS))
def test_merkle_root_equals_oracle(server, client_kind):
    client = CLIENTS[client_kind](server.bound_addr, timeout_s=60)
    try:
        for n in (1, 100):
            leaves = [b"leaf-%d" % i * (i % 3) for i in range(n)]
            assert client.merkle_root(leaves) == hash_from_byte_slices(leaves)
    finally:
        client.close()


def test_request_errors_are_isolated(server):
    client = GrpcBackend(server.bound_addr, timeout_s=60)
    try:
        with pytest.raises(RuntimeError, match="length mismatch"):
            client.batch_verify([b"\x00" * 32], [], [])
        with pytest.raises(RuntimeError, match="unknown method"):
            client._call("Nope", b"")
        with pytest.raises(RuntimeError, match="ValueError"):
            client._call("MerkleRoot", b"\x0a\xff")  # a truncated field
        assert client.ping()  # the connection survives each
        pubs, msgs, sigs = _signed(2)
        assert client.batch_verify(pubs, msgs, _corrupt(sigs, (1,))) == (False, [True, False])
    finally:
        client.close()


def test_legacy_unary_client(server):
    """A client that knows nothing of streaming: one framed BatchVerify,
    built by hand, through the server-side scheduler."""
    pubs, msgs, sigs = _signed(12)
    sigs = _corrupt(sigs, (5,))
    payload = b"".join(
        proto.field_bytes(k, v, emit_default=True)
        for k, col in ((1, pubs), (2, msgs), (3, sigs))
        for v in col
    )
    host, port = server.bound_addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=120) as sock:
        fields = _raw_call(sock, 9, "BatchVerify", payload)
    assert proto.get_uvarint(fields, 1) == 9 and proto.get_bool(fields, 2)
    out = proto.decode_fields(proto.get_bytes(fields, 4))
    assert not proto.get_bool(out, 1)
    assert [bool(b) for b in proto.get_bytes(out, 2)] == [i != 5 for i in range(12)]


def test_server_coalesces_across_connections(monkeypatch):
    """Concurrent connections merge into one dispatch, bitmaps sliced per
    request, identical triples sharing lanes."""
    monkeypatch.setenv("CMTPU_COALESCE_WINDOW_MS", "500")
    srv = SidecarServer("127.0.0.1:0", backend=TorchBackend(device="cpu")).start()
    clients = [GrpcBackend(srv.bound_addr, timeout_s=120) for _ in range(3)]
    pubs, msgs, sigs = _signed(6)
    sigs = _corrupt(sigs, (2,))
    results, errors = [], []

    def worker(cl):
        try:
            results.append(cl.batch_verify(pubs, msgs, sigs))
        except Exception as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        assert results == [(False, [i != 2 for i in range(6)])] * 3
        c = srv.scheduler_counters()
        assert c["requests"] == 3
        assert c["coalesced_dispatches"] >= 1 and c["batched_requests"] >= 2
        assert c["dedup_sigs"] >= 6
    finally:
        for cl in clients:
            cl.close()
        srv.shutdown()


def test_oversized_frame_draws_an_error_and_the_connection_survives(monkeypatch, server):
    monkeypatch.setenv("CMTPU_SIDECAR_MAX_FRAME", "2048")

    class NeverSock:
        def sendall(self, data):
            raise AssertionError("an oversized frame reached the socket")

    with pytest.raises(service.FrameTooLarge, match="refusing to send"):
        service.write_frame(NeverSock(), b"\x00" * 4096)
    host, port = server.bound_addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=10) as sock:
        sock.sendall(struct.pack(">I", 4096) + b"\x00" * 4096)
        fields = proto.decode_fields(service.read_frame(sock))
        assert not proto.get_bool(fields, 2)
        assert "FrameTooLarge" in proto.get_string(fields, 3)
        fields = _raw_call(sock, 7, "Ping")
        assert proto.get_uvarint(fields, 1) == 7 and proto.get_bool(fields, 2)


def test_sidecar_device_env(monkeypatch):
    monkeypatch.setenv("CMTPU_SIDECAR_DEVICE", "cpu")
    srv = SidecarServer("127.0.0.1:0")
    try:
        assert isinstance(srv.backend, TorchBackend) and srv.backend.device.type == "cpu"
    finally:
        srv.shutdown()
    for choice in ("cuda", "auto", "tpu"):
        monkeypatch.setenv("CMTPU_SIDECAR_DEVICE", choice)
        with pytest.raises(ValueError, match="sidecar device"):
            SidecarServer("127.0.0.1:0")
    if torch.cuda.is_available():
        assert device_backend().device.type == "cuda"
        return
    monkeypatch.delenv("CMTPU_SIDECAR_DEVICE")
    with pytest.raises(RuntimeError, match="CUDA"):
        SidecarServer("127.0.0.1:0")
    monkeypatch.setenv("CMTPU_SIDECAR_DEVICE", "torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        SidecarServer("127.0.0.1:0")


def test_warmup_and_shutdown_stop_every_thread():
    """Warmup answers (the plain path has nothing to build); shutdown ends
    the handler threads, an open connection's included, and the
    scheduler's dispatcher."""
    before = set(threading.enumerate())
    srv = SidecarServer("127.0.0.1:0", backend=TorchBackend(device="cpu")).start()
    client = GrpcBackend(srv.bound_addr, timeout_s=60)
    client.warmup((8,))
    pubs, msgs, sigs = _signed(4)
    assert client.batch_verify(pubs, msgs, sigs) == (True, [True] * 4)
    srv.shutdown()
    client.close()
    for t in set(threading.enumerate()) - before:
        if t.name != "cmtpu-torch-dev":  # the process-wide device owner
            t.join(timeout=10)
    left = {t.name for t in set(threading.enumerate()) - before if t.is_alive()}
    assert left <= {"cmtpu-torch-dev"}, left


def test_main_serves_until_killed():
    """``python -m cometbft_tpu_torch.sidecar`` on the plain path: it prints
    its bound address and answers a client there."""
    env = dict(os.environ, CMTPU_SIDECAR_ADDR="127.0.0.1:0", CMTPU_SIDECAR_DEVICE="cpu",
               CMTPU_SIDECAR_WARM="0")
    proc = subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.sidecar"], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("sidecar: serving on "), (line, proc.stderr.read())
        addr = line.split()[3]
        client = GrpcBackend(addr, timeout_s=60)
        try:
            assert client.ping()
            assert client.merkle_root([b"a", b"b", b"c"]) == hash_from_byte_slices([b"a", b"b", b"c"])
        finally:
            client.close()
    finally:
        proc.kill()
        proc.wait(timeout=30)
