"""The port's native host tier (``cometbft_tpu_torch/native``) against the
reference's (``cometbft_tpu/native``) and the pure oracles: batch Ed25519
bitmaps equal the reference native's and ``verify_zip215``'s on valid,
corrupted, ZIP-215 edge and fuzzed batches; ``merkle_root``,
``merkle_proof_parts`` and ``sha256_batch`` byte-identical to the
reference native's, ``hash_from_byte_slices`` and hashlib; ``CpuBackend``
equal to the reference's on both sides of its native threshold. The C
sources are the reference's byte for byte, and a failed build raises with
gcc's output instead of leaving a host without a verifier."""

import hashlib
import os
import random
import threading
from pathlib import Path

import pytest

from cometbft_tpu import native as ref_native
from cometbft_tpu.crypto import ed25519
from cometbft_tpu.crypto import ed25519_pure as ref_pure
from cometbft_tpu.crypto.merkle import hash_from_byte_slices_iterative
from cometbft_tpu.sidecar.backend import CpuBackend as RefCpuBackend
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import ed25519_pure as pure
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.sidecar.backend import CpuBackend

pytestmark = pytest.mark.torch_port


def _signed(n, seed=b"native"):
    pvs = [ed25519.gen_priv_key_from_secret(seed + b"%d" % i) for i in range(n)]
    msgs = [b"msg-%04d-" % i + bytes([i % 251]) * (i % 37) for i in range(n)]
    sigs = [pv.sign(m) for pv, m in zip(pvs, msgs)]
    pubs = [pv.pub_key().bytes() for pv in pvs]
    return pubs, msgs, sigs


def _both(pubs, msgs, sigs):
    """The port's native bitmap, held equal to the reference native's."""
    got = native.batch_verify(pubs, msgs, sigs)
    assert got == ref_native.batch_verify(pubs, msgs, sigs)
    return got


def test_all_valid_batch():
    ok, bits = _both(*_signed(100))
    assert ok and all(bits) and len(bits) == 100


def test_mixed_batch_bitmap_attribution():
    pubs, msgs, sigs = _signed(64)
    bad = {0, 17, 33, 63}
    sigs = [s if i not in bad else s[:20] + bytes([s[20] ^ 0xFF]) + s[21:] for i, s in enumerate(sigs)]
    ok, bits = _both(pubs, msgs, sigs)
    assert not ok
    assert all(bits[i] == (i not in bad) for i in range(64))


def test_zip215_edge_vectors_match_pure():
    """Non-canonical encodings, small-order points, s-range boundaries and
    malformed lengths: each bit equals both packages' pure ZIP-215 oracle."""
    P, L = pure.P, pure.L

    def enc_int(y, sign=0):
        return (y | (sign << 255)).to_bytes(32, "little")

    priv = ed25519.gen_priv_key_from_secret(b"edge")
    pub = priv.pub_key().bytes()
    msg = b"edge-message"
    good = priv.sign(msg)
    small_order = (1).to_bytes(32, "little")
    cases = [
        ("valid", pub, msg, good),
        ("wrong-msg", pub, b"tampered", good),
        ("corrupt-sig", pub, msg, good[:10] + bytes([good[10] ^ 1]) + good[11:]),
        ("s=L", pub, msg, good[:32] + L.to_bytes(32, "little")),
        ("s=L-1(garbage-R)", pub, msg, b"\x11" * 32 + (L - 1).to_bytes(32, "little")),
        ("s=0 identity-A", small_order, msg, small_order + (0).to_bytes(32, "little")),
        ("bad-pub-len", pub[:31], msg, good),
        ("bad-sig-len", pub, msg, good[:63]),
        ("undecodable-A", enc_int(P - 1, 0), msg, good),
        ("noncanon-identity-A s=0", enc_int(1 + P), msg, small_order + (0).to_bytes(32, "little")),
        ("y>=p-A", enc_int((1 << 255) - 1, 0), msg, good),
        ("x0-sign1-A", enc_int(0, 1), msg, good),
    ]
    _, got = _both([c[1] for c in cases], [c[2] for c in cases], [c[3] for c in cases])
    for (name, p_, m_, s_), bit in zip(cases, got):
        want = pure.verify_zip215(p_, m_, s_)
        assert want == (len(p_) == 32 and len(s_) == 64 and ref_pure.verify_zip215(p_, m_, s_))
        assert bit == want, f"{name}: native={bit} pure={want}"
    assert got[0] is True
    assert got[5] is True, "s=0 with identity A satisfies the cofactored equation"
    assert got[9] is True, "a non-canonical identity alias decodes (ZIP-215 rule 1)"


def test_randomized_bitmap_vs_pure_fuzz():
    rng = random.Random(1234)
    pubs, msgs, sigs = (list(c) for c in _signed(48))
    for i in range(48):
        roll = rng.random()
        if roll < 0.3:
            j = rng.randrange(64)
            sigs[i] = sigs[i][:j] + bytes([sigs[i][j] ^ (1 << rng.randrange(8))]) + sigs[i][j + 1:]
        elif roll < 0.4:
            msgs[i] = msgs[i] + b"x"
        elif roll < 0.5:
            j = rng.randrange(32)
            pubs[i] = pubs[i][:j] + bytes([pubs[i][j] ^ 1]) + pubs[i][j + 1:]
    ok, bits = _both(pubs, msgs, sigs)
    want = [pure.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert bits == want
    assert ok == all(want)


def test_empty_and_single():
    assert _both([], [], []) == (False, [])
    pubs, msgs, sigs = _signed(1)
    assert _both(pubs, msgs, sigs) == (True, [True])
    assert _both(pubs, [b"other"], sigs) == (False, [False])


def test_merkle_root_matches_pure():
    rng = random.Random(99)
    for n in (1, 2, 3, 4, 5, 7, 8, 9, 31, 32, 33, 100, 1000):
        leaves = [rng.randbytes(rng.randrange(0, 150)) for _ in range(n)]
        got = native.merkle_root(leaves)
        assert got == tmerkle.hash_from_byte_slices(leaves) == ref_native.merkle_root(leaves), n
        assert got == hash_from_byte_slices_iterative(leaves), n
    assert native.merkle_root([]) == hashlib.sha256(b"").digest() == ref_native.merkle_root([])


def test_merkle_large_leaves():
    """Leaves past 64 and 1,024 bytes take the copy and streaming paths."""
    leaves = [os.urandom(n) for n in (0, 1, 64, 65, 100, 1024, 1025, 5000)]
    got = native.merkle_root(leaves)
    assert got == tmerkle.hash_from_byte_slices(leaves) == ref_native.merkle_root(leaves)


def test_sha256_batch_matches_hashlib():
    msgs = [os.urandom(n) for n in (0, 1, 55, 56, 63, 64, 65, 119, 120, 200)]
    got = native.sha256_batch(msgs)
    assert got == [hashlib.sha256(m).digest() for m in msgs] == ref_native.sha256_batch(msgs)
    assert native.sha256_batch([]) == []


def test_merkle_proof_parts_match_reference_and_proofs():
    """Every level hashed in one C pass: equal to the reference native's
    parts, and each leaf's aunts are the port's own proof's."""
    rng = random.Random(5)
    for n in (1, 2, 3, 7, 16, 33, 100):
        leaves = [rng.randbytes(rng.randrange(0, 90)) for _ in range(n)]
        got = native.merkle_proof_parts(leaves)
        assert got == ref_native.merkle_proof_parts(leaves), n
        root, leaf_hashes, aunts, stride, counts = got
        want_root, proofs = tmerkle.proofs_from_byte_slices_pure(leaves)
        assert root == want_root
        for i, proof in enumerate(proofs):
            assert leaf_hashes[i] == proof.leaf_hash
            packed = aunts[i * stride : i * stride + 32 * counts[i]]
            assert [packed[32 * k : 32 * k + 32] for k in range(counts[i])] == list(proof.aunts)
    assert native.merkle_proof_parts([]) == ref_native.merkle_proof_parts([])


@pytest.mark.parametrize("n,bad", [(32, {5}), (16, {0, 15}), (15, {3}), (4, set()), (0, set())])
def test_cpu_backend_matches_reference(n, bad):
    """CpuBackend on both sides of its native threshold (16): the native
    MSM above, the pure ZIP-215 oracle one signature at a time below,
    malformed lengths included; the same answer as the reference's."""
    pubs, msgs, sigs = _signed(n)
    for i in bad:
        sigs[i] = b"\x00" * 64
    if n > 3:
        pubs[3] = pubs[3][:31] if 3 in bad else pubs[3]
    got = CpuBackend().batch_verify(pubs, msgs, sigs)
    assert got == RefCpuBackend().batch_verify(pubs, msgs, sigs)
    assert got[1] == [i not in bad for i in range(n)]


def test_cpu_backend_below_threshold_never_calls_native(monkeypatch):
    pubs, msgs, sigs = _signed(15)
    monkeypatch.setattr(native, "batch_verify", lambda *a: pytest.fail("native below 16 signatures"))
    assert CpuBackend().batch_verify(pubs, msgs, sigs) == (True, [True] * 15)
    leaves = [b"leaf-%d" % i for i in range(9)]
    assert CpuBackend().merkle_root(leaves) == tmerkle.hash_from_byte_slices(leaves)


def test_sources_are_the_reference_bytes():
    ref_dir = Path(ref_native.__file__).parent
    for name in native._SOURCES:
        assert (Path(native._HERE) / name).read_bytes() == (ref_dir / name).read_bytes(), name


def _fresh_state(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)


def test_failed_build_raises_with_gcc_output(monkeypatch, tmp_path):
    """A source gcc rejects: the build raises with gcc's message, ready()
    raises after it, and a commit-sized CpuBackend batch raises; none of
    them falls back to another verifier."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native._SOURCES:
        (src / name).write_text("int broken( {\n")
    _fresh_state(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "_HERE", str(src))
    assert native.ready() is None
    with pytest.raises(RuntimeError, match="gcc failed") as info:
        native.load()
    assert "error" in str(info.value)
    with pytest.raises(RuntimeError, match="build failed"):
        native.ready()
    with pytest.raises(RuntimeError, match="build failed"):
        native.merkle_root([b"a"])
    pubs, msgs, sigs = _signed(16)
    with pytest.raises(RuntimeError, match="build failed"):
        CpuBackend().batch_verify(pubs, msgs, sigs)


def test_missing_gcc_raises(monkeypatch, tmp_path):
    _fresh_state(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="gcc not found"):
        native.load()


def test_ensure_built_async_builds_off_thread(monkeypatch, tmp_path):
    """ready() stays non-blocking (None until the library is there); the
    build runs on its own thread and the library it loads serves."""
    _fresh_state(monkeypatch, tmp_path)
    assert native.ready() is None
    native.ensure_built_async()
    compiles = [t for t in threading.enumerate() if t.name == "cmtpu-torch-native-build"]
    for t in compiles:
        t.join(timeout=600)
        assert not t.is_alive()
    assert native.ready() is not None
    assert (tmp_path / "build" / "libcmtpu_native.so").exists()
    assert native.sha256_batch([b"abc"]) == [hashlib.sha256(b"abc").digest()]
