"""The fused ladder's plain version (``ladder.verify_lanes_plain``: -A,
[s]B + [k](-A), add -R, three doublings, the identity test, both decodings)
against the JAX package's verify program lane for lane, the zero-padded
tail lanes of the bucket included (they decode and verify true; only the
host mask vetoes them), on a batch of five signatures per corruption kind
and on the ZIP-215 edge batch; and ``TorchBackend(device="cpu")`` bitmaps
against ``TpuBackend`` on the same batches."""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519
from cometbft_tpu.crypto import ed25519_pure as pure
from cometbft_tpu.ops import ed25519_kernel as jek
from cometbft_tpu.sidecar.backend import TpuBackend
from cometbft_tpu_torch.ops import ed25519_kernel as tek
from cometbft_tpu_torch.ops import edwards as ted
from cometbft_tpu_torch.ops import ladder
from cometbft_tpu_torch.ops import unpack
from cometbft_tpu_torch.sidecar.backend import TorchBackend

pytestmark = pytest.mark.torch_port

L = tek.L
KINDS = ["valid", "bad-sig", "wrong-msg", "s=L+5", "bad-lengths", "oversized"]


@pytest.fixture(scope="module")
def batch5():
    privs = [ed25519.gen_priv_key_from_secret(b"verdict-%d" % i) for i in range(5)]
    msgs = [b"verdict-vote-%d" % i for i in range(5)]
    return [p.pub_key().bytes() for p in privs], msgs, [p.sign(m) for p, m in zip(privs, msgs)]


def _corrupt(batch, kind):
    pubs, msgs, sigs = (list(x) for x in batch)
    if kind == "bad-sig":
        sigs[1] = sigs[1][:20] + bytes([sigs[1][20] ^ 0x40]) + sigs[1][21:]
    elif kind == "wrong-msg":
        msgs[4] = b"tampered"
    elif kind == "s=L+5":
        sigs[3] = sigs[3][:32] + (L + 5).to_bytes(32, "little")
    elif kind == "bad-lengths":
        pubs[0] = pubs[0][:31]
        sigs[2] = sigs[2][:63]
    elif kind == "oversized":
        msgs[2] = b"x" * 5000  # past BLOCK_BUCKETS[-1]: host-hash program
    return pubs, msgs, sigs


def _lane_verdicts(pubs, msgs, sigs):
    """(port lanes, reference lanes, host mask) over the whole bucket."""
    t_ops, host_ok = tek.pack_batch(pubs, msgs, sigs)
    got = tek.verify_operands(tek.operands_to_device(t_ops, "cpu")).numpy()
    j_ops, _ = jek.pack_batch(pubs, msgs, sigs)
    want = np.asarray(jek._compiled(*jek._bucket_key(j_ops))(*j_ops))
    return got, want, host_ok


@pytest.mark.parametrize("kind", KINDS)
def test_lane_verdicts_match_jax_program(batch5, kind):
    pubs, msgs, sigs = _corrupt(batch5, kind)
    got, want, host_ok = _lane_verdicts(pubs, msgs, sigs)
    assert got.shape == (8,) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got[5:].all() and not host_ok[5:].any()
    assert TorchBackend(device="cpu").batch_verify(pubs, msgs, sigs) == (
        TpuBackend().batch_verify(pubs, msgs, sigs)
    )


def _enc_int(y, sign=0):
    return (y | (sign << 255)).to_bytes(32, "little")


def test_zip215_edge_lane_verdicts_match_jax_program():
    """Non-canonical and small-order A/R, a rejected x = 0 with sign 1,
    s-range boundaries and malformed inputs: 12 lanes in a bucket of 32."""
    priv = ed25519.gen_priv_key_from_secret(b"verdict-edge")
    pub, msg = priv.pub_key().bytes(), b"edge-message"
    good = priv.sign(msg)
    P, small = pure.P, (1).to_bytes(32, "little")
    cases = [
        (pub, msg, good),
        (pub, b"tampered", good),
        (pub, msg, good[:32] + L.to_bytes(32, "little")),
        (pub, msg, b"\x11" * 32 + (L - 1).to_bytes(32, "little")),
        (small, msg, small + bytes(32)),
        (pub[:31], msg, good),
        (_enc_int(P - 1), msg, good),
        (_enc_int(1 + P), msg, small + bytes(32)),
        (_enc_int((1 << 255) - 1), msg, good),
        (_enc_int(1, 1), msg, good),
        (_enc_int(0, 1), msg, small + bytes(32)),
        (pub, msg, _enc_int(1, 1) + bytes(32)),
    ]
    pubs, msgs, sigs = (list(c) for c in zip(*cases))
    got, want, host_ok = _lane_verdicts(pubs, msgs, sigs)
    np.testing.assert_array_equal(got, want)
    assert got[len(cases):].all()
    bits = [bool(h and g) for h, g in zip(host_ok, got)][: len(cases)]
    assert bits == [pure.verify_zip215(p, m, s) if len(p) == 32 and len(s) == 64 else False
                    for p, m, s in cases]
    assert bits[0] and bits[4] and bits[7] and not bits[9]


def test_failed_decodings_run_through_and_verify_false():
    """Lanes whose A or R fails to decode still run the whole ladder on
    whatever limbs decompress left, without fault, and come
    out false."""
    rng = np.random.default_rng(11)
    n = 12
    enc = rng.integers(0, 256, (2 * n, 32), dtype=np.uint8)
    words = torch.from_numpy(unpack.bytes_to_words(enc))
    pt, ok = ted.decompress_words(words[:, :n], words[:, n:])
    assert not ok.all() and ok.any()
    digits = torch.from_numpy(rng.integers(-8, 9, (2, 64, n)).astype(np.int32))
    verdict, acc = ladder.verify_lanes(digits[0], digits[1], pt, ok, with_acc=True)
    assert verdict.shape == (n,) and not verdict[~(ok[:n] & ok[n:])].any()
    assert all(c.shape == (17, n) for c in acc)
