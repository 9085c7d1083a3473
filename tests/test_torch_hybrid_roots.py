"""The hybrid tier's roots: a measured root cost model picks the card or the
native host tree (``HybridBackend._root_on_card``), where the reference
always takes the native tree once it is built.

Run as ``HybridBackend(device="cpu")`` (the card's root on the plain
PyTorch path). Every root, by either tier and through ``merkle_root`` and
``verify_and_root``, is byte-identical to the reference hybrid's and to
``hash_from_byte_slices`` at 0, 1, 2, 33, 1,000 and 65,536 leaves; the
model's choices follow its seeds; a root on the card is launched right
after the device share and leaves the device side of the rate model alone;
``warmup`` times the model.
"""

import pytest
import torch

from cometbft_tpu import native as ref_native
from cometbft_tpu.crypto import ed25519
from cometbft_tpu.crypto.merkle import hash_from_byte_slices
from cometbft_tpu.sidecar import backend as ref_be
from cometbft_tpu_torch import native
from cometbft_tpu_torch.sidecar import backend as be

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def setup_module_state():
    """Both native libraries built (the hybrid sends roots to the card while
    its own builds); one torch thread, as the other hybrid tests."""
    native.load()
    ref_native._load()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, bad=()):
    pvs = [ed25519.gen_priv_key_from_secret(b"roots-%d" % i) for i in range(n)]
    pubs = [pv.pub_key().bytes() for pv in pvs]
    msgs = [b"roots-msg-%d" % i for i in range(n)]
    sigs = [pv.sign(m) for pv, m in zip(pvs, msgs)]
    for i in bad:
        sigs[i] = sigs[i][:-1] + bytes([sigs[i][-1] ^ 1])
    return pubs, msgs, sigs


def _hybrid(monkeypatch, min_split="8"):
    monkeypatch.setenv("CMTPU_HYBRID_MIN", min_split)
    for name in ("CMTPU_DEV_RATE", "CMTPU_HOST_RATE", "CMTPU_DEV_OVERHEAD_MS"):
        monkeypatch.delenv(name, raising=False)
    return be.HybridBackend(device="cpu")


def _ref_hybrid(monkeypatch):
    monkeypatch.setenv("CMTPU_HYBRID_MIN", "8")
    hb = ref_be.HybridBackend()
    hb._n_dev = 1
    return hb


@pytest.mark.parametrize("n", [0, 1, 2, 33, 1000, 65536])
def test_roots_byte_identical_to_reference_on_either_tier(monkeypatch, n):
    leaves = [b"bench-tx-%08d" % i for i in range(n)]
    want = hash_from_byte_slices(leaves)
    assert _ref_hybrid(monkeypatch).merkle_root(leaves) == want
    hb = _hybrid(monkeypatch)
    for on_card in (True, False):
        monkeypatch.setattr(hb, "_root_on_card", lambda k, c=on_card: c)
        assert hb.merkle_root(leaves) == want
        assert hb.last_root == ("card" if on_card else "host")


def test_root_model_follows_its_seeds(monkeypatch):
    """With the seeds, a tree goes to the card exactly where the card's
    fixed cost plus its leaf time undercuts the native tree's."""
    hb = _hybrid(monkeypatch)
    assert (hb._root_fixed, hb._card_leaf_rate, hb._host_leaf_rate) == (
        be.CARD_ROOT_MS, be.CARD_LEAVES_PER_MS, be.HOST_LEAVES_PER_MS)
    cross = be.CARD_ROOT_MS / (1 / be.HOST_LEAVES_PER_MS - 1 / be.CARD_LEAVES_PER_MS)
    assert not hb._root_on_card(0) and not hb._root_on_card(1)
    assert not hb._root_on_card(int(cross) - 1) and hb._root_on_card(int(cross) + 1)
    assert hb._root_on_card(65536)
    hb._host_leaf_rate = 10 * hb._card_leaf_rate  # a host faster than the card keeps every root
    assert not hb._root_on_card(65536)


def test_root_goes_to_the_card_while_the_native_library_builds(monkeypatch):
    hb = _hybrid(monkeypatch)

    class _Building:
        @staticmethod
        def ready():
            return None

    hb._native = _Building()
    assert hb._root_on_card(1)
    leaves = [b"a", b"b", b"c"]
    assert hb.merkle_root(leaves) == hash_from_byte_slices(leaves) and hb.last_root == "card"


@pytest.mark.parametrize("on_card", [True, False])
@pytest.mark.parametrize("n,bad", [(48, (5, 40)), (16, ()), (4, (1,))])
def test_verify_and_root_equals_the_reference(monkeypatch, on_card, n, bad):
    """The bitmap and the root equal the reference hybrid's verify_and_root
    (a split at 48 signatures, all device at 16, the host anchor under the
    minimum at 4), with the root on either tier."""
    pubs, msgs, sigs = _batch(n, bad)
    leaves = [b"leaf-%d" % i for i in range(100)]
    hb = _hybrid(monkeypatch)
    hb._dev_rate, hb._host_rate, hb._dev_overhead = 1000.0, 1000.0, 0.0
    monkeypatch.setattr(hb, "_root_on_card", lambda k: on_card)
    got = hb.verify_and_root(pubs, msgs, sigs, leaves)
    want = ((not bad, [i not in bad for i in range(n)]), hash_from_byte_slices(leaves))
    assert got == want == _ref_hybrid(monkeypatch).verify_and_root(pubs, msgs, sigs, leaves)
    assert hb.last_root == ("card" if on_card else "host")


def test_card_root_is_launched_after_the_device_share_before_the_host_share(monkeypatch):
    """``on_card`` runs right after the device share is submitted, before
    the host's MSM share; its time is kept out of the host rate, and the
    call teaches the device side of the model nothing."""
    hb = _hybrid(monkeypatch)
    order = []
    submit, host_verify = hb._ek.batch_verify_submit, hb._native.batch_verify

    class _Ek:
        BUCKETS = hb._ek.BUCKETS
        bucket_for = staticmethod(hb._ek.bucket_for)

        @staticmethod
        def batch_verify_submit(*a, **k):
            order.append("submit")
            return submit(*a, **k)

    class _Native:
        @staticmethod
        def ready():
            return True

        @staticmethod
        def batch_verify(*a):
            order.append("host")
            return host_verify(*a)

    hb._ek, hb._native = _Ek(), _Native()
    pubs, msgs, sigs = _batch(40, (2, 35))
    walls, rate, bias = dict(hb._dev_wall), hb._dev_rate, hb._bias

    def root():
        order.append("root")
        return b"r"

    (ok, bits), extra = hb._routed_call(pubs, msgs, sigs, 32, on_card=root)
    assert order == ["submit", "root", "host"] and extra == b"r"
    assert bits == [i not in (2, 35) for i in range(40)] and not ok
    assert "card_root_ms" in hb.last_timing
    assert (hb._dev_wall, hb._dev_rate, hb._bias) == (walls, rate, bias)
    order.clear()
    (ok, bits), extra = hb._routed_call(pubs, msgs, sigs, 0, on_card=root)
    assert order == ["root", "host"] and extra == b"r" and hb.last_share == 0


def test_update_rates_without_a_card_root_is_unchanged(monkeypatch):
    """card_root_s 0 (every call but verify_and_root's with the root on the
    card) is the reference's update, bit for bit."""
    hb, ref = _hybrid(monkeypatch), _ref_hybrid(monkeypatch)
    for b in (hb, ref):
        b._dev_rate, b._host_rate, b._dev_overhead, b._bias = 500.0, 50.0, 1.0, 1
        b._warmed.add((32, 2, 1))
    args = ((32, 2), 32, 16, 0.0, 0.004, 0.010, 0.011, 0.020)
    hb._update_rates(*args)
    ref._update_rates(*args)
    assert (hb._dev_rate, hb._host_rate, hb._bias, hb._dev_wall) == (
        ref._dev_rate, ref._host_rate, ref._bias, ref._dev_wall)


def test_warmup_times_the_root_model(monkeypatch):
    """warmup times one root each way at each of its leaf counts: on the
    CPU the plain path's card root is far slower than the native tree, so
    the model keeps even the larger tree on the host."""
    hb = _hybrid(monkeypatch)
    hb.warmup(buckets=(8,), merkle_leaves=(16, 64))
    assert (hb._root_fixed, hb._card_leaf_rate, hb._host_leaf_rate) != (
        be.CARD_ROOT_MS, be.CARD_LEAVES_PER_MS, be.HOST_LEAVES_PER_MS)
    assert hb._root_fixed >= 0 and hb._card_leaf_rate > 0 and hb._host_leaf_rate > 0
    assert not hb._root_on_card(64)
    hb._time_roots((64,))  # one count: the card's rate over the fixed cost it has
    assert hb._card_leaf_rate > 0
