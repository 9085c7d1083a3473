"""The proofs path's selection (``crypto/merkle.proofs_from_byte_slices``)
against the reference's ``crypto/merkle/proof.py``.

Every path gives the reference's root and proofs at 13 sizes: the card
(``CMTPU_DEVICE_PROOFS=1``, here ``device="cpu"``, the levels entry's plain
version), the native host pass (``=0``, served lazily as ``_LazyProofs``),
pure Python (under 32 items, or while the native library builds) and the
empty tree; ``last_proofs_path`` names each. Unset, the variable takes
``DEVICE_PROOFS_DEFAULT``'s path. A failed native build raises, and the
device path's own empty tree does not come back through the selector.
"""

import random

import pytest

from cometbft_tpu.crypto.merkle import proofs_from_byte_slices as ref_proofs
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import merkle as host
from cometbft_tpu_torch.ops import merkle_kernel as tmk

pytestmark = pytest.mark.torch_port

SIZES = (0, 1, 2, 3, 7, 31, 32, 33, 64, 100, 255, 256, 1000)


@pytest.fixture(scope="module", autouse=True)
def native_built():
    native.load()


def _items(n, seed=3):
    rng = random.Random(seed + n)
    return [rng.randbytes(rng.randrange(0, 80)) for _ in range(n)]


def _fields(proofs):
    return [(p.total, p.index, p.leaf_hash, list(p.aunts)) for p in proofs]


def _expected_path(n, env):
    if n == 0:
        return "empty"
    if n < 32:
        return "pure-python"
    return "device" if env == "1" else "host-native"


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("env", ["1", "0"])
def test_every_path_equals_the_reference(monkeypatch, n, env):
    monkeypatch.setenv("CMTPU_DEVICE_PROOFS", env)
    items = _items(n)
    root, proofs = host.proofs_from_byte_slices(items, device="cpu")
    assert host.last_proofs_path == _expected_path(n, env)
    want_root, want = ref_proofs(items)
    assert root == want_root and len(proofs) == n
    assert _fields(proofs) == _fields(want)
    assert (root, _fields(proofs)) == (lambda r, p: (r, _fields(p)))(
        *host.proofs_from_byte_slices_pure(items))
    for i in range(0, n, 7):
        proofs[i].verify(root, items[i])


def test_unset_takes_the_default(monkeypatch):
    monkeypatch.delenv("CMTPU_DEVICE_PROOFS", raising=False)
    items = _items(64)
    host.proofs_from_byte_slices(items, device="cpu")
    assert host.last_proofs_path == ("device" if host.DEVICE_PROOFS_DEFAULT else "host-native")
    monkeypatch.setattr(host, "DEVICE_PROOFS_DEFAULT", not host.DEVICE_PROOFS_DEFAULT)
    host.proofs_from_byte_slices(items, device="cpu")
    assert host.last_proofs_path == ("device" if host.DEVICE_PROOFS_DEFAULT else "host-native")


def test_lazy_proofs_index_iterate_and_len(monkeypatch):
    monkeypatch.setenv("CMTPU_DEVICE_PROOFS", "0")
    items = _items(100)
    _, lazy = host.proofs_from_byte_slices(items)
    assert isinstance(lazy, host._LazyProofs) and len(lazy) == 100
    _, want = ref_proofs(items)
    assert _fields(list(lazy)) == _fields(want)
    assert _fields([lazy[-1]]) == _fields([want[99]]) and _fields([lazy[-100]]) == _fields([want[0]])
    assert _fields(lazy[10:20:3]) == _fields(want[10:20:3])
    assert _fields(lazy[95:]) == _fields(want[95:])
    for i in (100, -101):
        with pytest.raises(IndexError):
            lazy[i]


def test_pure_path_while_the_native_library_builds(monkeypatch):
    """As the reference: a proof set that finds the native library not yet
    built takes pure Python and starts the build."""
    monkeypatch.setenv("CMTPU_DEVICE_PROOFS", "0")
    started = []
    monkeypatch.setattr(native, "ready", lambda: None)
    monkeypatch.setattr(native, "ensure_built_async", lambda: started.append(1))
    items = _items(40)
    root, proofs = host.proofs_from_byte_slices(items)
    assert host.last_proofs_path == "pure-python" and started == [1]
    assert (root, _fields(proofs)) == (lambda r, p: (r, _fields(p)))(*ref_proofs(items))


def test_failed_native_build_raises(monkeypatch):
    monkeypatch.setenv("CMTPU_DEVICE_PROOFS", "0")

    def failed():
        raise RuntimeError("cometbft_tpu_torch.native: the build failed")

    monkeypatch.setattr(native, "ready", failed)
    with pytest.raises(RuntimeError, match="build failed"):
        host.proofs_from_byte_slices(_items(40))


def test_device_path_failure_raises_without_a_fallback(monkeypatch):
    """A device path that fails raises: no host path answers in its place
    (without a card, the default device is refused)."""
    import torch

    monkeypatch.setenv("CMTPU_DEVICE_PROOFS", "1")
    host.last_proofs_path = "none"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            host.proofs_from_byte_slices(_items(40))
    monkeypatch.setattr(tmk, "proofs_from_byte_slices_device",
                        lambda items, device=None: (_ for _ in ()).throw(RuntimeError("kernel")))
    with pytest.raises(RuntimeError, match="kernel"):
        host.proofs_from_byte_slices(_items(40), device="cpu")
    assert host.last_proofs_path == "none"


def test_device_empty_tree_does_not_reenter_the_selector(monkeypatch):
    monkeypatch.setenv("CMTPU_DEVICE_PROOFS", "1")
    calls = []
    monkeypatch.setattr(host, "proofs_from_byte_slices",
                        lambda *a, **k: calls.append(a) or (b"", []))
    assert tmk.proofs_from_byte_slices_device([], device="cpu") == (host.empty_hash(), [])
    assert calls == []
