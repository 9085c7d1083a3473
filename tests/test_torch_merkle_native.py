"""The port's roots take the native tree from 32 items, as the reference's
``crypto/merkle/tree.py`` does: ``hash_from_byte_slices`` and
``CpuBackend().merkle_root`` give the reference's root and the pure
oracle's, byte for byte, at every count around the switch, and name the
path they took."""

import numpy as np
import pytest

from cometbft_tpu.crypto.merkle import tree as ref_tree
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.sidecar.backend import CpuBackend

pytestmark = pytest.mark.torch_port

COUNTS = (0, 1, 31, 32, 33, 1_000, 65_536)


def _leaves(n: int) -> list[bytes]:
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, 251, n)
    return [rng.bytes(int(s)) for s in sizes]


@pytest.mark.parametrize("n", COUNTS)
def test_roots_equal_the_reference_and_the_oracle(n):
    leaves = _leaves(n)
    want = ref_tree.hash_from_byte_slices_iterative(leaves)
    assert merkle.hash_from_byte_slices_pure(leaves) == want
    assert ref_tree.hash_from_byte_slices(leaves) == want
    assert merkle.hash_from_byte_slices(leaves) == want
    assert merkle.last_root_path == ("host-native" if n >= 32 else "pure-python")
    assert CpuBackend().merkle_root(leaves) == want
    assert merkle.last_root_path == ("host-native" if n >= 32 else "pure-python")


def test_native_path_waits_for_the_build_and_raises_if_it_failed(monkeypatch):
    """From 32 items the root never drops to pure Python: a failed build
    raises, below 32 the pure path needs no library."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", RuntimeError("gcc failed (exit 1):\nno compiler"))
    leaves = _leaves(32)
    with pytest.raises(RuntimeError, match="the build failed"):
        merkle.hash_from_byte_slices(leaves)
    with pytest.raises(RuntimeError, match="the build failed"):
        CpuBackend().merkle_root(leaves)
    assert merkle.hash_from_byte_slices(leaves[:31]) == ref_tree.hash_from_byte_slices(leaves[:31])
