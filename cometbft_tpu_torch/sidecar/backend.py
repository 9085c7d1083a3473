"""The port's verification backend seam.

Counterpart of ``cometbft_tpu/sidecar/backend.py``: its own copy of the
``VerifyBackend`` contract (``batch_verify(pubs, msgs, sigs) -> (ok,
bitmap)`` and ``merkle_root(leaves) -> bytes``) and ``TorchBackend``, which
mirrors ``TpuBackend`` on the PyTorch/CUDA device tier. ``TorchBackend`` has
the same duck type, so a host that runs the reference's consensus code can
install it through that package's own ``set_backend``.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.device import resolve


class VerifyBackend:
    """Interface for the device tier."""

    name = "abstract"

    def batch_verify(
        self, pubs: list[bytes], msgs: list[bytes], sigs: list[bytes]
    ) -> tuple[bool, list[bool]]:
        raise NotImplementedError

    def merkle_root(self, leaves: list[bytes]) -> bytes:
        raise NotImplementedError


class TorchBackend(VerifyBackend):
    """Batch verification and Merkle roots on one PyTorch device: ``cuda``
    by default (raises when there is none), ``cpu`` only when asked."""

    name = "torch"

    def __init__(self, device=None):
        from cometbft_tpu_torch.ops import ed25519_kernel, merkle_kernel

        self.device = resolve(device)
        self._ed = ed25519_kernel
        self._merkle = merkle_kernel

    def batch_verify(self, pubs, msgs, sigs):
        return self._ed.batch_verify(pubs, msgs, sigs, device=self.device)

    def merkle_root(self, leaves):
        return self._merkle.merkle_root(leaves, device=self.device)

    def mesh_width(self) -> int:
        return self._ed.mesh_width()


_backend: VerifyBackend | None = None
_lock = threading.Lock()


def get_backend() -> VerifyBackend:
    """The process-wide backend: a ``TorchBackend`` on ``cuda`` unless one
    was installed with ``set_backend``."""
    global _backend
    if _backend is None:
        with _lock:
            if _backend is None:
                _backend = TorchBackend()
    return _backend


def set_backend(backend: VerifyBackend | None) -> None:
    """Override the process-wide backend (tests, node bootstrap)."""
    global _backend
    with _lock:
        _backend = backend
