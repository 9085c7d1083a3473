"""The port's verification backend seam.

Counterpart of ``cometbft_tpu/sidecar/backend.py``: its own copy of the
``VerifyBackend`` contract (``batch_verify(pubs, msgs, sigs) -> (ok,
bitmap)`` and ``merkle_root(leaves) -> bytes``) and ``TorchBackend``, which
mirrors ``TpuBackend`` on the PyTorch/CUDA device tier. ``TorchBackend`` has
the same duck type, so a host that runs the reference's consensus code can
install it through that package's own ``set_backend``. ``LockedBackend``
and ``device_backend`` are what the port's sidecar server
(``sidecar/service.py``) builds its device tier from.
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
        return self._merkle.merkle_root_fused(leaves, device=self.device)

    def mesh_width(self) -> int:
        """The routing width: this process's CUDA devices, 1 on the CPU."""
        return self._ed.mesh_width(self.device)

    def warmup(self, buckets=None, merkle_leaves=None) -> None:
        """Build the kernels and run each program once at the given batch
        buckets and leaf counts (``ed25519_kernel.warmup``)."""
        self._ed.warmup(buckets, merkle_leaves, device=self.device)


class LockedBackend(VerifyBackend):
    """Serializes every device call of a wrapped backend behind one lock.

    The sidecar server puts this under its coalescing scheduler: the
    scheduler's one dispatcher merges requests from many connections into
    one dispatch, and the lock keeps one caller on the card at a time for
    the calls that bypass the scheduler (roots, warm-up)."""

    def __init__(self, inner: VerifyBackend, lock: threading.Lock):
        self.inner = inner
        self.name = getattr(inner, "name", "device")
        self._device_lock = lock

    def batch_verify(self, pubs, msgs, sigs):
        with self._device_lock:
            return self.inner.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        with self._device_lock:
            return self.inner.merkle_root(leaves)

    def mesh_width(self) -> int:
        mw = getattr(self.inner, "mesh_width", None)
        return int(mw()) if mw is not None else 1


DEVICE_CHOICES = ("torch", "cpu")


def device_backend(choice: str = "torch") -> VerifyBackend:
    """The sidecar's device tier: ``torch`` is ``TorchBackend()`` on
    ``cuda`` (raises without a card), ``cpu`` the plain PyTorch path, only
    when asked for. Nothing falls back to the CPU on its own."""
    if choice == "torch":
        return TorchBackend()
    if choice == "cpu":
        return TorchBackend(device="cpu")
    raise ValueError(f"unknown sidecar device {choice!r}; expected one of {DEVICE_CHOICES}")


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
