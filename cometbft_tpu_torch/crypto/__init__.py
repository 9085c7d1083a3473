"""Crypto interfaces and address derivation: the port's copy of the
reference's ``crypto`` contract (crypto/crypto.go:22-54). ``PubKey`` and
``BatchVerifier`` are the seams commit verification reaches the backends
through; an address is SHA256-20 of the key's bytes (crypto/crypto.go:18)."""

from __future__ import annotations

import abc

from cometbft_tpu_torch.crypto import tmhash

def address_hash(bz: bytes) -> bytes:
    """The SHA256-20 address of arbitrary bytes (crypto/crypto.go:18)."""
    return tmhash.sum_truncated(bz)


class PubKey(abc.ABC):
    """crypto.PubKey (crypto/crypto.go:27-33)."""

    @abc.abstractmethod
    def address(self) -> bytes: ...

    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @abc.abstractmethod
    def type(self) -> str: ...

    def equals(self, other: "PubKey") -> bool:
        return type(self) is type(other) and self.bytes() == other.bytes()

    def __eq__(self, other) -> bool:
        return isinstance(other, PubKey) and self.equals(other)

    def __hash__(self) -> int:
        return hash((self.type(), self.bytes()))


class BatchVerifier(abc.ABC):
    """crypto.BatchVerifier (crypto/crypto.go:46-54): ``add`` appends an
    entry; ``verify`` returns (all valid, per-entry validity) in insertion
    order."""

    @abc.abstractmethod
    def add(self, key: PubKey, message: bytes, signature: bytes) -> None: ...

    @abc.abstractmethod
    def verify(self) -> tuple[bool, list[bool]]: ...
