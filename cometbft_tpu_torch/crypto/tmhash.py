"""SHA-256 and its 20-byte truncation (crypto/tmhash/hash.go: Size 32,
TruncatedSize 20). Counterpart of ``cometbft_tpu/crypto/tmhash.py``."""

import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum(bz: bytes) -> bytes:  # noqa: A001 - the reference's name, tmhash.Sum
    return hashlib.sha256(bz).digest()


def sum_truncated(bz: bytes) -> bytes:
    return hashlib.sha256(bz).digest()[:TRUNCATED_SIZE]
