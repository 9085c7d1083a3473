"""Key-type dispatch for batch verification (crypto/batch/batch.go), the
port's copy of ``cometbft_tpu/crypto/batch.py``: ed25519 and bn254 (sr25519,
the reference's third, is not ported yet).

The registry is keyed by the key-type string, so commit verification picks
the engine of the one key type a whole validator set shares
(``types/validation._batch_key_type``), never the proposer's alone.
"""

from __future__ import annotations

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bn254, ed25519

# key type -> (PubKey class, BatchVerifier factory)
_REGISTRY: dict[str, tuple] = {
    ed25519.KEY_TYPE: (ed25519.PubKey, ed25519.BatchVerifier),
    bn254.KEY_TYPE: (bn254.PubKey, bn254.BatchVerifier),
}


def _key_type_of(key) -> str | None:
    if isinstance(key, str):
        return key if key in _REGISTRY else None
    for kt, (cls, _) in _REGISTRY.items():
        if isinstance(key, cls):
            return kt
    return None


def create_batch_verifier(key) -> crypto.BatchVerifier:
    """batch.CreateBatchVerifier (batch.go:11-21), for a PubKey or a key-type
    string."""
    kt = _key_type_of(key)
    if kt is None:
        raise ValueError(f"only {', '.join(sorted(_REGISTRY))} support batch verification")
    return _REGISTRY[kt][1]()


def supports_batch_verifier(key) -> bool:
    """batch.SupportsBatchVerifier (batch.go:25-32), for a PubKey or a
    key-type string."""
    return _key_type_of(key) is not None
