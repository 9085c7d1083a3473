"""Public keys to and from their proto form (crypto/encoding/codec.go), the
port's copy of ``cometbft_tpu/crypto/encoding.py`` for the key types it
has: ed25519 and bn254.

Wire schema: tendermint.crypto.PublicKey oneof {ed25519 = 1, secp256k1 = 2,
bn254 = 3}, and the JAX package's sr25519 extension at 4. secp256k1 and
sr25519 keys are not ported yet: their fields raise an error that says so.
"""

from __future__ import annotations

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bn254, ed25519
from cometbft_tpu_torch.wire import proto as wire

# Key types of the reference that the port does not have yet, by proto
# field and by type name (ROADMAP lists them).
_NOT_PORTED = {2: "secp256k1", 4: "sr25519"}
_NOT_PORTED_NAMES = {
    "secp256k1": "secp256k1", "tendermint/PubKeySecp256k1": "secp256k1",
    "sr25519": "sr25519", "tendermint/PubKeySr25519": "sr25519",
}


def not_ported(key_type: str) -> ValueError:
    return ValueError(f"key type {key_type} is not ported to cometbft_tpu_torch yet")


def pub_key_to_proto(k: crypto.PubKey) -> bytes:
    """PubKeyToProto (codec.go:22-48): serialized tendermint.crypto.PublicKey."""
    if isinstance(k, ed25519.PubKey):
        return wire.field_bytes(1, k.bytes(), emit_default=True)
    if isinstance(k, bn254.PubKey):
        return wire.field_bytes(3, k.bytes(), emit_default=True)
    raise ValueError(f"toproto: key type {k} is not supported")


def pub_key_from_proto(data: bytes) -> crypto.PubKey:
    """PubKeyFromProto (codec.go:51-93)."""
    fields = wire.decode_fields(data)
    if 1 in fields:
        raw = fields[1][-1]
        if len(raw) != ed25519.PUB_KEY_SIZE:
            raise ValueError(
                f"invalid size for PubKeyEd25519. Got {len(raw)}, "
                f"expected {ed25519.PUB_KEY_SIZE}"
            )
        return ed25519.PubKey(raw)
    if 2 in fields:
        raise not_ported(_NOT_PORTED[2])
    if 3 in fields:
        raw = fields[3][-1]
        if len(raw) != bn254.PUB_KEY_SIZE:
            raise ValueError(
                f"invalid size for PubKeyBN254. Got {len(raw)}, "
                f"expected {bn254.PUB_KEY_SIZE}"
            )
        return bn254.PubKey(raw)
    if 4 in fields:
        raise not_ported(_NOT_PORTED[4])
    raise ValueError("fromproto: key type is not supported")


_KEY_TYPE_TO_CLASS = {
    ed25519.KEY_TYPE: (ed25519.PubKey, ed25519.PUB_KEY_SIZE),
    bn254.KEY_TYPE: (bn254.PubKey, bn254.PUB_KEY_SIZE),
    # Amino-style names, as genesis files and RPC answers carry them.
    ed25519.PUB_KEY_NAME: (ed25519.PubKey, ed25519.PUB_KEY_SIZE),
    bn254.PUB_KEY_NAME: (bn254.PubKey, bn254.PUB_KEY_SIZE),
}


def pub_key_from_type_and_bytes(key_type: str, raw: bytes) -> crypto.PubKey:
    """A public key from its registered type name and bytes."""
    if key_type in _NOT_PORTED_NAMES:
        raise not_ported(_NOT_PORTED_NAMES[key_type])
    if key_type not in _KEY_TYPE_TO_CLASS:
        raise ValueError(f"unsupported key type {key_type}")
    cls, size = _KEY_TYPE_TO_CLASS[key_type]
    if len(raw) != size:
        raise ValueError(f"invalid {key_type} pubkey size {len(raw)}, want {size}")
    return cls(raw)
