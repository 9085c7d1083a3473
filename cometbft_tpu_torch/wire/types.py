"""Hand-rolled codecs for the small crypto wire messages
(proto/tendermint/crypto/proof.proto), the port's copy of
``cometbft_tpu/wire/types.py``."""

from __future__ import annotations

from cometbft_tpu_torch.wire import proto as wire


def encode_proof(p) -> bytes:
    """tendermint.crypto.Proof {total=1, index=2, leaf_hash=3, aunts=4}."""
    out = wire.field_varint(1, p.total)
    out += wire.field_varint(2, p.index)
    out += wire.field_bytes(3, p.leaf_hash)
    for aunt in p.aunts:
        out += wire.field_bytes(4, aunt, emit_default=True)
    return out


def decode_proof(data: bytes):
    from cometbft_tpu_torch.crypto.merkle import Proof

    f = wire.decode_fields(data)
    return Proof(
        total=wire.get_varint(f, 1),
        index=wire.get_varint(f, 2),
        leaf_hash=wire.get_bytes(f, 3),
        aunts=wire.get_repeated_bytes(f, 4),
    )


def encode_value_op(key: bytes, proof) -> bytes:
    """tendermint.crypto.ValueOp {key=1, proof=2}."""
    return wire.field_bytes(1, key) + wire.field_message(2, encode_proof(proof))


def decode_value_op(data: bytes):
    f = wire.decode_fields(data)
    key = wire.get_bytes(f, 1)
    proof_raw = wire.get_bytes(f, 2)
    return key, decode_proof(proof_raw)
