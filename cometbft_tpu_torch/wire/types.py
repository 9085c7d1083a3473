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


def encode_proof_ops(ops: list) -> bytes:
    """tendermint.crypto.ProofOps {ops=1: ProofOp {type=1, key=2, data=3}}:
    the body of ``ResponseQuery.proof_ops`` (the reference encodes it in
    ``abci/wire.py``, as ``_enc_proof_ops``)."""
    out = b""
    for op in ops:
        body = (
            wire.field_string(1, op.type)
            + wire.field_bytes(2, op.key)
            + wire.field_bytes(3, op.data)
        )
        out += wire.field_message(1, body, emit_empty=True)
    return out


def decode_proof_ops(data: bytes) -> list:
    """The inverse of ``encode_proof_ops``: a list of ``ProofOp``."""
    from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOp

    f = wire.decode_fields(data)
    out = []
    for b in wire.get_repeated_bytes(f, 1):
        of = wire.decode_fields(b)
        out.append(
            ProofOp(
                type=wire.get_string(of, 1),
                key=wire.get_bytes(of, 2),
                data=wire.get_bytes(of, 3),
            )
        )
    return out
