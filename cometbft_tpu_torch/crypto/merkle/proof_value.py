"""Value proof operator over the SimpleMap KV tree (crypto/merkle/proof_value.go),
the port's copy of ``cometbft_tpu/crypto/merkle/proof_value.py``.

leaf = leafHash(uvarint-len(key) || key || uvarint-len(SHA256(value)) || SHA256(value))
folded through the inclusion proof to the store root.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from cometbft_tpu_torch.crypto.merkle import Proof, leaf_hash
from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOp, ProofOperator
from cometbft_tpu_torch.wire.proto import encode_bytes_len_prefixed

PROOF_OP_VALUE = "simple:v"


@dataclass
class ValueOp(ProofOperator):
    """crypto/merkle/proof_value.go:23-30."""

    key: bytes
    proof: Proof

    def run(self, args: list[bytes]) -> list[bytes]:
        """proof_value.go:76-97."""
        if len(args) != 1:
            raise ValueError(f"expected 1 arg, got {len(args)}")
        vhash = hashlib.sha256(args[0]).digest()
        # Wrap <key, vhash> as a length-prefixed KVPair before leaf-hashing.
        bz = encode_bytes_len_prefixed(self.key) + encode_bytes_len_prefixed(vhash)
        kvhash = leaf_hash(bz)
        if kvhash != self.proof.leaf_hash:
            raise ValueError(
                f"leaf hash mismatch: want {self.proof.leaf_hash.hex()} got {kvhash.hex()}"
            )
        root = self.proof.compute_root_hash()
        if root is None:
            raise ValueError("invalid proof shape")
        return [root]

    def get_key(self) -> bytes:
        return self.key

    def proof_op(self) -> ProofOp:
        from cometbft_tpu_torch.wire import types as wire_types

        data = wire_types.encode_value_op(self.key, self.proof)
        return ProofOp(type=PROOF_OP_VALUE, key=self.key, data=data)


def value_op_decoder(pop: ProofOp) -> ValueOp:
    """proof_value.go:40-55."""
    if pop.type != PROOF_OP_VALUE:
        raise ValueError(f"unexpected ProofOp.Type; got {pop.type}, want {PROOF_OP_VALUE}")
    from cometbft_tpu_torch.wire import types as wire_types

    key, proof = wire_types.decode_value_op(pop.data)
    return ValueOp(key=pop.key, proof=proof)
