"""Generalized multi-store proof operators (crypto/merkle/proof_op.go), the
port's copy of ``cometbft_tpu/crypto/merkle/proof_op.py``.

A chain of ProofOperators folds leaf values through successive Merkle trees
(e.g. app-store → multi-store) until the final root, checked against a trusted
root alongside a consumed key path.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto.merkle.proof_key_path import key_path_to_keys


@dataclass
class ProofOp:
    """Wire form of one operator (proto tendermint.crypto.ProofOp)."""

    type: str = ""
    key: bytes = b""
    data: bytes = b""


@dataclass
class ProofOps:
    ops: list[ProofOp] = field(default_factory=list)


class ProofOperator(abc.ABC):
    """crypto/merkle/proof_op.go:21-25."""

    @abc.abstractmethod
    def run(self, args: list[bytes]) -> list[bytes]: ...

    @abc.abstractmethod
    def get_key(self) -> bytes: ...

    @abc.abstractmethod
    def proof_op(self) -> ProofOp: ...


class ProofOperators(list):
    """Sequential application + root/keypath check (proof_op.go:33-70)."""

    def verify_value(self, root: bytes, keypath: str, value: bytes) -> None:
        self.verify(root, keypath, [value])

    def verify(self, root: bytes, keypath: str, args: list[bytes] | None) -> None:
        keys = key_path_to_keys(keypath)
        for i, op in enumerate(self):
            key = op.get_key()
            if len(key) != 0:
                if len(keys) == 0:
                    raise ValueError(
                        f"key path has insufficient # of parts: expected no more "
                        f"keys but got {key!r}"
                    )
                last_key = keys[-1]
                if last_key != key:
                    raise ValueError(
                        f"key mismatch on operation #{i}: expected {last_key!r} "
                        f"but got {key!r}"
                    )
                keys = keys[:-1]
            args = op.run(args or [])
        if not args or root != args[0]:
            got = args[0].hex() if args else None
            raise ValueError(
                f"calculated root hash is invalid: expected {root.hex()} but got {got}"
            )
        if len(keys) != 0:
            raise ValueError("keypath not consumed all")


class ProofRuntime:
    """Registry of op-type → decoder (crypto/merkle/proof_op.go:75-123)."""

    def __init__(self):
        self._decoders: dict[str, callable] = {}

    def register_op_decoder(self, typ: str, decoder) -> None:
        if typ in self._decoders:
            raise ValueError(f"already registered for type {typ}")
        self._decoders[typ] = decoder

    def decode(self, pop: ProofOp) -> ProofOperator:
        decoder = self._decoders.get(pop.type)
        if decoder is None:
            raise ValueError(f"unrecognized proof type {pop.type}")
        return decoder(pop)

    def decode_proof(self, proof: ProofOps) -> ProofOperators:
        poz = ProofOperators()
        for pop in proof.ops:
            poz.append(self.decode(pop))
        return poz

    def verify_value(self, proof: ProofOps, root: bytes, keypath: str, value: bytes) -> None:
        self.verify(proof, root, keypath, [value])

    def verify_absence(self, proof: ProofOps, root: bytes, keypath: str) -> None:
        self.verify(proof, root, keypath, None)

    def verify(self, proof: ProofOps, root: bytes, keypath: str, args) -> None:
        self.decode_proof(proof).verify(root, keypath, args)


def default_proof_runtime() -> ProofRuntime:
    """Knows only value proofs (proof_op.go:137-142)."""
    from cometbft_tpu_torch.crypto.merkle.proof_value import PROOF_OP_VALUE, value_op_decoder

    prt = ProofRuntime()
    prt.register_op_decoder(PROOF_OP_VALUE, value_op_decoder)
    return prt
