"""Transactions (types/tx.go), the port's copy of ``cometbft_tpu/types/tx.py``.

``txs_hash`` (a block's ``Data.hash``) goes through
``crypto/merkle.hash_from_byte_slices``: the native tree from 32 items."""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.crypto.merkle import Proof, proofs_from_byte_slices


def tx_hash(tx: bytes) -> bytes:
    """Tx.Hash = SHA256(tx) (types/tx.go:33)."""
    return tmhash.sum(tx)


def tx_key(tx: bytes) -> bytes:
    """TxKey: fixed 32-byte mempool cache key (types/tx.go)."""
    return tmhash.sum(tx)


def txs_hash(txs: list[bytes]) -> bytes:
    """Txs.Hash = Merkle root over raw txs (types/tx.go:47-50)."""
    return merkle.hash_from_byte_slices(list(txs))


def txs_proof(txs: list[bytes], i: int) -> "TxProof":
    """Txs.Proof(i) (types/tx.go:57-70)."""
    root, proofs = proofs_from_byte_slices(list(txs))
    return TxProof(root_hash=root, data=txs[i], proof=proofs[i])


@dataclass
class TxProof:
    """types/tx.go:75-110."""

    root_hash: bytes
    data: bytes
    proof: Proof

    def leaf(self) -> bytes:
        return self.data

    def validate(self, data_hash: bytes) -> None:
        if data_hash != self.root_hash:
            raise ValueError("proof matches different data hash")
        if self.proof.index < 0:
            raise ValueError("proof index cannot be negative")
        if self.proof.total <= 0:
            raise ValueError("proof total must be positive")
        self.proof.verify(self.root_hash, self.data)


def compute_proto_size_for_txs(txs: list[bytes]) -> int:
    """types/tx.go ComputeProtoSizeForTxs: wire size of Data{txs}."""
    from cometbft_tpu_torch.wire import proto as wire

    total = 0
    for tx in txs:
        total += len(wire.field_bytes(1, tx, emit_default=True))
    return total
