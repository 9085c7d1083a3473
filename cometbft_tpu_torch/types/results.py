"""ABCI results hashing (types/results.go), the port's copy of ``cometbft_tpu/types/results.py``.

LastResultsHash = Merkle root over deterministic subsets of the DeliverTx
responses (code, data, gas_wanted, gas_used — types/results.go:41-56).
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.wire import proto as wire


def deterministic_response_deliver_tx(code: int, data: bytes, gas_wanted: int, gas_used: int) -> bytes:
    """ResponseDeliverTx stripped of non-deterministic fields
    (types/results.go deterministicResponseDeliverTx): {code=1, data=2,
    gas_wanted=5, gas_used=6}."""
    out = wire.field_varint(1, code)
    out += wire.field_bytes(2, data)
    out += wire.field_varint(5, gas_wanted)
    out += wire.field_varint(6, gas_used)
    return out


def results_hash(deliver_txs: list) -> bytes:
    """ABCIResults.Hash (types/results.go:19-39). deliver_txs: list of
    abci ResponseDeliverTx-shaped objects."""
    leaves = [
        deterministic_response_deliver_tx(
            r.code, r.data, r.gas_wanted, r.gas_used
        )
        for r in deliver_txs
    ]
    return merkle.hash_from_byte_slices(leaves)
