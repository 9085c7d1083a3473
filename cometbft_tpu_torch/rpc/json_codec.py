"""JSON -> types decoding of RPC payloads (the inverse of rpc/core's
serializers; rpc/core/types/responses.go and the types' JSON), the port's
copy of ``cometbft_tpu/rpc/json_codec.py``.

The light client's HTTP provider decodes a node's ``/commit`` answer with
it."""
from __future__ import annotations

import base64

from cometbft_tpu_torch.types.block import (
    BlockID,
    Commit,
    CommitSig,
    Consensus,
    Header,
    PartSetHeader,
    SignedHeader,
)
from cometbft_tpu_torch.types.cmttime import Time


def _hx(s: str | None) -> bytes:
    return bytes.fromhex(s) if s else b""


def block_id_from_json(d: dict | None) -> BlockID:
    if not d:
        return BlockID()
    parts = d.get("parts") or {}
    return BlockID(
        hash=_hx(d.get("hash")),
        part_set_header=PartSetHeader(
            total=int(parts.get("total", 0)), hash=_hx(parts.get("hash"))
        ),
    )


def header_from_json(d: dict) -> Header:
    ver = d.get("version") or {}
    return Header(
        version=Consensus(int(ver.get("block", 0)), int(ver.get("app", 0))),
        chain_id=d.get("chain_id", ""),
        height=int(d.get("height", 0)),
        time=Time.parse_rfc3339(d["time"]) if d.get("time") else Time(),
        last_block_id=block_id_from_json(d.get("last_block_id")),
        last_commit_hash=_hx(d.get("last_commit_hash")),
        data_hash=_hx(d.get("data_hash")),
        validators_hash=_hx(d.get("validators_hash")),
        next_validators_hash=_hx(d.get("next_validators_hash")),
        consensus_hash=_hx(d.get("consensus_hash")),
        app_hash=_hx(d.get("app_hash")),
        last_results_hash=_hx(d.get("last_results_hash")),
        evidence_hash=_hx(d.get("evidence_hash")),
        proposer_address=_hx(d.get("proposer_address")),
    )


def commit_from_json(d: dict) -> Commit:
    sigs = []
    for s in d.get("signatures", []):
        sigs.append(
            CommitSig(
                block_id_flag=int(s.get("block_id_flag", 1)),
                validator_address=_hx(s.get("validator_address")),
                timestamp=(
                    Time.parse_rfc3339(s["timestamp"]) if s.get("timestamp") else Time()
                ),
                signature=(
                    base64.b64decode(s["signature"]) if s.get("signature") else b""
                ),
            )
        )
    return Commit(
        height=int(d.get("height", 0)),
        round=int(d.get("round", 0)),
        block_id=block_id_from_json(d.get("block_id")),
        signatures=sigs,
        agg_signature=(
            base64.b64decode(d["agg_signature"]) if d.get("agg_signature") else b""
        ),
        agg_bitmap=(
            base64.b64decode(d["agg_bitmap"]) if d.get("agg_bitmap") else b""
        ),
    )


def signed_header_from_json(d: dict) -> SignedHeader:
    return SignedHeader(
        header=header_from_json(d["header"]),
        commit=commit_from_json(d["commit"]),
    )
