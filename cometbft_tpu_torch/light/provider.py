"""Light block providers (light/provider/provider.go, mock, http), the port's
copy of ``cometbft_tpu/light/provider.py``.

A Provider serves a chain's LightBlocks and takes evidence reports.
``BlockStoreProvider`` serves a node's own block and state stores;
``HTTPProvider`` sits over a duck-typed RPC client (``commit(height)``,
``validators(height, page, per_page)``, ``broadcast_evidence(ev)``, JSON as
a node's ``/commit`` and ``/validators`` routes answer): in a node's
peers, ``rpc/client.HTTPClient`` over ``rpc/jsonrpc/server.JSONRPCServer``."""

from __future__ import annotations

from cometbft_tpu_torch.types.block import SignedHeader
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.types.validator_set import ValidatorSet


class ErrLightBlockNotFound(Exception):
    """provider.ErrLightBlockNotFound: requested height unavailable."""


class ErrNoResponse(Exception):
    """provider.ErrNoResponse: provider unreachable/misbehaving."""


class Provider:
    """light/provider/provider.go Provider interface."""

    def chain_id(self) -> str:
        raise NotImplementedError

    def light_block(self, height: int) -> LightBlock:
        """Height 0 means latest. Raises ErrLightBlockNotFound/ErrNoResponse."""
        raise NotImplementedError

    def report_evidence(self, ev) -> None:
        raise NotImplementedError


class MockProvider(Provider):
    """light/provider/mock/mock.go: canned LightBlocks by height."""

    def __init__(self, chain_id: str, light_blocks: dict[int, LightBlock]):
        self._chain_id = chain_id
        self.light_blocks = dict(light_blocks)
        self.evidences = []

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            if not self.light_blocks:
                raise ErrLightBlockNotFound("no blocks")
            height = max(self.light_blocks)
        lb = self.light_blocks.get(height)
        if lb is None:
            raise ErrLightBlockNotFound(f"no light block at height {height}")
        return lb

    def report_evidence(self, ev) -> None:
        self.evidences.append(ev)


class BlockStoreProvider(Provider):
    """A node's own provider over its block and state stores: the light
    gateway's source when it runs inside a node (no RPC round trip, no JSON
    re-encode). Commits as the /commit route picks them: the tip serves its
    seen commit, history the canonical block commit."""

    def __init__(self, chain_id: str, block_store, state_store):
        self._chain_id = chain_id
        self._block_store = block_store
        self._state_store = state_store

    def chain_id(self) -> str:
        return self._chain_id

    def base_height(self) -> int:
        """Lowest retained height: the gateway refuses MMR proofs when the
        store is pruned above 1 (leaf index = height - 1)."""
        return self._block_store.base()

    def header_hash(self, height: int) -> bytes | None:
        """The header's hash without building the validator set (the MMR
        append path touches every height once)."""
        meta = self._block_store.load_block_meta(height)
        return meta.header.hash() if meta is not None else None

    def light_block(self, height: int) -> LightBlock:
        tip = self._block_store.height()
        h = height if height > 0 else tip
        meta = self._block_store.load_block_meta(h)
        if meta is None:
            raise ErrLightBlockNotFound(f"no block meta at height {h}")
        if h == tip:
            commit = self._block_store.load_seen_commit(h)
        else:
            commit = self._block_store.load_block_commit(h)
        if commit is None:
            raise ErrLightBlockNotFound(f"no commit at height {h}")
        vals = self._state_store.load_validators(h)
        if vals is None:
            raise ErrLightBlockNotFound(f"no validators at height {h}")
        return LightBlock(
            signed_header=SignedHeader(meta.header, commit), validator_set=vals
        )

    def report_evidence(self, ev) -> None:
        pass  # a node's own source has nowhere to forward it


class HTTPProvider(Provider):
    """light/provider/http/http.go: LightBlocks from a node's RPC."""

    def __init__(self, chain_id: str, rpc_client):
        self._chain_id = chain_id
        self.client = rpc_client

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        h = height if height > 0 else None
        try:
            commit_res = self.client.commit(h)
            actual_h = int(commit_res["signed_header"]["header"]["height"])
            vals = self._validators_all(actual_h)
        except (ErrLightBlockNotFound, ErrNoResponse):
            raise
        except Exception as e:
            raise ErrNoResponse(str(e)) from e
        sh = _signed_header_from_json(commit_res["signed_header"])
        lb = LightBlock(signed_header=sh, validator_set=vals)
        lb.validate_basic(self._chain_id)
        return lb

    def _validators_all(self, height: int) -> ValidatorSet:
        """Page through /validators (http.go:165)."""
        vals = []
        page = 1
        while True:
            res = self.client.validators(height, page=page, per_page=100)
            for v in res["validators"]:
                vals.append(_validator_from_json(v))
            total = int(res["total"])
            if len(vals) >= total or not res["validators"]:
                break
            page += 1
        if not vals:
            raise ErrLightBlockNotFound(f"no validators at height {height}")
        return ValidatorSet(vals)

    def report_evidence(self, ev) -> None:
        self.client.broadcast_evidence(ev)


def _validator_from_json(v: dict):
    import base64

    from cometbft_tpu_torch.crypto.encoding import pub_key_from_type_and_bytes
    from cometbft_tpu_torch.types.validator import Validator

    pk = v["pub_key"]
    pub = pub_key_from_type_and_bytes(pk["type"], base64.b64decode(pk["value"]))
    val = Validator.new(pub, int(v["voting_power"]))
    val.proposer_priority = int(v.get("proposer_priority", 0))
    return val


def _signed_header_from_json(d: dict) -> SignedHeader:
    from cometbft_tpu_torch.rpc.json_codec import signed_header_from_json

    return signed_header_from_json(d)
