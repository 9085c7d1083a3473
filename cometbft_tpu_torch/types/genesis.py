"""Genesis document (types/genesis.go), the port's copy of
``cometbft_tpu/types/genesis.py``."""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.crypto import encoding as key_encoding
from cometbft_tpu_torch.types import cmttime
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.params import ConsensusParams, DEFAULT_CONSENSUS_PARAMS
from cometbft_tpu_torch.types.validator import Validator

MAX_CHAIN_ID_LEN = 50

_KEY_TYPE_TO_JSON_NAME = {
    "ed25519": "tendermint/PubKeyEd25519",
    "secp256k1": "tendermint/PubKeySecp256k1",
    "sr25519": "tendermint/PubKeySr25519",
    "bn254": "tendermint/PubKeyBn254",
}
_JSON_NAME_TO_KEY_TYPE = {v: k for k, v in _KEY_TYPE_TO_JSON_NAME.items()}


@dataclass
class GenesisValidator:
    """types/genesis.go GenesisValidator."""

    address: bytes
    pub_key: object
    power: int
    name: str = ""
    # BLS proof of possession: required for bn254 keys — plain
    # BLS aggregation without one is open to the rogue-key attack, so
    # validate_and_complete rejects a bn254 validator whose proof is
    # missing or invalid. Empty for non-aggregating key types.
    pop: bytes = b""

    def to_json(self) -> dict:
        d = {
            "address": self.address.hex().upper(),
            "pub_key": {
                "type": _KEY_TYPE_TO_JSON_NAME[self.pub_key.type()],
                "value": base64.b64encode(self.pub_key.bytes()).decode(),
            },
            "power": str(self.power),
            "name": self.name,
        }
        if self.pop:
            d["proof_of_possession"] = base64.b64encode(self.pop).decode()
        return d

    @classmethod
    def from_json(cls, d: dict) -> "GenesisValidator":
        pk = d["pub_key"]
        key_type = _JSON_NAME_TO_KEY_TYPE.get(pk["type"], pk["type"])
        pub_key = key_encoding.pub_key_from_type_and_bytes(
            key_type, base64.b64decode(pk["value"])
        )
        addr = bytes.fromhex(d["address"]) if d.get("address") else pub_key.address()
        return cls(
            address=addr,
            pub_key=pub_key,
            power=int(d["power"]),
            name=d.get("name", ""),
            pop=base64.b64decode(d.get("proof_of_possession", "") or ""),
        )


@dataclass
class GenesisDoc:
    """types/genesis.go GenesisDoc."""

    chain_id: str
    genesis_time: Time = dfield(default_factory=cmttime.now)
    initial_height: int = 1
    consensus_params: ConsensusParams | None = dfield(
        default_factory=lambda: DEFAULT_CONSENSUS_PARAMS
    )
    validators: list = dfield(default_factory=list)
    app_hash: bytes = b""
    app_state: dict | list | str | None = None

    def validate_and_complete(self) -> None:
        """types/genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(f"chain_id in genesis doc is too long (max: {MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        if self.consensus_params is None:
            self.consensus_params = DEFAULT_CONSENSUS_PARAMS
        else:
            self.consensus_params.validate_basic()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(f"the genesis file cannot contain validators with no voting power: {v}")
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(f"incorrect address for validator {i}")
            if not v.address:
                v.address = v.pub_key.address()
            if v.pub_key.type() == "bn254":
                from cometbft_tpu_torch.crypto import bn254

                if not v.pop:
                    raise ValueError(
                        f"validator {i} ({v.name or v.address.hex()}): bn254 "
                        "keys require a proof_of_possession in genesis — "
                        "without one a registrant can mount the rogue-key "
                        "attack against aggregate BLS commits"
                    )
                if not bn254.verify_possession(v.pub_key.bytes(), v.pop):
                    raise ValueError(
                        f"validator {i} ({v.name or v.address.hex()}): "
                        "invalid bn254 proof_of_possession — rejecting "
                        "possible rogue key"
                    )
        if self.genesis_time.is_zero():
            self.genesis_time = cmttime.now()

    def validator_hash(self) -> bytes:
        from cometbft_tpu_torch.types.validator_set import ValidatorSet

        vals = [Validator.new(v.pub_key, v.power) for v in self.validators]
        return ValidatorSet(vals).hash()

    # -- JSON (genesis.json) -------------------------------------------------

    def to_json(self) -> str:
        d = {
            "genesis_time": self.genesis_time.rfc3339(),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": _params_to_json(self.consensus_params),
            "validators": [v.to_json() for v in self.validators],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state is not None:
            d["app_state"] = self.app_state
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "GenesisDoc":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValueError("genesis doc must be a JSON object")
        vals = d.get("validators") or []
        if not isinstance(vals, list) or not all(isinstance(v, dict) for v in vals):
            raise ValueError("genesis validators must be a list of objects")
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time=Time.parse_rfc3339(d["genesis_time"]),
            initial_height=int(d.get("initial_height", 1)),
            consensus_params=_params_from_json(d.get("consensus_params")),
            validators=[GenesisValidator.from_json(v) for v in vals],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state"),
        )
        doc.validate_and_complete()
        return doc

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def _params_to_json(p: ConsensusParams | None) -> dict | None:
    if p is None:
        return None
    return {
        "block": {"max_bytes": str(p.block.max_bytes), "max_gas": str(p.block.max_gas)},
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration_ns),
            "max_bytes": str(p.evidence.max_bytes),
        },
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "version": {"app": str(p.version.app)},
    }


def _params_from_json(d: dict | None) -> ConsensusParams | None:
    if d is None:
        return None
    from cometbft_tpu_torch.types.params import (
        BlockParams,
        EvidenceParams,
        ValidatorParams,
        VersionParams,
    )

    return ConsensusParams(
        block=BlockParams(
            int(d["block"]["max_bytes"]), int(d["block"]["max_gas"])
        ),
        evidence=EvidenceParams(
            int(d["evidence"]["max_age_num_blocks"]),
            int(d["evidence"]["max_age_duration"]),
            int(d["evidence"].get("max_bytes", 1048576)),
        ),
        validator=ValidatorParams(tuple(d["validator"]["pub_key_types"])),
        version=VersionParams(int(d.get("version", {}).get("app", 0))),
    )
