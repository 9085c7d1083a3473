"""State persistence: state, ABCI responses, validator sets, consensus params
per height (state/store.go), the port's copy of ``cometbft_tpu/state/store.py``;
keys and values are byte-identical, so a store the JAX package wrote loads
here.

Validator sets are loadable per height (needed by the evidence pool and the
light client), with CometBFT's sparse storage: full sets are written
only when they change; other heights store a pointer to the last-changed
height (state/store.go saveValidatorsInfo).
"""

from __future__ import annotations

import json

from cometbft_tpu_torch.libs.db import DB
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.types.block import BlockID, Consensus
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.params import ConsensusParams
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.wire import proto as wire

_STATE_KEY = b"stateKey"
_PRUNED_TO_KEY = b"stateStorePrunedToKey"


def _validators_key(height: int) -> bytes:
    return b"validatorsKey:%d" % height


def _params_key(height: int) -> bytes:
    return b"consensusParamsKey:%d" % height


def _abci_responses_key(height: int) -> bytes:
    return b"abciResponsesKey:%d" % height


class StateStore:
    """state/store.go dbStore."""

    def __init__(self, db: DB, discard_abci_responses: bool = False):
        self._db = db
        # storage.discard_abci_responses: keep ONLY the latest height's
        # responses (still needed by the handshake's ran-Commit-but-didn't-
        # save-state replay) — /block_results for older heights is gone
        # (state/store.go Options.DiscardABCIResponses).
        self.discard_abci_responses = discard_abci_responses
        # Pruned floor: checkpoints below this height are gone; new pointer
        # records must target the migrated checkpoint AT this height, or a
        # save after pruning would write a dangling reference.
        raw = self._db.get(_PRUNED_TO_KEY)
        self._pruned_to = int(raw) if raw else 0

    # -- state ---------------------------------------------------------------

    def save(self, state: State) -> None:
        """state/store.go Save: state + next-validators + params."""
        next_height = state.last_block_height + 1
        if next_height == 1:
            next_height = state.initial_height
            # genesis: save base validator records
            self._save_validators_info(next_height, next_height, state.validators)
        self._save_validators_info(
            next_height + 1, state.last_height_validators_changed, state.next_validators
        )
        self._save_params_info(
            next_height, state.last_height_consensus_params_changed, state.consensus_params
        )
        self._db.set(_STATE_KEY, _encode_state(state))

    def load(self) -> State | None:
        raw = self._db.get(_STATE_KEY)
        if raw is None:
            return None
        return _decode_state(raw)

    def bootstrap(self, state: State) -> None:
        """state/store.go Bootstrap (statesync entry)."""
        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height
        if height > 1 and state.last_validators and not state.last_validators.is_nil_or_empty():
            self._save_validators_info(height - 1, height - 1, state.last_validators)
        self._save_validators_info(height, height, state.validators)
        self._save_validators_info(height + 1, height + 1, state.next_validators)
        self._save_params_info(
            height, state.last_height_consensus_params_changed, state.consensus_params
        )
        self._db.set(_STATE_KEY, _encode_state(state))

    # -- validators per height ----------------------------------------------

    def _save_validators_info(
        self, height: int, last_height_changed: int, vals: ValidatorSet
    ) -> None:
        if last_height_changed > height:
            raise ValueError("lastHeightChanged cannot be greater than valInfo height")
        if height == last_height_changed:
            payload = {"h": height, "set": vals.encode().hex()}
        else:
            # Never point below the pruned floor (the checkpoint there was
            # migrated to the floor height by prune_states).
            payload = {"h": max(last_height_changed, self._pruned_to)}
        self._db.set(_validators_key(height), json.dumps(payload).encode())

    def load_validators(self, height: int) -> ValidatorSet:
        """state/store.go LoadValidators with pointer-chasing + CometBFT's
        IncrementProposerPriority restoration (priority is recomputed from the
        stored checkpoint by offsetting rounds)."""
        raw = self._db.get(_validators_key(height))
        if raw is None:
            raise NoValidatorsError(height)
        info = json.loads(raw)
        if "set" in info:
            return ValidatorSet.decode(bytes.fromhex(info["set"]))
        last_changed = info["h"]
        raw2 = self._db.get(_validators_key(last_changed))
        if raw2 is None:
            raise NoValidatorsError(height)
        info2 = json.loads(raw2)
        if "set" not in info2:
            raise NoValidatorsError(height)
        vals = ValidatorSet.decode(bytes.fromhex(info2["set"]))
        vals.increment_proposer_priority(height - last_changed)
        return vals

    # -- consensus params per height ------------------------------------------

    def _save_params_info(
        self, height: int, last_height_changed: int, params: ConsensusParams
    ) -> None:
        if height == last_height_changed:
            payload = {"h": height, "params": params.encode().hex()}
        else:
            payload = {"h": max(last_height_changed, self._pruned_to)}
        self._db.set(_params_key(height), json.dumps(payload).encode())

    def load_consensus_params(self, height: int) -> ConsensusParams:
        raw = self._db.get(_params_key(height))
        if raw is None:
            raise NoParamsError(height)
        info = json.loads(raw)
        if "params" in info:
            return ConsensusParams.decode(bytes.fromhex(info["params"]))
        raw2 = self._db.get(_params_key(info["h"]))
        if raw2 is None:
            raise NoParamsError(height)
        info2 = json.loads(raw2)
        return ConsensusParams.decode(bytes.fromhex(info2["params"]))

    # -- ABCI responses -------------------------------------------------------

    def save_abci_responses(self, height: int, responses: dict) -> None:
        """state/store.go SaveABCIResponses: {deliver_txs, end_block, begin_block}
        stored for reindexing and /block_results; under discard mode only the
        latest height survives (store.go:344)."""
        if self.discard_abci_responses:
            self._db.delete(_abci_responses_key(height - 1))
        self._db.set(_abci_responses_key(height), json.dumps(responses).encode())

    def load_abci_responses(self, height: int) -> dict | None:
        raw = self._db.get(_abci_responses_key(height))
        return json.loads(raw) if raw else None

    def prune_states(self, retain_height: int) -> None:
        """state/store.go PruneStates. Keys are textual "prefix:height", so a
        full prefix scan with numeric parsing is required (bytewise ranges
        over decimal strings would skip e.g. ':2'..':9' when pruning to 10).

        Validator-set and params records are stored SPARSELY: unchanged
        heights hold a pointer to the last-changed checkpoint, which may sit
        below retain_height. The checkpoint is migrated to retain_height as
        a full record BEFORE deleting (CometBFT's PruneStates does the
        same), or every retained pointer would dangle."""
        if retain_height <= 0:
            raise ValueError("height must be greater than 0")
        # Migrate checkpoints the retained range depends on. A failed load
        # ABORTS the prune (CometBFT errors out too): silently
        # proceeding would delete every record the retained range needs.
        vals = self.load_validators(retain_height)
        self._db.set(
            _validators_key(retain_height),
            json.dumps({"h": retain_height, "set": vals.encode().hex()}).encode(),
        )
        params = self.load_consensus_params(retain_height)
        self._db.set(
            _params_key(retain_height),
            json.dumps(
                {"h": retain_height, "params": params.encode().hex()}
            ).encode(),
        )
        self._pruned_to = max(self._pruned_to, retain_height)
        self._db.set(_PRUNED_TO_KEY, str(self._pruned_to).encode())
        for prefix in (b"validatorsKey:", b"consensusParamsKey:", b"abciResponsesKey:"):
            for k, raw in list(self._db.iterator(prefix, prefix + b"\xff")):
                try:
                    h = int(k.rsplit(b":", 1)[1])
                except Exception:
                    continue
                if h < retain_height:
                    self._db.delete(k)
                elif h > retain_height and prefix != b"abciResponsesKey:":
                    # Retained pointer records that referenced a deleted
                    # checkpoint now chase the migrated one.  NOTE: proposer-
                    # priority restoration after this rewrite is order-
                    # preserving but not always bit-exact — each increment
                    # re-applies rescale+shift, which composes exactly only
                    # while rescaling never clips.  Safe for consensus
                    # (priorities are excluded from validator hashes, and
                    # the live proposer comes from the state record, not
                    # historical loads); only historical
                    # load_validators().proposer can diverge post-prune.
                    try:
                        info = json.loads(raw)
                    except ValueError:
                        continue
                    ptr = info.get("h")
                    if (
                        isinstance(ptr, int)
                        and ptr < retain_height
                        and "set" not in info
                        and "params" not in info
                    ):
                        self._db.set(
                            k, json.dumps({"h": retain_height}).encode()
                        )


class NoValidatorsError(Exception):
    def __init__(self, height: int):
        super().__init__(f"could not find validator set for height #{height}")


class NoParamsError(Exception):
    def __init__(self, height: int):
        super().__init__(f"could not find consensus params for height #{height}")


# -- state codec (JSON for readability; stable field set) ---------------------


def _encode_state(s: State) -> bytes:
    return json.dumps(
        {
            "chain_id": s.chain_id,
            "initial_height": s.initial_height,
            "last_block_height": s.last_block_height,
            "last_block_id": {
                "hash": s.last_block_id.hash.hex(),
                "psh_total": s.last_block_id.part_set_header.total,
                "psh_hash": s.last_block_id.part_set_header.hash.hex(),
            },
            "last_block_time": [s.last_block_time.seconds, s.last_block_time.nanos],
            "next_validators": s.next_validators.encode().hex() if s.next_validators else "",
            "validators": s.validators.encode().hex() if s.validators else "",
            "last_validators": s.last_validators.encode().hex() if s.last_validators else "",
            "last_height_validators_changed": s.last_height_validators_changed,
            "consensus_params": s.consensus_params.encode().hex(),
            "last_height_consensus_params_changed": s.last_height_consensus_params_changed,
            "last_results_hash": s.last_results_hash.hex(),
            "app_hash": s.app_hash.hex(),
            "version_block": s.version_consensus.block,
            "version_app": s.version_consensus.app,
        }
    ).encode()


def _decode_state(raw: bytes) -> State:
    from cometbft_tpu_torch.types.block import PartSetHeader

    d = json.loads(raw)
    return State(
        chain_id=d["chain_id"],
        initial_height=d["initial_height"],
        last_block_height=d["last_block_height"],
        last_block_id=BlockID(
            hash=bytes.fromhex(d["last_block_id"]["hash"]),
            part_set_header=PartSetHeader(
                d["last_block_id"]["psh_total"],
                bytes.fromhex(d["last_block_id"]["psh_hash"]),
            ),
        ),
        last_block_time=Time(*d["last_block_time"]),
        next_validators=ValidatorSet.decode(bytes.fromhex(d["next_validators"]))
        if d["next_validators"]
        else None,
        validators=ValidatorSet.decode(bytes.fromhex(d["validators"]))
        if d["validators"]
        else None,
        last_validators=ValidatorSet.decode(bytes.fromhex(d["last_validators"]))
        if d["last_validators"]
        else ValidatorSet(),
        last_height_validators_changed=d["last_height_validators_changed"],
        consensus_params=ConsensusParams.decode(bytes.fromhex(d["consensus_params"])),
        last_height_consensus_params_changed=d["last_height_consensus_params_changed"],
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        version_consensus=Consensus(d["version_block"], d["version_app"]),
    )
