"""BlockExecutor: proposal creation and ApplyBlock pipeline
(state/execution.go), the port's copy of ``cometbft_tpu/state/execution.py``.

ApplyBlock = validate → BeginBlock/DeliverTx*/EndBlock over the consensus
ABCI connection → save responses → update state (validator/param updates
with the +1 delay) → app Commit under mempool lock → prune → fire events
(state/execution.go:194-280).

The event bus (``types/events.EventBus``) may be None, as blocksync's
callers pass it; with one, ``apply_block`` publishes NewBlock,
NewBlockHeader, one Tx event a transaction and ValidatorSetUpdates, as the
reference does. The evidence pool is duck-typed and may be None.
"""

from __future__ import annotations

import base64

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import fail
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.state.validation import validate_block
from cometbft_tpu_torch.types import events as ev
from cometbft_tpu_torch.types.block import Block, BlockID, Commit
from cometbft_tpu_torch.types.results import results_hash
from cometbft_tpu_torch.types.validator import Validator


class BlockExecutor:
    """state/execution.go:42-90."""

    def __init__(
        self,
        state_store,
        app_conn_consensus,
        mempool,
        evidence_pool,
        block_store=None,
        event_bus=None,
        logger=None,
    ):
        self.state_store = state_store
        self.proxy_app = app_conn_consensus
        self.mempool = mempool
        self.evpool = evidence_pool
        self.block_store = block_store
        self.event_bus = event_bus
        self.logger = logger

    # -- proposal path -------------------------------------------------------

    def create_proposal_block(
        self, height: int, state: State, commit: Commit | None, proposer_addr: bytes
    ) -> Block:
        """state/execution.go:100-150: reap mempool, pass through the app's
        PrepareProposal, assemble the block."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence, ev_size = (
            self.evpool.pending_evidence(state.consensus_params.evidence.max_bytes)
            if self.evpool
            else ([], 0)
        )
        # MaxDataBytes accounting (types/block.go MaxDataBytes).
        max_data_bytes = max_data_bytes_for(max_bytes, ev_size, state.validators.size())
        txs = self.mempool.reap_max_bytes_max_gas(max_data_bytes, max_gas)
        local_last_commit = self._build_last_commit_info(state, commit)
        rpp = self.proxy_app.prepare_proposal(
            abci.RequestPrepareProposal(
                max_tx_bytes=max_data_bytes,
                txs=list(txs),
                local_last_commit=local_last_commit,
                misbehavior=_abci_evidence(evidence),
                height=height,
                time_seconds=0,
                proposer_address=proposer_addr,
            )
        )
        return state.make_block(height, list(rpp.txs), commit, evidence, proposer_addr)

    def process_proposal(self, block: Block, state: State) -> bool:
        """state/execution.go:152-178."""
        resp = self.proxy_app.process_proposal(
            abci.RequestProcessProposal(
                txs=list(block.data.txs),
                proposed_last_commit=self._build_last_commit_info(
                    state, block.last_commit
                ),
                misbehavior=_abci_evidence(block.evidence),
                hash=block.hash() or b"",
                height=block.header.height,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
            )
        )
        return resp.is_accepted()

    # -- apply path ----------------------------------------------------------

    def validate_block(self, state: State, block: Block) -> None:
        """state/execution.go:180-192: header/commit checks + evidence check."""
        validate_block(state, block)
        if self.evpool:
            self.evpool.check_evidence(block.evidence)

    def apply_block(
        self, state: State, block_id: BlockID, block: Block
    ) -> tuple[State, int]:
        """state/execution.go:194-280. Returns (new_state, retain_height)."""
        self.validate_block(state, block)
        abci_responses = self._exec_block_on_proxy_app(state, block)
        fail.fail()  # kill-point: block executed, responses unsaved (execution.go:212)
        # Save ABCI responses for /block_results + reindexing.
        self.state_store.save_abci_responses(
            block.header.height, _encode_responses(abci_responses)
        )
        fail.fail()  # kill-point: responses saved, state not updated (execution.go:219)
        validator_updates = abci_responses["end_block"].validator_updates
        _validate_validator_updates(validator_updates, state.consensus_params)
        new_state = _update_state(
            state, block_id, block, abci_responses, validator_updates
        )
        # Lock mempool, commit app, update mempool (state/execution.go:288-330).
        fail.fail()  # kill-point: before app Commit (execution.go:255)
        app_hash, retain_height = self._commit(new_state, block, abci_responses)
        fail.fail()  # kill-point: app committed, state unsaved (execution.go:263)
        new_state.app_hash = app_hash
        self.state_store.save(new_state)
        # Evidence pool update (prune committed/expired evidence).
        if self.evpool:
            self.evpool.update(new_state, block.evidence)
        self._fire_events(block, block_id, abci_responses, validator_updates)
        return new_state, retain_height

    def _commit(self, state: State, block: Block, abci_responses) -> tuple[bytes, int]:
        """state/execution.go:288-330: flush mempool conn, app Commit with
        mempool locked, then mempool.Update with DeliverTx results."""
        self.mempool.lock()
        try:
            self.mempool.flush_app_conn()
            res = self.proxy_app.commit()
            deliver_txs = abci_responses["deliver_txs"]
            self.mempool.update(
                block.header.height,
                list(block.data.txs),
                deliver_txs,
                None,
                None,
            )
            return res.data, res.retain_height
        finally:
            self.mempool.unlock()

    def _exec_block_on_proxy_app(self, state: State, block: Block) -> dict:
        """state/execution.go:336-410: BeginBlock, DeliverTx xN, EndBlock."""
        commit_info = self._build_last_commit_info(state, block.last_commit)
        byz_vals = _abci_evidence(block.evidence)
        begin = self.proxy_app.begin_block(
            abci.RequestBeginBlock(
                hash=block.hash() or b"",
                header=block.header,
                last_commit_info=commit_info,
                byzantine_validators=byz_vals,
            )
        )
        deliver_txs = []
        for tx in block.data.txs:
            deliver_txs.append(self.proxy_app.deliver_tx(abci.RequestDeliverTx(tx=tx)))
        end = self.proxy_app.end_block(
            abci.RequestEndBlock(height=block.header.height)
        )
        return {"begin_block": begin, "deliver_txs": deliver_txs, "end_block": end}

    def _build_last_commit_info(
        self, state: State, commit: Commit | None
    ) -> abci.CommitInfo:
        """getBeginBlockValidatorInfo (state/execution.go:420-460): match the
        commit's signatures against the validator set at that height."""
        if commit is None or state.last_block_height == 0:
            return abci.CommitInfo()
        return build_last_commit_info(commit, state.last_validators)

    def _fire_events(self, block, block_id, abci_responses, validator_updates) -> None:
        """state/execution.go fireEvents: NewBlock, NewBlockHeader, per-Tx,
        ValidatorSetUpdates."""
        if self.event_bus is None:
            return
        begin = abci_responses["begin_block"]
        end = abci_responses["end_block"]
        self.event_bus.publish_new_block(
            ev.EventDataNewBlock(
                block=block,
                block_id=block_id,
                result_begin_block=begin,
                result_end_block=end,
            ),
            events=list(begin.events) + list(end.events),
        )
        self.event_bus.publish_new_block_header(
            ev.EventDataNewBlockHeader(
                header=block.header,
                num_txs=len(block.data.txs),
                result_begin_block=begin,
                result_end_block=end,
            )
        )
        for i, tx in enumerate(block.data.txs):
            res = abci_responses["deliver_txs"][i]
            self.event_bus.publish_tx(
                ev.EventDataTx(
                    height=block.header.height, tx=tx, index=i, result=res
                ),
                events=res.events,
            )
        if validator_updates:
            self.event_bus.publish_validator_set_updates(
                ev.EventDataValidatorSetUpdates(validator_updates=validator_updates)
            )


def build_last_commit_info(commit: Commit | None, vals) -> abci.CommitInfo:
    """Positional commit-sig ↔ validator matching for BeginBlock
    (state/execution.go getBeginBlockValidatorInfo); `vals` must be the
    validator set of the commit's height (historical on replay)."""
    if commit is None or vals is None:
        return abci.CommitInfo()
    votes = []
    for i, cs in enumerate(commit.signatures):
        if i >= vals.size():
            break
        val = vals.validators[i]
        votes.append(
            abci.VoteInfo(
                validator_address=val.address,
                validator_power=val.voting_power,
                signed_last_block=not cs.is_absent(),
            )
        )
    return abci.CommitInfo(round=commit.round, votes=votes)


def max_data_bytes_for(max_bytes: int, evidence_bytes: int, vals_count: int) -> int:
    """types/block.go MaxDataBytes approximation: block max minus header,
    commit, and evidence overheads."""
    from cometbft_tpu_torch.types.block import (
        MAX_COMMIT_OVERHEAD_BYTES,
        MAX_COMMIT_SIG_BYTES,
        MAX_HEADER_BYTES,
    )

    if max_bytes == -1:
        from cometbft_tpu_torch.types.params import MAX_BLOCK_SIZE_BYTES

        max_bytes = MAX_BLOCK_SIZE_BYTES
    commit_bytes = MAX_COMMIT_OVERHEAD_BYTES + MAX_COMMIT_SIG_BYTES * vals_count
    data = max_bytes - MAX_HEADER_BYTES - commit_bytes - evidence_bytes - 64
    return max(data, 0)


def _validate_validator_updates(updates: list, params) -> None:
    """state/validation.go validateValidatorUpdates."""
    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative {vu}")
        if vu.power == 0:
            continue
        if vu.pub_key.type() not in params.validator.pub_key_types:
            raise ValueError(
                f"validator {vu} is using pubkey {vu.pub_key.type()}, which is "
                f"unsupported for consensus"
            )


def _update_state(
    state: State, block_id: BlockID, block: Block, abci_responses, validator_updates
) -> State:
    """state/execution.go:241 updateState."""
    n_val_set = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        changes = [
            Validator.new(vu.pub_key, vu.power) for vu in validator_updates
        ]
        n_val_set.update_with_change_set(changes)
        last_height_vals_changed = block.header.height + 1 + 1
    n_val_set.increment_proposer_priority(1)

    params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    param_updates = abci_responses["end_block"].consensus_param_updates
    if param_updates is not None:
        params = params.update(param_updates)
        params.validate_basic()
        last_height_params_changed = block.header.height + 1

    from dataclasses import replace

    version = state.version_consensus
    if params.version.app != version.app:
        from cometbft_tpu_torch.types.block import Consensus

        version = Consensus(block=version.block, app=params.version.app)

    return State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=block.header.height,
        last_block_id=block_id,
        last_block_time=block.header.time,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=results_hash(abci_responses["deliver_txs"]),
        app_hash=b"",
        version_consensus=version,
    )


def _abci_evidence(evidence: list) -> list:
    """Evidence → abci.Misbehavior (types/evidence.go ABCI conversion)."""
    out = []
    for evd in evidence:
        from cometbft_tpu_torch.types.evidence import (
            DuplicateVoteEvidence,
            LightClientAttackEvidence,
        )

        if isinstance(evd, DuplicateVoteEvidence):
            out.append(
                abci.Misbehavior(
                    type=abci.MISBEHAVIOR_DUPLICATE_VOTE,
                    validator_address=evd.vote_a.validator_address,
                    validator_power=evd.validator_power,
                    height=evd.height(),
                    time_seconds=evd.timestamp.seconds,
                    total_voting_power=evd.total_voting_power,
                )
            )
        elif isinstance(evd, LightClientAttackEvidence):
            for v in evd.byzantine_validators:
                out.append(
                    abci.Misbehavior(
                        type=abci.MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
                        validator_address=v.address,
                        validator_power=v.voting_power,
                        height=evd.height(),
                        time_seconds=evd.timestamp.seconds,
                        total_voting_power=evd.total_voting_power,
                    )
                )
    return out


def _encode_responses(abci_responses: dict) -> dict:
    """JSON-able form of the ABCI responses for the state store. Must be
    COMPLETE enough to re-run updateState from storage alone: the handshake's
    ran-Commit-but-didn't-save-state replay path (consensus/replay.go:420
    mock app) rebuilds EndBlock validator/param updates from here."""

    def enc_events(events):
        return [
            {
                "type": e.type,
                "attributes": [
                    {"key": a.key, "value": a.value, "index": a.index}
                    for a in e.attributes
                ],
            }
            for e in events
        ]

    def enc_tx(r):
        return {
            "code": r.code,
            "data": base64.b64encode(r.data).decode(),
            "log": r.log,
            "gas_wanted": r.gas_wanted,
            "gas_used": r.gas_used,
            "events": enc_events(r.events),
        }

    from cometbft_tpu_torch.crypto.encoding import pub_key_to_proto

    end = abci_responses["end_block"]
    return {
        "deliver_txs": [enc_tx(r) for r in abci_responses["deliver_txs"]],
        "end_block": {
            "validator_updates": [
                {
                    "pub_key": base64.b64encode(pub_key_to_proto(vu.pub_key)).decode(),
                    "power": vu.power,
                }
                for vu in end.validator_updates
            ],
            "consensus_param_updates": _enc_param_updates(
                end.consensus_param_updates
            ),
        },
        "begin_block": {},
    }


def _enc_param_updates(updates) -> dict | None:
    """Section-wise JSON of an abci.ConsensusParams-shaped update. The object
    is PARTIAL by contract (ConsensusParams.update getattr-guards each
    section), so it can't be run through ConsensusParams.encode()."""
    if updates is None:
        return None
    out = {}
    block = getattr(updates, "block", None)
    if block is not None:
        out["block"] = {"max_bytes": block.max_bytes, "max_gas": block.max_gas}
    evidence = getattr(updates, "evidence", None)
    if evidence is not None:
        out["evidence"] = {
            "max_age_num_blocks": evidence.max_age_num_blocks,
            "max_age_duration_ns": evidence.max_age_duration_ns,
            "max_bytes": evidence.max_bytes,
        }
    validator = getattr(updates, "validator", None)
    if validator is not None:
        out["validator"] = {"pub_key_types": list(validator.pub_key_types)}
    version = getattr(updates, "version", None)
    if version is not None:
        out["version"] = {"app": version.app}
    return out


def _dec_param_updates(raw: dict | None):
    if not raw:
        return None
    from types import SimpleNamespace

    ns = SimpleNamespace(block=None, evidence=None, validator=None, version=None)
    if "block" in raw:
        ns.block = SimpleNamespace(**raw["block"])
    if "evidence" in raw:
        ns.evidence = SimpleNamespace(**raw["evidence"])
    if "validator" in raw:
        ns.validator = SimpleNamespace(**raw["validator"])
    if "version" in raw:
        ns.version = SimpleNamespace(**raw["version"])
    return ns


def decode_responses(raw: dict) -> dict:
    """Inverse of _encode_responses: rebuild the in-memory ABCI response
    objects the replay/mock-app path feeds back through updateState."""

    def dec_events(items):
        return [
            abci.Event(
                type=e["type"],
                attributes=[
                    abci.EventAttribute(a["key"], a["value"], a["index"])
                    for a in e["attributes"]
                ],
            )
            for e in items
        ]

    def dec_tx(d):
        return abci.ResponseDeliverTx(
            code=d["code"],
            data=base64.b64decode(d["data"]),
            log=d["log"],
            gas_wanted=d["gas_wanted"],
            gas_used=d["gas_used"],
            events=dec_events(d.get("events", [])),
        )

    from cometbft_tpu_torch.crypto.encoding import pub_key_from_proto

    end = raw.get("end_block") or {}
    vus = end.get("validator_updates") or []
    if isinstance(vus, int):
        # Legacy records stored only a count — not enough to rebuild
        # updateState. Degrading to [] would silently drop validator updates
        # and diverge from committed validators_hash; fail loudly instead.
        raise RuntimeError(
            "stored ABCI responses use the legacy summary format and cannot "
            "be replayed; reset the node or re-sync"
        )
    param_updates = _dec_param_updates(end.get("consensus_param_updates"))
    return {
        "deliver_txs": [dec_tx(d) for d in raw.get("deliver_txs", [])],
        "end_block": abci.ResponseEndBlock(
            validator_updates=[
                abci.ValidatorUpdate(
                    pub_key=pub_key_from_proto(base64.b64decode(vu["pub_key"])),
                    power=vu["power"],
                )
                for vu in vus
            ],
            consensus_param_updates=param_updates,
        ),
        "begin_block": abci.ResponseBeginBlock(),
    }
