"""Typed event system + EventBus (types/events.go, types/event_bus.go), the
port's copy of ``cometbft_tpu/types/events.py``.

The EventBus bridges consensus → RPC subscribers: consensus fires typed
events, subscribers filter with the pubsub query DSL
(types/event_bus.go:33,134).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from cometbft_tpu_torch.libs.pubsub import Query, Server

# Reserved event types (types/events.go:15-60).
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_LOCK = "Lock"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_POLKA = "Polka"
EVENT_RELOCK = "Relock"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"
EVENT_UNLOCK = "Unlock"
EVENT_VALID_BLOCK = "ValidBlock"
EVENT_VOTE = "Vote"

# Event attribute keys (types/events.go:185-200).
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


def query_for_event(event_type: str) -> Query:
    return Query(f"{EVENT_TYPE_KEY}='{event_type}'")


EVENT_QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
EVENT_QUERY_NEW_BLOCK_HEADER = query_for_event(EVENT_NEW_BLOCK_HEADER)
EVENT_QUERY_TX = query_for_event(EVENT_TX)
EVENT_QUERY_VOTE = query_for_event(EVENT_VOTE)
EVENT_QUERY_NEW_EVIDENCE = query_for_event(EVENT_NEW_EVIDENCE)
EVENT_QUERY_VALIDATOR_SET_UPDATES = query_for_event(EVENT_VALIDATOR_SET_UPDATES)


@dataclass
class EventDataNewBlock:
    block: Any
    block_id: Any = None
    result_begin_block: Any = None
    result_end_block: Any = None


@dataclass
class EventDataNewBlockHeader:
    header: Any
    num_txs: int = 0
    result_begin_block: Any = None
    result_end_block: Any = None


@dataclass
class EventDataTx:
    height: int
    tx: bytes
    index: int
    result: Any


@dataclass
class EventDataNewRound:
    height: int
    round: int
    step: str
    proposer_address: bytes = b""


@dataclass
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass
class EventDataVote:
    vote: Any


@dataclass
class EventDataNewEvidence:
    evidence: Any
    height: int


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list


@dataclass
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: Any


class EventBus:
    """types/event_bus.go: a thin typed wrapper over pubsub.Server."""

    def __init__(self):
        self._server = Server()

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop()

    def subscribe(self, subscriber: str, query: Query, out_capacity: int = 100):
        return self._server.subscribe(subscriber, query, out_capacity)

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self._server.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self._server.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self._server.num_clients()

    def _publish(self, event_type: str, data: Any, extra_attrs: dict | None = None) -> None:
        attrs = {EVENT_TYPE_KEY: [event_type]}
        if extra_attrs:
            for k, v in extra_attrs.items():
                attrs.setdefault(k, []).extend(v if isinstance(v, list) else [v])
        self._server.publish_with_events(data, attrs)

    # Typed publishers (event_bus.go:115-280).

    def publish_new_block(self, data: EventDataNewBlock, events: list | None = None) -> None:
        attrs = _abci_events_to_attrs(events)
        self._publish(EVENT_NEW_BLOCK, data, attrs)

    def publish_new_block_header(self, data: EventDataNewBlockHeader, events: list | None = None) -> None:
        self._publish(EVENT_NEW_BLOCK_HEADER, data, _abci_events_to_attrs(events))

    def publish_tx(self, data: EventDataTx, events: list | None = None) -> None:
        attrs = _abci_events_to_attrs(events)
        from cometbft_tpu_torch.types.tx import tx_hash

        attrs.setdefault(TX_HASH_KEY, []).append(tx_hash(data.tx).hex().upper())
        attrs.setdefault(TX_HEIGHT_KEY, []).append(str(data.height))
        self._publish(EVENT_TX, data, attrs)

    def publish_vote(self, data: EventDataVote) -> None:
        self._publish(EVENT_VOTE, data)

    def publish_new_evidence(self, data: EventDataNewEvidence) -> None:
        self._publish(EVENT_NEW_EVIDENCE, data)

    def publish_validator_set_updates(self, data: EventDataValidatorSetUpdates) -> None:
        self._publish(EVENT_VALIDATOR_SET_UPDATES, data)

    def publish_new_round(self, data: EventDataNewRound) -> None:
        self._publish(EVENT_NEW_ROUND, data)

    def publish_new_round_step(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_NEW_ROUND_STEP, data)

    def publish_complete_proposal(self, data: EventDataCompleteProposal) -> None:
        self._publish(EVENT_COMPLETE_PROPOSAL, data)

    def publish_timeout_propose(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_TIMEOUT_WAIT, data)

    def publish_polka(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_POLKA, data)

    def publish_relock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_RELOCK, data)

    def publish_lock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_LOCK, data)

    def publish_unlock(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_UNLOCK, data)

    def publish_valid_block(self, data: EventDataRoundState) -> None:
        self._publish(EVENT_VALID_BLOCK, data)


def _abci_events_to_attrs(events: list | None) -> dict:
    """Flatten ABCI events ([{type, attributes:[{key,value,index}]}]) into
    composite 'type.key' → [values] pubsub attributes."""
    attrs: dict[str, list] = {}
    for ev in events or []:
        ev_type = getattr(ev, "type", None) or (ev.get("type") if isinstance(ev, dict) else "")
        raw_attrs = getattr(ev, "attributes", None) or (
            ev.get("attributes", []) if isinstance(ev, dict) else []
        )
        if not ev_type:
            continue
        for a in raw_attrs:
            key = getattr(a, "key", None) or (a.get("key") if isinstance(a, dict) else None)
            value = getattr(a, "value", None) or (a.get("value", "") if isinstance(a, dict) else "")
            if isinstance(key, bytes):
                key = key.decode()
            if isinstance(value, bytes):
                value = value.decode()
            if key:
                attrs.setdefault(f"{ev_type}.{key}", []).append(value)
    return attrs
