"""Handshake replay: sync CometBFT state, block store, and the app on startup
(consensus/replay.go:241 Handshake, :284 ReplayBlocks), the port's copy of
``cometbft_tpu/consensus/replay.py``.

The three persisted tiers can legally differ by at most one height after a
crash (state <= store <= state+1, app <= store). The case analysis replays
whatever is behind so all three advance together — crucially, the block at
state_height+1 is applied via BlockExecutor.apply_block so consensus state,
store, and app stay in lockstep instead of the app silently running ahead
(replaying store-height blocks into the app without updating state would
double-execute that block on restart). That final block's ``apply_block``
runs ``validate_block``, which verifies its ``LastCommit`` on the process
backend.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci import types as abci_types
from cometbft_tpu_torch.state.execution import (
    BlockExecutor,
    build_last_commit_info,
    decode_responses,
)


class _ReplayMempool:
    """Stub mempool for handshake-time ApplyBlock (replay.go emptyMempool)."""

    def lock(self):
        pass

    def unlock(self):
        pass

    def flush_app_conn(self):
        pass

    def update(self, *a, **k):
        pass

    def reap_max_bytes_max_gas(self, *a):
        return []


class _MockCommitConn:
    """Proxy-app stand-in replaying stored ABCI responses
    (consensus/replay_stubs.go newMockProxyApp): used when the app already
    ran Commit but CometBFT crashed before saving state — re-running the
    block against the real app would double-execute it."""

    def __init__(self, app_hash: bytes, stored_responses: dict):
        self._app_hash = app_hash
        self._responses = stored_responses
        self._tx_idx = 0

    def begin_block(self, req):
        return self._responses["begin_block"]

    def deliver_tx(self, req):
        r = self._responses["deliver_txs"][self._tx_idx]
        self._tx_idx += 1
        return r

    def end_block(self, req):
        return self._responses["end_block"]

    def commit(self):
        return abci_types.ResponseCommit(data=self._app_hash)

    def prepare_proposal(self, req):  # pragma: no cover - not used in replay
        return abci_types.ResponsePrepareProposal(txs=list(req.txs))

    def process_proposal(self, req):  # pragma: no cover
        return abci_types.ResponseProcessProposal(
            status=abci_types.PROCESS_PROPOSAL_ACCEPT
        )


class AppHashMismatchError(RuntimeError):
    pass


class AppHeightError(RuntimeError):
    pass


class Handshaker:
    """consensus/replay.go:213-238."""

    def __init__(self, state_store, state, block_store, genesis_doc, event_bus=None, logger=None):
        self.state_store = state_store
        self.initial_state = state
        self.store = block_store
        self.genesis_doc = genesis_doc
        self.event_bus = event_bus
        self.logger = logger
        self.n_blocks = 0

    def handshake(self, proxy_app):
        """Query app Info, replay as needed. Returns the synced State."""
        info = proxy_app.query.info(abci_types.RequestInfo())
        app_height = info.last_block_height
        if app_height < 0:
            raise AppHeightError(f"got negative app height {app_height}")
        return self.replay_blocks(
            self.initial_state, info.last_block_app_hash, app_height, proxy_app
        )

    # -- replay.go:284 ReplayBlocks -------------------------------------------

    def replay_blocks(self, state, app_hash, app_height, proxy_app):
        store_base = self.store.base()
        store_height = self.store.height()
        state_height = state.last_block_height

        if app_height == 0:
            state, app_hash = self._init_chain(state, proxy_app)

        # Edge cases on store height/base (replay.go:358-383).
        if store_height == 0:
            _assert_app_hash(app_hash, state.app_hash, "state")
            return state
        if app_height == 0 and state.initial_height < store_base:
            raise AppHeightError(
                f"app has no state; block store truncated to base {store_base}"
            )
        if 0 < app_height < store_base - 1:
            raise AppHeightError(
                f"app height {app_height} too far below store base {store_base}"
            )
        if store_height < app_height:
            raise AppHeightError(
                f"app height ({app_height}) is higher than core ({store_height})"
            )
        if store_height < state_height:
            raise RuntimeError(
                f"StateBlockHeight ({state_height}) > StoreBlockHeight ({store_height})"
            )
        if store_height > state_height + 1:
            raise RuntimeError(
                f"StoreBlockHeight ({store_height}) > StateBlockHeight+1 ({state_height + 1})"
            )

        if store_height == state_height:
            # CometBFT ran Commit and saved state; app may ask for replay.
            if app_height < store_height:
                replayed = self._replay_blocks_through_app(
                    state, proxy_app, app_height, store_height
                )
                # replay.go:488 assertAppHashEqualsOneFromState: replay does
                # not mutate state here, so the app must land exactly on the
                # hash consensus already committed to.
                _assert_app_hash(replayed, state.app_hash, "state")
            elif app_height == store_height:
                _assert_app_hash(app_hash, state.app_hash, "state")
            return state

        # store_height == state_height + 1: block saved, state not updated.
        if app_height < state_height:
            # App even further behind: replay up to state_height through the
            # app, then apply the final block for real (mutateState).
            self._replay_blocks_through_app(state, proxy_app, app_height, state_height)
            return self._replay_final_block(state, store_height, proxy_app.consensus)
        if app_height == state_height:
            # Commit never ran: apply the stored block via the real app so
            # state/store/app advance together (replay.go:421).
            return self._replay_final_block(state, store_height, proxy_app.consensus)
        if app_height == store_height:
            # App ran Commit but state wasn't saved: replay through a mock
            # conn fed by the stored ABCI responses (replay.go:429-438).
            raw = self.state_store.load_abci_responses(store_height)
            if raw is None:
                raise RuntimeError(
                    f"no stored ABCI responses for height {store_height}; "
                    "cannot replay the committed block without re-executing it"
                )
            mock = _MockCommitConn(app_hash, decode_responses(raw))
            return self._replay_final_block(state, store_height, mock)
        raise RuntimeError(
            f"uncovered replay case: app {app_height}, store {store_height}, "
            f"state {state_height}"
        )

    # -- helpers ---------------------------------------------------------------

    def _init_chain(self, state, proxy_app):
        """replay.go:303-355 (InitChain at genesis)."""
        validators = [
            abci_types.ValidatorUpdate(pub_key=v.pub_key, power=v.power)
            for v in self.genesis_doc.validators
        ]
        res = proxy_app.consensus.init_chain(
            abci_types.RequestInitChain(
                time_seconds=self.genesis_doc.genesis_time.seconds,
                chain_id=self.genesis_doc.chain_id,
                consensus_params=self.genesis_doc.consensus_params,
                validators=validators,
                app_state_bytes=_app_state_bytes(self.genesis_doc.app_state),
                initial_height=self.genesis_doc.initial_height,
            )
        )
        app_hash = res.app_hash
        if state.last_block_height == 0:
            if res.app_hash:
                state.app_hash = res.app_hash
            if res.validators:
                from cometbft_tpu_torch.types.validator import Validator
                from cometbft_tpu_torch.types.validator_set import ValidatorSet

                vals = [Validator.new(vu.pub_key, vu.power) for vu in res.validators]
                state.validators = ValidatorSet(vals)
                state.next_validators = state.validators.copy_increment_proposer_priority(1)
            elif not self.genesis_doc.validators:
                raise RuntimeError(
                    "validator set is nil in genesis and still empty after InitChain"
                )
            if res.consensus_params is not None:
                state.consensus_params = state.consensus_params.update(
                    res.consensus_params
                )
            self.state_store.save(state)
        return state, app_hash

    def _replay_blocks_through_app(self, state, proxy_app, from_height, to_height):
        """replay.go:439-490 replayBlocks: raw ABCI execution (no state
        mutation — historical validator sets come from the state store).
        Returns the app hash of the last replayed Commit so callers can run
        replay.go's assertAppHashEqualsOneFromState check."""
        first = from_height + 1
        if first == 1:
            first = state.initial_height
        app_hash = b""
        for h in range(first, to_height + 1):
            block = self.store.load_block(h)
            if block is None:
                raise RuntimeError(f"block store has no block at height {h}")
            app_hash = self._exec_commit_block(
                proxy_app.consensus, block, h, state.initial_height
            )
            self.n_blocks += 1
        return app_hash

    def _exec_commit_block(self, conn, block, height, initial_height=1):
        """sm.ExecCommitBlock: BeginBlock/DeliverTx*/EndBlock/Commit with the
        historical validator set for last_commit_info."""
        vals_prev = None
        if height > initial_height:
            # A missing validator record is fatal (sm.ExecCommitBlock panics):
            # replaying with an empty last_commit_info would silently feed the
            # app different vote info than it saw live → app-hash divergence.
            vals_prev = self.state_store.load_validators(height - 1)
        commit_info = build_last_commit_info(block.last_commit, vals_prev)
        conn.begin_block(
            abci_types.RequestBeginBlock(
                hash=block.hash() or b"",
                header=block.header,
                last_commit_info=commit_info,
            )
        )
        for tx in block.data.txs:
            conn.deliver_tx(abci_types.RequestDeliverTx(tx=tx))
        conn.end_block(abci_types.RequestEndBlock(height=height))
        res = conn.commit()
        return res.data

    def _replay_final_block(self, state, height, conn):
        """replay.go:492-512 replayBlock: full ApplyBlock so state advances."""
        block = self.store.load_block(height)
        meta = self.store.load_block_meta(height)
        if block is None or meta is None:
            raise RuntimeError(f"block store missing block/meta at height {height}")
        block_exec = BlockExecutor(
            self.state_store,
            conn,
            _ReplayMempool(),
            None,
            self.store,
            self.event_bus,
            self.logger,
        )
        new_state, _ = block_exec.apply_block(state, meta.block_id, block)
        self.n_blocks += 1
        return new_state


def _app_state_bytes(app_state) -> bytes:
    """GenesisDoc.app_state is parsed JSON; ABCI wants the raw bytes."""
    if app_state is None:
        return b""
    if isinstance(app_state, (bytes, bytearray)):
        return bytes(app_state)
    import json

    return json.dumps(app_state).encode()


def _assert_app_hash(app_hash: bytes, expected: bytes, what: str) -> None:
    if app_hash != expected:
        raise AppHashMismatchError(
            f"app hash {app_hash.hex()} does not match {what} app hash "
            f"{expected.hex()} after replay. Did you reset CometBFT without "
            "resetting the application?"
        )
