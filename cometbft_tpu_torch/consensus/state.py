"""The Tendermint BFT consensus state machine (consensus/state.go), the
port's copy of ``cometbft_tpu/consensus/state.py``.

Single-writer design exactly like the reference's receiveRoutine
(consensus/state.go:718-806): one thread owns all round state; peer
messages, own messages, and timeouts are serialized through one queue. Own
messages are fsynced to the WAL before processing (state.go:774), peer
messages are buffered-written.

Height/round/step transitions (state.go:988-1720): NewRound → Propose →
Prevote → PrevoteWait → Precommit → PrecommitWait → Commit, with POL
locking/unlocking rules and valid-block tracking.

Vote signatures reach the card through two pre-verifies: each drain of up
to 256 queued peer messages checks its votes in one ``BatchVerifier`` call
under the consensus admission class, and a restart checks the seen commit
in one call; ``VoteSet.add_vote`` then answers from the verified-triple
cache. Every exception the reference swallows here is counted on the state
machine with the last one kept, and the machine carries on as the
reference does: ``prebatch_errors`` (both pre-verifies),
``consensus_failures`` (the receive routine), ``stall_errors`` (the
watchdog's hook and re-arm), ``prune_errors``, ``self_sign_cache_errors``
and ``wal_catchup_errors``, each with its ``last_*`` error.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
from cometbft_tpu_torch.consensus import cstypes
from cometbft_tpu_torch.consensus.cstypes import (
    STEP_COMMIT,
    STEP_NEW_HEIGHT,
    STEP_NEW_ROUND,
    STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT,
    STEP_PREVOTE,
    STEP_PREVOTE_WAIT,
    STEP_PROPOSE,
    HeightVoteSet,
    RoundState,
)
from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    HasVoteMessage,
    ProposalMessage,
    TimeoutInfo,
    VoteMessage,
)
from cometbft_tpu_torch.consensus.ticker import TimeoutTicker
from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage
from cometbft_tpu_torch.libs import fail
from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.privval.file import (
    STEP_PRECOMMIT as PV_STEP_PRECOMMIT,
    STEP_PREVOTE as PV_STEP_PREVOTE,
)
from cometbft_tpu_torch.types import cmttime, events as ev
from cometbft_tpu_torch.types.canonical import decode_canonical_vote
from cometbft_tpu_torch.types.block import (
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    BlockID,
    Commit,
    PartSetHeader,
)
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import ErrVoteConflictingVotes, VoteError


class _NilWAL:
    def write(self, msg):
        pass

    def write_sync(self, msg):
        pass

    def flush_and_sync(self):
        pass

    def start(self):
        pass

    def stop(self):
        pass


class ConsensusState:
    """consensus/state.go State."""

    def __init__(
        self,
        config,
        state,
        block_exec,
        block_store,
        mempool,
        evpool=None,
        event_bus=None,
        wal: WAL | None = None,
        ticker: TimeoutTicker | None = None,
        logger=None,
        name: str = "",
        metrics=None,
        clock=None,
    ):
        from cometbft_tpu_torch.simnet.clock import MonotonicClock

        self.clock = clock or MonotonicClock()
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool
        self.evpool = evpool
        self.event_bus = event_bus
        self.wal = wal or _NilWAL()
        self.ticker = ticker or TimeoutTicker(clock=self.clock)
        self.logger = logger
        self.name = name
        from cometbft_tpu_torch.consensus.metrics import Metrics as _CsMetrics

        self.metrics = metrics or _CsMetrics()

        self.rs = RoundState()
        self.state = None  # sm.State, set in update_to_state
        # Errors the reference swallows, counted (module docstring).
        self.prebatch_errors = 0
        self.last_prebatch_error: Exception | None = None
        self.consensus_failures = 0
        self.last_consensus_failure: Exception | None = None
        self.stall_errors = 0
        self.last_stall_error: Exception | None = None
        self.prune_errors = 0
        self.last_prune_error: Exception | None = None
        self.self_sign_cache_errors = 0
        self.last_self_sign_cache_error: Exception | None = None
        self.wal_catchup_errors = 0
        self.last_wal_catchup_error: Exception | None = None
        # Known-bad (pub, sig, signbytes) triples seen by the prebatcher —
        # see _prebatch_vote_signatures.
        self._failed_triples: dict[bytes, None] = {}
        self.priv_validator = None
        self.priv_validator_pub_key = None
        self.replay_mode = False
        self.do_wal_catchup = True

        # Unbounded: the single consumer also produces (own proposal parts and
        # votes enter this queue from inside the receive routine), so a
        # bounded queue could self-deadlock on large blocks.
        self._queue: queue.Queue = queue.Queue()
        self._mtx = threading.RLock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._broadcast = None  # fn(msg) -> None: reactor / test harness hook
        self._height_events = threading.Condition()
        # Stall watchdog: no round-step progress for stall_factor × the
        # current round's full timeout budget ⇒ re-announce + re-arm.
        self._on_stall = None  # reactor hook: fn() -> None
        self._last_progress = self.clock.now()
        self._stall_factor = getattr(config, "stall_watchdog_factor", 10.0)
        env_factor = os.environ.get("CMTPU_STALL_FACTOR")
        if env_factor:
            try:
                self._stall_factor = float(env_factor)
            except ValueError:
                pass

        self.update_to_state(state)
        self._reconstruct_last_commit_if_needed(state)

    # -- wiring ---------------------------------------------------------------

    def set_priv_validator(self, pv) -> None:
        with self._mtx:
            self.priv_validator = pv
            if pv is not None:
                self.priv_validator_pub_key = pv.get_pub_key()

    def set_broadcast(self, fn) -> None:
        """Reactor hook: called with every own message to gossip
        (ProposalMessage / BlockPartMessage / VoteMessage)."""
        self._broadcast = fn

    def set_on_stall(self, fn) -> None:
        """Reactor hook: called (from the watchdog thread) when no round-step
        progress has been made for the stall budget."""
        self._on_stall = fn

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self.wal.start()
        self.ticker.start()
        # Catch up within the current height from the WAL BEFORE processing
        # new messages (state.go:318-370): a node that crashed mid-height
        # replays its own proposals/votes/timeouts so it can't equivocate and
        # doesn't stall the round. Corrupted WALs get one repair attempt.
        if self.do_wal_catchup:
            self._wal_catchup_with_repair()
        # Hand ticker tocks into the unified queue.
        self._running = True
        self._tock_pump = threads.spawn(self._pump_tocks)
        self._thread = threads.spawn(self._receive_routine)
        if self.rs.round == 0 and self.rs.step == STEP_NEW_HEIGHT:
            self._schedule_round0()
        else:
            # WAL replay restored a later round/step: a round-0 NEW_HEIGHT
            # timeout would be discarded by _handle_timeout AND (single-timer
            # ticker) would clobber the restored step's pending timer — re-arm
            # the timer the restored step actually needs.
            with self._mtx:
                self._rearm_step_timeout()
        self._last_progress = self.clock.now()
        if self._stall_factor > 0:
            threads.spawn(self._stall_watchdog_routine)

    def _wal_catchup_with_repair(self) -> None:
        """state.go:320-370: catchupReplay, with a one-shot corrupted-WAL
        repair (backup to .CORRUPTED, keep intact prefix, retry)."""
        from cometbft_tpu_torch.consensus.wal import DataCorruptionError, repair_wal

        repair_attempted = False
        while True:
            try:
                self._catchup_replay(self.rs.height)
                return
            except DataCorruptionError as e:
                if repair_attempted:
                    raise
                repair_attempted = True
                path = getattr(self.wal, "path", None)
                if path is None:
                    raise
                self._log(f"WAL corrupted ({e}); attempting repair")
                self.wal.stop()
                corrupted = path + ".CORRUPTED"
                import shutil

                shutil.copyfile(path, corrupted)
                repair_wal(corrupted, path)
                self.wal.reopen()
                # Re-anchor: if repair emptied the file, start() rewrites the
                # EndHeightMessage(0) replay anchor (state.go loadWalFile
                # re-runs OnStart).
                self.wal.start()
            except Exception as e:
                # Non-corruption replay errors: log and start anyway
                # (state.go:330 "proceeding to start state anyway").
                self.wal_catchup_errors += 1
                self.last_wal_catchup_error = e
                self._log(f"error on WAL catchup replay; starting anyway: {e}")
                return

    def _catchup_replay(self, cs_height: int) -> None:
        """consensus/replay.go:93 catchupReplay: re-apply every WAL message
        recorded after the last committed height's EndHeightMessage."""
        from cometbft_tpu_torch.consensus.wal import DataCorruptionError

        self.replay_mode = True
        try:
            if cs_height < self.state.initial_height:
                raise RuntimeError(
                    f"cannot replay height {cs_height}, below initial height "
                    f"{self.state.initial_height}"
                )
            end_height = cs_height - 1
            if cs_height == self.state.initial_height:
                end_height = 0
            if not hasattr(self.wal, "catchup_scan"):
                return  # nil WAL
            # One pass answers both: messages to replay, and the sanity check
            # that no #ENDHEIGHT exists for the CURRENT height (that would
            # mean update_to_state should already have advanced past it).
            msgs, saw_cs_end = self.wal.catchup_scan(end_height, cs_height)
            if saw_cs_end:
                raise RuntimeError(f"wal should not contain #ENDHEIGHT {cs_height}")
            if msgs is None:
                raise RuntimeError(
                    f"cannot replay height {cs_height}: WAL has no #ENDHEIGHT "
                    f"for {end_height}"
                )
            msgs = list(msgs)
            # Restore the ROUND reached before the crash, not round 0. Only
            # own messages (write_sync, fsynced) and our own ticker's
            # timeouts are trusted for this — a garbage peer vote in the
            # buffered WAL tail must not drag us to an arbitrary round.
            wal_round = self._scan_wal_round(msgs, cs_height)
            if wal_round > 0:
                # Enter BEFORE replaying: _set_proposal only accepts the
                # proposal for rs.round, and entering pre-creates the vote
                # sets so own votes from intermediate rounds land instead of
                # tripping HeightVoteSet's 2-catchup-round peer limit.
                with self._mtx:
                    self.rs.votes.set_round(wal_round + 1)
                    self._enter_new_round(cs_height, wal_round)
            n = 0
            for tm in msgs:
                self._read_replay_message(tm)
                n += 1
            # Message replay alone leaves the step wherever vote majorities
            # drove it; if our own recorded votes prove we got further
            # (peer votes/timeouts are buffered writes and die with a
            # SIGKILL), re-enter those steps. replay_mode swallows the
            # double-sign refusals; identical re-signs rebroadcast our votes.
            with self._mtx:
                self._recover_privval_vote(cs_height)
                self._restore_wal_step(cs_height)
            self.metrics.wal_replay_round.set(self.rs.round)
            if n:
                self._log(
                    f"WAL catchup: replayed {n} messages at height {cs_height}"
                    f" (round {self.rs.round})"
                )
        finally:
            self.replay_mode = False

    def _scan_wal_round(self, msgs, cs_height: int) -> int:
        """Highest round provably reached before the crash: our own signed
        votes (fsynced before processing) and our own ticker's timeouts."""
        own_addr = (
            self.priv_validator_pub_key.address()
            if self.priv_validator_pub_key is not None
            else None
        )
        wal_round = 0
        for tm in msgs:
            msg = tm.msg
            if isinstance(msg, TimeoutInfo) and msg.height == cs_height:
                wal_round = max(wal_round, msg.round)
            elif (
                isinstance(msg, VoteMessage)
                and msg.vote.height == cs_height
                and own_addr is not None
                and msg.vote.validator_address == own_addr
            ):
                wal_round = max(wal_round, msg.vote.round)
        # The privval fsyncs its last-sign state BEFORE the vote reaches the
        # WAL (sign_vote persists, then _send_internal queues the write), so
        # a crash in that window leaves a signed round the WAL never saw.
        # The sign state is as trustworthy as our own fsynced votes.
        lss = getattr(self.priv_validator, "last_sign_state", None)
        if (
            lss is not None
            and getattr(lss, "height", None) == cs_height
            and getattr(lss, "step", 0) in (PV_STEP_PREVOTE, PV_STEP_PRECOMMIT)
        ):
            wal_round = max(wal_round, lss.round)
        return wal_round

    def _recover_privval_vote(self, cs_height: int) -> None:
        """Re-publish the privval's last signed vote when the WAL lost it.

        A crash between FilePV's fsync and the WAL's write_sync leaves the
        privval remembering a vote this node never recorded or broadcast.
        After restart the double-sign guard then refuses to vote at that
        (height, round, step) — correctly — but the round's quorum may be
        impossible without this validator's power, livelocking the whole
        network at that round. The persisted sign_bytes + signature are
        enough to reconstruct the exact vote; feeding it back through
        _send_internal fsyncs it to the WAL, broadcasts it to peers, and
        adds it to our own vote set like any other own vote."""
        pv = self.priv_validator
        lss = getattr(pv, "last_sign_state", None)
        if lss is None or not getattr(lss, "sign_bytes", None):
            return
        if not getattr(lss, "signature", None):
            return
        if lss.height != cs_height or lss.step not in (
            PV_STEP_PREVOTE,
            PV_STEP_PRECOMMIT,
        ):
            return
        rs = self.rs
        if rs.height != cs_height or rs.votes is None:
            return
        if self.priv_validator_pub_key is None:
            return
        own_addr = self.priv_validator_pub_key.address()
        if not rs.validators.has_address(own_addr):
            return
        vote_set = (
            rs.votes.prevotes(lss.round)
            if lss.step == PV_STEP_PREVOTE
            else rs.votes.precommits(lss.round)
        )
        if vote_set is None or vote_set.get_by_address(own_addr) is not None:
            return  # WAL replay already restored it
        try:
            msg_type, height, round_, block_id, ts = decode_canonical_vote(
                lss.sign_bytes
            )
        except Exception as e:
            self._log(f"cannot decode privval last sign bytes: {e}")
            return
        if height != cs_height or round_ != lss.round:
            return
        idx, _ = rs.validators.get_by_address(own_addr)
        vote = Vote(
            type=msg_type,
            height=height,
            round=round_,
            block_id=block_id,
            timestamp=ts,
            validator_address=own_addr,
            validator_index=idx,
            signature=lss.signature,
        )
        self._send_internal(VoteMessage(vote))
        self._log(
            f"recovered last signed vote from privval state "
            f"(h={height} r={round_} type={msg_type})"
        )

    def _restore_wal_step(self, cs_height: int) -> None:
        """Re-enter prevote/precommit at the restored round when the WAL
        holds our own vote for that step (replay-mode only)."""
        rs = self.rs
        if rs.height != cs_height or rs.votes is None:
            return
        if self.priv_validator_pub_key is None:
            return
        own_addr = self.priv_validator_pub_key.address()
        prevotes = rs.votes.prevotes(rs.round)
        precommits = rs.votes.precommits(rs.round)
        prevoted = prevotes is not None and prevotes.get_by_address(own_addr) is not None
        precommitted = (
            precommits is not None and precommits.get_by_address(own_addr) is not None
        )
        # The privval sign state is fsynced before the WAL write, so it can
        # prove a step the WAL lost (see _recover_privval_vote).
        lss = getattr(self.priv_validator, "last_sign_state", None)
        if (
            lss is not None
            and getattr(lss, "height", None) == cs_height
            and lss.round == rs.round
        ):
            prevoted = prevoted or lss.step >= PV_STEP_PREVOTE
            precommitted = precommitted or lss.step >= PV_STEP_PRECOMMIT
        if prevoted:
            self._enter_prevote(cs_height, rs.round)
        if precommitted:
            self._enter_precommit(cs_height, rs.round)

    def _read_replay_message(self, tm) -> None:
        """replay.go:36-90 readReplayMessage: route one TimedWALMessage back
        through the live handlers (sign attempts hit the double-sign guard
        and are ignored in replay mode)."""
        msg = tm.msg
        if isinstance(msg, EndHeightMessage):
            return
        with self._mtx:
            if isinstance(msg, TimeoutInfo):
                self._handle_timeout(msg)
            else:
                self._handle_msg(msg, "")

    def _log(self, text: str) -> None:
        if self.logger is not None and hasattr(self.logger, "error"):
            self.logger.error(text)
        else:
            print(f"[{self.name or 'consensus'}] {text}")

    def stop(self) -> None:
        self._running = False
        self.ticker.stop()
        self.wal.stop()

    def _pump_tocks(self) -> None:
        while self._running:
            try:
                ti = self.ticker.tock_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._queue.put(("timeout", ti, ""))

    # -- message entry points -------------------------------------------------

    def send_peer_message(self, msg, peer_id: str = "peer") -> None:
        self._queue.put(("peer", msg, peer_id))

    def _send_internal(self, msg) -> None:
        self._queue.put(("internal", msg, ""))
        if self._broadcast is not None:
            self._broadcast(msg)

    # -- the single-writer event loop (state.go:718-806) ----------------------

    def _receive_routine(self) -> None:
        while self._running:
            try:
                items = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                continue
            # Opportunistic drain: under vote storms (large validator sets,
            # gossip bursts) the queue holds many VoteMessages — pre-verify
            # their signatures in ONE device batch so the serial per-vote
            # checks below become verified-cache hits. No reordering, no
            # added latency: only what is ALREADY queued is drained.
            while len(items) < 256:
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # Never delay a drained timeout or own-message behind a device
            # call: round progression (and the WAL fsync of own msgs) must
            # not wait on a possibly-slow backend. Note ApplyBlock already
            # rides the device for commit verification, so prebatching adds
            # no NEW device dependency to consensus — only this ordering
            # hazard, which the guard removes.
            if len(items) >= 8 and all(k == "peer" for k, _, _ in items):
                self._prebatch_vote_signatures(items)
            for kind, payload, peer_id in items:
                try:
                    with self._mtx:
                        if kind == "timeout":
                            self.wal.write(payload)
                            self._handle_timeout(payload)
                        elif kind == "internal":
                            # fsync own messages before acting (state.go:774).
                            self.wal.write_sync(payload)
                            fail.fail()  # kill-point: own msg durable, unprocessed (state.go:787)
                            self._handle_msg(payload, "")
                        else:
                            self.wal.write(payload)
                            self._handle_msg(payload, peer_id)
                except Exception as e:
                    self.consensus_failures += 1
                    self.last_consensus_failure = e
                    if self.logger:
                        self.logger.error(
                            f"consensus failure: {traceback.format_exc()}"
                        )
                    else:
                        traceback.print_exc()

    # Bound on the known-bad-triple memo (below): enough for a sustained
    # invalid-vote storm without growing unboundedly.
    _FAILED_TRIPLES_MAX = 4096

    def _prebatch_vote_signatures(self, items) -> None:
        """Batch-verify the signatures of queued peer votes (crypto only —
        every protocol check still runs in _try_add_vote; invalid sigs are
        simply not cached and fail there as before). A pure optimization:
        errors here must never disturb the state machine.

        Triples that already failed a batch are memoized and skipped, so an
        attacker replaying invalid signatures costs one device dispatch and
        one host verify per UNIQUE bad triple, not one of each per drain."""
        try:
            from cometbft_tpu_torch.crypto import ed25519 as _ed

            votes = []
            for kind, payload, _ in items:
                if kind == "peer" and isinstance(payload, VoteMessage):
                    votes.append(payload.vote)
            if len(votes) < 8:
                return
            vals = self.state.validators
            bv = _ed.BatchVerifier()
            keys = []
            for v in votes:
                if not (0 <= v.validator_index < vals.size()):
                    continue
                val = vals.validators[v.validator_index]
                if val.address != v.validator_address or not isinstance(
                    val.pub_key, _ed.PubKey
                ):
                    continue
                if len(v.signature) != _ed.SIGNATURE_SIZE:
                    continue
                sb = v.sign_bytes(self.state.chain_id)
                key = val.pub_key.bytes() + v.signature + sb
                if key in self._failed_triples:
                    continue
                bv.add(val.pub_key, sb, v.signature)
                keys.append(key)
            if len(bv) >= 8:
                from cometbft_tpu_torch.sidecar import engine as _engine

                # Consensus-class engine admission: drained vote queues go
                # to the head of the shared device queue under the
                # admission deadline.
                with _engine.submission_class(_engine.CLASS_CONSENSUS):
                    _, bits = bv.verify()
                for key, valid in zip(keys, bits):
                    if not valid:
                        if len(self._failed_triples) >= self._FAILED_TRIPLES_MAX:
                            self._failed_triples.clear()
                        self._failed_triples[key] = None
        except Exception as e:
            self.prebatch_errors += 1
            self.last_prebatch_error = e

    def _handle_msg(self, msg, peer_id: str) -> None:
        """state.go:810-880 handleMsg."""
        if isinstance(msg, ProposalMessage):
            self._set_proposal(msg.proposal)
        elif isinstance(msg, BlockPartMessage):
            added = self._add_proposal_block_part(msg, peer_id)
            if added and self._broadcast is not None and peer_id:
                pass  # reactor handles gossip
        elif isinstance(msg, VoteMessage):
            self._try_add_vote(msg.vote, peer_id)
        elif isinstance(msg, HasVoteMessage):
            pass  # peer-state bookkeeping lives in the reactor
        else:
            raise ValueError(f"unknown consensus message {msg!r}")

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """state.go:885-940 handleTimeout."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < rs.step
        ):
            return
        if ti.step == STEP_NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            if self.event_bus:
                self.event_bus.publish_timeout_propose(rs.round_state_event())
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            if self.event_bus:
                self.event_bus.publish_timeout_wait(rs.round_state_event())
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            if self.event_bus:
                self.event_bus.publish_timeout_wait(rs.round_state_event())
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        else:
            raise ValueError(f"invalid timeout step {ti.step}")

    # -- state update ---------------------------------------------------------

    def update_to_state(self, state) -> None:
        """state.go:530-640 updateToState."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and rs.height != state.last_block_height:
            raise RuntimeError(
                f"updateToState() expected state height of {rs.height} but found {state.last_block_height}"
            )
        last_precommits = None
        if rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if precommits is None or not precommits.has_two_thirds_majority():
                raise RuntimeError("updateToState called with commitRound but no +2/3")
            last_precommits = precommits
        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height
        validators = state.validators
        rs.height = height
        rs.round = 0
        rs.step = STEP_NEW_HEIGHT
        if rs.commit_time.is_zero():
            rs.start_time = cmttime.now().add_nanos(
                int(self.config.timeout_commit * 1e9)
            )
        else:
            rs.start_time = rs.commit_time.add_nanos(
                int(self.config.timeout_commit * 1e9)
            )
        rs.validators = validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, validators)
        rs.commit_round = -1
        rs.last_commit = last_precommits
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = state
        self._last_progress = self.clock.now()
        with self._height_events:
            self._height_events.notify_all()

    def _reconstruct_last_commit_if_needed(self, state) -> None:
        """state.go reconstructLastCommit: after restart, rebuild LastCommit
        votes from the block store's seen commit."""
        if state.last_block_height == 0 or self.rs.last_commit is not None:
            return
        seen_commit = (
            self.block_store.load_seen_commit(state.last_block_height)
            if self.block_store
            else None
        )
        if seen_commit is None:
            return
        from cometbft_tpu_torch.types.vote_set import VoteSet

        # Pre-verify the whole seen commit in ONE dispatch so the serial
        # add_vote loop below runs on cache hits — otherwise every signature
        # would pay a scalar verify (or a micro-batch window wait) one at a
        # time at boot. Purely an optimization: failures just miss the cache
        # and add_vote verifies as before.
        try:
            from cometbft_tpu_torch.crypto import ed25519 as _ed

            vals = state.last_validators
            if all(isinstance(v.pub_key, _ed.PubKey) for v in vals.validators):
                bv = _ed.BatchVerifier()
                sbs = seen_commit.vote_sign_bytes_all(state.chain_id)
                for idx, cs in enumerate(seen_commit.signatures):
                    if not cs.is_absent():
                        bv.add(vals.validators[idx].pub_key, sbs[idx], cs.signature)
                if len(bv) >= 2:
                    from cometbft_tpu_torch.sidecar import engine as _engine

                    with _engine.submission_class(_engine.CLASS_CONSENSUS):
                        bv.verify()
        except Exception as e:
            self.prebatch_errors += 1
            self.last_prebatch_error = e
        vote_set = VoteSet(
            state.chain_id,
            state.last_block_height,
            seen_commit.round,
            PRECOMMIT_TYPE,
            state.last_validators,
        )
        for idx, cs_sig in enumerate(seen_commit.signatures):
            if cs_sig.is_absent():
                continue
            vote = Vote(
                type=PRECOMMIT_TYPE,
                height=seen_commit.height,
                round=seen_commit.round,
                block_id=cs_sig.block_id(seen_commit.block_id),
                timestamp=cs_sig.timestamp,
                validator_address=cs_sig.validator_address,
                validator_index=idx,
                signature=cs_sig.signature,
            )
            vote_set.add_vote(vote)
        self.rs.last_commit = vote_set

    # -- scheduling -----------------------------------------------------------

    def _schedule_round0(self) -> None:
        sleep = max(
            0.0, (self.rs.start_time.unix_nanos() - cmttime.now().unix_nanos()) / 1e9
        )
        self.ticker.schedule_timeout(
            TimeoutInfo(sleep, self.rs.height, 0, STEP_NEW_HEIGHT)
        )

    def _schedule_timeout(self, duration: float, height: int, round_: int, step: int) -> None:
        self.ticker.schedule_timeout(TimeoutInfo(duration, height, round_, step))

    def _new_step(self) -> None:
        self._last_progress = self.clock.now()
        if self.event_bus:
            self.event_bus.publish_new_round_step(self.rs.round_state_event())

    # -- stall watchdog -------------------------------------------------------

    # Wall-clock poll cadence of the watchdog thread. The check itself is
    # clock-driven (_stall_check reads self.clock), so tests and the simnet
    # scenario harness invoke it directly on a virtual clock with no sleeps.
    _WATCHDOG_POLL_S = 0.05

    def _stall_watchdog_routine(self) -> None:
        while self._running:
            self.clock.sleep(self._WATCHDOG_POLL_S)
            self._stall_check()

    def _stall_check(self) -> bool:
        """One watchdog evaluation against the injected clock: if the round
        state made no progress for _stall_factor × the current round's full
        (escalated) timeout budget, assume our announcements or timers were
        lost — re-broadcast our round step + observed majorities through the
        reactor hook and re-arm the current step's timeout. Every action is
        idempotent, so a false positive costs a few duplicate messages,
        never safety. Returns True when the stall action fired."""
        factor = self._stall_factor
        if factor <= 0:
            return False
        rs = self.rs
        # Waiting for transactions is idle by design, not a stall.
        if not self.config.create_empty_blocks and rs.step == STEP_NEW_ROUND:
            self._last_progress = self.clock.now()
            return False
        budget = self.config.round_timeout_budget(rs.round) * factor
        idle = self.clock.now() - self._last_progress
        if idle < budget:
            return False
        self._last_progress = self.clock.now()  # re-arm before acting
        self.metrics.consensus_stalls_total.inc()
        self._log(
            f"stall watchdog: no progress for {idle:.1f}s at "
            f"{rs.height}/{rs.round}/{cstypes.STEP_NAMES.get(rs.step, rs.step)}"
            "; re-announcing round state"
        )
        cb = self._on_stall
        if cb is not None:
            try:
                cb()
            except Exception as e:
                self.stall_errors += 1
                self.last_stall_error = e
        try:
            with self._mtx:
                self._rearm_step_timeout()
        except Exception as e:
            self.stall_errors += 1
            self.last_stall_error = e
        return True

    def _rearm_step_timeout(self) -> None:
        """Re-schedule the timeout the CURRENT step depends on (the ticker
        keeps a single pending timer, so a lost/clobbered tock would
        otherwise leave the step waiting forever). Steps that legitimately
        wait on votes/parts (Prevote, Precommit without 2/3-any, Commit)
        have no timer to re-arm."""
        rs = self.rs
        if rs.step == STEP_NEW_HEIGHT:
            self._schedule_round0()
        elif rs.step in (STEP_NEW_ROUND, STEP_PROPOSE):
            if rs.step == STEP_NEW_ROUND and not self.config.create_empty_blocks:
                return  # waiting for txs: no timer by design
            self._schedule_timeout(
                self.config.propose_timeout(rs.round), rs.height, rs.round, STEP_PROPOSE
            )
        elif rs.step == STEP_PREVOTE_WAIT:
            self._schedule_timeout(
                self.config.prevote_timeout(rs.round),
                rs.height, rs.round, STEP_PREVOTE_WAIT,
            )
        elif rs.step == STEP_PRECOMMIT and rs.triggered_timeout_precommit:
            self._schedule_timeout(
                self.config.precommit_timeout(rs.round),
                rs.height, rs.round, STEP_PRECOMMIT_WAIT,
            )

    # -- transitions ----------------------------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        """state.go:988-1046."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != STEP_NEW_HEIGHT
        ):
            return
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)
        rs.round = round_
        rs.step = STEP_NEW_ROUND
        rs.validators = validators
        self._last_progress = self.clock.now()
        self.metrics.rounds.set(round_)
        if round_ != 0:
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)
        rs.triggered_timeout_precommit = False
        if self.event_bus:
            proposer = validators.get_proposer()
            self.event_bus.publish_new_round(
                ev.EventDataNewRound(
                    height=height,
                    round=round_,
                    step=cstypes.STEP_NAMES[STEP_NEW_ROUND],
                    proposer_address=proposer.address if proposer else b"",
                )
            )
        wait_for_txs = (
            not self.config.create_empty_blocks
            and round_ == 0
            and not self._need_proof_block(height)
        )
        if wait_for_txs:
            if self.config.create_empty_blocks_interval > 0:
                self._schedule_timeout(
                    self.config.create_empty_blocks_interval, height, round_, STEP_NEW_ROUND
                )
            self.mempool.tx_available_callback = lambda: self._queue.put(
                ("timeout", TimeoutInfo(0, height, round_, STEP_NEW_ROUND), "")
            )
        else:
            self._enter_propose(height, round_)

    def _need_proof_block(self, height: int) -> bool:
        """state.go:1049-1063: first height, or the app hash changed."""
        if height == self.state.initial_height:
            return True
        last_meta = (
            self.block_store.load_block_meta(height - 1) if self.block_store else None
        )
        if last_meta is None:
            return True
        return self.state.app_hash != last_meta.header.app_hash

    def _enter_propose(self, height: int, round_: int) -> None:
        """state.go:1071-1132."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and STEP_PROPOSE <= rs.step
        ):
            return
        try:
            self._schedule_timeout(
                self.config.propose_timeout(round_), height, round_, STEP_PROPOSE
            )
            if self.priv_validator is None or self.priv_validator_pub_key is None:
                return
            address = self.priv_validator_pub_key.address()
            if not rs.validators.has_address(address):
                return
            if rs.validators.get_proposer().address == address:
                self._decide_proposal(height, round_)
        finally:
            rs.round = round_
            rs.step = STEP_PROPOSE
            self._new_step()
            if self._is_proposal_complete():
                self._enter_prevote(height, rs.round)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """state.go:1135-1190 defaultDecideProposal."""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            block = self._create_proposal_block()
            if block is None:
                return
            block_parts = block.make_part_set()
        self.wal.flush_and_sync()
        prop_block_id = BlockID(block.hash(), block_parts.header())
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=prop_block_id,
            timestamp=cmttime.now(),
        )
        try:
            proposal = self.priv_validator.sign_proposal(self.state.chain_id, proposal)
        except Exception as e:
            if not self.replay_mode:
                # Same contract as _sign_add_vote: log and skip, never
                # propagate a privval refusal into the step machinery.
                self._log(
                    f"failed signing proposal h={height} r={round_}: {e}"
                )
            return
        self._send_internal(ProposalMessage(proposal))
        for i in range(block_parts.total):
            part = block_parts.get_part(i)
            self._send_internal(BlockPartMessage(rs.height, rs.round, part))

    def _create_proposal_block(self):
        """state.go:1196-1233 createProposalBlock."""
        rs = self.rs
        if rs.height == self.state.initial_height:
            commit = Commit(height=0, round=0, block_id=BlockID(), signatures=[])
        elif rs.last_commit is not None and rs.last_commit.has_two_thirds_majority():
            commit = rs.last_commit.make_commit()
            if os.environ.get("CMTPU_AGG_COMMITS", "") == "1":
                # Block-embedded form only: the seen commit saved in
                # _finalize keeps per-vote signatures so restart
                # reconstruction can rebuild the VoteSet (see
                # types.block.aggregate_commit).
                from cometbft_tpu_torch.types.block import aggregate_commit

                commit = aggregate_commit(commit, self.state.last_validators)
        else:
            return None
        proposer_addr = self.priv_validator_pub_key.address()
        return self.block_exec.create_proposal_block(
            rs.height, self.state, commit, proposer_addr
        )

    def _is_proposal_complete(self) -> bool:
        """state.go:1193-1208."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    def _enter_prevote(self, height: int, round_: int) -> None:
        """state.go:1250-1275."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and STEP_PREVOTE <= rs.step
        ):
            return
        self._do_prevote(height, round_)
        rs.round = round_
        rs.step = STEP_PREVOTE
        self._new_step()

    def _do_prevote(self, height: int, round_: int) -> None:
        """state.go:1277-1335 defaultDoPrevote."""
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(
                PREVOTE_TYPE, rs.locked_block.hash(), rs.locked_block_parts.header()
            )
            return
        if rs.proposal_block is None:
            self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except Exception:
            self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return
        if not self.block_exec.process_proposal(rs.proposal_block, self.state):
            self._sign_add_vote(PREVOTE_TYPE, b"", PartSetHeader())
            return
        self._sign_add_vote(
            PREVOTE_TYPE, rs.proposal_block.hash(), rs.proposal_block_parts.header()
        )

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and STEP_PREVOTE_WAIT <= rs.step
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise RuntimeError(
                f"entering prevote wait step ({height}/{round_}) without +2/3"
            )
        rs.round = round_
        rs.step = STEP_PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(
            self.config.prevote_timeout(round_), height, round_, STEP_PREVOTE_WAIT
        )

    def _enter_precommit(self, height: int, round_: int) -> None:
        """state.go:1373-1471."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and STEP_PRECOMMIT <= rs.step
        ):
            return
        try:
            prevotes = rs.votes.prevotes(round_)
            block_id, ok = (
                prevotes.two_thirds_majority() if prevotes else (None, False)
            )
            if not ok:
                self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
                return
            if self.event_bus:
                self.event_bus.publish_polka(rs.round_state_event())
            pol_round, _ = rs.votes.pol_info()
            if pol_round < round_:
                raise RuntimeError(
                    f"this POLRound should be {round_} but got {pol_round}"
                )
            if len(block_id.hash) == 0:
                # +2/3 prevoted nil: unlock and precommit nil.
                if rs.locked_block is not None:
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                    if self.event_bus:
                        self.event_bus.publish_unlock(rs.round_state_event())
                self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
                return
            if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                rs.locked_round = round_
                if self.event_bus:
                    self.event_bus.publish_relock(rs.round_state_event())
                self._sign_add_vote(
                    PRECOMMIT_TYPE, block_id.hash, block_id.part_set_header
                )
                return
            if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                self.block_exec.validate_block(self.state, rs.proposal_block)
                rs.locked_round = round_
                rs.locked_block = rs.proposal_block
                rs.locked_block_parts = rs.proposal_block_parts
                if self.event_bus:
                    self.event_bus.publish_lock(rs.round_state_event())
                self._sign_add_vote(
                    PRECOMMIT_TYPE, block_id.hash, block_id.part_set_header
                )
                return
            # Polka for a block we don't have: unlock, fetch, precommit nil.
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                block_id.part_set_header
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(block_id.part_set_header)
            self._sign_add_vote(PRECOMMIT_TYPE, b"", PartSetHeader())
        finally:
            rs.round = round_
            rs.step = STEP_PRECOMMIT
            self._new_step()

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise RuntimeError(
                f"entering precommit wait step ({height}/{round_}) without +2/3"
            )
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.config.precommit_timeout(round_), height, round_, STEP_PRECOMMIT_WAIT
        )

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """state.go:1527-1588."""
        rs = self.rs
        if rs.height != height or STEP_COMMIT <= rs.step:
            return
        try:
            precommits = rs.votes.precommits(commit_round)
            block_id, ok = precommits.two_thirds_majority()
            if not ok:
                raise RuntimeError("enterCommit expects +2/3 precommits")
            if rs.locked_block is not None and rs.locked_block.hash() == block_id.hash:
                rs.proposal_block = rs.locked_block
                rs.proposal_block_parts = rs.locked_block_parts
            if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
                if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                    block_id.part_set_header
                ):
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(block_id.part_set_header)
                    if self.event_bus:
                        self.event_bus.publish_valid_block(rs.round_state_event())
        finally:
            rs.step = STEP_COMMIT
            rs.commit_round = commit_round
            rs.commit_time = cmttime.now()
            self._new_step()
            self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        """state.go:1590-1616."""
        rs = self.rs
        if rs.height != height:
            raise RuntimeError(f"tryFinalizeCommit() height mismatch")
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, ok = precommits.two_thirds_majority()
        if not ok or block_id is None or len(block_id.hash) == 0:
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != block_id.hash:
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """state.go:1618-1720."""
        rs = self.rs
        if rs.height != height or rs.step != STEP_COMMIT:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, ok = precommits.two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if not ok:
            raise RuntimeError("cannot finalize commit; no 2/3 majority")
        if not block_parts.has_header(block_id.part_set_header):
            raise RuntimeError("expected ProposalBlockParts header to be commit header")
        if block.hash() != block_id.hash:
            raise RuntimeError("cannot finalize commit; block hash mismatch")
        self.block_exec.validate_block(self.state, block)
        fail.fail()  # kill-point: before SaveBlock (state.go:1656)
        # Save to block store before the WAL end-height marker.
        if self.block_store.height() < block.header.height:
            seen_commit = precommits.make_commit()
            self.block_store.save_block(block, block_parts, seen_commit)
        fail.fail()  # kill-point: block saved, no #ENDHEIGHT yet (state.go:1670)
        self.wal.write_sync(EndHeightMessage(height))
        fail.fail()  # kill-point: #ENDHEIGHT durable, state not applied (state.go:1693)
        state_copy = self.state.copy()
        state_copy, retain_height = self.block_exec.apply_block(
            state_copy, BlockID(block.hash(), block_parts.header()), block
        )
        fail.fail()  # kill-point: after ApplyBlock (state.go:1720)
        if retain_height > 0:
            try:
                self.block_store.prune_blocks(retain_height)
                # the reference prunes state records alongside blocks
                # (state/execution.go pruneBlocks -> Store().PruneStates)
                self.block_exec.state_store.prune_states(retain_height)
            except Exception as e:
                self.prune_errors += 1
                self.last_prune_error = e
        self._record_commit_metrics(block)
        self.update_to_state(state_copy)
        if self.priv_validator is not None:
            self.priv_validator_pub_key = self.priv_validator.get_pub_key()
        self._schedule_round0()

    def _record_commit_metrics(self, block) -> None:
        """consensus/state.go recordMetrics (:1726-1790 subset)."""
        from cometbft_tpu_torch.consensus.metrics import _Nop

        m = self.metrics
        if isinstance(m.height, _Nop):
            return  # metrics disabled: skip the block re-encode + DB read
        h = block.header.height
        m.height.set(h)
        m.latest_block_height.set(h)
        m.validators.set(self.rs.validators.size())
        m.validators_power.set(self.rs.validators.total_voting_power())
        ntxs = len(block.data.txs)
        m.num_txs.set(ntxs)
        if ntxs:
            m.total_txs.inc(ntxs)
        m.block_size_bytes.set(len(block.encode()))
        prev = self.block_store.load_block_meta(h - 1)
        if prev is not None and prev.header.time is not None:
            dt = (block.header.time.seconds - prev.header.time.seconds) + (
                block.header.time.nanos - prev.header.time.nanos
            ) / 1e9
            if dt >= 0:
                m.block_interval_seconds.observe(dt)

    # -- proposals ------------------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """state.go defaultSetProposal (:1865-1905)."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (
            proposal.pol_round >= 0 and proposal.pol_round >= proposal.round
        ):
            raise VoteError("error invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
            proposal.sign_bytes(self.state.chain_id), proposal.signature
        ):
            raise VoteError("error invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)

    def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str) -> bool:
        """state.go addProposalBlockPart (:1905-1990)."""
        rs = self.rs
        if rs.height != msg.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        try:
            added = rs.proposal_block_parts.add_part(msg.part)
        except ValueError:
            if msg.round != rs.round:
                # A part from an earlier round's proposal at the same height
                # fails the proof check against the current round's part-set
                # header — benign late gossip, not a bad peer; don't take
                # down message processing for it.
                if self.logger:
                    self.logger.debug(
                        f"block part from another round does not match "
                        f"current proposal (h={msg.height} r={msg.round} "
                        f"cs_round={rs.round})"
                    )
                return False
            raise  # same-round invalid proof: a genuinely faulty peer
        if added and rs.proposal_block_parts.is_complete():
            from cometbft_tpu_torch.types.block import Block

            rs.proposal_block = Block.decode(rs.proposal_block_parts.get_reader())
            if self.event_bus:
                self.event_bus.publish_complete_proposal(
                    ev.EventDataCompleteProposal(
                        height=rs.height,
                        round=rs.round,
                        step=cstypes.STEP_NAMES[rs.step],
                        block_id=BlockID(
                            rs.proposal_block.hash(), rs.proposal_block_parts.header()
                        ),
                    )
                )
            prevotes = rs.votes.prevotes(rs.round)
            if prevotes is not None:
                block_id, has_maj = prevotes.two_thirds_majority()
                if (
                    has_maj
                    and block_id is not None
                    and len(block_id.hash) > 0
                    and rs.valid_round < rs.round
                ):
                    if rs.proposal_block.hash() == block_id.hash:
                        rs.valid_round = rs.round
                        rs.valid_block = rs.proposal_block
                        rs.valid_block_parts = rs.proposal_block_parts
            if rs.step <= STEP_PROPOSE and self._is_proposal_complete():
                self._enter_prevote(msg.height, rs.round)
            elif rs.step == STEP_COMMIT:
                self._try_finalize_commit(msg.height)
        return added

    # -- votes ----------------------------------------------------------------

    def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:1974-2020 tryAddVote."""
        from cometbft_tpu_torch.consensus.cstypes import GotVoteFromUnwantedRoundError

        try:
            return self._add_vote(vote, peer_id)
        except GotVoteFromUnwantedRoundError:
            return False
        except ErrVoteConflictingVotes as e:
            if (
                self.priv_validator_pub_key is not None
                and vote.validator_address == self.priv_validator_pub_key.address()
            ):
                # Found conflicting vote from ourselves — bad, don't report.
                return False
            if self.evpool is not None:
                self.evpool.report_conflicting_votes(e.vote_a, e.vote_b)
            return False
        except VoteError:
            return False

    def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """state.go:2022-2160 addVote."""
        rs = self.rs
        # Precommit for the previous height (LastCommit catchup).
        if vote.height + 1 == rs.height and vote.type == PRECOMMIT_TYPE:
            if rs.step != STEP_NEW_HEIGHT:
                return False
            if rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote)
            if not added:
                return False
            if self.event_bus:
                self.event_bus.publish_vote(ev.EventDataVote(vote))
            if self.config.skip_timeout_commit and rs.last_commit.has_all():
                self._enter_new_round(rs.height, 0)
            return added
        if vote.height != rs.height:
            return False
        height = rs.height
        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return False
        if self.event_bus:
            self.event_bus.publish_vote(ev.EventDataVote(vote))
        if vote.type == PREVOTE_TYPE:
            prevotes = rs.votes.prevotes(vote.round)
            # Unlock on a polka for a later round than our lock.
            block_id, ok = prevotes.two_thirds_majority()
            if (
                rs.locked_block is not None
                and rs.locked_round < vote.round <= rs.round
                and ok
                and rs.locked_block.hash() != block_id.hash
            ):
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            # Valid-block update.
            if (
                ok
                and block_id is not None
                and len(block_id.hash) > 0
                and rs.valid_round < vote.round
                and vote.round == rs.round
            ):
                if rs.proposal_block is not None and rs.proposal_block.hash() == block_id.hash:
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                else:
                    rs.proposal_block = None
                    if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
                        block_id.part_set_header
                    ):
                        rs.proposal_block_parts = PartSet(block_id.part_set_header)
            if rs.round < vote.round and prevotes.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
            elif rs.round == vote.round and STEP_PREVOTE <= rs.step:
                block_id2, ok2 = prevotes.two_thirds_majority()
                if ok2 and (
                    self._is_proposal_complete()
                    or (block_id2 is not None and len(block_id2.hash) == 0)
                ):
                    self._enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    self._enter_prevote_wait(height, vote.round)
            elif (
                rs.proposal is not None
                and 0 <= rs.proposal.pol_round == vote.round
            ):
                if self._is_proposal_complete():
                    self._enter_prevote(height, rs.round)
        elif vote.type == PRECOMMIT_TYPE:
            precommits = rs.votes.precommits(vote.round)
            block_id, ok = precommits.two_thirds_majority()
            if ok:
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                if block_id is not None and len(block_id.hash) > 0:
                    self._enter_commit(height, vote.round)
                    if self.config.skip_timeout_commit and precommits.has_all():
                        self._enter_new_round(rs.height, 0)
                else:
                    self._enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and precommits.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                self._enter_precommit_wait(height, vote.round)
        else:
            raise ValueError(f"unexpected vote type {vote.type}")
        return added

    def _sign_add_vote(self, msg_type: int, hash_: bytes, header: PartSetHeader):
        """state.go signAddVote."""
        rs = self.rs
        if self.priv_validator is None or self.priv_validator_pub_key is None:
            return None
        address = self.priv_validator_pub_key.address()
        if not rs.validators.has_address(address):
            return None
        idx, _ = rs.validators.get_by_address(address)
        vote = Vote(
            type=msg_type,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(hash_, header),
            timestamp=self._vote_time(),
            validator_address=address,
            validator_index=idx,
        )
        try:
            vote = self.priv_validator.sign_vote(self.state.chain_id, vote)
        except Exception as e:
            if not self.replay_mode:
                # state.go:2270 "failed signing vote": a refusing privval
                # (double-sign guard, remote signer down) must never abort a
                # step transition — _enter_prevote/_enter_precommit set
                # rs.step AFTER the vote goes out, so a raise here would
                # re-enter the same step forever and wedge the round. The
                # node simply doesn't vote this step.
                self._log(
                    f"failed signing vote h={rs.height} r={rs.round} "
                    f"type={msg_type}: {e}"
                )
            return None
        # An in-process signer's signature is valid by construction (it just
        # computed it over exactly these sign bytes) — prove the triple into
        # the verified cache so our own admission is a dict hit instead of a
        # crypto call or a micro-batch window wait. FilePV and MockPV both
        # sign locally with a key this process holds; remote/untrusted
        # signers keep the full verify — a byzantine privval must not be
        # able to plant unverified triples.
        try:
            from cometbft_tpu_torch.crypto import ed25519 as _ed
            from cometbft_tpu_torch.privval.file import FilePV as _FilePV
            from cometbft_tpu_torch.types.priv_validator import MockPV as _MockPV

            pk = self.priv_validator_pub_key
            if isinstance(self.priv_validator, (_FilePV, _MockPV)) and isinstance(
                pk, _ed.PubKey
            ):
                _ed.mark_self_signed(
                    pk.bytes(), vote.sign_bytes(self.state.chain_id), vote.signature
                )
        except Exception as e:
            self.self_sign_cache_errors += 1
            self.last_self_sign_cache_error = e
        self._send_internal(VoteMessage(vote))
        return vote

    def _vote_time(self):
        """state.go:2242 voteTime: now, floored strictly after the locked (or
        proposal) block's own time per the BFT-time spec — NOT last_block_time:
        flooring on the previous block would let an ahead-of-clock proposer
        push MedianTime(commit) <= block time and stall next-height proposals."""
        now = cmttime.now()
        min_time = now
        if self.rs.locked_block is not None:
            min_time = self.rs.locked_block.header.time.add_nanos(1_000_000)
        elif self.rs.proposal_block is not None:
            min_time = self.rs.proposal_block.header.time.add_nanos(1_000_000)
        if now.unix_nanos() > min_time.unix_nanos():
            return now
        return min_time

    # -- introspection --------------------------------------------------------

    def wait_for_height(self, height: int, timeout: float = 30.0) -> bool:
        """Block until consensus reaches `height` (False after `timeout` s)."""
        deadline = time.monotonic() + timeout
        with self._height_events:
            while self.rs.height < height:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._height_events.wait(remaining)
        return True
