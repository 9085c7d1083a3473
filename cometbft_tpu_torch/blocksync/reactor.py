"""Blocksync reactor (blocksync/reactor.go, channel 0x40), the port's copy of
``cometbft_tpu/blocksync/reactor.py``.

The sync loop validates each block with the NEXT block's LastCommit via
VerifyCommitLight (reactor.go:355-400, call at :360), then applies it;
switches to consensus when caught up. Ahead of it, the prefetch window
verifies the commits of up to PREFETCH_WINDOW fetched blocks in one backend
call (the card's sha512 -> decompress -> ladder by default), so that the
light check and validate_block's full check land on the verified-triple
cache.

Every exception the prefetch or trySync catches is counted
(``prefetch_errors``, ``sync_errors``) and the last one kept
(``last_prefetch_error``, ``last_sync_error``): a failed launch on the card
must not pass for a bad peer unseen.

Wire (proto/tendermint/blocksync/types.proto): Message oneof
{block_request=1{height}, no_block_response=2{height}, block_response=3
{block}, status_request=4, status_response=5{height, base}}.
"""

from __future__ import annotations

import os
import threading
import time

from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.p2p.reactor import BLOCKSYNC_CHANNEL, ChannelDescriptor, Reactor
from cometbft_tpu_torch.sidecar import engine
from cometbft_tpu_torch.types.block import Block, BlockID
from cometbft_tpu_torch.wire import proto as wire


def _encode(tag: int, inner: bytes) -> bytes:
    return wire.field_message(tag, inner, emit_empty=True)


def encode_block_request(height: int) -> bytes:
    return _encode(1, wire.field_varint(1, height))


def encode_no_block_response(height: int) -> bytes:
    return _encode(2, wire.field_varint(1, height))


def encode_block_response(block: Block) -> bytes:
    return _encode(3, wire.field_message(1, block.encode(), emit_empty=True))


def encode_status_request() -> bytes:
    return _encode(4, b"")


def encode_status_response(height: int, base: int) -> bytes:
    return _encode(5, wire.field_varint(1, height) + wire.field_varint(2, base))


def decode_message(data: bytes):
    f = wire.decode_fields(data)
    if 1 in f:
        return ("block_request", wire.get_varint(wire.decode_fields(wire.get_bytes(f, 1)), 1))
    if 2 in f:
        return ("no_block_response", wire.get_varint(wire.decode_fields(wire.get_bytes(f, 2)), 1))
    if 3 in f:
        inner = wire.decode_fields(wire.get_bytes(f, 3))
        return ("block_response", Block.decode(wire.get_bytes(inner, 1)))
    if 4 in f:
        return ("status_request", None)
    if 5 in f:
        inner = wire.decode_fields(wire.get_bytes(f, 5))
        return ("status_response", (wire.get_varint(inner, 1), wire.get_varint(inner, 2)))
    raise ValueError("unknown blocksync message")


class BlocksyncReactor(Reactor):
    """blocksync/reactor.go Reactor."""

    def __init__(
        self, state, block_exec, block_store, block_sync: bool,
        on_caught_up=None, clock=None,
    ):
        from cometbft_tpu_torch.sidecar.supervisor import MonotonicClock

        super().__init__("BLOCKSYNC")
        self.clock = clock or MonotonicClock()
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.block_sync_enabled = block_sync
        self.on_caught_up = on_caught_up  # fn(state) -> switch to consensus
        self.pool = BlockPool(
            state.last_block_height + 1, self._send_request, clock=self.clock
        )
        self._running = False
        self.synced = False
        self._prefetched_to = 0  # height up to which the window was batched
        # One-deep verify/apply pipeline: the prefetch producer (device-
        # bound commit verification for the window ahead) runs on a worker
        # while apply_block (app-bound) runs on the sync thread, so the
        # serial per-block decision path below stays unchanged and lands on
        # cache hits. CMTPU_BLOCKSYNC_PIPELINE=0 restores the inline
        # prefetch-then-verify ordering.
        self._pipeline_enabled = (
            os.environ.get("CMTPU_BLOCKSYNC_PIPELINE", "1") != "0"
        )
        self._pf_job: tuple[threading.Event, list[float]] | None = None
        self.pipeline_overlap_ms = 0.0  # verify/apply overlap accumulated
        # Exceptions the two guarded paths swallow (peer input must not stop
        # the sync thread); counted so that a caller can tell a device
        # failure from a bad peer.
        self.prefetch_errors = 0
        self.last_prefetch_error: BaseException | None = None
        self.sync_errors = 0
        self.last_sync_error: BaseException | None = None

    def get_channels(self):
        return [
            ChannelDescriptor(
                BLOCKSYNC_CHANNEL, priority=5, send_queue_capacity=1000,
                recv_message_capacity=50 * 1024 * 1024,
            )
        ]

    def start(self) -> None:
        self._running = True
        if self.block_sync_enabled:
            threading.Thread(target=self._pool_routine, daemon=True).start()

    def stop(self) -> None:
        self._running = False

    def switch_to_block_sync(self, state, block_exec=None) -> None:
        """reactor.go SwitchToBlockSync: statesync finished — start fast-sync
        from the freshly bootstrapped state (node.go:423-433 boot phasing)."""
        self.state = state
        if block_exec is not None:
            self.block_exec = block_exec
        self.synced = False
        with self.pool._mtx:
            self.pool.height = state.last_block_height + 1
        was_enabled = self.block_sync_enabled
        self.block_sync_enabled = True
        if self._running and not was_enabled:
            threading.Thread(target=self._pool_routine, daemon=True).start()

    # -- peers ----------------------------------------------------------------

    def add_peer(self, peer) -> None:
        peer.try_send(
            BLOCKSYNC_CHANNEL,
            encode_status_response(self.block_store.height(), self.block_store.base()),
        )
        peer.try_send(BLOCKSYNC_CHANNEL, encode_status_request())

    def remove_peer(self, peer, reason) -> None:
        self.pool.remove_peer(peer.id)

    def receive(self, chan_id: int, peer, msg_bytes: bytes) -> None:
        kind, payload = decode_message(msg_bytes)
        if kind == "block_request":
            block = self.block_store.load_block(payload)
            if block is not None:
                peer.try_send(BLOCKSYNC_CHANNEL, encode_block_response(block))
            else:
                peer.try_send(BLOCKSYNC_CHANNEL, encode_no_block_response(payload))
        elif kind == "block_response":
            self.pool.add_block(peer.id, payload)
        elif kind == "status_request":
            peer.try_send(
                BLOCKSYNC_CHANNEL,
                encode_status_response(self.block_store.height(), self.block_store.base()),
            )
        elif kind == "status_response":
            height, base = payload
            self.pool.set_peer_range(peer.id, base, height)
        elif kind == "no_block_response":
            pass

    def _send_request(self, peer_id: str, height: int) -> None:
        peer = self.switch.get_peer(peer_id) if self.switch else None
        if peer is not None:
            peer.try_send(BLOCKSYNC_CHANNEL, encode_block_request(height))

    # -- sync loop (reactor.go:280-410 poolRoutine) ---------------------------

    def _pool_routine(self) -> None:
        status_tick = 0.0
        while self._running and not self.synced:
            self.pool.make_requests()
            now = self.clock.now()
            if now - status_tick > 10:
                status_tick = now
                if self.switch:
                    self.switch.broadcast(BLOCKSYNC_CHANNEL, encode_status_request())
            if self._try_sync_one():
                continue  # immediately try the next pair
            # IsCaughtUp needs >= 1 peer STATUS (pool._peers non-empty), so a
            # fresh all-genesis net switches to consensus as soon as statuses
            # arrive — matching reactor.go's switchToConsensusTicker, which
            # gates on IsCaughtUp alone (a max-height>0 guard would deadlock
            # the everyone-at-height-0 boot).
            if self.pool.is_caught_up():
                self.synced = True
                if self.on_caught_up:
                    self.on_caught_up(self.state)
                return
            self.clock.sleep(0.01)

    # Prefetch window: how many consecutive fetched blocks to batch-verify
    # in ONE backend call; the verified-triple cache then makes both the
    # trySync VerifyCommitLight AND ApplyBlock's full LastCommit check cache
    # hits.
    PREFETCH_WINDOW = 32
    # Signature budget for one prefetch call. A window's triples must stay
    # in the verified-triple cache (ed25519._VERIFIED_MAX = 131072, whose
    # overflow evicts the oldest quarter) until trySync and validate_block
    # read them, while the pipeline adds the next window: at a quarter of
    # the cache, no eviction reaches a window before it is read. The card
    # takes a batch of any size in one sha512 -> decompress -> ladder launch
    # set (padded to its bucket: 20,480 lanes run at 32,768). At 10,240
    # validators the budget gives 3 blocks (two commits, 20,480 lanes), at
    # 150 the full 32 (31 commits, 4,650 lanes).
    PREFETCH_MAX_SIGS = 32768

    def _prefetch_verify_window(self) -> None:
        """Device-first fast sync: while validator sets are unchanged
        (header.validators_hash pins the exact set that signed each
        commit), the signatures of MANY consecutive blocks' commits are
        independent — verify them all in one batched device call and let
        the per-commit protocol checks hit the verified-triple cache.
        Failures are simply not cached; the per-block path then attributes
        the bad block and punishes the peer as before."""
        from cometbft_tpu_torch.crypto import ed25519

        if self.pool.height < self._prefetched_to:
            return
        vals = self.state.validators
        # Clamp the window in SIGNATURES, not blocks (a 10k-validator set
        # at 32 blocks would be ~320k triples in one dispatch).  Below 3
        # blocks there is nothing to batch (window covers window-1 commits);
        # skip before paying the pool-mutex peek.
        window_blocks = min(
            self.PREFETCH_WINDOW,
            self.PREFETCH_MAX_SIGS // max(1, len(vals.validators)),
        )
        if window_blocks < 3:
            return
        window = self.pool.peek_window(window_blocks)
        if len(window) < 3:
            return
        # Only ed25519 carries the verified-triple cache; for other key
        # types a prefetch would be pure extra work (three verifications
        # per commit instead of two).
        if not all(
            isinstance(v.pub_key, ed25519.PubKey) for v in vals.validators
        ):
            self._prefetched_to = self.pool.height + self.PREFETCH_WINDOW
            return
        # A pure optimization must never take down the sync thread: blocks
        # here are unvalidated peer input (oversized signatures etc. make
        # bv.add raise), and backend hiccups surface from bv.verify — the
        # per-block path re-verifies, attributes, and punishes as before.
        try:
            bv = ed25519.BatchVerifier()
            vh = vals.hash()
            chain_id = self.state.chain_id
            covered = 0
            for j in range(len(window) - 1):
                blk, nxt = window[j], window[j + 1]
                commit = nxt.last_commit
                if (
                    blk.header.validators_hash != vh
                    or commit is None
                    or commit.height != blk.header.height
                    or len(commit.signatures) != len(vals.validators)
                ):
                    break
                sbs = commit.vote_sign_bytes_all(chain_id)
                for idx, cs in enumerate(commit.signatures):
                    if cs.is_absent():
                        continue
                    bv.add(vals.validators[idx].pub_key, sbs[idx], cs.signature)
                covered += 1
            self._prefetched_to = self.pool.height + max(covered, 1)
            if covered >= 2 and len(bv):
                # Blocksync-class engine admission (the untagged default,
                # made explicit): window pre-verify yields to consensus
                # votes but outranks ingress and light prewarm.
                with engine.submission_class(engine.CLASS_BLOCKSYNC):
                    bv.verify()  # populates the cache; bad sigs fall to per-block
        except Exception as e:
            self.prefetch_errors += 1
            self.last_prefetch_error = e
            self._prefetched_to = self.pool.height + 1

    # -- verify/apply pipeline ------------------------------------------------

    def _pipeline_submit(self) -> None:
        """Kick the prefetch producer on a worker so it overlaps the
        apply_block that follows. One-deep: a still-running job means the
        producer is already ahead — never stack a second one."""
        job = self._pf_job
        if job is not None and not job[0].is_set():
            return
        done = threading.Event()
        times = [time.monotonic(), 0.0]

        def run():
            try:
                self._prefetch_verify_window()
            finally:
                times[1] = time.monotonic()
                done.set()

        self._pf_job = (done, times)
        threading.Thread(target=run, daemon=True).start()

    def _pipeline_wait(self) -> None:
        """Barrier before the serial verify: the producer must have finished
        populating the verified cache for the height we are about to check.
        Bounded — _prefetch_verify_window swallows its own errors, so the
        worker always terminates."""
        job = self._pf_job
        if job is not None:
            job[0].wait(timeout=60.0)

    def _pipeline_account(self, apply_t0: float, apply_t1: float) -> None:
        job = self._pf_job
        if job is None:
            return
        done, times = job
        end = times[1] if done.is_set() else apply_t1
        overlap = min(apply_t1, end) - max(apply_t0, times[0])
        if overlap > 0:
            self.pipeline_overlap_ms += overlap * 1000.0

    def _try_sync_one(self) -> bool:
        """reactor.go:340-400 trySync: verify `first` with `second.LastCommit`
        (VerifyCommitLight — batched on device), then apply."""
        first, second = self.pool.peek_two_blocks()
        if first is None or second is None:
            return False
        if self._pipeline_enabled:
            self._pipeline_wait()
        else:
            self._prefetch_verify_window()
        first_parts = first.make_part_set()
        first_id = BlockID(first.hash(), first_parts.header())
        try:
            # The light check (types/validation.go:59 via blocksync/reactor.go:360)
            self.state.validators.verify_commit_light(
                self.state.chain_id, first_id, first.header.height, second.last_commit
            )
            self.block_exec.validate_block(self.state, first)
        except Exception as e:
            self.sync_errors += 1
            self.last_sync_error = e
            bad_peer = self.pool.redo_request(first.header.height)
            if bad_peer and self.switch:
                peer = self.switch.get_peer(bad_peer)
                if peer:
                    self.switch.stop_peer_for_error(peer, "sent us an invalid block")
            return False
        self.block_store.save_block(first, first_parts, second.last_commit)
        if self._pipeline_enabled:
            # Overlap the next window's verification (device) with this
            # block's application (app). The worker only POPULATES the
            # verified-triple cache — the accepting verify_commit_light
            # above still runs serially on this thread, so a validator-set
            # change simply misses the cache and verifies inline.
            self._pipeline_submit()
            t0 = time.monotonic()
            self.state, _ = self.block_exec.apply_block(self.state, first_id, first)
            self._pipeline_account(t0, time.monotonic())
        else:
            self.state, _ = self.block_exec.apply_block(self.state, first_id, first)
        self.pool.pop_request()
        return True
