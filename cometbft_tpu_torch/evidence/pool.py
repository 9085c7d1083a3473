"""Evidence pool (evidence/pool.go), the port's copy of
``cometbft_tpu/evidence/pool.py``.

Pending evidence lives in the DB until committed or expired
(pool.go:105 Update, :134 AddEvidence, :192 CheckEvidence); consensus
reports double-signs through report_conflicting_votes
(consensus/state.go:69-72 evidencePool interface). The keys (``evP:`` and
``evC:`` + the height as 16 hex digits + the evidence hash) and values are
byte-identical to the JAX package's. ``state/execution.BlockExecutor`` takes
the pool as its ``evidence_pool``.

A conflicting vote pair that cannot be turned into evidence at Update is
dropped, as in the JAX package, but counted (``consensus_buffer_errors``,
the last exception in ``last_consensus_buffer_error``).
"""
from __future__ import annotations

import threading

from cometbft_tpu_torch.evidence.verify import verify_evidence
from cometbft_tpu_torch.libs.db import DB
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    decode_evidence,
    encode_evidence,
)

_PENDING_PREFIX = b"evP:"
_COMMITTED_PREFIX = b"evC:"


def _key(prefix: bytes, ev) -> bytes:
    return prefix + b"%016x" % ev.height() + ev.hash()


class EvidencePool:
    """evidence/pool.go Pool."""

    def __init__(self, db: DB, state_store, block_store, logger=None):
        self._db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logger
        self._mtx = threading.Lock()
        self.state = state_store.load()
        self._pruning_height = 0
        self._pruning_time = Time()
        # Conflicting votes reported by consensus, turned into evidence on the
        # next Update (pool.go processConsensusBuffer analog).
        self._consensus_buffer: list = []
        # Lifetime counters (evidence_* gauges and stats_snapshot).
        self.stats = {
            "reported_total": 0,   # conflicting-vote reports from consensus
            "added_total": 0,      # evidence accepted into pending
            "committed_total": 0,  # evidence marked committed via Update
            "expired_total": 0,    # pending pruned past max-age
        }
        self.consensus_buffer_errors = 0
        self.last_consensus_buffer_error: BaseException | None = None

    # -- ingest ---------------------------------------------------------------

    def add_evidence(self, ev) -> None:
        """pool.go:134-190 AddEvidence: dedup, verify, persist, gossip-ready."""
        with self._mtx:
            if self._is_pending(ev) or self._is_committed(ev):
                return
            verify_evidence(ev, self.state, self.state_store, self.block_store)
            self._db.set(_key(_PENDING_PREFIX, ev), encode_evidence(ev))
            self.stats["added_total"] += 1

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """consensus hook (pool.go ReportConflictingVotes): buffered, turned
        into DuplicateVoteEvidence against the right validator set at Update."""
        with self._mtx:
            self._consensus_buffer.append((vote_a, vote_b))
            self.stats["reported_total"] += 1

    def _process_consensus_buffer(self, state) -> None:
        with self._mtx:
            buffered, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buffered:
            try:
                val_set = self.state_store.load_validators(vote_a.height)
                block_meta = self.block_store.load_block_meta(vote_a.height)
                ev_time = (
                    block_meta.header.time if block_meta else state.last_block_time
                )
                ev = DuplicateVoteEvidence.new(vote_a, vote_b, ev_time, val_set)
                with self._mtx:
                    if not self._is_pending(ev) and not self._is_committed(ev):
                        self._db.set(_key(_PENDING_PREFIX, ev), encode_evidence(ev))
                        self.stats["added_total"] += 1
            except Exception as e:
                with self._mtx:
                    self.consensus_buffer_errors += 1
                    self.last_consensus_buffer_error = e
                if self.logger:
                    self.logger.error(f"failed to generate evidence from conflicting votes: {e}")

    # -- consumption ----------------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> tuple[list, int]:
        """pool.go PendingEvidence: list for inclusion in a proposal."""
        out, size = [], 0
        for _, raw in self._db.iterator(_PENDING_PREFIX, _PENDING_PREFIX + b"\xff"):
            ev = decode_evidence(raw)
            ev_size = len(raw)
            if max_bytes >= 0 and size + ev_size > max_bytes:
                break
            out.append(ev)
            size += ev_size
        return out, size

    def check_evidence(self, evidence: list) -> None:
        """pool.go:192-240 CheckEvidence: every piece must be (or become)
        verified; duplicates within the list rejected."""
        hashes = set()
        for ev in evidence:
            key = ev.hash()
            if key in hashes:
                raise ValueError("duplicate evidence")
            hashes.add(key)
            if self._is_committed(ev):
                raise ValueError("evidence was already committed")
            if not self._is_pending(ev):
                verify_evidence(ev, self.state, self.state_store, self.block_store)
                self._db.set(_key(_PENDING_PREFIX, ev), encode_evidence(ev))
                self.stats["added_total"] += 1

    def update(self, state, evidence: list) -> None:
        """pool.go:105-130 Update: mark committed, prune expired."""
        if state.last_block_height <= self.state.last_block_height:
            raise ValueError("failed EvidencePool.Update: new state has lower height")
        self.state = state
        for ev in evidence:
            self._db.set(_key(_COMMITTED_PREFIX, ev), b"\x01")
            self._db.delete(_key(_PENDING_PREFIX, ev))
            self.stats["committed_total"] += 1
        self._process_consensus_buffer(state)
        self._prune_expired()

    def _prune_expired(self) -> None:
        params = self.state.consensus_params.evidence
        for k, raw in list(
            self._db.iterator(_PENDING_PREFIX, _PENDING_PREFIX + b"\xff")
        ):
            ev = decode_evidence(raw)
            age_blocks = self.state.last_block_height - ev.height()
            age_ns = (
                self.state.last_block_time.unix_nanos() - ev.time().unix_nanos()
            )
            if age_blocks > params.max_age_num_blocks and age_ns > params.max_age_duration_ns:
                self._db.delete(k)
                self.stats["expired_total"] += 1

    # -- queries --------------------------------------------------------------

    def pending_count(self) -> int:
        """Number of evidence pieces currently pending inclusion."""
        return sum(
            1 for _ in self._db.iterator(_PENDING_PREFIX, _PENDING_PREFIX + b"\xff")
        )

    def stats_snapshot(self) -> dict:
        """One coherent read of the counters and the pending count."""
        with self._mtx:
            out = dict(self.stats)
        out["pending"] = self.pending_count()
        return out

    def _is_pending(self, ev) -> bool:
        return self._db.has(_key(_PENDING_PREFIX, ev))

    def _is_committed(self, ev) -> bool:
        return self._db.has(_key(_COMMITTED_PREFIX, ev))
