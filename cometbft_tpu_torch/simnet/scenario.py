"""Deterministic 50–200 node consensus scenarios on one SimClock, the
port's copy of ``cometbft_tpu/simnet/scenario.py``.

The harness runs N full ``ConsensusState`` machines (real executor, real
ABCI kvstore app, real mempool, real crypto — only the WAL is nil and the
wire is virtual) **single-threaded**: nothing calls ``cs.start()``.
Instead of receive/tock/watchdog threads, every external stimulus is a
SimClock event —

* a :class:`SimTicker` turns ``schedule_timeout`` into a clock event whose
  callback enqueues the tock and synchronously drains that node's queue;
* each node's ``set_broadcast`` fan-out schedules per-peer deliveries at
  ``now + latency(zone_i, zone_j) + jitter`` (seeded), subject to drop and
  the scripted partition state;
* partitions, heals, churn, tx load, and the per-node stall-watchdog
  check are themselves clock events scheduled from the spec.

Because the run loop pops events in ``(due, seq)`` order from one heap and
``cmttime.now()`` is virtualized onto the same clock, two runs of the
same spec produce *bit-identical* blocks — same timestamps, same votes,
same hashes — while wall time is only the Python/crypto work, typically
an order of magnitude less than the simulated chain time.

Vote-batch modeling: with ``vote_window_ms`` set, vote deliveries are
quantized up to window boundaries and delivered per (node, window)
bucket, pre-verified in one ``_prebatch_vote_signatures`` dispatch —
the sim-side analogue of ``CMTPU_VOTE_BATCH_WINDOW_MS``.

Non-goals: no device-call simulation — verification backends run for
real (the process backend, the card's kernels by default); churned nodes
that miss blocks are served by the catchup path or reported as
stragglers.

Drain failures, which the reference prints and passes over, are printed
and counted: ``counters["drain_failures"]`` (a key the reference does not
have) and ``last_drain_failure``.
"""

from __future__ import annotations

import math
import queue
import random
import time as _time

from cometbft_tpu_torch.consensus.ticker import TimeoutTicker
from cometbft_tpu_torch.simnet.clock import SimClock

GENESIS_SECONDS = 1_700_000_000


class SimTicker(TimeoutTicker):
    """Single-pending-timeout ticker whose tocks go straight to a sink
    callback (no tock queue, no pump thread)."""

    def __init__(self, clock: SimClock, sink):
        super().__init__(clock=clock)
        self._sink = sink

    def _fire(self, ti) -> None:
        self._sink(ti)


def default_spec(**overrides) -> dict:
    """Baseline WAN scenario; every field overridable (generator/manifest)."""
    spec = {
        "seed": 0,
        "validators": 50,
        "blocks": 10,  # target committed height
        "zones": 4,
        "zone_latency_ms": None,  # NxN (zones); synthesized from seed if None
        "jitter_ms": 10.0,
        "drop_p": 0.0,
        "vote_window_ms": 0.0,
        # WAN-ish consensus timeouts (seconds, simulated).
        "timeout_propose": 3.0,
        "timeout_propose_delta": 0.5,
        "timeout_prevote": 1.0,
        "timeout_prevote_delta": 0.5,
        "timeout_precommit": 1.0,
        "timeout_precommit_delta": 0.5,
        # WAN-realistic commit dwell (Cosmos Hub mainnet ships 5s). Sim
        # dead time costs no wall time — the clock jumps it — so a
        # realistic dwell is free and keeps block cadence honest.
        "timeout_commit": 5.0,
        "partitions": [],  # [{"at_s", "heal_s", "fraction"}]
        "churn": [],  # [{"at_s", "down_s", "nodes"}] nodes = count, never node 0
        "tx_interval_s": 0.0,  # 0 = no load
        "txs_per_interval": 1,
        # Byzantine actor windows (simnet/byzantine.py): [{"role":
        # equivocator|withholder|flooder, "node", "from_s", "until_s",
        # ...role knobs}]. Node 0 is never byzantine (hash reference).
        "byzantine": [],
        # In-sim blocksync late-joins: [{"node", "at_s"}] — the node is a
        # genesis validator that stays dark until at_s, then catches up
        # through real blocksync wire frames over the sim links and
        # switches into consensus. Never node 0.
        "joins": [],
        # Background vote/evidence gossip tick (the reactor
        # gossipVotesRoutine / evidence broadcast analogue): each tick a
        # node relays to one rotating peer the votes that peer provably
        # lacks at its own current round, plus any pending evidence.
        # 0 disables.
        "gossip_interval_s": 1.0,
        "max_sim_s": 600.0,
        "watchdog_poll_s": 2.0,
        # Lower than the production default (10): sim recovery from a
        # heal should take round-budgets, not minutes of sim time.
        "stall_factor": 4.0,
    }
    unknown = set(overrides) - set(spec)
    if unknown:
        raise ValueError(f"unknown simnet spec keys {sorted(unknown)}")
    spec.update(overrides)
    return spec


def _synth_zone_latency(rng: random.Random, zones: int) -> list[list[float]]:
    """Symmetric zone-pair base latency (ms): LAN-ish intra, WAN inter."""
    m = [[0.0] * zones for _ in range(zones)]
    for a in range(zones):
        m[a][a] = rng.uniform(2.0, 15.0)
        for b in range(a + 1, zones):
            m[a][b] = m[b][a] = rng.uniform(40.0, 150.0)
    return m


class _SimNode:
    __slots__ = (
        "index", "name", "cs", "mempool", "app", "online",
        # Handles the blocksync late-join path needs to rebuild
        # a caught-up ConsensusState, plus the node's evidence pool.
        "cfg", "pv", "evpool", "executor", "block_store", "state_store",
    )

    def __init__(self, index, name, cs, mempool, app):
        self.index = index
        self.name = name
        self.cs = cs
        self.mempool = mempool
        self.app = app
        self.online = True
        self.cfg = None
        self.pv = None
        self.evpool = None
        self.executor = None
        self.block_store = None
        self.state_store = None


class Scenario:
    """One seeded run. Build with a spec dict (see default_spec), then
    :meth:`run` to completion; ``report`` holds the result + full schedule."""

    def __init__(self, spec: dict):
        self.spec = dict(spec)
        self.seed = int(spec["seed"])
        self.rng = random.Random(f"simnet:{self.seed}")
        self.clock = SimClock()
        self.n = int(spec["validators"])
        self.nodes: list[_SimNode] = []
        self._groups: list[set[int]] | None = None
        self._vote_buckets: dict[tuple[int, int], list] = {}
        # FIFO clamp per directed link (i, j): jitter may stretch a
        # stream, never reorder it — parts must not overtake their
        # proposal (a part arriving first is dropped, as in state.go).
        self._fifo: dict[tuple[int, int], float] = {}
        self._tx_counter = 0
        self.counters = {
            "deliveries": 0,
            "dropped": 0,
            "partitioned": 0,
            "offline_skips": 0,
            "vote_dispatches": 0,
            "stall_fires": 0,
            "catchups": 0,
            "conflicts_reported": 0,
            "gossip_votes": 0,
            "gossip_evidence": 0,
            "evidence_rejects": 0,
            "joins": 0,
            "join_completions": 0,
            "blocksync_served": 0,
            "drain_failures": 0,
        }
        self.last_drain_failure: Exception | None = None
        self.schedule = {}  # realized schedule, filled by _build/_script
        self.byz_actors: list = []
        self._evidence_detections: list[dict] = []
        self._commit_times: list[list] = []  # [height, sim_s] at node 0
        # Gossip relay bookkeeping: per (i, j) the (height, sent-keys set)
        # of votes already relayed, and a per-node rotor for peer choice.
        self._gossip_sent: dict[tuple[int, int], tuple[int, set]] = {}
        self._gossip_rotor: dict[int, int] = {}
        # Blocksync late-join state per joining node index.
        self._join_nodes: set[int] = {
            int(j["node"]) for j in spec.get("joins", [])
        }
        self._join_state: dict[int, dict] = {}
        self._join_reports: list[dict] = []

    # -- assembly -------------------------------------------------------------

    def _build(self) -> None:
        from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
        from cometbft_tpu_torch.config import test_config
        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.crypto import ed25519
        from cometbft_tpu_torch.evidence.pool import EvidencePool
        from cometbft_tpu_torch.mempool import CListMempool
        from cometbft_tpu_torch.proxy import AppConns, local_client_creator
        from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.libs.db import MemDB
        from cometbft_tpu_torch.types import Time
        from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
        from cometbft_tpu_torch.types.priv_validator import MockPV

        spec = self.spec
        pvs = [
            MockPV(
                priv_key=ed25519.gen_priv_key_from_secret(
                    f"simnet:{self.seed}:val{i}".encode()
                )
            )
            for i in range(self.n)
        ]
        gen_vals = [
            GenesisValidator(pv.address(), pv.get_pub_key(), 10, f"sim{i}")
            for i, pv in enumerate(pvs)
        ]
        gen = GenesisDoc(
            chain_id=f"simnet-{self.seed}",
            genesis_time=Time(GENESIS_SECONDS, 0),
            validators=gen_vals,
        )
        gen.validate_and_complete()

        zones = int(spec["zones"])
        self.zone_of = [i % zones for i in range(self.n)]
        zl = spec["zone_latency_ms"] or _synth_zone_latency(self.rng, zones)
        self.zone_latency_ms = [[float(x) for x in row] for row in zl]
        self.jitter_s = float(spec["jitter_ms"]) / 1000.0
        self.drop_p = float(spec["drop_p"])
        self.vote_window_s = float(spec["vote_window_ms"]) / 1000.0

        for i, pv in enumerate(pvs):
            state = make_genesis_state(gen)
            app = KVStoreApplication()
            conns = AppConns(local_client_creator(app))
            conns.start()
            cfg = test_config()
            for k in (
                "timeout_propose", "timeout_propose_delta",
                "timeout_prevote", "timeout_prevote_delta",
                "timeout_precommit", "timeout_precommit_delta",
                "timeout_commit",
            ):
                setattr(cfg.consensus, k, float(spec[k]))
            cfg.consensus.skip_timeout_commit = False
            mempool = CListMempool(cfg.mempool, conns.mempool)
            state_store = StateStore(MemDB())
            block_store = BlockStore(MemDB())
            state_store.save(state)
            evpool = EvidencePool(MemDB(), state_store, block_store)
            executor = BlockExecutor(
                state_store, conns.consensus, mempool, evpool, block_store
            )
            sink = self._make_tock_sink(i)
            ticker = SimTicker(self.clock, sink)
            cs = ConsensusState(
                cfg.consensus,
                state,
                executor,
                block_store,
                mempool,
                evpool=evpool,
                wal=None,
                ticker=ticker,
                clock=self.clock,
                name=f"sim{i}",
            )
            cs.set_priv_validator(pv)
            cs._stall_factor = float(spec["stall_factor"])
            cs.set_broadcast(self._make_broadcast(i))
            node = _SimNode(i, f"sim{i}", cs, mempool, app)
            node.cfg = cfg
            node.pv = pv
            node.evpool = evpool
            node.executor = executor
            node.block_store = block_store
            node.state_store = state_store
            self._tap_conflict_reports(i, evpool)
            cs.set_on_stall(self._make_on_stall(node))
            self.nodes.append(node)

        # Byzantine actors wrap the node's OWN broadcast (same send
        # surface, no consensus-code forks — see simnet/byzantine.py).
        from cometbft_tpu_torch.simnet.byzantine import make_actor

        for entry in spec["byzantine"]:
            actor = make_actor(self, entry)
            if actor.node_index in self._join_nodes:
                raise ValueError(
                    "a byzantine node cannot also be a late-joiner"
                )
            bnode = self.nodes[actor.node_index]
            bnode.cs.set_broadcast(actor.wrap(bnode.cs._broadcast))
            self.byz_actors.append(actor)
        for j in sorted(self._join_nodes):
            if not (1 <= j < self.n):
                raise ValueError(
                    f"join node must be in 1..{self.n - 1} "
                    "(node 0 is the hash-reference node)"
                )
            self.nodes[j].online = False

        self.schedule = {
            "seed": self.seed,
            "validators": self.n,
            "zones": zones,
            "zone_of": list(self.zone_of),
            "zone_latency_ms": self.zone_latency_ms,
            "jitter_ms": float(spec["jitter_ms"]),
            "drop_p": self.drop_p,
            "vote_window_ms": float(spec["vote_window_ms"]),
            "timeouts": {
                k: float(spec[k])
                for k in (
                    "timeout_propose", "timeout_propose_delta",
                    "timeout_prevote", "timeout_prevote_delta",
                    "timeout_precommit", "timeout_precommit_delta",
                    "timeout_commit",
                )
            },
            "partitions": [],
            "churn": [],
            "byzantine": [a.resolved() for a in self.byz_actors],
            "joins": [
                {"node": int(j["node"]), "at_s": float(j["at_s"])}
                for j in spec["joins"]
            ],
            "gossip_interval_s": float(spec["gossip_interval_s"]),
        }

    def _tap_conflict_reports(self, i: int, evpool) -> None:
        """Timestamp every conflicting-vote report (the evidence DETECTION
        moment) so the report can bound detection→commitment latency."""
        orig = evpool.report_conflicting_votes

        def report(vote_a, vote_b):
            self.counters["conflicts_reported"] += 1
            self._evidence_detections.append({
                "node": i,
                "height": vote_a.height,
                "round": vote_a.round,
                "validator_index": vote_a.validator_index,
                "sim_s": round(self.clock.now(), 6),
            })
            orig(vote_a, vote_b)

        evpool.report_conflicting_votes = report

    # -- event plumbing -------------------------------------------------------

    def _make_tock_sink(self, i: int):
        def sink(ti):
            node = self.nodes[i]
            node.cs._queue.put(("timeout", ti, ""))
            self._drain(node)
        return sink

    def _make_on_stall(self, node: _SimNode):
        """Reactor-gossip analogue: a stalled node re-announces its OWN
        contribution to the current round — proposal + parts (if it holds
        the complete block) and its own votes. A quorum-wide stall thus
        re-announces the whole vote set exactly once collectively (each
        voter re-sends itself), instead of every node flooding everything
        it knows; cross-height gaps are the catchup path's job. Everything
        is idempotent at the receivers, mirroring the real reactor's
        NewRoundStep/maj23 stall re-broadcast."""
        from cometbft_tpu_torch.consensus.messages import (
            BlockPartMessage, ProposalMessage, VoteMessage,
        )

        def on_stall():
            self.counters["stall_fires"] += 1
            cs = node.cs
            rs = cs.rs
            bc = cs._broadcast
            if bc is None or not node.online:
                return
            if rs.proposal is not None:
                bc(ProposalMessage(rs.proposal))
            parts = rs.proposal_block_parts
            if parts is not None and parts.is_complete():
                for k in range(parts.total):
                    bc(BlockPartMessage(rs.height, rs.round, parts.get_part(k)))
            addr = cs.priv_validator_pub_key.address() if cs.priv_validator_pub_key else None
            if addr is None:
                return
            for vs in (rs.votes.prevotes(rs.round), rs.votes.precommits(rs.round)):
                if vs is None:
                    continue
                own = vs.get_by_address(addr)
                if own is not None:
                    bc(VoteMessage(own))
        return on_stall

    # Heights served per catchup fire: one height per fire cannot close a
    # growing gap (the chain advances ~1 height per commit dwell while the
    # watchdog fires every poll × stall budget) — a blocksync late-joiner
    # handed off one block behind tip would trail forever. A span bounds
    # the burst while converging in O(gap / span) fires.
    _CATCHUP_SPAN = 20

    def _catchup(self, node: _SimNode) -> None:
        """Consensus-reactor catchup-gossip analogue: a peer that already
        committed this node's current height re-sends, for a span of the
        node's missing heights, each height's precommits (from its seen
        commit) and block parts. The link FIFO keeps the span ordered, so
        the node commits height h between the h and h+1 deliveries —
        exactly the lagging-peer flow of reactor.go, span-batched."""
        from cometbft_tpu_torch.consensus.messages import BlockPartMessage, VoteMessage
        from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE, Vote

        h = node.cs.rs.height
        donor = next(
            (d for d in self.nodes
             if d.online and d.index != node.index and d.cs.rs.height > h
             and self._reachable(d.index, node.index)),
            None,
        )
        if donor is None:
            return
        served = False
        for hh in range(h, min(donor.cs.rs.height, h + self._CATCHUP_SPAN)):
            seen = donor.cs.block_store.load_seen_commit(hh)
            block = donor.cs.block_store.load_block(hh)
            if seen is None or block is None:
                break
            served = True
            msgs = []
            for idx, sig in enumerate(seen.signatures):
                if sig.is_absent():
                    continue
                msgs.append(VoteMessage(Vote(
                    type=PRECOMMIT_TYPE,
                    height=seen.height,
                    round=seen.round,
                    block_id=sig.block_id(seen.block_id),
                    timestamp=sig.timestamp,
                    validator_address=sig.validator_address,
                    validator_index=idx,
                    signature=sig.signature,
                )))
            parts = block.make_part_set()
            for k in range(parts.total):
                msgs.append(BlockPartMessage(hh, seen.round, parts.get_part(k)))
            for msg in msgs:
                self._send_direct(donor.index, node.index, msg)
        if served:
            self.counters["catchups"] += 1

    def _send_direct(self, i: int, j: int, msg) -> None:
        due = max(
            self.clock.now() + self._link_delay(i, j),
            self._fifo.get((i, j), 0.0),
        )
        self._fifo[(i, j)] = due
        self.clock.timer(due - self.clock.now(), self._deliver, j, msg, f"sim{i}")

    def _drain(self, node: _SimNode) -> None:
        """Synchronous stand-in for _receive_routine: process everything
        queued on this node (own internal messages re-enter mid-drain)."""
        cs = node.cs
        while True:
            try:
                kind, payload, peer_id = cs._queue.get_nowait()
            except queue.Empty:
                return
            try:
                with cs._mtx:
                    if kind == "timeout":
                        cs._handle_timeout(payload)
                    else:
                        cs._handle_msg(payload, peer_id)
            except Exception as e:
                import traceback

                self.counters["drain_failures"] += 1
                self.last_drain_failure = e
                print(f"[{node.name}] sim drain failure: {traceback.format_exc()}")

    def _reachable(self, a: int, b: int) -> bool:
        if self._groups is None:
            return True
        ga = next((g for g in self._groups if a in g), None)
        gb = next((g for g in self._groups if b in g), None)
        if ga is None or gb is None:
            return True
        return ga is gb

    def _link_delay(self, a: int, b: int) -> float:
        d = self.zone_latency_ms[self.zone_of[a]][self.zone_of[b]] / 1000.0
        if self.jitter_s > 0:
            d += self.rng.random() * self.jitter_s
        return d

    def _make_broadcast(self, i: int):
        from cometbft_tpu_torch.consensus.messages import VoteMessage

        def broadcast(msg):
            if not self.nodes[i].online:
                self.counters["offline_skips"] += 1
                return
            is_vote = self.vote_window_s > 0 and isinstance(msg, VoteMessage)
            peer_id = f"sim{i}"
            for j in range(self.n):
                if j == i:
                    continue
                if not self._reachable(i, j):
                    self.counters["partitioned"] += 1
                    continue
                if self.drop_p > 0 and self.rng.random() < self.drop_p:
                    self.counters["dropped"] += 1
                    continue
                due = max(
                    self.clock.now() + self._link_delay(i, j),
                    self._fifo.get((i, j), 0.0),
                )
                if is_vote:
                    self._bucket_vote(i, j, due, msg, peer_id)
                else:
                    self._fifo[(i, j)] = due
                    self.clock.timer(
                        due - self.clock.now(), self._deliver, j, msg, peer_id
                    )
        return broadcast

    def _deliver(self, j: int, msg, peer_id: str) -> None:
        node = self.nodes[j]
        if not node.online:
            self.counters["offline_skips"] += 1
            return
        self.counters["deliveries"] += 1
        node.cs._queue.put(("peer", msg, peer_id))
        self._drain(node)

    # Vote-window quantization: deliveries round UP to the next window
    # boundary and land as one per-(node, window) bucket, pre-verified in a
    # single batch dispatch — deterministic, and the dispatch count drops
    # by ~the bucket fill factor (the sim analogue of the vote-batch knob).
    def _bucket_vote(self, i: int, j: int, due: float, msg, peer_id: str) -> None:
        w = self.vote_window_s
        slot = int(math.floor(due / w)) + 1
        self._fifo[(i, j)] = slot * w
        key = (j, slot)
        bucket = self._vote_buckets.get(key)
        if bucket is None:
            self._vote_buckets[key] = [(msg, peer_id)]
            self.clock.timer(slot * w - self.clock.now(), self._flush_votes, key)
        else:
            bucket.append((msg, peer_id))

    def _flush_votes(self, key) -> None:
        j, _slot = key
        bucket = self._vote_buckets.pop(key, [])
        node = self.nodes[j]
        if not bucket or not node.online:
            self.counters["offline_skips"] += 0 if not bucket else len(bucket)
            return
        items = [("peer", m, pid) for m, pid in bucket]
        self.counters["vote_dispatches"] += 1
        self.counters["deliveries"] += len(items)
        if len(items) >= 8:
            node.cs._prebatch_vote_signatures(items)
        for item in items:
            node.cs._queue.put(item)
        self._drain(node)

    # -- scripted schedule ----------------------------------------------------

    def _script(self) -> None:
        spec = self.spec
        for p in spec["partitions"]:
            at = float(p["at_s"])
            heal = float(p["heal_s"])
            frac = float(p.get("fraction", 0.5))
            k = max(1, min(self.n - 1, int(round(self.n * frac))))
            groups = [set(range(k)), set(range(k, self.n))]
            self.clock.timer(at, self._set_partition, groups)
            self.clock.timer(heal, self._set_partition, None)
            self.schedule["partitions"].append(
                {"at_s": at, "heal_s": heal, "fraction": frac,
                 "group_sizes": [k, self.n - k]}
            )
        # Node 0 is the reference node for hashes: never churn it. Join
        # nodes are dark until their at_s — churning one would double-book
        # its online flag. With no joins this is identical sampling.
        churnable = [i for i in range(1, self.n) if i not in self._join_nodes]
        for c in spec["churn"]:
            at = float(c["at_s"])
            down = float(c["down_s"])
            count = min(int(c.get("nodes", 1)), max(self.n // 3 - 1, 0),
                        len(churnable))
            picked = self.rng.sample(churnable, count) if count else []
            for idx in picked:
                self.clock.timer(at, self._set_online, idx, False)
                self.clock.timer(at + down, self._set_online, idx, True)
            self.schedule["churn"].append(
                {"at_s": at, "down_s": down, "nodes": sorted(picked)}
            )
        if float(spec["tx_interval_s"]) > 0:
            self.clock.timer(float(spec["tx_interval_s"]), self._inject_txs)
        poll = float(spec["watchdog_poll_s"])
        if poll > 0:
            for i in range(self.n):
                self.clock.timer(poll, self._watchdog_tick, i)
        gossip = float(spec["gossip_interval_s"])
        if gossip > 0:
            for i in range(self.n):
                # Staggered first ticks: node i's gossip phase is offset so
                # N nodes do not all relay on the same clock instant.
                self.clock.timer(gossip * (1.0 + i / self.n), self._gossip_tick, i)
        for j in spec["joins"]:
            self.clock.timer(float(j["at_s"]), self._begin_join, int(j["node"]))
        for actor in self.byz_actors:
            actor.start()

    def _set_partition(self, groups) -> None:
        self._groups = groups

    def _set_online(self, idx: int, online: bool) -> None:
        node = self.nodes[idx]
        node.online = online
        if online:
            # Back from the dead: rearm whatever timer the current step
            # needs and reset the stall baseline.
            cs = node.cs
            cs._last_progress = self.clock.now()
            with cs._mtx:
                cs._rearm_step_timeout()

    def _inject_txs(self) -> None:
        spec = self.spec
        for _ in range(int(spec["txs_per_interval"])):
            target = self.nodes[self._tx_counter % self.n]
            if target.online:
                tx = f"sim{self.seed}-tx{self._tx_counter}=v".encode()
                try:
                    target.mempool.check_tx(tx)
                except Exception:
                    pass  # full mempool under load is expected
                self._drain(target)
            self._tx_counter += 1
        self.clock.timer(float(spec["tx_interval_s"]), self._inject_txs)

    def _watchdog_tick(self, i: int) -> None:
        node = self.nodes[i]
        if node.online:
            cs = node.cs
            cs._stall_check()
            # Height straggler (missed a commit to drops/partition/churn):
            # after one round-0 budget of idleness, a caught-up peer
            # re-serves that height (reactor catchup-gossip analogue).
            idle = self.clock.now() - cs._last_progress
            if idle > cs.config.round_timeout_budget(0):
                self._catchup(node)
            self._drain(node)
        self.clock.timer(float(self.spec["watchdog_poll_s"]), self._watchdog_tick, i)

    # -- background gossip (votes + evidence) ---------------------------------
    #
    # The reactor-analogue the byzantine layer leans on: the per-signer
    # broadcast alone never places two CONFLICTING copies of a vote in one
    # honest node's VoteSet (each camp only ever saw its own copy), so
    # equivocation would go undetected and pending evidence would only
    # commit when the detecting node itself proposes. Each gossip tick a
    # node picks one rotating same-height peer and relays (a) the votes it
    # holds at that peer's CURRENT round which the peer provably lacks or
    # holds a DIFFERENT copy of — the HasVote-bitmap logic of
    # gossipVotesRoutine, with harness omniscience standing in for the
    # tracked peer state — and (b) its pending evidence as real
    # evidence-reactor wire bytes. In a healthy full mesh every vote is
    # already at every peer, so (a) relays almost nothing; after a heal or
    # under equivocation it converges the split knowledge within ticks.

    def _gossip_tick(self, i: int) -> None:
        node = self.nodes[i]
        if node.online and node.cs is not None:
            self._relay_votes(i)
            self._relay_evidence(i)
        self.clock.timer(float(self.spec["gossip_interval_s"]), self._gossip_tick, i)

    def _gossip_peer(self, i: int) -> int | None:
        h = self.nodes[i].cs.rs.height
        candidates = [
            j for j in range(self.n)
            if j != i and self.nodes[j].online and self.nodes[j].cs is not None
            and self.nodes[j].cs.rs.height == h and self._reachable(i, j)
        ]
        if not candidates:
            return None
        rotor = self._gossip_rotor.get(i, 0)
        self._gossip_rotor[i] = rotor + 1
        return candidates[rotor % len(candidates)]

    def _relay_votes(self, i: int, cap: int = 16) -> None:
        from cometbft_tpu_torch.consensus.messages import VoteMessage

        j = self._gossip_peer(i)
        if j is None:
            return
        cs_i, cs_j = self.nodes[i].cs, self.nodes[j].cs
        h, r_j = cs_i.rs.height, cs_j.rs.round
        sent_h, sent = self._gossip_sent.get((i, j), (None, None))
        if sent_h != h:
            sent = set()
            self._gossip_sent[(i, j)] = (h, sent)
        relayed = 0
        for vs_i, vs_j in (
            (cs_i.rs.votes.prevotes(r_j), cs_j.rs.votes.prevotes(r_j)),
            (cs_i.rs.votes.precommits(r_j), cs_j.rs.votes.precommits(r_j)),
        ):
            if vs_i is None:
                continue
            for idx, vote in enumerate(vs_i.votes):
                if vote is None or relayed >= cap:
                    continue
                key = (r_j, vote.type, idx)
                if key in sent:
                    continue
                theirs = vs_j.votes[idx] if vs_j is not None else None
                if theirs is not None and theirs.block_id == vote.block_id:
                    continue  # peer already holds this copy (HasVote)
                sent.add(key)
                relayed += 1
                self.counters["gossip_votes"] += 1
                self._send_direct(i, j, VoteMessage(vote))

    def _relay_evidence(self, i: int, cap: int = 4) -> None:
        from cometbft_tpu_torch.evidence.reactor import encode_evidence_list_msg

        j = self._gossip_peer(i)
        if j is None:
            return
        evpool = self.nodes[i].evpool
        if evpool is None:
            return
        pending, _ = evpool.pending_evidence(-1)
        if not pending:
            return
        raw = encode_evidence_list_msg(pending[:cap])
        self.counters["gossip_evidence"] += 1
        self.clock.timer(self._link_delay(i, j), self._deliver_evidence, j, raw)

    def _deliver_evidence(self, j: int, raw: bytes) -> None:
        from cometbft_tpu_torch.evidence.reactor import decode_evidence_list_msg

        node = self.nodes[j]
        if not node.online or node.evpool is None:
            self.counters["offline_skips"] += 1
            return
        for ev in decode_evidence_list_msg(raw):
            try:
                node.evpool.add_evidence(ev)
            except Exception:
                # Peers that have not yet committed the evidence height
                # reject it (evidence/reactor.go swallows the same way);
                # the sender keeps re-offering while it stays pending.
                self.counters["evidence_rejects"] += 1

    # -- in-sim blocksync late-join -------------------------------------------
    #
    # A join node is a genesis validator that stays dark until ``at_s``,
    # then catches up by driving REAL blocksync wire frames
    # (encode_block_request/encode_block_response + the
    # verify_commit_light-then-apply flow of blocksync/reactor.py
    # _try_sync_one) over the sim link model, and finally constructs a
    # fresh ConsensusState from the synced state — the same boot sequence
    # a wall-clock node performs, minus the thread-driven reactor shell
    # that would break single-threaded determinism.

    _JOIN_WINDOW = 8  # request pipeline depth (blocksync pool analogue)
    _JOIN_POLL_S = 0.5

    def _begin_join(self, j: int) -> None:
        self.counters["joins"] += 1
        self._join_state[j] = {
            "blocks": {},
            "requested": set(),
            "state": self.nodes[j].state_store.load(),
            "synced": 0,
            "started_s": round(self.clock.now(), 6),
            "done": False,
        }
        self._blocksync_tick(j)

    def _pick_donor(self, j: int):
        best = None
        for d in self.nodes:
            if (
                d.index == j or not d.online or d.cs is None
                or not self._reachable(d.index, j)
            ):
                continue
            h = d.block_store.height()
            if h > 0 and (best is None or h > best.block_store.height()):
                best = d
        return best

    def _blocksync_tick(self, j: int) -> None:
        from cometbft_tpu_torch.blocksync.reactor import encode_block_request

        js = self._join_state.get(j)
        if js is None or js["done"]:
            return
        node = self.nodes[j]
        donor = self._pick_donor(j)
        if donor is not None:
            tip = donor.block_store.height()
            my_h = node.block_store.height()
            if my_h >= tip - 1:
                # Within one block of the donor tip: the pair rule cannot
                # certify the tip block, so switch to consensus — the
                # watchdog catchup path serves the remainder, exactly the
                # reactor's is_caught_up handoff.
                self._complete_join(j, js)
                return
            for h in range(my_h + 1, min(my_h + 1 + self._JOIN_WINDOW, tip + 1)):
                if h in js["blocks"] or h in js["requested"]:
                    continue
                js["requested"].add(h)
                raw = encode_block_request(h)
                self.clock.timer(
                    self._link_delay(j, donor.index),
                    self._bs_serve, donor.index, j, raw,
                )
        self.clock.timer(self._JOIN_POLL_S, self._blocksync_tick, j)

    def _bs_serve(self, d: int, j: int, raw: bytes) -> None:
        from cometbft_tpu_torch.blocksync.reactor import (
            decode_message,
            encode_block_response,
        )

        donor = self.nodes[d]
        if not donor.online:
            return  # request lost: the joiner's next tick re-picks a donor
        kind, height = decode_message(raw)
        assert kind == "block_request"
        block = donor.block_store.load_block(height)
        if block is None:
            return
        self.counters["blocksync_served"] += 1
        self.clock.timer(
            self._link_delay(d, j), self._bs_receive, j,
            encode_block_response(block),
        )

    def _bs_receive(self, j: int, raw: bytes) -> None:
        from cometbft_tpu_torch.blocksync.reactor import decode_message

        js = self._join_state.get(j)
        if js is None or js["done"]:
            return
        kind, block = decode_message(raw)
        assert kind == "block_response"
        h = block.header.height
        js["blocks"][h] = block
        js["requested"].discard(h)
        self._bs_apply(j, js)

    def _bs_apply(self, j: int, js: dict) -> None:
        """reactor.py _try_sync_one verbatim: verify `first` with
        `second.last_commit` (verify_commit_light — the TPU-batched call),
        validate, save with the certifying commit, apply."""
        from cometbft_tpu_torch.types.block import BlockID

        node = self.nodes[j]
        while True:
            h = node.block_store.height() + 1
            first, second = js["blocks"].get(h), js["blocks"].get(h + 1)
            if first is None or second is None:
                return
            first_parts = first.make_part_set()
            first_id = BlockID(first.hash(), first_parts.header())
            state = js["state"]
            state.validators.verify_commit_light(
                state.chain_id, first_id, h, second.last_commit
            )
            node.executor.validate_block(state, first)
            node.block_store.save_block(first, first_parts, second.last_commit)
            js["state"], _ = node.executor.apply_block(state, first_id, first)
            del js["blocks"][h]
            js["synced"] += 1

    def _complete_join(self, j: int, js: dict) -> None:
        from cometbft_tpu_torch.consensus.state import ConsensusState

        node = self.nodes[j]
        js["done"] = True
        sink = self._make_tock_sink(j)
        cs = ConsensusState(
            node.cfg.consensus,
            js["state"],
            node.executor,
            node.block_store,
            node.mempool,
            evpool=node.evpool,
            wal=None,
            ticker=SimTicker(self.clock, sink),
            clock=self.clock,
            name=node.name,
        )
        cs.set_priv_validator(node.pv)
        cs._stall_factor = float(self.spec["stall_factor"])
        cs.set_broadcast(self._make_broadcast(j))
        node.cs = cs
        cs.set_on_stall(self._make_on_stall(node))
        node.online = True
        cs.ticker.start()
        cs._schedule_round0()
        self.counters["join_completions"] += 1
        self._join_reports.append({
            "node": j,
            "started_s": js["started_s"],
            "joined_s": round(self.clock.now(), 6),
            "synced_blocks": js["synced"],
            "height_at_join": node.block_store.height(),
        })

    # -- run ------------------------------------------------------------------

    def run(self) -> dict:
        import gc
        import os

        from cometbft_tpu_torch.crypto import sigbatch
        from cometbft_tpu_torch.types import cmttime
        from cometbft_tpu_torch.types.cmttime import Time

        target_height = int(self.spec["blocks"]) + 1
        horizon = float(self.spec["max_sim_s"])
        wall_start = _time.monotonic()

        def sim_now() -> Time:
            ns = GENESIS_SECONDS * 10**9 + int(self.clock.now() * 1e9)
            return Time(ns // 10**9, ns % 10**9)

        cmttime.set_now_source(sim_now)
        # The wall-clock vote-admission micro-batch would make every scalar
        # verify wait out a real window with no concurrent producers to
        # share it (the harness is single-threaded) — the sim models vote
        # batching virtually instead (vote_window_ms).
        prev_window = os.environ.get("CMTPU_VOTE_BATCH_WINDOW_MS")
        os.environ["CMTPU_VOTE_BATCH_WINDOW_MS"] = "0"
        sigbatch.reset()
        # The drive loop allocates millions of short-lived objects against
        # a large persistent heap (N nodes × stores × caches): generational
        # GC passes dominate wall time and grow with heap size, making
        # back-to-back runs progressively slower. The harness has no
        # reference cycles it needs collected mid-run.
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            self._build()
            self._script()
            for node in self.nodes:
                if node.index in self._join_nodes:
                    continue  # dark until its join event fires
                node.cs.ticker.start()
                node.cs._schedule_round0()
            cs0 = self.nodes[0].cs
            last_h = cs0.rs.height
            while (
                cs0.rs.height < target_height
                and self.clock.now() < horizon
                and self.clock.step()
            ):
                if cs0.rs.height != last_h:
                    t = round(self.clock.now(), 6)
                    for hh in range(last_h, cs0.rs.height):
                        self._commit_times.append([hh, t])
                    last_h = cs0.rs.height
            if cs0.rs.height != last_h:  # the commit that ended the loop
                t = round(self.clock.now(), 6)
                for hh in range(last_h, cs0.rs.height):
                    self._commit_times.append([hh, t])
        finally:
            cmttime.set_now_source(None)
            if prev_window is None:
                os.environ.pop("CMTPU_VOTE_BATCH_WINDOW_MS", None)
            else:
                os.environ["CMTPU_VOTE_BATCH_WINDOW_MS"] = prev_window
            sigbatch.reset()
            for node in self.nodes:
                node.cs.ticker.stop()

        wall = _time.monotonic() - wall_start
        if gc_was_enabled:
            gc.enable()
            gc.collect()
        sim_time = self.clock.now()
        heights = [n.cs.rs.height for n in self.nodes]
        committed = min(cs0.rs.height - 1, int(self.spec["blocks"]))
        hashes = {}
        for h in range(1, committed + 1):
            blk = self.nodes[0].cs.block_store.load_block(h)
            hashes[h] = blk.hash().hex() if blk is not None else None
        reached = cs0.rs.height >= target_height
        # Hash agreement (the e2e runner's invariant, in-process form):
        # every node that committed the highest common height must hold the
        # bit-identical block there. Stragglers below it are exempt — they
        # are reported, not silently passed.
        common = 0
        agreed_hash = None
        agreement = True
        if committed >= 1:
            common = min(
                [committed]
                + [h - 1 for h in heights if h - 1 >= 1 and h >= cs0.rs.height - 1]
            )
            agreed_hash = hashes.get(common)
            for node in self.nodes:
                if node.cs.rs.height - 1 < common:
                    continue
                blk = node.cs.block_store.load_block(common)
                if blk is None or blk.hash().hex() != agreed_hash:
                    agreement = False
        safety_ok, conflicting = self._check_safety(committed)
        return {
            "ok": reached and agreement and safety_ok,
            "seed": self.seed,
            "validators": self.n,
            "blocks_target": int(self.spec["blocks"]),
            "height_node0": cs0.rs.height,
            "heights_min": min(heights),
            "heights_max": max(heights),
            "stragglers": [
                i for i, h in enumerate(heights) if h < cs0.rs.height - 1
            ],
            "block_hashes": hashes,
            "agreed_height": common,
            "agreed_hash": agreed_hash,
            "hash_agreement": agreement,
            "safety_ok": safety_ok,
            "conflicting_heights": conflicting,
            "evidence": self._evidence_report(committed),
            "recovery": self._recovery_report(),
            "joins": list(self._join_reports),
            "commit_times": [list(x) for x in self._commit_times],
            "sim_time_s": round(sim_time, 6),
            "wall_time_s": round(wall, 6),
            "accel": round(sim_time / wall, 3) if wall > 0 else None,
            "events": self.clock.events_run,
            "counters": dict(self.counters),
            "schedule": self.schedule,
        }

    # -- report helpers -------------------------------------------------------

    def _check_safety(self, committed: int) -> tuple[bool, list[int]]:
        """The BFT safety contract: no two HONEST nodes hold different
        blocks at any committed height (byzantine nodes' own stores are
        not part of the claim). Distinct from hash_agreement, which only
        checks the highest common height."""
        byz = {a.node_index for a in self.byz_actors}
        conflicting = []
        for h in range(1, committed + 1):
            seen = None
            for node in self.nodes:
                if node.index in byz:
                    continue
                meta = node.cs.block_store.load_block_meta(h)
                if meta is None:
                    continue
                bh = meta.block_id.hash
                if seen is None:
                    seen = bh
                elif bh != seen:
                    conflicting.append(h)
                    break
        return not conflicting, conflicting

    def _evidence_report(self, committed: int) -> dict:
        """Detection → pending → committed accounting, from node 0's chain
        (every honest chain is bit-identical when safety holds)."""
        committed_heights = []
        committed_count = 0
        for h in range(1, committed + 1):
            blk = self.nodes[0].cs.block_store.load_block(h)
            if blk is not None and blk.evidence:
                committed_heights.append(h)
                committed_count += len(blk.evidence)
        byz = {a.node_index for a in self.byz_actors}
        pending_honest = 0
        pool_stats: dict[str, int] = {}
        for node in self.nodes:
            if node.index in byz or node.evpool is None:
                continue
            snap = node.evpool.stats_snapshot()
            pending_honest = max(pending_honest, snap["pending"])
            for k, v in snap.items():
                pool_stats[k] = pool_stats.get(k, 0) + v
        first = self._evidence_detections[0] if self._evidence_detections else None
        commit_s = None
        if committed_heights:
            at = dict((hh, t) for hh, t in self._commit_times)
            commit_s = at.get(committed_heights[0])
        return {
            "detections": len(self._evidence_detections),
            "first_detection": first,
            "committed_heights": committed_heights,
            "committed_count": committed_count,
            "first_commit_sim_s": commit_s,
            "detect_to_commit_s": (
                round(commit_s - first["sim_s"], 6)
                if commit_s is not None and first is not None else None
            ),
            "max_pending_honest": pending_honest,
            "pool_stats": pool_stats,
        }

    def _recovery_report(self) -> dict:
        """Block-rate recovery after the last byzantine/partition window:
        baseline = median commit interval during clean time before the
        first window; recovered when a post-window commit interval is
        back within 2x baseline."""
        disturb_from = [float(a.from_s) for a in self.byz_actors]
        disturb_until = [float(a.until_s) for a in self.byz_actors]
        for p in self.schedule.get("partitions", []):
            disturb_from.append(float(p["at_s"]))
            disturb_until.append(float(p["heal_s"]))
        if not disturb_from or len(self._commit_times) < 3:
            return {"applicable": False}
        t_from, t_until = min(disturb_from), max(disturb_until)
        ct = self._commit_times
        intervals = [
            (ct[k][1], ct[k][1] - ct[k - 1][1]) for k in range(1, len(ct))
        ]
        base = sorted(dt for t, dt in intervals if t <= t_from)
        source = "pre_window"
        if not base:
            # Nothing committed before the window opened (early
            # disturbance): take the run's steady-state tail instead —
            # the last quartile of intervals — as the honest baseline.
            tail = [dt for _, dt in intervals[-max(2, len(intervals) // 4):]]
            base = sorted(tail)
            source = "tail"
        baseline = base[len(base) // 2] if base else None
        recovered_at = None
        if baseline:
            for t, dt in intervals:
                if t > t_until and dt <= 2.0 * baseline:
                    recovered_at = t
                    break
        return {
            "applicable": True,
            "baseline_source": source,
            "baseline_interval_s": round(baseline, 6) if baseline else None,
            "window": [t_from, t_until],
            "recovered_at_s": recovered_at,
            "recovery_lag_s": (
                round(recovered_at - t_until, 6)
                if recovered_at is not None else None
            ),
        }


def run_scenario(spec: dict | None = None, **overrides) -> dict:
    """Build + run one seeded scenario; returns the report dict (the
    ``schedule`` key is sufficient to replay the run bit-identically)."""
    full = default_spec(**{**(spec or {}), **overrides})
    return Scenario(full).run()
