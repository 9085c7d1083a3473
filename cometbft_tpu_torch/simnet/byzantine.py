"""Scripted byzantine adversaries for the simnet scenario harness, the
port's copy of ``cometbft_tpu/simnet/byzantine.py``.

Every adversary taps the node's OWN send surface — the broadcast hook
the scenario installs with ``cs.set_broadcast`` — and never forks
consensus code: the byzantine node runs the same ``ConsensusState``
machine as every honest peer, and the actor merely rewrites, splits,
delays, or replays what leaves it. That mirrors how a real byzantine
operator would act (patch the gossip layer, not rebuild Tendermint) and
guarantees the honest nodes under test exercise their production
decision paths against well-formed, correctly signed adversarial bytes.

Roles (attach via the scenario spec's ``byzantine`` list):

* ``equivocator`` — for each own prevote/precommit, signs a second
  conflicting vote (a fabricated, seed-derived block id at the same
  (height, round, type)) and splits delivery: one camp of peers gets the
  honest vote, the other camp gets the conflicting one. With
  ``only_partitioned`` the split only happens while a partition is
  active, with the camps equal to the partition sides — the classic
  "invisible" equivocation that no honest node can witness until the
  heal merges vote knowledge. The adversary's own links straddle the
  partition (it reaches both sides): the scripted partition models
  correlated *honest* link failure, and an adversary that lost one side
  too would simply be a crashed node, not a byzantine one.
* ``withholder`` — while active, the node's own ProposalMessage and
  BlockPartMessage broadcasts are dropped (``delay_s = 0``) or delayed
  by ``delay_s`` simulated seconds, forcing honest peers through
  ``timeout_propose`` nil-prevote rounds whenever its proposer turn
  comes up.
* ``flooder`` — replays its own recently broadcast votes (stale rounds,
  duplicates) to a seeded sample of peers at ``rate_hz``, griefing the
  vote-admission/dedup path without ever producing invalid signatures.

Determinism: each actor draws from its own ``random.Random`` stream
seeded from (scenario seed, node, role), and every action is either a
synchronous rewrite inside a broadcast call or a SimClock event — two
runs of the same spec replay bit-identically, adversaries included.
"""

from __future__ import annotations

import hashlib
import random

ROLES = ("equivocator", "withholder", "flooder")

_COMMON_KEYS = {"role", "node", "from_s", "until_s"}
_ROLE_KEYS = {
    "equivocator": {"only_partitioned"},
    "withholder": {"delay_s"},
    "flooder": {"rate_hz", "burst", "fanout"},
}


def make_actor(scenario, entry: dict):
    """Validate one ``byzantine`` spec entry and build its actor."""
    role = entry.get("role")
    if role not in ROLES:
        raise ValueError(f"unknown byzantine role {role!r} (want one of {ROLES})")
    unknown = set(entry) - _COMMON_KEYS - _ROLE_KEYS[role]
    if unknown:
        raise ValueError(f"unknown byzantine keys {sorted(unknown)} for {role}")
    node = int(entry.get("node", -1))
    if not (1 <= node < scenario.n):
        raise ValueError(
            f"byzantine node must be in 1..{scenario.n - 1} "
            "(node 0 is the hash-reference node)"
        )
    cls = {"equivocator": Equivocator, "withholder": Withholder,
           "flooder": Flooder}[role]
    return cls(scenario, entry, node)


class _ActorBase:
    role = ""

    def __init__(self, scenario, entry: dict, node: int):
        self.scen = scenario
        self.node_index = node
        self.from_s = float(entry.get("from_s", 0.0))
        until = entry.get("until_s")
        self.until_s = (
            float(until) if until is not None else float(scenario.spec["max_sim_s"])
        )
        self.rng = random.Random(
            f"simnet-byz:{scenario.seed}:{node}:{self.role}"
        )

    def active(self) -> bool:
        t = self.scen.clock.now()
        return self.from_s <= t < self.until_s

    def wrap(self, base):
        """Return the broadcast fn to install in place of ``base``."""
        return base

    def start(self) -> None:
        """Schedule any clock-driven loops (called once, before the run)."""

    def resolved(self) -> dict:
        """The realized schedule entry (embedded in report/repro.json)."""
        return {
            "role": self.role,
            "node": self.node_index,
            "from_s": self.from_s,
            "until_s": self.until_s,
        }

    def _count(self, key: str, n: int = 1) -> None:
        self.scen.counters[key] = self.scen.counters.get(key, 0) + n


class Equivocator(_ActorBase):
    role = "equivocator"

    def __init__(self, scenario, entry, node):
        super().__init__(scenario, entry, node)
        self.only_partitioned = bool(entry.get("only_partitioned", False))
        # Static camps for the un-partitioned mode: a seeded half/half
        # split of the peer set (under a partition the camps ARE the
        # partition sides instead).
        peers = [j for j in range(scenario.n) if j != node]
        self.rng.shuffle(peers)
        self._camp_b = set(peers[len(peers) // 2:])
        self.first_equivocation_s: float | None = None

    def resolved(self) -> dict:
        out = super().resolved()
        out["only_partitioned"] = self.only_partitioned
        return out

    def wrap(self, base):
        from cometbft_tpu_torch.consensus.messages import VoteMessage

        def broadcast(msg):
            if not isinstance(msg, VoteMessage) or not self.active():
                base(msg)
                return
            scen = self.scen
            if self.only_partitioned and scen._groups is None:
                base(msg)
                return
            node = scen.nodes[self.node_index]
            pub = node.cs.priv_validator_pub_key
            vote = msg.vote
            if pub is None or vote.validator_address != pub.address():
                base(msg)  # not our own vote (relay etc.) — pass through
                return
            alt = self._conflicting_vote(node, vote)
            if alt is None:
                base(msg)
                return
            if self.first_equivocation_s is None:
                self.first_equivocation_s = round(scen.clock.now(), 6)
            self._count("byz_equivocations")
            self._split_deliver(msg, VoteMessage(alt))

        return broadcast

    def _conflicting_vote(self, node, vote):
        """A correctly signed vote at the same (h, r, type) for a
        fabricated, seed-derived block id — differs from the honest vote
        whether that one was nil or a real block."""
        from cometbft_tpu_torch.types import BlockID, Vote
        from cometbft_tpu_torch.types.part_set import PartSetHeader

        scen = self.scen
        mark = hashlib.sha256(
            f"simnet-equivocation:{scen.seed}:{self.node_index}:"
            f"{vote.height}:{vote.round}:{vote.type}".encode()
        ).digest()
        alt = Vote(
            type=vote.type,
            height=vote.height,
            round=vote.round,
            block_id=BlockID(mark, PartSetHeader(1, mark)),
            timestamp=vote.timestamp,
            validator_address=vote.validator_address,
            validator_index=vote.validator_index,
        )
        try:
            return node.cs.priv_validator.sign_vote(node.cs.state.chain_id, alt)
        except Exception:
            return None

    def _split_deliver(self, honest_msg, alt_msg) -> None:
        """Camp A gets the honest vote, camp B the conflicting one.
        Adversary links ignore the partition (see module docstring) and
        the drop model — the adversary makes sure its words arrive."""
        scen = self.scen
        i = self.node_index
        if scen._groups is not None:
            own = next((g for g in scen._groups if i in g), None)
            for j in range(scen.n):
                if j == i:
                    continue
                other_side = own is not None and j not in own
                scen._send_direct(i, j, alt_msg if other_side else honest_msg)
        else:
            for j in range(scen.n):
                if j == i:
                    continue
                scen._send_direct(
                    i, j, alt_msg if j in self._camp_b else honest_msg
                )


class Withholder(_ActorBase):
    role = "withholder"

    def __init__(self, scenario, entry, node):
        super().__init__(scenario, entry, node)
        self.delay_s = float(entry.get("delay_s", 0.0))

    def resolved(self) -> dict:
        out = super().resolved()
        out["delay_s"] = self.delay_s
        return out

    def wrap(self, base):
        from cometbft_tpu_torch.consensus.messages import (
            BlockPartMessage,
            ProposalMessage,
        )

        def broadcast(msg):
            if self.active() and isinstance(
                msg, (ProposalMessage, BlockPartMessage)
            ):
                self._count("byz_withheld")
                if self.delay_s > 0:
                    # Late release: peers decide whether it is still
                    # relevant (stale-round proposals are ignored).
                    self.scen.clock.timer(self.delay_s, base, msg)
                return
            base(msg)

        return broadcast


class Flooder(_ActorBase):
    role = "flooder"

    def __init__(self, scenario, entry, node):
        super().__init__(scenario, entry, node)
        self.rate_hz = float(entry.get("rate_hz", 5.0))
        self.burst = int(entry.get("burst", 4))
        self.fanout = int(entry.get("fanout", 8))
        self._ring: list = []  # own recently broadcast VoteMessages

    def resolved(self) -> dict:
        out = super().resolved()
        out.update(rate_hz=self.rate_hz, burst=self.burst, fanout=self.fanout)
        return out

    def wrap(self, base):
        from cometbft_tpu_torch.consensus.messages import VoteMessage

        def broadcast(msg):
            if isinstance(msg, VoteMessage):
                self._ring.append(msg)
                if len(self._ring) > 64:
                    del self._ring[0]
            base(msg)

        return broadcast

    def start(self) -> None:
        if self.rate_hz > 0:
            self.scen.clock.timer(max(self.from_s, 1e-9), self._tick)

    def _tick(self) -> None:
        scen = self.scen
        if scen.clock.now() >= self.until_s:
            return
        node = scen.nodes[self.node_index]
        if self.active() and node.online and self._ring:
            replay = [
                self._ring[self.rng.randrange(len(self._ring))]
                for _ in range(self.burst)
            ]
            peers = [
                j for j in range(scen.n)
                if j != self.node_index and scen._reachable(self.node_index, j)
            ]
            if len(peers) > self.fanout:
                peers = self.rng.sample(peers, self.fanout)
            for j in peers:
                for m in replay:
                    scen._send_direct(self.node_index, j, m)
                    self._count("byz_flooded")
        self.scen.clock.timer(1.0 / self.rate_hz, self._tick)
