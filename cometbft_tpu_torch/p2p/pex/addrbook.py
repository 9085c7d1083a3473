"""Address book: bucketed peer-address store with JSON persistence
(p2p/pex/addrbook.go — 947 LoC), the port's copy of
``cometbft_tpu/p2p/pex/addrbook.py`` (the same JSON file, so either package
loads the other's book; same new/old bucket design,
group-key hashing, good/bad promotion, and biased sampling, without the
amortized-iteration micro-structures Go needs for its GC profile).

New addresses land in one of 256 "new" buckets keyed by
hash(key || src-group || bucket#); addresses that survive a successful
connection are promoted to one of 64 "old" buckets. pick_address samples
new vs old with a configurable bias, like addrbook.go:368.
"""

from __future__ import annotations

import hashlib
import ipaddress
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field as dfield

NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
NEW_BUCKET_SIZE = 64
OLD_BUCKET_SIZE = 64
MAX_NEW_BUCKETS_PER_ADDRESS = 4


@dataclass
class NetAddress:
    """p2p/netaddress.go NetAddress: id@ip:port."""

    id: str = ""
    ip: str = ""
    port: int = 0

    @classmethod
    def parse(cls, addr: str) -> "NetAddress":
        if "@" not in addr:
            raise ValueError(f"address {addr!r} missing id@")
        node_id, hostport = addr.split("@", 1)
        host, _, port = hostport.rpartition(":")
        return cls(id=node_id.lower(), ip=host, port=int(port))

    def dial_string(self) -> str:
        return f"{self.id}@{self.ip}:{self.port}"

    def routable(self) -> bool:
        """netaddress.go Routable: valid and not in a reserved range."""
        try:
            ip = ipaddress.ip_address(self.ip)
        except ValueError:
            return False
        return not (
            ip.is_loopback
            or ip.is_private
            or ip.is_link_local
            or ip.is_multicast
            or ip.is_unspecified
        )

    def valid(self) -> bool:
        if not self.id or self.port <= 0 or self.port > 65535:
            return False
        try:
            ipaddress.ip_address(self.ip)
        except ValueError:
            return False
        return True

    def group_key(self) -> str:
        """addrbook.go groupKey: /16 for IPv4 — dials spread across groups."""
        try:
            ip = ipaddress.ip_address(self.ip)
        except ValueError:
            return "unroutable"
        if not self.routable():
            return "unroutable"
        if ip.version == 4:
            return ".".join(self.ip.split(".")[:2])
        return self.ip[:10]


@dataclass
class _KnownAddress:
    """addrbook.go knownAddress."""

    addr: NetAddress
    src_id: str = ""
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    bucket_type: str = "new"  # "new" | "old"
    buckets: list = dfield(default_factory=list)

    def is_bad(self, now: float) -> bool:
        """addrbook.go isBad: too many failed attempts recently."""
        if self.bucket_type == "old":
            return False
        if self.attempts >= 3 and self.last_success == 0:
            return True
        return self.attempts >= 10


class AddrBook:
    """p2p/pex/addrbook.go addrBook."""

    def __init__(self, file_path: str = "", strict: bool = True, key: bytes | None = None):
        self.file_path = file_path
        self.strict = strict  # strict routability (False for loopback tests)
        self._key = key or os.urandom(24)
        self._addrs: dict[str, _KnownAddress] = {}
        self._new_buckets: list[set] = [set() for _ in range(NEW_BUCKET_COUNT)]
        self._old_buckets: list[set] = [set() for _ in range(OLD_BUCKET_COUNT)]
        self._our_ids: set[str] = set()
        self._private_ids: set[str] = set()
        self._mtx = threading.RLock()
        self._rand = random.Random()
        # A corrupt file set aside (or a set-aside that failed), counted with
        # the last exception kept, where the original only moves on.
        self.load_errors = 0
        self.last_load_error = None
        if file_path and os.path.exists(file_path):
            self.load(file_path)

    # -- identity filters -----------------------------------------------------

    def add_our_address(self, node_id: str) -> None:
        with self._mtx:
            self._our_ids.add(node_id.lower())

    def add_private_ids(self, ids: list[str]) -> None:
        with self._mtx:
            self._private_ids.update(i.lower() for i in ids)

    # -- core -----------------------------------------------------------------

    def size(self) -> int:
        with self._mtx:
            return len(self._addrs)

    def is_empty(self) -> bool:
        return self.size() == 0

    def need_more_addrs(self) -> bool:
        """addrbook.go NeedMoreAddrs: < 1000 known."""
        return self.size() < 1000

    def _bucket_index_new(self, addr: NetAddress, src_group: str) -> int:
        h = hashlib.sha256(
            self._key + addr.id.encode() + b"|" + src_group.encode()
        ).digest()
        return int.from_bytes(h[:8], "big") % NEW_BUCKET_COUNT

    def _bucket_index_old(self, addr: NetAddress) -> int:
        h = hashlib.sha256(
            self._key + addr.id.encode() + b"|" + addr.group_key().encode()
        ).digest()
        return int.from_bytes(h[:8], "big") % OLD_BUCKET_COUNT

    def add_address(self, addr: NetAddress, src: NetAddress | None = None) -> bool:
        """addrbook.go AddAddress: new addresses go to a new bucket chosen by
        (addr, source group). Returns True when stored."""
        if not addr.valid():
            return False
        if self.strict and not addr.routable():
            return False
        with self._mtx:
            if addr.id in self._our_ids or addr.id in self._private_ids:
                return False
            ka = self._addrs.get(addr.id)
            if ka is not None:
                if ka.bucket_type == "old":
                    return False
                if len(ka.buckets) >= MAX_NEW_BUCKETS_PER_ADDRESS:
                    return False
                # Probabilistically skip re-adding to more buckets.
                if self._rand.random() > 0.5 ** len(ka.buckets):
                    return False
            else:
                ka = _KnownAddress(addr=addr, src_id=src.id if src else "")
                self._addrs[addr.id] = ka
            idx = self._bucket_index_new(
                addr, src.group_key() if src else addr.group_key()
            )
            if idx not in ka.buckets:
                bucket = self._new_buckets[idx]
                if len(bucket) >= NEW_BUCKET_SIZE:
                    self._evict_new(idx)
                bucket.add(addr.id)
                ka.buckets.append(idx)
            return True

    def _evict_new(self, idx: int) -> None:
        """Drop the worst (most-attempted, oldest) entry from a full bucket."""
        bucket = self._new_buckets[idx]
        worst_id, worst_score = None, None
        for aid in bucket:
            ka = self._addrs.get(aid)
            if ka is None:
                worst_id = aid
                break
            score = (ka.attempts, -ka.last_success)
            if worst_score is None or score > worst_score:
                worst_id, worst_score = aid, score
        if worst_id is not None:
            bucket.discard(worst_id)
            ka = self._addrs.get(worst_id)
            if ka is not None:
                if idx in ka.buckets:
                    ka.buckets.remove(idx)
                if not ka.buckets:
                    del self._addrs[worst_id]

    def mark_attempt(self, addr: NetAddress) -> None:
        with self._mtx:
            ka = self._addrs.get(addr.id)
            if ka:
                ka.attempts += 1
                ka.last_attempt = time.time()

    def mark_good(self, node_id: str) -> None:
        """addrbook.go MarkGood: promote to an old bucket."""
        with self._mtx:
            ka = self._addrs.get(node_id.lower())
            if ka is None:
                return
            ka.attempts = 0
            ka.last_success = time.time()
            if ka.bucket_type == "old":
                return
            for idx in ka.buckets:
                self._new_buckets[idx].discard(node_id)
            ka.buckets = []
            ka.bucket_type = "old"
            idx = self._bucket_index_old(ka.addr)
            bucket = self._old_buckets[idx]
            if len(bucket) >= OLD_BUCKET_SIZE:
                # Demote a random old entry back to new (addrbook.go style).
                victim = self._rand.choice(sorted(bucket))
                bucket.discard(victim)
                vka = self._addrs.get(victim)
                if vka:
                    vka.bucket_type = "new"
                    vidx = self._bucket_index_new(vka.addr, vka.addr.group_key())
                    vka.buckets = [vidx]
                    self._new_buckets[vidx].add(victim)
            bucket.add(node_id)
            ka.buckets = [idx]

    def mark_bad(self, addr: NetAddress) -> None:
        """Remove entirely (addrbook.go MarkBad banishes for a duration)."""
        with self._mtx:
            self._remove(addr.id)

    def _remove(self, node_id: str) -> None:
        ka = self._addrs.pop(node_id, None)
        if ka is None:
            return
        buckets = self._old_buckets if ka.bucket_type == "old" else self._new_buckets
        for idx in ka.buckets:
            buckets[idx].discard(node_id)

    def pick_address(self, bias_towards_new: int = 30) -> NetAddress | None:
        """addrbook.go PickAddress: weighted coin between old and new, then a
        uniform sample. bias is a percentage 0..100."""
        now = time.time()
        with self._mtx:
            if not self._addrs:
                return None
            bias = max(0, min(100, bias_towards_new))
            old_ids = [a for b in self._old_buckets for a in b]
            new_ids = [a for b in self._new_buckets for a in b]
            pool = None
            if old_ids and (not new_ids or self._rand.random() * 100 >= bias):
                pool = old_ids
            elif new_ids:
                pool = new_ids
            if not pool:
                return None
            candidates = [
                self._addrs[a]
                for a in pool
                if a in self._addrs and not self._addrs[a].is_bad(now)
            ]
            if not candidates:
                return None
            return self._rand.choice(candidates).addr

    def get_selection(self, max_count: int = 30) -> list[NetAddress]:
        """addrbook.go GetSelection: a random sample (23% of book, capped) to
        answer a pex request."""
        with self._mtx:
            all_addrs = [ka.addr for ka in self._addrs.values()]
        if not all_addrs:
            return []
        n = max(1, min(max_count, (len(all_addrs) * 23) // 100 + 1))
        self._rand.shuffle(all_addrs)
        return all_addrs[:n]

    def has_address(self, node_id: str) -> bool:
        with self._mtx:
            return node_id.lower() in self._addrs

    # -- persistence (addrbook.go saveToFile/loadFromFile) ---------------------

    def save(self, path: str | None = None) -> None:
        path = path or self.file_path
        if not path:
            return
        with self._mtx:
            dump = {
                "key": self._key.hex(),
                "addrs": [
                    {
                        "addr": ka.addr.dial_string(),
                        "src": ka.src_id,
                        "attempts": ka.attempts,
                        "last_success": ka.last_success,
                        "bucket_type": ka.bucket_type,
                    }
                    for ka in self._addrs.values()
                ],
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dump, f)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        """Load the persisted book. The book is a peer-discovery CACHE, not
        consensus state: a corrupt file must not stop node boot (the Go
        CometBFT errors out and operators end up deleting the file by
        hand). On corruption the file is set aside as <path>.corrupt for
        diagnosis and the node starts with an empty book."""
        try:
            with open(path) as f:
                dump = json.load(f)
            if not isinstance(dump, dict):
                raise ValueError("addrbook dump must be a JSON object")
            # Validate EVERYTHING before mutating the book: the key seeds
            # bucket placement, and adopting it from a file we then reject
            # as corrupt would let a tampered file steer bucketing.
            key = bytes.fromhex(dump.get("key", self._key.hex()))
            entries = dump.get("addrs", [])
            if not isinstance(entries, list):
                raise ValueError("addrbook addrs must be a list")
        except (ValueError, TypeError, AttributeError) as e:
            self.load_errors += 1
            self.last_load_error = e
            try:
                os.replace(path, path + ".corrupt")
            except OSError as e2:
                self.load_errors += 1
                self.last_load_error = e2
            return
        self._key = key
        for e in entries:
            if not isinstance(e, dict):
                continue
            try:
                addr = NetAddress.parse(e["addr"])
                attempts = int(e.get("attempts", 0))
                last_success = float(e.get("last_success", 0))
            except (ValueError, KeyError, TypeError):
                continue
            self.add_address(addr)
            ka = self._addrs.get(addr.id)
            if ka is not None:
                ka.attempts = attempts
                ka.last_success = last_success
                if e.get("bucket_type") == "old":
                    self.mark_good(addr.id)
