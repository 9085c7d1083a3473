"""Pubsub server with the query DSL (libs/pubsub/ +
libs/pubsub/query/query.go), the port's copy of
``cometbft_tpu/libs/pubsub.py``.

Query grammar (subset-complete vs the reference's PEG): conditions joined by
AND, each `key OP value` with OP ∈ {=, <, <=, >, >=, CONTAINS, EXISTS};
values are 'single-quoted strings', numbers, or date/time literals
(TIME/DATE prefixes accepted as plain strings). Events carry attributes as
{composite_key: [values]}; numeric comparisons apply when both sides parse
as numbers (query.go:269-347 semantics).
"""

from __future__ import annotations

import queue
import re
import threading
from dataclasses import dataclass
from typing import Any

_COND_RE = re.compile(
    # Quoted strings have NO escape sequences — matching the reference
    # grammar (libs/pubsub/query), where a value is '...' of non-quote
    # characters; a lone backslash-quote would otherwise parse but never
    # unescape, silently mismatching.
    r"\s*([\w.\-/]+)\s*(>=|<=|=|<|>|\bCONTAINS\b|\bEXISTS\b)\s*"
    r"('[^']*'|[\w.\-:+TZ]*)\s*",
    re.IGNORECASE,
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    value: str


class Query:
    """Compiled query; matches against {key: [values]} attribute maps."""

    def __init__(self, s: str):
        self._str = s.strip()
        self.conditions = self._parse(self._str)

    @staticmethod
    def _split_and(s: str) -> list[str]:
        """Split on AND outside single-quoted strings."""
        parts, buf, in_quote, i = [], [], False, 0
        while i < len(s):
            ch = s[i]
            if ch == "'":
                in_quote = not in_quote
                buf.append(ch)
                i += 1
            elif (
                not in_quote
                and s[i : i + 3].upper() == "AND"
                and (i == 0 or s[i - 1].isspace())
                and (i + 3 >= len(s) or s[i + 3].isspace())
            ):
                parts.append("".join(buf))
                buf = []
                i += 3
            else:
                buf.append(ch)
                i += 1
        parts.append("".join(buf))
        return parts

    @classmethod
    def _parse(cls, s: str) -> list[Condition]:
        if not s:
            return []
        conds = []
        for part in cls._split_and(s):
            part = part.strip()
            if not part:
                continue
            m = _COND_RE.fullmatch(part)
            if not m:
                raise ValueError(f"failed to parse query condition: {part!r}")
            key, op, raw = m.group(1), m.group(2).upper(), m.group(3)
            if op == "EXISTS":
                value = ""
            elif raw.startswith("'") and raw.endswith("'") and len(raw) >= 2:
                value = raw[1:-1]
            elif raw == "":
                # a bare `key=` has no value; only the quoted form '' means
                # the empty string (the reference grammar requires a value)
                raise ValueError(f"failed to parse query condition: {part!r}")
            else:
                value = raw
            conds.append(Condition(key, op, value))
        return conds

    def matches(self, attrs: dict[str, list]) -> bool:
        for cond in self.conditions:
            values = attrs.get(cond.key)
            if values is None:
                return False
            if cond.op == "EXISTS":
                continue
            if not any(_match_one(v, cond.op, cond.value) for v in values):
                return False
        return True

    def __str__(self) -> str:
        return self._str

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self._str == str(other)

    def __hash__(self) -> int:
        return hash(self._str)


def _match_one(value: str, op: str, target: str) -> bool:
    value = str(value)
    if op == "=":
        return value == target
    if op == "CONTAINS":
        return target in value
    try:
        a, b = float(value), float(target)
    except ValueError:
        return False
    return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b}[op]


class Message:
    __slots__ = ("data", "events")

    def __init__(self, data: Any, events: dict[str, list]):
        self.data = data
        self.events = events


class Subscription:
    """A buffered out-channel; canceled flag set on unsubscribe
    (libs/pubsub/subscription.go)."""

    def __init__(self, capacity: int = 100):
        self.out: queue.Queue[Message] = queue.Queue(maxsize=capacity)
        self.canceled = threading.Event()
        self.cancel_reason: str | None = None

    def cancel(self, reason: str) -> None:
        self.cancel_reason = reason
        self.canceled.set()


class Server:
    """libs/pubsub/pubsub.go Server: subscribe/publish with per-subscriber
    queries. Synchronous publish (the reference's PublishWithEvents blocks on
    full subscriber buffers; we drop-on-full to avoid stalling consensus —
    subscribers that fall behind are canceled, matching the bus's
    non-blocking wrapper behavior in the reference node)."""

    def __init__(self):
        self._mtx = threading.RLock()
        # subscriber -> {query -> Subscription}
        self._subs: dict[str, dict[Query, Subscription]] = {}
        self._running = False

    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        with self._mtx:
            for qs in self._subs.values():
                for sub in qs.values():
                    sub.cancel("server stopped")
            self._subs.clear()
            self._running = False

    def num_clients(self) -> int:
        with self._mtx:
            return len(self._subs)

    def subscribe(self, subscriber: str, query: Query, out_capacity: int = 100) -> Subscription:
        with self._mtx:
            qs = self._subs.setdefault(subscriber, {})
            if query in qs:
                raise ValueError("already subscribed")
            sub = Subscription(out_capacity)
            qs[query] = sub
            return sub

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        with self._mtx:
            qs = self._subs.get(subscriber)
            if not qs or query not in qs:
                raise KeyError("subscription not found")
            qs.pop(query).cancel("unsubscribed")
            if not qs:
                del self._subs[subscriber]

    def unsubscribe_all(self, subscriber: str) -> None:
        with self._mtx:
            qs = self._subs.pop(subscriber, None)
            if qs is None:
                raise KeyError("subscription not found")
            for sub in qs.values():
                sub.cancel("unsubscribed")

    def publish(self, data: Any) -> None:
        self.publish_with_events(data, {})

    def publish_with_events(self, data: Any, events: dict[str, list]) -> None:
        msg = Message(data, events)
        with self._mtx:
            targets = [
                (name, q, sub)
                for name, qs in self._subs.items()
                for q, sub in qs.items()
                if q.matches(events)
            ]
        for _, _, sub in targets:
            try:
                sub.out.put_nowait(msg)
            except queue.Full:
                sub.cancel("client is not pulling messages fast enough")
