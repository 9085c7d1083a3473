"""Micro-batched scalar signature checks for the consensus path, the port's
copy of ``cometbft_tpu/crypto/sigbatch.py``.

Vote admission and duplicate-vote evidence check one or two signatures at
a time, but under gossip many such checks run at once. This module gives
those callers a consensus-class seat in the port's continuous-batching
engine (``sidecar/engine.py``): each caller submits the triples the
verified-triple cache cannot answer, tagged CLASS_CONSENSUS, and the engine
merges whatever is queued, from every caller and class, into its next
backend call, votes first. Only valid triples enter the cache afterwards.

When no engine is active (``CMTPU_COALESCE=0``, or a bare backend such as
``TorchBackend()`` installed with ``set_backend``), a private window runs
instead: callers wait on a shared window (``CMTPU_VOTE_BATCH_WINDOW_MS``,
default 2 ms from the first waiter) and one dispatcher thread sends what
queued in ONE ``ed25519.BatchVerifier`` call, which reaches the card's
``sha512`` -> ``decompress`` -> ``ladder`` through ``get_backend()``.

A bad signature is a False lane and never spoils the window. A failed
dispatch, or a result that does not arrive within the deadline-derived
timeout, drops each request on its own to the scalar ``verify_signature``
(the pure ZIP-215 check, same verdicts). Each such drop is counted in
``fallbacks`` and its cause kept in ``last_fallback_error``: a failed
launch on the card must not pass unseen. (The JAX package counts a failed
dispatch but not a timeout.) Window 0, the knob's off switch, keeps the
inline scalar path exactly; ``inline`` dispatches each request at once,
with no window and no thread.
"""

from __future__ import annotations

import os
import threading
import time

_DEFAULT_WINDOW_MS = 2.0
# A caller never waits forever on the dispatcher: consensus liveness
# outranks batching, so a wedged dispatch degrades to scalar verification.
# Used as is only when no supervisor deadline is set: _result_timeout_s().
_RESULT_TIMEOUT_S = 30.0


def _result_timeout_s() -> float:
    """How long a caller waits on a dispatch result before it checks its
    signatures on the scalar path. With a supervised per-call deadline
    (``CMTPU_DEADLINE_MS``) the worst honest wall is every tier of the
    chain spending its retries under that deadline: wait that long, so a
    wedge degrades after one supervised exhaustion. Deadline 0 or unset
    keeps the 30 s backstop."""
    try:
        deadline_ms = float(os.environ.get("CMTPU_DEADLINE_MS", "") or 0.0)
    except ValueError:
        deadline_ms = 0.0
    if deadline_ms <= 0:
        return _RESULT_TIMEOUT_S
    try:
        retries = int(os.environ.get("CMTPU_RETRIES", "") or 2)
    except ValueError:
        retries = 2
    # <= 3 tiers (grpc|torch -> hybrid -> cpu), each (retries+1) attempts.
    return max(1.0, deadline_ms / 1000.0 * (retries + 1) * 3)


class _Req:
    __slots__ = ("pubs", "msgs", "sigs", "event", "bits")

    def __init__(self, pubs, msgs, sigs):
        self.pubs = pubs
        self.msgs = msgs
        self.sigs = sigs
        self.event = threading.Event()
        self.bits: list[bool] | None = None


class SigBatcher:
    """Window-from-first-waiter batcher over ``ed25519.BatchVerifier``.

    ``inline`` dispatches each request through the batch verifier at once,
    with no window and no dispatcher thread: one backend call a vote, the
    other arm of an A/B comparison.
    """

    def __init__(self, window_ms: float | None = None, max_sigs: int = 4096,
                 inline: bool = False):
        if window_ms is None:
            window_ms = float(
                os.environ.get("CMTPU_VOTE_BATCH_WINDOW_MS", "") or _DEFAULT_WINDOW_MS
            )
        self.window_ms = window_ms
        self.max_sigs = max_sigs
        self.inline = inline
        self.result_timeout_s = _result_timeout_s()
        self._cond = threading.Condition()
        self._queue: list[_Req] = []
        self._thread: threading.Thread | None = None
        self._closed = False
        # Counters (mutated under _cond).
        self.requests = 0
        self.batched = 0  # requests that rode a shared dispatch
        self.dispatches = 0
        self.dispatched_sigs = 0
        self.cache_hits = 0
        self.scalar_direct = 0
        self.fallbacks = 0
        self.max_batch = 0
        self.last_fallback_error: BaseException | None = None

    def _fell_back(self, n: int, err: BaseException) -> None:
        with self._cond:
            self.fallbacks += n
            self.last_fallback_error = err

    # -- public API -----------------------------------------------------------

    def verify_one(self, pub_key, msg: bytes, sig: bytes) -> bool:
        return self.verify_many([pub_key], [msg], [sig])[0]

    def verify_many(self, pub_keys, msgs, sigs) -> list[bool]:
        from cometbft_tpu_torch.crypto import ed25519 as _ed

        n = len(pub_keys)
        bits: list[bool | None] = [None] * n
        pend: list[int] = []
        cache_hits = scalar = 0
        for i in range(n):
            pk = pub_keys[i]
            if not isinstance(pk, _ed.PubKey):
                # Only ed25519 has a batch backend; other key types keep
                # their own scalar verify.
                bits[i] = bool(pk.verify_signature(msgs[i], sigs[i]))
                scalar += 1
            elif (
                len(sigs[i]) != _ed.SIGNATURE_SIZE
                or len(pk.bytes()) != _ed.PUB_KEY_SIZE
            ):
                # Structurally impossible: reject without letting it spoil
                # a batch (BatchVerifier.add raises on bad sizes).
                bits[i] = False
            elif (pk.bytes(), bytes(sigs[i]), bytes(msgs[i])) in _ed._verified:
                # Gossip re-delivery and own-vote echo land here: free.
                bits[i] = True
                cache_hits += 1
            else:
                pend.append(i)
        with self._cond:
            self.requests += 1
            self.cache_hits += cache_hits
            self.scalar_direct += scalar
        if not pend:
            return bits  # type: ignore[return-value]
        if self.window_ms <= 0 and not self.inline:
            # Off switch: the inline scalar path, as is.
            for i in pend:
                bits[i] = bool(pub_keys[i].verify_signature(msgs[i], sigs[i]))
            with self._cond:
                self.scalar_direct += len(pend)
            return bits  # type: ignore[return-value]
        if not self.inline:
            eng = self._engine()
            if eng is not None:
                # Continuous batching: no private window thread; the engine
                # merges concurrent admissions (and the other classes)
                # itself, votes first.
                pbits = self._engine_dispatch(eng, pub_keys, msgs, sigs, pend)
                for j, i in enumerate(pend):
                    bits[i] = pbits[j]
                return bits  # type: ignore[return-value]
        req = _Req(
            [pub_keys[i] for i in pend],
            [msgs[i] for i in pend],
            [sigs[i] for i in pend],
        )
        if self.inline:
            self._dispatch([req])
        else:
            with self._cond:
                self._queue.append(req)
                if self._thread is None or not self._thread.is_alive():
                    self._thread = threading.Thread(
                        target=self._run, name="sigbatch", daemon=True
                    )
                    self._thread.start()
                self._cond.notify_all()
            if not req.event.wait(self.result_timeout_s):
                self._fell_back(1, TimeoutError(
                    f"sigbatch window result not in {self.result_timeout_s} s"))
                req.bits = [
                    bool(pk.verify_signature(m, s))
                    for pk, m, s in zip(req.pubs, req.msgs, req.sigs)
                ]
        for j, i in enumerate(pend):
            bits[i] = bool(req.bits[j])
        return bits  # type: ignore[return-value]

    # -- engine path ----------------------------------------------------------

    @staticmethod
    def _engine():
        """The port's engine behind the process backend, or None when the
        chain runs bare (``CMTPU_COALESCE=0``, or an installed backend
        without one): the private window serves those. An error in finding
        it (a process default that cannot be built) raises: a broken
        backend must not pass for a missing engine."""
        from cometbft_tpu_torch.sidecar import backend as _be
        from cometbft_tpu_torch.sidecar import engine as _engine

        return _engine.engine_of(_be.get_backend())

    def _engine_dispatch(self, eng, pub_keys, msgs, sigs, pend) -> list[bool]:
        """Submit the pending triples consensus-class and wait. The same
        verdicts as the private window: only valid dispatched triples enter
        the verified-triple cache, and any failure (an engine error, the
        chain's exhaustion, the deadline-derived timeout) drops THIS request
        alone to the scalar check, counted."""
        from cometbft_tpu_torch.crypto import ed25519 as _ed
        from cometbft_tpu_torch.sidecar.engine import CLASS_CONSENSUS

        pubs = [pub_keys[i].bytes() for i in pend]
        ms = [bytes(msgs[i]) for i in pend]
        ss = [bytes(sigs[i]) for i in pend]
        try:
            fut = eng.submit(pubs, ms, ss, klass=CLASS_CONSENSUS)
            _, rbits = fut.result(self.result_timeout_s)
            rbits = [bool(b) for b in rbits]
        except Exception as e:
            self._fell_back(1, e)
            return [
                bool(pub_keys[i].verify_signature(msgs[i], sigs[i]))
                for i in pend
            ]
        _ed._verified_put_many(
            [(p, s, m) for p, m, s, b in zip(pubs, ms, ss, rbits) if b]
        )
        with self._cond:
            self.dispatches += 1
            self.dispatched_sigs += len(pend)
            if fut.shared:
                self.batched += 1
            self.max_batch = max(self.max_batch, len(pend))
        return rbits

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def counters(self) -> dict:
        with self._cond:
            return {
                "requests": self.requests,
                "batched": self.batched,
                "dispatches": self.dispatches,
                "dispatched_sigs": self.dispatched_sigs,
                "cache_hits": self.cache_hits,
                "scalar_direct": self.scalar_direct,
                "fallbacks": self.fallbacks,
                "max_batch": self.max_batch,
            }

    # -- dispatcher -----------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
            # Window from the FIRST waiter: the request that opened the
            # window pays it once; everything that arrives inside rides free.
            if self.window_ms > 0:
                time.sleep(self.window_ms / 1000.0)
            with self._cond:
                batch: list[_Req] = []
                total = 0
                while self._queue:
                    nxt = len(self._queue[0].pubs)
                    if batch and total + nxt > self.max_sigs:
                        break  # whole requests only; the rest opens a new window
                    total += nxt
                    batch.append(self._queue.pop(0))
            if batch:
                self._dispatch(batch)

    def _dispatch(self, reqs: list[_Req]) -> None:
        from cometbft_tpu_torch.crypto import ed25519 as _ed

        total = sum(len(r.pubs) for r in reqs)
        try:
            bv = _ed.BatchVerifier()
            for r in reqs:
                for pk, m, s in zip(r.pubs, r.msgs, r.sigs):
                    bv.add(pk, m, s)
            # BatchVerifier.verify(): the cache filter and dedup, one backend
            # call, the scalar ZIP-215 path on ChainExhausted.
            _, bits = bv.verify()
        except Exception as e:
            # Each request drops to the scalar check on its own: one hostile
            # entry or a failed backend must never reject a whole window of
            # valid votes.
            self._fell_back(len(reqs), e)
            for r in reqs:
                try:
                    r.bits = [
                        bool(pk.verify_signature(m, s))
                        for pk, m, s in zip(r.pubs, r.msgs, r.sigs)
                    ]
                except Exception:
                    r.bits = [False] * len(r.pubs)
                r.event.set()
            return
        with self._cond:
            self.dispatches += 1
            self.dispatched_sigs += total
            if len(reqs) > 1:
                self.batched += len(reqs)
            self.max_batch = max(self.max_batch, total)
        i = 0
        for r in reqs:
            n = len(r.pubs)
            r.bits = [bool(b) for b in bits[i : i + n]]
            i += n
            r.event.set()


# -- module singleton ---------------------------------------------------------

_batcher: SigBatcher | None = None
_lock = threading.Lock()


def get_batcher() -> SigBatcher:
    """The process-wide batcher (built at first use from the environment)."""
    global _batcher
    b = _batcher
    if b is None:
        with _lock:
            if _batcher is None:
                _batcher = SigBatcher()
            b = _batcher
    return b


def set_batcher(b: SigBatcher | None) -> SigBatcher | None:
    """Install a batcher (tests); returns the previous one."""
    global _batcher
    with _lock:
        old, _batcher = _batcher, b
    return old


def reset() -> None:
    """Drop the singleton so the next use re-reads the knobs."""
    set_batcher(None)


def verify_vote_signature(pub_key, msg: bytes, sig: bytes) -> bool:
    return get_batcher().verify_one(pub_key, msg, sig)


def verify_triples(pub_keys, msgs, sigs) -> list[bool]:
    return get_batcher().verify_many(pub_keys, msgs, sigs)


def counters() -> dict:
    """Counters WITHOUT building a batcher."""
    b = _batcher
    if b is None:
        return {
            "requests": 0, "batched": 0, "dispatches": 0, "dispatched_sigs": 0,
            "cache_hits": 0, "scalar_direct": 0, "fallbacks": 0, "max_batch": 0,
        }
    return b.counters()
