"""QoS-aware transaction ingress: signed envelopes, batched pre-verification,
priority lanes, and load shedding. The port's copy of
``cometbft_tpu/mempool/ingress.py``: the same envelope bytes, codes,
codespace, logs and counters.

The ``IngressPipeline`` sits between the tx producers (RPC
``broadcast_tx_*`` handlers and the mempool reactor's gossip receive) and
the clist mempool.  It exposes the same ``check_tx(tx, callback, sender)``
admission surface and delegates everything else to the wrapped mempool, so
node wiring can hand it anywhere a mempool is expected.

Pipeline stages::

    submit (RPC / gossip thread, never blocks)
      -> envelope decode (legacy passthrough) + duplicate short-circuit
      -> per-sender token bucket  -> reject CODE_RATE_LIMITED
      -> bounded lane enqueue     -> reject CODE_QUEUE_FULL (load shed)
    dispatcher thread (micro-batch window)
      -> WFQ drain of lanes
      -> ed25519.BatchVerifier over envelope sigs — one dispatch through
         the CoalescingScheduler -> ResilientBackend chain; the
         verified-triple LRU makes gossip re-admission free and the
         chain-exhausted fallback scalar-verifies, so a wedged device
         tier degrades admission but never drops valid txs
      -> invalid sigs rejected without waking the app
      -> survivors forwarded to mempool.check_tx (app CheckTx) lane-tagged

Rejections are delivered synchronously through the caller's callback as a
``ResponseCheckTx`` with codespace ``"ingress"`` and a distinct code per
cause — the RPC thread gets its answer immediately instead of blocking on
a full queue.

Where the original swallows an exception, the port keeps the verdict and
counts it: a preverify batch call that raised (answered by the scalar
fallback) in ``preverify_fallbacks`` with the last in
``last_preverify_error``, a batch the dispatcher's catch-all answered in
``dispatcher_errors`` (``last_dispatcher_error``), and a callback that raised
in ``callback_errors`` (``last_callback_error``). The scalar fallback is
kept only where the process backend verifies on the host: where it runs on
a CUDA card, the batch call's exception goes to the dispatcher's catch-all,
which answers the batch ``CODE_REJECTED``, so that no work leaves a card
that is present.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.libs import threads
from cometbft_tpu_torch.mempool.clist_mempool import (
    ErrMempoolIsFull,
    ErrTxInCache,
)
from cometbft_tpu_torch.mempool.lanes import LaneFull, LaneItem, LaneSet
from cometbft_tpu_torch.sidecar import engine

# -- SignedTxEnvelope wire format (version 1) --------------------------------
#
#   [0]      magic 0xCE ("claimed envelope"); any other first byte is a
#            legacy unsigned tx and passes through untouched
#   [1]      version (1)
#   [2:34]   ed25519 pubkey (32 bytes) — the authenticated sender identity
#   [34]     priority byte (clamped into the configured lane count)
#   [35:43]  nonce, u64 big-endian (replay discrimination; two envelopes
#            differing only in nonce are distinct txs)
#   [43:-64] payload (>= 1 byte, handed to the app unchanged inside the
#            envelope bytes)
#   [-64:]   ed25519 signature over SIGN_DOMAIN || version || priority ||
#            nonce || payload

ENVELOPE_MAGIC = 0xCE
ENVELOPE_VERSION = 1
SIGN_DOMAIN = b"cmtpu/ingress/"
_HEADER_LEN = 2 + 32 + 1 + 8
_MIN_LEN = _HEADER_LEN + 1 + 64

CODESPACE_INGRESS = "ingress"
CODE_BAD_ENVELOPE = 101
CODE_INVALID_SIGNATURE = 102
CODE_RATE_LIMITED = 103
CODE_QUEUE_FULL = 104  # distinct load-shed "mempool full" code
CODE_TX_IN_CACHE = 105
CODE_MEMPOOL_FULL = 106
CODE_REJECTED = 107


class BadEnvelope(Exception):
    pass


@dataclass
class SignedTxEnvelope:
    pubkey: bytes
    priority: int
    nonce: int
    payload: bytes
    signature: bytes

    @property
    def sender(self) -> str:
        return self.pubkey.hex()

    def sign_bytes(self) -> bytes:
        return (
            SIGN_DOMAIN
            + bytes([ENVELOPE_VERSION, self.priority])
            + struct.pack(">Q", self.nonce)
            + self.payload
        )


def encode_envelope(
    priv: ed25519.PrivKey, payload: bytes, priority: int = 0, nonce: int = 0
) -> bytes:
    if not payload:
        raise ValueError("envelope payload must be non-empty")
    priority = max(0, min(int(priority), 255))
    body = bytes([priority]) + struct.pack(">Q", nonce)
    msg = SIGN_DOMAIN + bytes([ENVELOPE_VERSION]) + body + payload
    sig = priv.sign(msg)
    return (
        bytes([ENVELOPE_MAGIC, ENVELOPE_VERSION])
        + priv.pub_key().bytes()
        + body
        + payload
        + sig
    )


def decode_envelope(tx: bytes) -> Optional[SignedTxEnvelope]:
    """Decode ``tx``; None for legacy passthrough, BadEnvelope if malformed.

    A tx is only treated as an envelope when its first byte is the magic;
    from there on malformed framing is an error, not a passthrough —
    otherwise a truncated envelope would sneak past signature checks as a
    "legacy" tx.
    """
    if not tx or tx[0] != ENVELOPE_MAGIC:
        return None
    if len(tx) < _MIN_LEN:
        raise BadEnvelope(f"envelope too short ({len(tx)} < {_MIN_LEN})")
    if tx[1] != ENVELOPE_VERSION:
        raise BadEnvelope(f"unsupported envelope version {tx[1]}")
    pubkey = bytes(tx[2:34])
    priority = tx[34]
    (nonce,) = struct.unpack(">Q", tx[35:43])
    payload = bytes(tx[43:-64])
    sig = bytes(tx[-64:])
    return SignedTxEnvelope(pubkey, priority, nonce, payload, sig)


def _env_float(name: str, fallback: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else fallback
    except ValueError:
        return fallback


def _reject_response(code: int, log: str) -> abci.ResponseCheckTx:
    return abci.ResponseCheckTx(code=code, log=log, codespace=CODESPACE_INGRESS)


def _backend_on_card() -> bool:
    """Whether the process backend verifies on a CUDA card: by its
    ``device`` where it has one; a ``CpuBackend`` never; else (a chain or a
    scheduler over one, or a backend that cannot be built) whether a card
    is present."""
    import torch

    from cometbft_tpu_torch.sidecar import backend as be

    try:
        backend = be.get_backend()
    except Exception:
        backend = None
    if isinstance(backend, be.CpuBackend):
        return False
    dev = getattr(backend, "device", None)
    if dev is None:
        return torch.cuda.is_available()
    return torch.device(dev).type == "cuda"


class IngressPipeline:
    """Admission pipeline wrapping a CListMempool.

    Knobs (env wins over the mempool config section):
      CMTPU_INGRESS_LANES      priority lane count        (default 4)
      CMTPU_INGRESS_SENDER_RPS per-sender token rate, 0 = unlimited
      CMTPU_INGRESS_QUEUE_MAX  per-lane bound             (default 2048)
      CMTPU_INGRESS_WINDOW_MS  preverify micro-batch window (default 2)
    """

    def __init__(self, config, mempool, now: Callable[[], float] = time.monotonic):
        self.mempool = mempool
        self.n_lanes = int(
            _env_float("CMTPU_INGRESS_LANES", getattr(config, "ingress_lanes", 4))
        )
        self.sender_rps = _env_float(
            "CMTPU_INGRESS_SENDER_RPS", getattr(config, "ingress_sender_rps", 0.0)
        )
        self.queue_max = int(
            _env_float(
                "CMTPU_INGRESS_QUEUE_MAX", getattr(config, "ingress_queue_max", 2048)
            )
        )
        self.window_ms = _env_float(
            "CMTPU_INGRESS_WINDOW_MS", getattr(config, "ingress_window_ms", 2.0)
        )
        self.max_batch = int(_env_float("CMTPU_INGRESS_MAX_BATCH", 4096))
        self.lanes = LaneSet(
            lanes=self.n_lanes,
            queue_max=self.queue_max,
            sender_rps=self.sender_rps,
            now=now,
        )
        self._cmtx = threading.Lock()
        self.counters = {
            "submitted": 0,
            "admitted": 0,
            "legacy_passthrough": 0,
            "rejected_bad_envelope": 0,
            "rejected_invalid_sig": 0,
            "rejected_rate_limited": 0,
            "rejected_queue_full": 0,
            "rejected_duplicate": 0,
            "rejected_mempool_full": 0,
            "rejected_other": 0,
            "shed_total": 0,
            "preverify_batches": 0,
            "preverify_sigs": 0,
            "preverify_batch_max": 0,
            "preverify_fallbacks": 0,
            "dispatcher_errors": 0,
            "callback_errors": 0,
        }
        self.last_preverify_error = None
        self.last_dispatcher_error = None
        self.last_callback_error = None
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threads.spawn(self._run, name="tx-ingress")

    # -- admission surface ---------------------------------------------------

    def check_tx(self, tx: bytes, callback=None, sender: str = "") -> None:
        """Admit ``tx`` asynchronously; rejections answer via ``callback``.

        Never blocks: over-rate and over-capacity submissions are shed with
        a coded ResponseCheckTx instead of waiting for queue space.
        """
        self._count("submitted")
        try:
            env = decode_envelope(tx)
        except BadEnvelope as e:
            self._count("rejected_bad_envelope")
            self._answer(callback, _reject_response(CODE_BAD_ENVELOPE, str(e)))
            return
        # Duplicate short-circuit: seen txs (gossip echo, client retry) go
        # straight to the mempool, which records the new sender and raises
        # — no bucket charge, no queue slot, no signature work.
        if self.mempool.cache.has(tx):
            try:
                self.mempool.check_tx(tx, callback=callback, sender=sender)
            except ErrTxInCache:
                self._count("rejected_duplicate")
                self._answer(
                    callback,
                    _reject_response(CODE_TX_IN_CACHE, "tx already exists in cache"),
                )
            except ErrMempoolIsFull as e:
                self._count("rejected_mempool_full")
                self._count("shed_total")
                self._answer(callback, _reject_response(CODE_MEMPOOL_FULL, str(e)))
            except Exception as e:
                self._count("rejected_other")
                self._answer(callback, _reject_response(CODE_REJECTED, str(e)))
            return
        if env is None:
            self._count("legacy_passthrough")
            item = LaneItem(tx=tx, sender="", lane=0, meta=(None, callback, sender))
        else:
            ident = env.sender
            if not self.lanes.rate_check(ident):
                self._count("rejected_rate_limited")
                self._count("shed_total")
                self._answer(
                    callback,
                    _reject_response(
                        CODE_RATE_LIMITED, f"sender {ident[:16]} over rate limit"
                    ),
                )
                return
            item = LaneItem(
                tx=tx,
                sender=ident,
                lane=self.lanes.clamp_lane(env.priority),
                meta=(env, callback, sender or ident),
            )
        try:
            self.lanes.push(item)
        except LaneFull as e:
            self._count("rejected_queue_full")
            self._count("shed_total")
            self._answer(
                callback, _reject_response(CODE_QUEUE_FULL, f"mempool full: {e}")
            )
            return
        self._wake.set()

    # -- dispatcher ----------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            # Micro-batch window measured from the first waiter, mirroring
            # the CoalescingScheduler: trade window_ms of latency for one
            # fused preverify dispatch across concurrent senders.
            if self.window_ms > 0:
                time.sleep(self.window_ms / 1000.0)
            while True:
                batch = self.lanes.drain(self.max_batch)
                if not batch:
                    break
                try:
                    self._process(batch)
                except Exception as e:
                    # The dispatcher thread must survive anything — a dead
                    # dispatcher would silently blackhole all admission.
                    with self._cmtx:
                        self.counters["dispatcher_errors"] += 1
                        self.last_dispatcher_error = e
                    for it in batch:
                        _, cb, _ = it.meta
                        self._answer(
                            cb, _reject_response(CODE_REJECTED, "ingress error")
                        )

    def _process(self, batch) -> None:
        signed = [it for it in batch if it.meta[0] is not None]
        bits = []
        if signed:
            verifier = ed25519.BatchVerifier()
            for it in signed:
                env = it.meta[0]
                verifier.add(
                    ed25519.PubKey(env.pubkey), env.sign_bytes(), env.signature
                )
            try:
                # Ingress-class admission into the continuous-batching
                # engine: preverify work rides the shared device
                # queue below consensus votes and blocksync, above light
                # prewarm. BatchVerifier semantics (cache filter, dedup,
                # scalar fallback on chain exhaustion) are unchanged.
                with engine.submission_class(engine.CLASS_INGRESS):
                    _, bits = verifier.verify()
            except Exception as e:
                with self._cmtx:
                    self.last_preverify_error = e
                if _backend_on_card():
                    # A card that fails is a fault to see, not work to move
                    # to the host: the dispatcher answers the batch
                    # CODE_REJECTED and counts it.
                    raise
                # Anchor of last resort: scalar-verify each envelope so a
                # broken backend chain degrades throughput, not correctness.
                with self._cmtx:
                    self.counters["preverify_fallbacks"] += 1
                bits = [
                    ed25519.PubKey(it.meta[0].pubkey).verify_signature(
                        it.meta[0].sign_bytes(), it.meta[0].signature
                    )
                    for it in signed
                ]
            with self._cmtx:
                self.counters["preverify_batches"] += 1
                self.counters["preverify_sigs"] += len(signed)
                self.counters["preverify_batch_max"] = max(
                    self.counters["preverify_batch_max"], len(signed)
                )
        verdict = dict(zip(map(id, signed), bits))
        for it in batch:
            env, cb, sender = it.meta
            if env is not None and not verdict.get(id(it), False):
                self._count("rejected_invalid_sig")
                self._answer(
                    cb,
                    _reject_response(CODE_INVALID_SIGNATURE, "envelope signature invalid"),
                )
                continue
            try:
                self.mempool.check_tx(it.tx, callback=cb, sender=sender, lane=it.lane)
                self._count("admitted")
            except ErrTxInCache:
                self._count("rejected_duplicate")
                self._answer(
                    cb, _reject_response(CODE_TX_IN_CACHE, "tx already exists in cache")
                )
            except ErrMempoolIsFull as e:
                self._count("rejected_mempool_full")
                self._count("shed_total")
                self._answer(cb, _reject_response(CODE_MEMPOOL_FULL, str(e)))
            except Exception as e:
                self._count("rejected_other")
                self._answer(cb, _reject_response(CODE_REJECTED, str(e)))

    # -- plumbing ------------------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._cmtx:
            self.counters[key] += n

    def _answer(self, callback, res: abci.ResponseCheckTx) -> None:
        if callback is not None:
            try:
                callback(res)
            except Exception as e:
                with self._cmtx:
                    self.counters["callback_errors"] += 1
                    self.last_callback_error = e

    def stats(self) -> dict:
        with self._cmtx:
            out = dict(self.counters)
        out["lane_depths"] = self.lanes.depths()
        out["lanes"] = self.n_lanes
        out["sender_rps"] = self.sender_rps
        out["queue_max"] = self.queue_max
        return out

    def lane_depths(self):
        return self.lanes.depths()

    def register_metrics(self, registry) -> None:
        def sample(key):
            return lambda: float(self.counters[key])

        for key in (
            "admitted",
            "legacy_passthrough",
            "rejected_bad_envelope",
            "rejected_invalid_sig",
            "rejected_rate_limited",
            "rejected_queue_full",
            "rejected_duplicate",
            "rejected_mempool_full",
            "shed_total",
            "preverify_batches",
            "preverify_sigs",
            "preverify_batch_max",
        ):
            registry.gauge_func(
                "ingress", f"{key}_total" if not key.startswith("preverify") else key,
                f"ingress {key.replace('_', ' ')}", sample(key),
            )
        registry.gauge_func(
            "ingress", "queue_depth", "total queued txs across lanes",
            lambda: float(self.lanes.size()),
        )
        for i in range(self.n_lanes):
            registry.gauge_func(
                "ingress", f"lane{i}_depth", f"queued txs in lane {i}",
                (lambda i=i: float(self.lanes.depths()[i])),
            )

    def flush_queue(self, timeout: float = 5.0) -> bool:
        """Block until the lane queues are empty (tests/bench)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.lanes.size() == 0:
                return True
            self._wake.set()
            time.sleep(0.002)
        return False

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30.0)

    def __getattr__(self, name):
        # Everything that is not admission (reap, update, size, cache,
        # txs_front, locks, ...) is the wrapped mempool's business.
        return getattr(self.mempool, name)
