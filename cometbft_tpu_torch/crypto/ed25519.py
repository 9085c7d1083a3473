"""Ed25519 public keys and batch verification under ZIP-215, the port's copy
of ``cometbft_tpu/crypto/ed25519.py`` (crypto/ed25519/ed25519.go).

A key is 32 bytes, a signature 64, the address SHA256-20 of the key
(ed25519.go:162-168). ``PubKey.verify_signature`` answers from the
verified-triple cache or the pure ZIP-215 check (``ed25519_pure``);
``BatchVerifier.verify`` sends the triples the cache cannot answer to the
process's backend (``sidecar/backend.get_backend()``: the card's
``sha512`` -> ``decompress`` -> ``ladder`` by default) in one call, and
drops to the scalar ZIP-215 check only when every tier of the supervised
chain has failed (``ChainExhausted``), as the reference does for liveness.
"""

from __future__ import annotations

import os
import threading

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import ed25519_pure, tmhash

KEY_TYPE = "ed25519"
PUB_KEY_SIZE = 32
SIGNATURE_SIZE = 64

PUB_KEY_NAME = "tendermint/PubKeyEd25519"


class PubKey(crypto.PubKey):
    def __init__(self, data: bytes):
        self._bytes = bytes(data)

    def address(self) -> bytes:
        if len(self._bytes) != PUB_KEY_SIZE:
            raise ValueError("pubkey is incorrect size")
        return tmhash.sum_truncated(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE or len(self._bytes) != PUB_KEY_SIZE:
            return False
        key = (self._bytes, bytes(sig), bytes(msg))
        if key in _verified:
            return True
        ok = ed25519_pure.verify_zip215(self._bytes, msg, sig)
        if ok:
            _verified_put(key)
        return ok

    def type(self) -> str:
        return KEY_TYPE

    def __repr__(self) -> str:
        return f"PubKeyEd25519{{{self._bytes.hex().upper()}}}"


SEED_SIZE = 32
PRIVATE_KEY_SIZE = 64


class PrivKey:
    """A 64-byte key, seed || public key (ed25519.go:48-120). ``sign`` is
    RFC 8032 in pure Python (``ed25519_pure.sign``): deterministic, so the
    same seed signs the same bytes as any other RFC 8032 signer."""

    def __init__(self, data: bytes):
        if len(data) != PRIVATE_KEY_SIZE:
            raise ValueError(f"ed25519 privkey must be {PRIVATE_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def bytes(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        return ed25519_pure.sign(self._bytes[:SEED_SIZE], self._bytes[SEED_SIZE:], msg)

    def pub_key(self) -> PubKey:
        if not any(self._bytes[SEED_SIZE:]):
            raise ValueError("expected ed25519 PrivKey to include concatenated pubkey bytes")
        return PubKey(self._bytes[SEED_SIZE:])

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    """GenPrivKey (ed25519.go:124-135): a random seed."""
    return _from_seed(os.urandom(SEED_SIZE))


def gen_priv_key_from_secret(secret: bytes) -> PrivKey:
    """GenPrivKeyFromSecret (ed25519.go:141-148): seed = SHA256(secret)."""
    return _from_seed(tmhash.sum(secret))


def _from_seed(seed: bytes) -> PrivKey:
    return PrivKey(seed + ed25519_pure.public_key(seed))


# The verified-triple cache: (pub, sig, msg) tuples that verified, so that a
# commit checked twice (blocksync's light check, then the full check when
# the block is applied; a light hop's trusting and light checks) reaches the
# backend once. Only valid results are kept. Bounded by
# CMTPU_VERIFY_CACHE_MAX: on overflow the oldest quarter goes, and a triple
# verified again moves to the young end (dict order is insertion order).
_VERIFIED_MAX = int(os.environ.get("CMTPU_VERIFY_CACHE_MAX", "") or 131072)
_verified: dict[tuple, None] = {}
_verified_lock = threading.Lock()


# How many verify calls took the scalar path after ChainExhausted.
# Observability only.
scalar_fallbacks = 0


def _verified_put_many(keys: list[tuple]) -> None:
    """Insert verified triples under one acquisition of the lock; the
    eviction repeats until the bound holds, so a batch larger than a quarter
    of the cache cannot push it past ``_VERIFIED_MAX``."""
    if not keys:
        return
    with _verified_lock:
        for key in keys:
            if key in _verified:
                del _verified[key]
            elif len(_verified) >= _VERIFIED_MAX:
                for k in list(_verified)[: max(1, _VERIFIED_MAX // 4)]:
                    _verified.pop(k, None)
            _verified[key] = None


def _verified_put(key: tuple) -> None:
    _verified_put_many([key])


class BatchVerifier(crypto.BatchVerifier):
    """Ed25519 batch verification (ed25519.go:196-228): entries gather on
    the host; ``verify`` dispatches the uncached, deduplicated triples to
    ``get_backend()`` in one call."""

    def __init__(self):
        self._pubs: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def add(self, key: crypto.PubKey, message: bytes, signature: bytes) -> None:
        if not isinstance(key, PubKey):
            raise TypeError("pubkey is not Ed25519")
        pk = key.bytes()
        if len(pk) != PUB_KEY_SIZE:
            raise ValueError(
                f"pubkey size is incorrect; expected: {PUB_KEY_SIZE}, got {len(pk)}"
            )
        if len(signature) != SIGNATURE_SIZE:
            raise ValueError("invalid signature")
        self._pubs.append(pk)
        self._msgs.append(bytes(message))
        self._sigs.append(bytes(signature))

    def __len__(self) -> int:
        return len(self._pubs)

    def verify(self) -> tuple[bool, list[bool]]:
        global scalar_fallbacks
        from cometbft_tpu_torch.sidecar.backend import get_backend
        from cometbft_tpu_torch.sidecar.supervisor import ChainExhausted

        if not self._pubs:
            return False, []
        # Only the triples the cache cannot answer go out, each once: lanes
        # holds each entry's lane in the sub-batch, -1 for a cache hit. The
        # cache is read once here, so the merge below keeps this snapshot
        # even while other threads add to it.
        keys = list(zip(self._pubs, self._sigs, self._msgs))
        lane_of: dict[tuple, int] = {}
        lanes: list[int] = []
        sub_pubs: list[bytes] = []
        sub_msgs: list[bytes] = []
        sub_sigs: list[bytes] = []
        for key in keys:
            if key in _verified:
                lanes.append(-1)
                continue
            lane = lane_of.get(key)
            if lane is None:
                lane = len(sub_pubs)
                lane_of[key] = lane
                sub_pubs.append(key[0])
                sub_msgs.append(key[2])
                sub_sigs.append(key[1])
            lanes.append(lane)
        if not sub_pubs:
            return True, [True] * len(keys)
        try:
            _, sub_bits = get_backend().batch_verify(sub_pubs, sub_msgs, sub_sigs)
        except ChainExhausted:
            # Every tier of the chain failed: liveness outranks batch speed.
            with _verified_lock:
                scalar_fallbacks += 1
            sub_bits = [
                ed25519_pure.verify_zip215(p, m, s)
                for p, m, s in zip(sub_pubs, sub_msgs, sub_sigs)
            ]
        bits = [True if lane < 0 else sub_bits[lane] for lane in lanes]
        _verified_put_many(
            [k for k, lane in zip(keys, lanes) if lane >= 0 and sub_bits[lane]]
        )
        return all(bits), bits
