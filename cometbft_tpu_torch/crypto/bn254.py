"""The BN254 verification chain: host engines and the supervised chain.

Counterpart of the backend half of ``cometbft_tpu/crypto/bn254.py``, over
the port's ``bn254_pure``:

- ``verify_aggregate``: e(G1, agg) == prod_i e(pk_i, H(m_i)), n + 1 Miller
  loops sharing one final exponentiation;
- ``batch_verify_signatures``: the per-signature bitmap of a vote batch,
  each signature weighted by a Fiat-Shamir 64-bit scalar (two bad
  signatures cannot cancel), bisected to the exact bad lanes on failure;
- ``Bn254HostBackend`` (the host multi-pairing engine) and
  ``Bn254ScalarBackend`` (one independent pairing check a signature: the
  chain's anchor and cross-check ground truth), with the ``VerifyBackend``
  duck type the supervisor speaks;
- ``build_bn254_chain``: ``bn254-device`` (the port's ``Bn254DeviceBackend``,
  Miller loops on the card) -> ``bn254-host`` -> the scalar anchor, and
  ``get_bn254_backend``, the process singleton over it;
- the key type of the crypto registry (``crypto/batch.py``): ``PubKey``
  (a compressed G1 point; ``verify_signature`` is the scalar pairing
  check), ``PrivKey`` and ``gen_priv_key`` (a ``FilePV``'s key),
  ``BatchVerifier`` over ``get_bn254_backend()`` with its own
  verified-triple cache, and ``aggregate_signatures`` /
  ``aggregate_signatures_compressed``, the G2 sum an aggregate commit
  carries (``types/block.aggregate_commit``).

Unlike the reference, the device tier is not opt-in and no construction
error is caught: ``device`` None means ``cuda`` and raises without a card;
``device="cpu"`` puts the plain Miller program in its place, for the tests.
"""

from __future__ import annotations

import os
import threading

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bn254_pure as _b
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices

KEY_TYPE = "bn254"
PUB_KEY_SIZE = 32
SIGNATURE_SIZE = _b.SIGNATURE_SIZE
PRIV_KEY_SIZE = 64  # fr scalar (32) || compressed pubkey (32)
PRIV_KEY_NAME = "tendermint/PrivKeyBn254"
PUB_KEY_NAME = "tendermint/PubKeyBn254"


def verify_aggregate(pub_keys, msgs, agg_sig: bytes) -> bool:
    """One aggregate check over compressed G1 keys and the signers'
    messages; False on any malformed encoding."""
    if len(pub_keys) != len(msgs) or not pub_keys:
        return False
    try:
        s = _b.g2_unmarshal(bytes(agg_sig))
    except (ValueError, TypeError):
        return False
    pairs = []
    for pb, m in zip(pub_keys, msgs):
        try:
            pk = _b.g1_decompress(bytes(pb))
        except (ValueError, TypeError):
            return False
        if pk is None:
            return False
        pairs.append(((pk[0], (_b.P - pk[1]) % _b.P), _b._hash_to_g2_cached(m)))
    pairs.append((_b.G1, s))
    return _b.pairing_check_fast(pairs)


def batch_verify_signatures(pubs, msgs, sigs) -> tuple[bool, list]:
    """(all ok, per-signature bitmap) over raw byte columns. Malformed
    entries are False lanes and never poison the rest."""
    n = len(pubs)
    bits = [False] * n
    parsed: dict[int, tuple] = {}
    for i in range(n):
        try:
            pk = _b.g1_decompress(bytes(pubs[i]))
            s = _b.g2_unmarshal(bytes(sigs[i]))
        except (ValueError, TypeError):
            continue
        if pk is None or s is None:
            continue
        parsed[i] = ((pk[0], (_b.P - pk[1]) % _b.P), _b._hash_to_g2_cached(bytes(msgs[i])), s)
    ws = _b._batch_weights([bytes(p) for p in pubs], [bytes(m) for m in msgs],
                           [bytes(s) for s in sigs])

    def check(idxs) -> bool:
        pairs = []
        agg = None
        for i in idxs:
            neg_pk, hm, s = parsed[i]
            pairs.append((_b._g1_mul(ws[i], neg_pk), hm))
            agg = _b._g2_add(agg, _b._g2_mul(ws[i], s))
        pairs.append((_b.G1, agg))
        return _b.pairing_check_fast(pairs)

    stack = [sorted(parsed)] if parsed else []
    while stack:
        idxs = stack.pop()
        if not idxs:
            continue
        if check(idxs):
            for i in idxs:
                bits[i] = True
        elif len(idxs) > 1:
            mid = len(idxs) // 2
            stack.append(idxs[:mid])
            stack.append(idxs[mid:])
    return (n > 0 and all(bits)), bits


def _scalar_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """One pairing check a signature: the anchor's per-signature form."""
    if len(sig) != _b.SIGNATURE_SIZE:
        return False
    try:
        pk = _b.g1_decompress(pub)
        s = _b.g2_unmarshal(sig)
    except (ValueError, TypeError):
        return False
    if pk is None or s is None:
        return False
    neg_pk = (pk[0], (_b.P - pk[1]) % _b.P)
    return _b.pairing_check_fast([(neg_pk, _b._hash_to_g2_cached(msg)), (_b.G1, s)])


class Bn254HostBackend:
    """The host multi-pairing engine: randomized weights, one shared final
    exponentiation."""

    name = "bn254-host"

    def batch_verify(self, pubs, msgs, sigs):
        return batch_verify_signatures(pubs, msgs, sigs)

    def aggregate_verify(self, pubs, msgs, agg_sig) -> bool:
        return verify_aggregate(pubs, msgs, agg_sig)

    def merkle_root(self, leaves):
        return hash_from_byte_slices(list(leaves))

    def ping(self) -> bool:
        return True


class Bn254ScalarBackend:
    """The chain's anchor: independent pairing checks, one a signature, with
    no state shared with the batched engines, so it is valid cross-check
    ground truth for them."""

    name = "bn254-cpu"

    def batch_verify(self, pubs, msgs, sigs):
        bits = [_scalar_verify(bytes(p), bytes(m), bytes(s)) for p, m, s in zip(pubs, msgs, sigs)]
        return (len(bits) > 0 and all(bits)), bits

    def aggregate_verify(self, pubs, msgs, agg_sig) -> bool:
        # An aggregate has no per-signature form: the exact host check.
        return verify_aggregate(pubs, msgs, agg_sig)

    def merkle_root(self, leaves):
        return hash_from_byte_slices(list(leaves))

    def ping(self) -> bool:
        return True


def build_bn254_chain(device=None):
    """``bn254-device`` -> ``bn254-host`` -> ``cpu`` (the scalar anchor),
    with ``CMTPU_FAULTS`` wrapping the two non-anchor tiers as
    ``sidecar/supervisor.build_chain`` does. ``device`` None is ``cuda``
    (raises without a card); ``"cpu"`` runs the plain Miller program."""
    from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
    from cometbft_tpu_torch.sidecar.chaos import wrap_tiers_from_env

    tiers = wrap_tiers_from_env(
        [("bn254-device", Bn254DeviceBackend(device)), ("bn254-host", Bn254HostBackend())])
    tiers.append(("cpu", Bn254ScalarBackend()))
    return tiers


_backend = None
_backend_lock = threading.Lock()


def get_bn254_backend():
    """The process's BN254 backend: under ``CMTPU_BACKEND=auto`` (the
    default) the supervised chain, behind the coalescer unless
    ``CMTPU_COALESCE=0``; any other choice the bare host engine."""
    global _backend
    if _backend is not None:
        return _backend
    with _backend_lock:
        if _backend is None:
            choice = os.environ.get("CMTPU_BACKEND", "auto").strip() or "auto"
            if choice == "auto":
                from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler
                from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend

                chain = ResilientBackend(build_bn254_chain())
                coalesce = os.environ.get("CMTPU_COALESCE", "1") != "0"
                _backend = CoalescingScheduler(chain) if coalesce else chain
            else:
                _backend = Bn254HostBackend()
    return _backend


def set_bn254_backend(b) -> None:
    """Install ``b`` as the process's backend (None resolves again on the
    next use), closing the one it replaces."""
    global _backend
    with _backend_lock:
        old, _backend = _backend, b
    close = getattr(old, "close", None)
    if close is not None and old is not b:
        close()


# -- the key type --------------------------------------------------------------


class PubKey(crypto.PubKey):
    """A BN254 public key: a compressed G1 point (crypto/bn254/bn254.go)."""

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise ValueError(f"bn254 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return tmhash.sum_truncated(self._bytes)

    def bytes(self) -> bytes:
        return self._bytes

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """The pairing check e(-pk, H(m)) * e(G1, sig) == 1; False on any
        malformed encoding."""
        return _scalar_verify(self._bytes, bytes(msg), bytes(sig))

    def type(self) -> str:
        return KEY_TYPE


class PrivKey:
    """A BN254 secret scalar with its compressed public key; ``sign`` is
    [sk]H(m) on G2, uncompressed (bn254.go:46-53)."""

    def __init__(self, data: bytes):
        if len(data) not in (32, PRIV_KEY_SIZE):
            raise ValueError("bn254 privkey must be 32 or 64 bytes")
        self._scalar_bytes = bytes(data[:32])
        self._scalar = int.from_bytes(self._scalar_bytes, "big") % _b.R
        if self._scalar == 0:
            raise ValueError("invalid bn254 scalar")
        self._pub = PubKey(_b.public_key(self._scalar))

    def bytes(self) -> bytes:
        return self._scalar_bytes + self._pub.bytes()

    def sign(self, msg: bytes) -> bytes:
        return _b.sign(self._scalar, bytes(msg))

    def pub_key(self) -> PubKey:
        return self._pub

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    while True:
        raw = os.urandom(32)
        if int.from_bytes(raw, "big") % _b.R != 0:
            return PrivKey(raw)


def _g2_sum(sigs):
    """The G2 sum of BLS signatures. Every input is checked (on the twist,
    in the r-torsion): a malformed one raises ValueError."""
    total = None
    for s in sigs:
        total = _b._g2_add(total, _b.g2_unmarshal(bytes(s)))
    return total


def aggregate_signatures(sigs) -> bytes:
    """The G2 sum of BLS signatures, uncompressed (128 bytes)."""
    return _b.g2_marshal(_g2_sum(sigs))


def aggregate_signatures_compressed(sigs) -> bytes:
    """The same G2 sum in the 64-byte compressed form a block's commit
    carries."""
    return _b.g2_compress(_g2_sum(sigs))


# The verified-triple cache of this key type (the ed25519 cache's contract:
# valid results only, the oldest quarter evicted on overflow).
_VERIFIED_MAX = int(os.environ.get("CMTPU_VERIFY_CACHE_MAX", "") or 131072)
_verified: dict[tuple, None] = {}
_verified_lock = threading.Lock()


def _verified_put(key: tuple) -> None:
    with _verified_lock:
        if key in _verified:
            del _verified[key]
        elif len(_verified) >= _VERIFIED_MAX:
            for k in list(_verified)[: max(1, _VERIFIED_MAX // 4)]:
                _verified.pop(k, None)
        _verified[key] = None


class BatchVerifier(crypto.BatchVerifier):
    """``crypto.BatchVerifier`` over BN254 triples: the verified-triple
    filter, duplicates within the batch sent once, ``get_bn254_backend()``,
    and one scalar pairing check a signature when every tier of the chain
    has failed (``ChainExhausted``)."""

    def __init__(self):
        self._pubs: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []

    def add(self, key, msg: bytes, sig: bytes) -> None:
        if not isinstance(key, PubKey):
            raise TypeError("bn254.BatchVerifier requires bn254 public keys")
        if len(sig) != SIGNATURE_SIZE:
            raise ValueError(f"bn254 signature must be {SIGNATURE_SIZE} bytes")
        self._pubs.append(key.bytes())
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))

    def verify(self) -> tuple[bool, list]:
        from cometbft_tpu_torch.sidecar.supervisor import ChainExhausted

        n = len(self._pubs)
        if n == 0:
            return False, []
        keys = list(zip(self._pubs, self._sigs, self._msgs))
        first_at: dict[tuple, int] = {}
        sub_idx: list[int] = []
        for i, key in enumerate(keys):
            if key not in _verified and key not in first_at:
                first_at[key] = i
                sub_idx.append(i)
        sub_bits: list = []
        if sub_idx:
            sub = [keys[i] for i in sub_idx]
            pubs, sigs, msgs = ([k[j] for k in sub] for j in range(3))
            try:
                _, sub_bits = get_bn254_backend().batch_verify(pubs, msgs, sigs)
                if len(sub_bits) != len(sub_idx):
                    raise ValueError("backend returned wrong-shaped bitmap")
            except ChainExhausted:
                sub_bits = [_scalar_verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
        bit_of = {keys[i]: bool(b) for i, b in zip(sub_idx, sub_bits)}
        for key, ok in bit_of.items():
            if ok:
                _verified_put(key)
        out = [bit_of.get(key, True) for key in keys]
        return all(out), out


# The proof of possession a bn254 validator carries in genesis: its signature
# over POP_DST || its key, which plain BLS aggregation needs against the
# rogue-key attack (types/genesis.py checks it).
POP_DST = b"CMTPU-BN254-POP-V1|"


def pop_sign_bytes(pub_key_bytes: bytes) -> bytes:
    return POP_DST + bytes(pub_key_bytes)


def prove_possession(priv: "PrivKey") -> bytes:
    """64-byte compressed G2 proof that the holder knows the secret scalar
    behind their published pubkey — required in genesis for bn254 keys."""
    sig = priv.sign(pop_sign_bytes(priv.pub_key().bytes()))
    return _b.g2_compress(_b.g2_unmarshal(sig))


def verify_possession(pub_key_bytes: bytes, pop: bytes) -> bool:
    """One pairing check; accepts either G2 wire form. Never raises:
    malformed input is an invalid proof."""
    if len(pop) not in (_b.SIGNATURE_SIZE, _b.SIGNATURE_SIZE_COMPRESSED):
        return False
    try:
        pk = _b.g1_decompress(bytes(pub_key_bytes))
        s = _b.g2_unmarshal(bytes(pop))
        if pk is None or s is None:
            return False
        hm = _b._hash_to_g2_cached(pop_sign_bytes(pub_key_bytes))
        neg_pk = (pk[0], (_b.P - pk[1]) % _b.P)
        return _b.pairing_check_fast([(neg_pk, hm), (_b.G1, s)])
    except (ValueError, TypeError):
        return False
