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
  ``get_bn254_backend``, the process singleton over it.

Unlike the reference, the device tier is not opt-in and no construction
error is caught: ``device`` None means ``cuda`` and raises without a card;
``device="cpu"`` puts the plain Miller program in its place, for the tests.
"""

from __future__ import annotations

import os
import threading

from cometbft_tpu_torch.crypto import bn254_pure as _b
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices


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
