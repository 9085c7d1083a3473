"""Checkpoint bundles: static, cacheable light-client cold sync, the port's
copy of ``cometbft_tpu/light/bundle.py``.

A bundle is a deterministic, self-contained byte artifact: the anchor light
block (header + commit + validator set), the MMR peaks at the anchor, and
inclusion paths for a geometric ladder of heights below it (anchor,
anchor/2, anchor/4, ..., 1), built at checkpoint intervals by
``light/origin.py``. "Practical Light Clients for Committee-Based
Blockchains" (arXiv:2410.03347) is the grounding: cold sync becomes a
replicable artifact rather than a conversation.

Trust model: a bundle binds history, it never grants trust. The client
re-derives acceptance itself: its OWN trust anchor must prove into the
bundle's root at a ladder height with its OWN stored hash, every rung must
prove into that root, and the anchor light block must pass the standard
trusting-overlap check (``verifier.verify``: overlap against the client's
trusted set, then the anchor's own +2/3 commit, whose signatures go to the
backend in one call). A forged, stale or truncated bundle can only fail
one of those checks and cost a fallback.

Content addressing: a bundle's name IS the hex of its SHA-256, so any dumb
cache, file sync or peer can replicate it.

Wire format (proto-shaped, canonical field order, the idiom of
types/light_block), byte-identical to the JAX package's:

    Bundle:    1 chain_id (string)   2 anchor (LightBlock message)
               3 mmr_size (uvarint)  4 peaks (repeated 32-byte)
               5 ladder (repeated LadderHop message)
    LadderHop: 1 height (uvarint)    2 header_hash (32-byte)
               3 aunts (repeated 32-byte)
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from dataclasses import field as dfield

from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.light.mmr import bag_peaks, verify_inclusion
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.wire import proto as wire


class BundleError(Exception):
    """Bundle malformed / unverifiable / unavailable; clients treat any
    of these as 'fall back to the interactive paths'."""


def ladder_heights(anchor_height: int) -> list[int]:
    """The geometric ladder frozen into a bundle at `anchor_height`:
    descending halvings down to height 1 (anchor included).  O(log n)
    hops keep the witness cost bounded as history grows, and height 1 —
    the canonical social-checkpoint anchor — is always a rung."""
    if anchor_height < 1:
        raise BundleError(f"bad anchor height {anchor_height}")
    out, h = [], anchor_height
    while h >= 1:
        out.append(h)
        if h == 1:
            break
        h //= 2
    return out


@dataclass
class LadderHop:
    """One rung: header hash at `height` plus its inclusion path under
    the bundle root (leaf index = height - 1)."""

    height: int
    header_hash: bytes
    aunts: list[bytes]

    def encode(self) -> bytes:
        return (
            wire.field_varint(1, self.height, emit_default=True)
            + wire.field_bytes(2, self.header_hash)
            + b"".join(wire.field_bytes(3, a, emit_default=True)
                       for a in self.aunts)
        )

    @classmethod
    def decode(cls, data: bytes) -> "LadderHop":
        f = wire.decode_fields(data)
        return cls(
            height=wire.get_uvarint(f, 1),
            header_hash=wire.get_bytes(f, 2),
            aunts=wire.get_repeated_bytes(f, 3),
        )


@dataclass
class Bundle:
    """The checkpoint artifact; see module docstring for the format and
    trust model."""

    chain_id: str
    anchor: LightBlock
    mmr_size: int
    peaks: list[bytes]
    ladder: list[LadderHop]
    # Encode memo (immutable-after-construction, same contract as
    # LightBlock._enc): the origin re-serves one artifact thousands of
    # times and its name is a hash of these exact bytes.
    _enc: bytes | None = dfield(default=None, compare=False, repr=False)

    def encode(self) -> bytes:
        if self._enc is None:
            self._enc = (
                wire.field_string(1, self.chain_id)
                + wire.field_message(2, self.anchor.encode(), emit_empty=True)
                + wire.field_varint(3, self.mmr_size, emit_default=True)
                + b"".join(wire.field_bytes(4, p, emit_default=True)
                           for p in self.peaks)
                + b"".join(wire.field_message(5, hop.encode())
                           for hop in self.ladder)
            )
        return self._enc

    @classmethod
    def decode(cls, data: bytes) -> "Bundle":
        try:
            f = wire.decode_fields(data)
            b = cls(
                chain_id=wire.get_string(f, 1),
                anchor=LightBlock.decode(wire.get_bytes(f, 2)),
                mmr_size=wire.get_uvarint(f, 3),
                peaks=wire.get_repeated_bytes(f, 4),
                ladder=[LadderHop.decode(h)
                        for h in wire.get_repeated_bytes(f, 5)],
            )
        except Exception as e:
            raise BundleError(f"bundle undecodable: {e}") from e
        # No encode-memo from the wire input: a peer's non-canonical field
        # order must not survive as this bundle's canonical bytes (the
        # content address below would then lie about what was hashed).
        return b

    def bundle_hash(self) -> bytes:
        return hashlib.sha256(self.encode()).digest()

    @property
    def name(self) -> str:
        """Content address: the artifact's immutable, cache-safe name."""
        return self.bundle_hash().hex()

    def root(self) -> bytes:
        """The claimed history root, recomputed from the shipped peaks —
        never taken from a separate wire field."""
        return bag_peaks(list(self.peaks))

    # -- verification ------------------------------------------------------

    def self_check(self, chain_id: str | None = None) -> None:
        """Structural + internal-consistency checks that need no client
        state: anchor validity (including its own +2/3 commit via
        validate_basic's commit wiring at verify time), ladder shape, and
        every hop proving into the root the peaks bag to.  Raises
        BundleError.  Trust is NOT established here — see verify()."""
        if chain_id is not None and self.chain_id != chain_id:
            raise BundleError(
                f"bundle chain {self.chain_id!r}, want {chain_id!r}"
            )
        try:
            self.anchor.validate_basic(self.chain_id)
        except Exception as e:
            raise BundleError(f"bundle anchor invalid: {e}") from e
        if self.mmr_size != self.anchor.height:
            raise BundleError(
                f"bundle size {self.mmr_size} != anchor height "
                f"{self.anchor.height}"
            )
        if len(self.peaks) != bin(self.mmr_size).count("1") or any(
            len(p) != 32 for p in self.peaks
        ):
            raise BundleError("bundle peaks do not decompose the size")
        want = ladder_heights(self.anchor.height)
        got = [hop.height for hop in self.ladder]
        if got != want:
            raise BundleError(
                f"bundle ladder heights {got} != geometric ladder {want}"
            )
        if self.ladder[0].header_hash != self.anchor.hash():
            raise BundleError("bundle ladder top is not the anchor header")
        root = self.root()
        for hop in self.ladder:
            try:
                verify_inclusion(root, self.mmr_size, hop.height - 1,
                                 list(hop.aunts), hop.header_hash)
            except Exception as e:
                raise BundleError(
                    f"ladder hop {hop.height} fails inclusion: {e}"
                ) from e

    def ladder_hash(self, height: int) -> bytes | None:
        for hop in self.ladder:
            if hop.height == height:
                return hop.header_hash
        return None

    def verify(self, chain_id: str, trusted: LightBlock, now,
               trusting_period_ns: int, max_clock_drift_ns: int,
               trust_level) -> LightBlock:
        """Full client-side acceptance; returns the (now-trustable) anchor
        light block or raises (BundleError / verifier errors) — callers
        treat ANY raise as 'refuse the bundle, fall back'.

        Order matters: structural self-check first (cheap, no signatures),
        then the client's own anchor must appear on the ladder with the
        client's OWN stored hash (history binding), then expiry, then the
        standard trusting-overlap + commit verification — the exact check
        interactive sync runs, so decisions stay bit-identical."""
        self.self_check(chain_id)
        if self.anchor.height <= trusted.height:
            raise BundleError(
                f"bundle anchor {self.anchor.height} not above trusted "
                f"height {trusted.height}"
            )
        bound = self.ladder_hash(trusted.height)
        if bound is None:
            raise BundleError(
                f"trusted height {trusted.height} is not a ladder rung"
            )
        if bound != trusted.hash():
            raise BundleError(
                "bundle history does not contain our trust anchor"
            )
        if verifier.header_expired(trusted.signed_header,
                                   trusting_period_ns, now):
            raise verifier.ErrOldHeaderExpired(
                trusted.signed_header.header.time.add_nanos(
                    trusting_period_ns
                ),
                now,
            )
        verifier.verify(
            trusted.signed_header,
            trusted.validator_set,
            self.anchor.signed_header,
            self.anchor.validator_set,
            trusting_period_ns,
            now,
            max_clock_drift_ns,
            trust_level,
        )
        return self.anchor


def check_name(name: str, data: bytes) -> None:
    """Content-address check: `data` must hash to `name`.  Every consumer
    of a cached/replicated bundle runs this BEFORE decoding — a flipped
    bit anywhere in transit renames the artifact."""
    got = hashlib.sha256(data).hexdigest()
    if got != name:
        raise BundleError(
            f"bundle content address mismatch: named {name[:16]}…, "
            f"hashes to {got[:16]}…"
        )


# -- sources (where a client gets bundle bytes) -----------------------------


class DirBundleSource:
    """Flat-directory source: the layout `bundle export` writes and any
    dumb HTTP cache or file sync can replicate — `<name>.bundle` blobs
    plus an `index.json` mapping checkpoint heights to names."""

    def __init__(self, path: str):
        self.path = path

    def _index(self) -> dict:
        import json
        import os

        try:
            with open(os.path.join(self.path, "index.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise BundleError(f"bundle index unreadable: {e}") from e

    def bundle(self, height: int = 0) -> bytes | None:
        """Bytes of the best checkpoint at or below `height` (0 = latest),
        content-address-checked.  None when the directory has nothing
        usable (the client falls back)."""
        import os

        idx = self._index()
        by_height = {int(h): n for h, n in idx.get("bundles", {}).items()}
        if not by_height:
            return None
        eligible = [h for h in by_height if height == 0 or h <= height]
        if not eligible:
            return None
        name = by_height[max(eligible)]
        try:
            with open(os.path.join(self.path, f"{name}.bundle"), "rb") as f:
                data = f.read()
        except OSError as e:
            raise BundleError(f"bundle blob unreadable: {e}") from e
        check_name(name, data)
        return data


class RemoteBundleSource:
    """Source over a node's `light_bundle` RPC route."""

    def __init__(self, rpc_client):
        self.client = rpc_client

    def bundle(self, height: int = 0) -> bytes | None:
        import base64

        res = self.client.call("light_bundle", height=str(height))
        if not res.get("enabled", False) or not res.get("bundle"):
            return None
        data = base64.b64decode(res["bundle"])
        check_name(res["name"], data)
        return data


class MemoryBundleSource:
    """In-memory source — peer-to-peer re-serving: a synced client holds
    the raw bytes it verified and hands them onward unchanged (the next
    client re-derives everything, so relaying costs no trust)."""

    def __init__(self, data: bytes | None = None):
        self._data = data

    def put(self, data: bytes) -> None:
        self._data = data

    def bundle(self, height: int = 0) -> bytes | None:
        if self._data is None:
            return None
        if height:
            b = Bundle.decode(self._data)
            if b.anchor.height > height:
                return None
        return self._data
