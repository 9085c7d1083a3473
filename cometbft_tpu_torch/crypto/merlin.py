"""Merlin transcripts, the port's copy of ``cometbft_tpu/crypto/merlin.py``
(the construction under curve25519-voi's primitives/merlin, used by
CometBFT for the SecretConnection handshake
transcript — p2p/conn/secret_connection.go:111-135 — and by schnorrkel for
sr25519 signing contexts).

A Transcript is STROBE-128 under protocol label "Merlin v1.0" with:
  append_message(label, msg):   meta-AD(label || LE32(len)) ; AD(msg)
  challenge_bytes(label, n):    meta-AD(label || LE32(n))   ; PRF(n)
Transcript construction appends the application label as
append_message(b"dom-sep", label).
"""

from __future__ import annotations

import struct

from cometbft_tpu_torch.crypto.strobe import Strobe128

_MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


class Transcript:
    __slots__ = ("_strobe",)

    def __init__(self, label: bytes, _strobe: Strobe128 | None = None):
        if _strobe is not None:
            self._strobe = _strobe
            return
        self._strobe = Strobe128(_MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        return Transcript(b"", _strobe=self._strobe.clone())

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", len(message)), True)
        self._strobe.ad(bytes(message), False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, struct.pack("<Q", value))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", n), True)
        return self._strobe.prf(n)

    # curve25519-voi naming (used by the secret-connection port)
    def extract_bytes(self, label: bytes, n: int) -> bytes:
        return self.challenge_bytes(label, n)

    # -- witness generation (schnorrkel signing nonces) ---------------------

    def build_rng(self) -> "TranscriptRng":
        return TranscriptRng(self._strobe.clone())


class TranscriptRng:
    """merlin's TranscriptRngBuilder finalized with system randomness:
    rekey(witness...) then KEY(64 bytes of entropy), challenges via PRF.
    Deterministic iff the caller passes fixed entropy (tests)."""

    __slots__ = ("_strobe",)

    def __init__(self, strobe: Strobe128):
        self._strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRng":
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", len(witness)), True)
        self._strobe.key(witness, False)
        return self

    def finalize(self, entropy32: bytes) -> "TranscriptRng":
        if len(entropy32) != 32:
            raise ValueError("need exactly 32 bytes of entropy")
        self._strobe.meta_ad(b"rng", False)
        self._strobe.key(entropy32, False)
        return self

    def fill_bytes(self, n: int) -> bytes:
        self._strobe.meta_ad(struct.pack("<I", n), False)
        return self._strobe.prf(n)
