"""Authenticated encrypted transport (p2p/conn/secret_connection.go), the
port's copy of ``cometbft_tpu/p2p/conn/secret_connection.py``: the same
handshake and frames, so that a port node and a reference node talk.

Station-to-Station handshake: exchange ephemeral X25519 keys (length-
delimited BytesValue, secret_connection.go:299-320), Diffie-Hellman, derive
recv/send keys + a 32-byte challenge via HKDF-SHA256 with the
"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN" info label
(:51,:335-360 — key order decided by sorted ephemeral pubkeys), sign the
challenge with the node's ed25519 key and exchange AuthSig messages over the
now-encrypted channel (:411-425).

Framing (:35-38,:185-260): ChaCha20-Poly1305 over 1028-byte frames
(4-byte LE length + 1024 data max), 12-byte nonces with a little-endian
64-bit counter in the low bytes, separate counters per direction.

The authentication challenge is the merlin transcript hash exactly as the
reference computes it (secret_connection.go:111-135): a
"TENDERMINT_SECRET_CONNECTION_TRANSCRIPT_HASH" transcript absorbing the
sorted ephemeral pubkeys and the DH secret, challenge extracted under the
"SECRET_CONNECTION_MAC" label — byte-for-byte the Go handshake.

The port counts what the reference only does: ``handshake_ms`` (the
handshake's wall time), ``frames_sent`` / ``frames_recv`` (sealed frames),
and ``close_errors`` with ``last_close_error`` (a close that raised; the
reference passes over it).
"""

from __future__ import annotations

import hashlib
import hmac
import socket
import struct
import time

from cometbft_tpu_torch.crypto.compat import (
    ChaCha20Poly1305,
    X25519PrivateKey,
    X25519PublicKey,
)
from cometbft_tpu_torch.crypto.encoding import pub_key_from_proto, pub_key_to_proto
from cometbft_tpu_torch.crypto.merlin import Transcript
from cometbft_tpu_torch.wire import proto as wire

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE
AEAD_SIZE_OVERHEAD = 16
KEY_AND_CHALLENGE_GEN = b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"


class SecretConnectionError(Exception):
    pass


def _hkdf_sha256(secret: bytes, info: bytes, length: int) -> bytes:
    """RFC 5869 with empty salt (golang.org/x/crypto/hkdf defaults)."""
    prk = hmac.new(b"\x00" * 32, secret, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def derive_secrets_and_challenge(
    dh_secret: bytes, loc_is_least: bool
) -> tuple[bytes, bytes, bytes]:
    """deriveSecretsAndChallenge (secret_connection.go:335-360): 96 bytes of
    HKDF output — two 32-byte AEAD keys ordered by which side sorts lower,
    plus the legacy 32-byte challenge in the tail.  Returns
    (recv_secret, send_secret, challenge).

    The handshake authenticates with the merlin transcript challenge (see
    _handshake), not this HKDF tail, but the key halves here are exactly
    what the live handshake uses — and the whole triple is pinned by the
    reference's TestDeriveSecretsAndChallengeGolden vectors."""
    okm = _hkdf_sha256(dh_secret, KEY_AND_CHALLENGE_GEN, 96)
    challenge = okm[64:96]
    if loc_is_least:
        recv_secret, send_secret = okm[:32], okm[32:64]
    else:
        send_secret, recv_secret = okm[:32], okm[32:64]
    return recv_secret, send_secret, challenge


class SecretConnection:
    """p2p/conn/secret_connection.go:92 MakeSecretConnection."""

    def __init__(self, conn, loc_priv_key):
        self._conn = conn
        self.loc_priv_key = loc_priv_key
        self.loc_pub_key = loc_priv_key.pub_key()
        self.rem_pub_key = None
        self._recv_buffer = b""
        self._send_nonce = 0
        self._recv_nonce = 0
        self.frames_sent = 0
        self.frames_recv = 0
        self.close_errors = 0
        self.last_close_error = None
        t0 = time.perf_counter()
        self._handshake()
        self.handshake_ms = (time.perf_counter() - t0) * 1e3

    # -- handshake ------------------------------------------------------------

    def _handshake(self) -> None:
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes_raw()
        # Exchange ephemeral pubkeys: length-delimited BytesValue{value=1}.
        self._write_raw(wire.length_delimited(wire.field_bytes(1, eph_pub)))
        rem_eph_pub = self._read_delimited_bytes_value()
        if len(rem_eph_pub) != 32:
            raise SecretConnectionError("invalid ephemeral pubkey size")
        # Sorted ephemeral keys pick the HKDF key order.
        lo, hi = sorted([eph_pub, rem_eph_pub])
        loc_is_least = eph_pub == lo
        transcript = Transcript(b"TENDERMINT_SECRET_CONNECTION_TRANSCRIPT_HASH")
        transcript.append_message(b"EPHEMERAL_LOWER_PUBLIC_KEY", lo)
        transcript.append_message(b"EPHEMERAL_UPPER_PUBLIC_KEY", hi)
        dh_secret = eph_priv.exchange(X25519PublicKey.from_public_bytes(rem_eph_pub))
        transcript.append_message(b"DH_SECRET", dh_secret)
        recv_secret, send_secret, _ = derive_secrets_and_challenge(
            dh_secret, loc_is_least
        )
        challenge = transcript.extract_bytes(b"SECRET_CONNECTION_MAC", 32)
        self._send_aead = ChaCha20Poly1305(send_secret)
        self._recv_aead = ChaCha20Poly1305(recv_secret)
        # Authenticate: sign the challenge, swap AuthSig over the sealed channel.
        sig = self.loc_priv_key.sign(challenge)
        auth_msg = wire.field_message(
            1, pub_key_to_proto(self.loc_pub_key), emit_empty=True
        ) + wire.field_bytes(2, sig)
        self.write(wire.length_delimited(auth_msg))
        their_auth = self._read_auth_sig()
        rem_pub, rem_sig = their_auth
        if not rem_pub.verify_signature(challenge, rem_sig):
            raise SecretConnectionError("challenge verification failed")
        self.rem_pub_key = rem_pub

    def _read_auth_sig(self):
        buf = self.read(DATA_MAX_SIZE)
        ln, pos = wire.decode_uvarint(buf, 0)
        while len(buf) - pos < ln:
            buf += self.read(DATA_MAX_SIZE)
        f = wire.decode_fields(buf[pos : pos + ln])
        return pub_key_from_proto(wire.get_bytes(f, 1)), wire.get_bytes(f, 2)

    def _read_delimited_bytes_value(self) -> bytes:
        hdr = self._read_raw(1)
        while hdr[-1] & 0x80:
            hdr += self._read_raw(1)
        ln, _ = wire.decode_uvarint(hdr, 0)
        body = self._read_raw(ln)
        f = wire.decode_fields(body)
        return wire.get_bytes(f, 1)

    # -- sealed IO ------------------------------------------------------------

    def write(self, data: bytes) -> int:
        """Chunk into sealed frames (secret_connection.go:185-225)."""
        n = 0
        while data:
            chunk, data = data[:DATA_MAX_SIZE], data[DATA_MAX_SIZE:]
            frame = struct.pack("<I", len(chunk)) + chunk
            frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
            nonce = b"\x00\x00\x00\x00" + struct.pack("<Q", self._send_nonce)
            self._send_nonce += 1
            self.frames_sent += 1
            sealed = self._send_aead.encrypt(nonce, frame, None)
            self._write_raw(sealed)
            n += len(chunk)
        return n

    def read(self, max_bytes: int = DATA_MAX_SIZE) -> bytes:
        """One frame's worth (buffered; secret_connection.go:229-260)."""
        if self._recv_buffer:
            out, self._recv_buffer = (
                self._recv_buffer[:max_bytes],
                self._recv_buffer[max_bytes:],
            )
            return out
        sealed = self._read_raw(TOTAL_FRAME_SIZE + AEAD_SIZE_OVERHEAD)
        nonce = b"\x00\x00\x00\x00" + struct.pack("<Q", self._recv_nonce)
        self._recv_nonce += 1
        self.frames_recv += 1
        try:
            frame = self._recv_aead.decrypt(nonce, sealed, None)
        except Exception as e:
            raise SecretConnectionError(f"failed to decrypt frame: {e}") from e
        (length,) = struct.unpack("<I", frame[:DATA_LEN_SIZE])
        if length > DATA_MAX_SIZE:
            raise SecretConnectionError("chunk length exceeds maximum")
        data = frame[DATA_LEN_SIZE : DATA_LEN_SIZE + length]
        out, self._recv_buffer = data[:max_bytes], data[max_bytes:]
        return out

    def read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.read(n - len(out))
            if not chunk:
                raise SecretConnectionError("connection closed")
            out += chunk
        return out

    # -- raw socket -----------------------------------------------------------

    def _write_raw(self, data: bytes) -> None:
        self._conn.sendall(data)

    def _read_raw(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._conn.recv(n - len(out))
            if not chunk:
                raise SecretConnectionError("connection closed")
            out += chunk
        return out

    def close(self) -> None:
        # shutdown() before close(): close() alone does NOT wake a thread
        # blocked in recv() on another thread's stack (the fd stays open in
        # the kernel until the recv returns) — the recv loop would leak.
        try:
            self._conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._conn.close()
        except Exception as e:
            self.close_errors += 1
            self.last_close_error = e
