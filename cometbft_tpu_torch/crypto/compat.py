"""Optional-dependency shim for the `cryptography` package, the port's copy
of ``cometbft_tpu/crypto/compat.py`` (the same three AEAD tiers, the same
names, the same `CMTPU_PURE_AEAD` knob).

The C-backed `cryptography` wheel is the preferred provider for Ed25519
signing, X25519 ECDH, and ChaCha20-Poly1305 (library-speed hot paths), but
it is not part of the baked toolchain on every host this repo runs on.
Everything it provides here has an exact pure-Python equivalent — ed25519
via crypto/ed25519_pure (already the ZIP-215 arbiter), X25519 via RFC 7748
on the same curve field, ChaCha20-Poly1305 via RFC 8439 — so this module
exports one set of names and picks the provider at import time:

    from cometbft_tpu_torch.crypto.compat import (
        HAVE_CRYPTOGRAPHY, InvalidSignature, InvalidTag,
        Ed25519PrivateKey, Ed25519PublicKey,
        X25519PrivateKey, X25519PublicKey, ChaCha20Poly1305,
    )

The pure tier is slower (≈2 ms/sign, ≈4 ms/verify, ≈1 ms per 1 KiB AEAD
frame) but correct and wire-identical; consensus at e2e block intervals
(200 ms+) is unaffected.  Nothing outside this module may import
`cryptography` directly.

For the AEAD specifically there is a middle tier: when the wheel is absent
but the interpreter's own OpenSSL (`libcrypto`, already loaded for the ssl
module) exposes `EVP_chacha20_poly1305`, a ctypes binding provides
library-speed seal/open.  The pure tier's ≈1 ms/KiB is fatal on the p2p
secret-connection hot path — every 1 KiB wire frame is sealed+opened once
per hop, so a multi-node host caps out at a few dozen KiB/s per connection
and block parts outlive the propose timeout.  The binding is cross-checked
against the pure RFC 8439 implementation at import; any mismatch (or a
libcrypto without the cipher) falls back to pure.  `AEAD_PROVIDER` names
the active tier ("cryptography" | "libcrypto" | "pure");
`CMTPU_PURE_AEAD=1` forces the pure tier for A/B and tests.
"""

from __future__ import annotations

import hmac as _hmac
import os
import struct

try:  # pragma: no cover - exercised implicitly on hosts that have the wheel
    from cryptography.exceptions import InvalidSignature, InvalidTag
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    HAVE_CRYPTOGRAPHY = True
except ImportError:
    HAVE_CRYPTOGRAPHY = False

    class InvalidSignature(Exception):
        pass

    class InvalidTag(Exception):
        pass

    # -- Ed25519 (backed by crypto/ed25519_pure) ---------------------------

    class Ed25519PublicKey:
        def __init__(self, raw: bytes):
            from cometbft_tpu_torch.crypto import ed25519_pure

            if len(raw) != 32:
                raise ValueError("ed25519 public key must be 32 bytes")
            # Reject encodings that don't decompress at all (parity with
            # from_public_bytes raising on malformed keys).
            if ed25519_pure.point_decompress_zip215(bytes(raw)) is None:
                raise ValueError("invalid ed25519 public key")
            self._raw = bytes(raw)

        @classmethod
        def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
            return cls(raw)

        def public_bytes_raw(self) -> bytes:
            return self._raw

        def verify(self, signature: bytes, data: bytes) -> None:
            from cometbft_tpu_torch.crypto import ed25519_pure

            # ZIP-215 is a superset of the strict RFC 8032 acceptance set;
            # callers that need the exact strict subset (none do today — the
            # consensus arbiter IS ZIP-215) would need a dedicated check.
            if not ed25519_pure.verify_zip215(
                self._raw, bytes(data), bytes(signature)
            ):
                raise InvalidSignature("signature verification failed")

    class Ed25519PrivateKey:
        def __init__(self, seed: bytes):
            from cometbft_tpu_torch.crypto import ed25519_pure

            if len(seed) != 32:
                raise ValueError("ed25519 seed must be 32 bytes")
            self._seed = bytes(seed)
            self._pub = ed25519_pure.public_key(self._seed)

        @classmethod
        def from_private_bytes(cls, seed: bytes) -> "Ed25519PrivateKey":
            return cls(seed)

        @classmethod
        def generate(cls) -> "Ed25519PrivateKey":
            return cls(os.urandom(32))

        def private_bytes_raw(self) -> bytes:
            return self._seed

        def public_key(self) -> Ed25519PublicKey:
            return Ed25519PublicKey(self._pub)

        def sign(self, data: bytes) -> bytes:
            from cometbft_tpu_torch.crypto import ed25519_pure

            return ed25519_pure.sign(self._seed, self._pub, bytes(data))

    # -- X25519 (RFC 7748) -------------------------------------------------

    _P = 2**255 - 19
    _A24 = 121665

    def _x25519_scalarmult(k: bytes, u: bytes) -> bytes:
        """RFC 7748 §5 ladder: clamped scalar k times u-coordinate u."""
        scalar = bytearray(k)
        scalar[0] &= 248
        scalar[31] &= 127
        scalar[31] |= 64
        kn = int.from_bytes(bytes(scalar), "little")
        x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
        x2, z2, x3, z3 = 1, 0, x1, 1
        swap = 0
        for t in reversed(range(255)):
            kt = (kn >> t) & 1
            swap ^= kt
            if swap:
                x2, x3 = x3, x2
                z2, z3 = z3, z2
            swap = kt
            a = (x2 + z2) % _P
            aa = (a * a) % _P
            b = (x2 - z2) % _P
            bb = (b * b) % _P
            e = (aa - bb) % _P
            c = (x3 + z3) % _P
            d = (x3 - z3) % _P
            da = (d * a) % _P
            cb = (c * b) % _P
            x3 = (da + cb) % _P
            x3 = (x3 * x3) % _P
            z3 = (da - cb) % _P
            z3 = (x1 * z3 * z3) % _P
            x2 = (aa * bb) % _P
            z2 = (e * (aa + _A24 * e)) % _P
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        out = (x2 * pow(z2, _P - 2, _P)) % _P
        return out.to_bytes(32, "little")

    class X25519PublicKey:
        def __init__(self, raw: bytes):
            if len(raw) != 32:
                raise ValueError("x25519 public key must be 32 bytes")
            self._raw = bytes(raw)

        @classmethod
        def from_public_bytes(cls, raw: bytes) -> "X25519PublicKey":
            return cls(raw)

        def public_bytes_raw(self) -> bytes:
            return self._raw

    class X25519PrivateKey:
        _BASE = (9).to_bytes(32, "little")

        def __init__(self, raw: bytes):
            if len(raw) != 32:
                raise ValueError("x25519 private key must be 32 bytes")
            self._raw = bytes(raw)

        @classmethod
        def generate(cls) -> "X25519PrivateKey":
            return cls(os.urandom(32))

        @classmethod
        def from_private_bytes(cls, raw: bytes) -> "X25519PrivateKey":
            return cls(raw)

        def public_key(self) -> X25519PublicKey:
            return X25519PublicKey(_x25519_scalarmult(self._raw, self._BASE))

        def exchange(self, peer: X25519PublicKey) -> bytes:
            out = _x25519_scalarmult(self._raw, peer.public_bytes_raw())
            if out == b"\x00" * 32:
                raise ValueError("x25519 shared secret is all zeros")
            return out

    # -- ChaCha20-Poly1305 (RFC 8439) --------------------------------------

    def _rotl32(v: int, c: int) -> int:
        return ((v << c) | (v >> (32 - c))) & 0xFFFFFFFF

    def _chacha20_block(key_words, counter: int, nonce_words) -> bytes:
        init = [
            0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
            *key_words, counter & 0xFFFFFFFF, *nonce_words,
        ]
        x = list(init)
        for _ in range(10):
            for a, b, c, d in (
                (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
            ):
                x[a] = (x[a] + x[b]) & 0xFFFFFFFF
                x[d] = _rotl32(x[d] ^ x[a], 16)
                x[c] = (x[c] + x[d]) & 0xFFFFFFFF
                x[b] = _rotl32(x[b] ^ x[c], 12)
                x[a] = (x[a] + x[b]) & 0xFFFFFFFF
                x[d] = _rotl32(x[d] ^ x[a], 8)
                x[c] = (x[c] + x[d]) & 0xFFFFFFFF
                x[b] = _rotl32(x[b] ^ x[c], 7)
        return struct.pack(
            "<16I", *((xi + ii) & 0xFFFFFFFF for xi, ii in zip(x, init))
        )

    def _chacha20_xor(key: bytes, counter: int, nonce: bytes, data: bytes) -> bytes:
        key_words = struct.unpack("<8I", key)
        nonce_words = struct.unpack("<3I", nonce)
        out = bytearray()
        for i in range(0, len(data), 64):
            block = _chacha20_block(key_words, counter + i // 64, nonce_words)
            chunk = data[i : i + 64]
            out += bytes(a ^ b for a, b in zip(chunk, block))
        return bytes(out)

    _P1305 = (1 << 130) - 5

    def _poly1305(key32: bytes, msg: bytes) -> bytes:
        r = int.from_bytes(key32[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
        s = int.from_bytes(key32[16:], "little")
        acc = 0
        for i in range(0, len(msg), 16):
            block = msg[i : i + 16]
            n = int.from_bytes(block + b"\x01", "little")
            acc = ((acc + n) * r) % _P1305
        return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")

    def _pad16(b: bytes) -> bytes:
        return b"\x00" * (-len(b) % 16)

    class _PureChaCha20Poly1305:
        def __init__(self, key: bytes):
            if len(key) != 32:
                raise ValueError("chacha20poly1305 key must be 32 bytes")
            self._key = bytes(key)

        def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
            otk = _chacha20_block(
                struct.unpack("<8I", self._key), 0, struct.unpack("<3I", nonce)
            )[:32]
            mac_data = (
                aad + _pad16(aad) + ct + _pad16(ct)
                + struct.pack("<QQ", len(aad), len(ct))
            )
            return _poly1305(otk, mac_data)

        def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
            if len(nonce) != 12:
                raise ValueError("nonce must be 12 bytes")
            aad = aad or b""
            ct = _chacha20_xor(self._key, 1, nonce, bytes(data))
            return ct + self._tag(nonce, ct, aad)

        def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
            if len(nonce) != 12:
                raise ValueError("nonce must be 12 bytes")
            if len(data) < 16:
                raise InvalidTag("ciphertext too short")
            aad = aad or b""
            ct, tag = bytes(data[:-16]), bytes(data[-16:])
            if not _hmac.compare_digest(self._tag(nonce, ct, aad), tag):
                raise InvalidTag("poly1305 tag mismatch")
            return _chacha20_xor(self._key, 1, nonce, ct)

    # -- ChaCha20-Poly1305 via the interpreter's own libcrypto -------------

    def _load_libcrypto_aead():
        """Bind EVP_chacha20_poly1305 from the system libcrypto via ctypes.

        Returns an AEAD class API-compatible with the `cryptography` wheel's
        ChaCha20Poly1305, or None when the library / cipher is unavailable
        or the binding fails its cross-check against the pure tier.
        """
        import ctypes
        import ctypes.util

        lib = None
        names = [ctypes.util.find_library("crypto"), "libcrypto.so.3",
                 "libcrypto.so.1.1", "libcrypto.so"]
        for cand in names:
            if not cand:
                continue
            try:
                cdll = ctypes.CDLL(cand)
            except OSError:
                continue
            if getattr(cdll, "EVP_chacha20_poly1305", None) is not None:
                lib = cdll
                break
        if lib is None:
            return None

        c_int = ctypes.c_int
        c_void_p = ctypes.c_void_p
        c_char_p = ctypes.c_char_p
        lib.EVP_chacha20_poly1305.restype = c_void_p
        lib.EVP_chacha20_poly1305.argtypes = []
        lib.EVP_CIPHER_CTX_new.restype = c_void_p
        lib.EVP_CIPHER_CTX_new.argtypes = []
        lib.EVP_CIPHER_CTX_free.restype = None
        lib.EVP_CIPHER_CTX_free.argtypes = [c_void_p]
        lib.EVP_CipherInit_ex.restype = c_int
        lib.EVP_CipherInit_ex.argtypes = [
            c_void_p, c_void_p, c_void_p, c_char_p, c_char_p, c_int,
        ]
        lib.EVP_CipherUpdate.restype = c_int
        lib.EVP_CipherUpdate.argtypes = [
            c_void_p, c_void_p, ctypes.POINTER(c_int), c_char_p, c_int,
        ]
        lib.EVP_CipherFinal_ex.restype = c_int
        lib.EVP_CipherFinal_ex.argtypes = [
            c_void_p, c_void_p, ctypes.POINTER(c_int),
        ]
        lib.EVP_CIPHER_CTX_ctrl.restype = c_int
        lib.EVP_CIPHER_CTX_ctrl.argtypes = [c_void_p, c_int, c_int, c_void_p]

        _SET_IVLEN, _GET_TAG, _SET_TAG = 0x09, 0x10, 0x11
        cipher = lib.EVP_chacha20_poly1305()
        if not cipher:
            return None

        class _LibcryptoChaCha20Poly1305:
            """RFC 8439 AEAD over the already-loaded system libcrypto."""

            def __init__(self, key: bytes):
                if len(key) != 32:
                    raise ValueError("chacha20poly1305 key must be 32 bytes")
                self._key = bytes(key)

            def _run(self, enc: int, nonce: bytes, data: bytes,
                     aad: bytes, tag: bytes | None) -> bytes:
                # Fresh context per call keeps concurrent send/recv AEADs
                # (and any other threads) isolated without locking.
                ctx = lib.EVP_CIPHER_CTX_new()
                if not ctx:
                    raise MemoryError("EVP_CIPHER_CTX_new failed")
                try:
                    outl = c_int(0)
                    out = ctypes.create_string_buffer(len(data) or 1)
                    ok = (
                        lib.EVP_CipherInit_ex(ctx, cipher, None, None, None, enc)
                        and lib.EVP_CIPHER_CTX_ctrl(ctx, _SET_IVLEN, 12, None)
                        and lib.EVP_CipherInit_ex(
                            ctx, None, None, self._key, bytes(nonce), enc
                        )
                    )
                    if ok and aad:
                        ok = lib.EVP_CipherUpdate(
                            ctx, None, ctypes.byref(outl), aad, len(aad)
                        )
                    if ok:
                        ok = lib.EVP_CipherUpdate(
                            ctx, out, ctypes.byref(outl),
                            bytes(data), len(data),
                        )
                    n = outl.value
                    if ok and not enc:
                        ok = lib.EVP_CIPHER_CTX_ctrl(
                            ctx, _SET_TAG, 16,
                            ctypes.create_string_buffer(tag, 16),
                        )
                    if ok:
                        fin = lib.EVP_CipherFinal_ex(
                            ctx, ctypes.byref(out, n), ctypes.byref(outl)
                        )
                        if not fin:
                            if not enc:
                                raise InvalidTag("poly1305 tag mismatch")
                            ok = 0
                        else:
                            n += outl.value
                    if not ok:
                        raise ValueError("libcrypto chacha20poly1305 failed")
                    if enc:
                        tagbuf = ctypes.create_string_buffer(16)
                        if not lib.EVP_CIPHER_CTX_ctrl(
                            ctx, _GET_TAG, 16, tagbuf
                        ):
                            raise ValueError("EVP_CTRL_AEAD_GET_TAG failed")
                        return out.raw[:n] + tagbuf.raw
                    return out.raw[:n]
                finally:
                    lib.EVP_CIPHER_CTX_free(ctx)

            def encrypt(self, nonce: bytes, data: bytes,
                        aad: bytes | None) -> bytes:
                if len(nonce) != 12:
                    raise ValueError("nonce must be 12 bytes")
                return self._run(1, nonce, bytes(data), aad or b"", None)

            def decrypt(self, nonce: bytes, data: bytes,
                        aad: bytes | None) -> bytes:
                if len(nonce) != 12:
                    raise ValueError("nonce must be 12 bytes")
                if len(data) < 16:
                    raise InvalidTag("ciphertext too short")
                data = bytes(data)
                return self._run(
                    0, nonce, data[:-16], aad or b"", data[-16:]
                )

        # Cross-check against the pure RFC 8439 tier before trusting the
        # binding: wire bytes must be identical and tampering must raise.
        try:
            key = bytes(range(32))
            nonce = bytes(range(12))
            for msg, aad in (
                (b"", b""),
                (b"tpu-bft frame", b"hdr"),
                (bytes(1024) + b"tail", b""),
            ):
                fast = _LibcryptoChaCha20Poly1305(key)
                pure = _PureChaCha20Poly1305(key)
                sealed = fast.encrypt(nonce, msg, aad)
                if sealed != pure.encrypt(nonce, msg, aad):
                    return None
                if fast.decrypt(nonce, sealed, aad) != msg:
                    return None
                try:
                    fast.decrypt(
                        nonce, sealed[:-1] + bytes([sealed[-1] ^ 1]), aad
                    )
                    return None
                except InvalidTag:
                    pass
        except Exception:
            return None
        return _LibcryptoChaCha20Poly1305

    _libcrypto_aead = (
        None
        if os.environ.get("CMTPU_PURE_AEAD")
        else _load_libcrypto_aead()
    )
    if _libcrypto_aead is not None:
        ChaCha20Poly1305 = _libcrypto_aead
        AEAD_PROVIDER = "libcrypto"
    else:
        ChaCha20Poly1305 = _PureChaCha20Poly1305
        AEAD_PROVIDER = "pure"

if HAVE_CRYPTOGRAPHY:
    AEAD_PROVIDER = "cryptography"


__all__ = [
    "AEAD_PROVIDER",
    "HAVE_CRYPTOGRAPHY",
    "InvalidSignature",
    "InvalidTag",
    "Ed25519PrivateKey",
    "Ed25519PublicKey",
    "X25519PrivateKey",
    "X25519PublicKey",
    "ChaCha20Poly1305",
]
