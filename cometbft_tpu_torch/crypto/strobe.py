"""Keccak-f[1600] + the STROBE-128/1600 subset merlin needs, the port's copy
of ``cometbft_tpu/crypto/strobe.py``.

The reference's handshake transcript and sr25519 signing contexts both sit
on merlin (p2p/conn/secret_connection.go:18,111; crypto/sr25519 via
curve25519-voi), and merlin sits on a tiny STROBE-128 core: meta-AD / AD /
PRF / KEY over keccak-f[1600] with rate 166.  This is that core, written
from the STROBE v1.0.2 spec.  Correctness anchors (tests/test_merlin.py):
the permutation is validated by building SHA3-256/SHAKE on top of it
against hashlib, and the full transcript layer against merlin's published
"equivalence" test vector; tests/test_torch_p2p.py holds this copy to the
reference's transcripts byte for byte.

Pure Python: handshakes run once per connection, and sr25519 verification
transcripts absorb a handful of blocks; keccak here costs ~100us per
permutation which is fine off the batch path.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed [x][y]: generated by the spec's lane walk
# ((x,y) <- (y, 2x+3y), offset_t = (t+1)(t+2)/2 mod 64) and validated
# wholesale by the SHA3 cross-check in tests/test_merlin.py.
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place keccak-f[1600] over a 200-byte state, lane (x,y) at
    little-endian bytes 8*(x + 5*y)."""
    lanes = [
        [int.from_bytes(state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8], "little")
         for y in range(5)]
        for x in range(5)
    ]
    for rc in _RC:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                lanes[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                lanes[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _MASK)
        # iota
        lanes[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y) : 8 * (x + 5 * y) + 8] = lanes[x][y].to_bytes(8, "little")


_R = 166  # STROBE-128/1600 rate less the two framing bytes

_FLAG_I = 0x01
_FLAG_A = 0x02
_FLAG_C = 0x04
_FLAG_T = 0x08
_FLAG_M = 0x10
_FLAG_K = 0x20


class Strobe128:
    """The merlin subset of STROBE-128/1600: meta_ad, ad, prf, key."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c

    # -- duplex core --------------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"continuation flags {flags:#x} != begun {self.cur_flags:#x}"
                )
            return
        if flags & _FLAG_T:
            raise ValueError("transport ops unsupported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        # C/K ops must start on a fresh block
        if flags & (_FLAG_C | _FLAG_K) and self.pos != 0:
            self._run_f()

    # -- merlin's four operations -------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)
