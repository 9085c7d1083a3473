"""Thread-safe bit array for vote/part presence tracking
(libs/bits/bit_array.go, gossiped between peers), the port's copy of
``cometbft_tpu/libs/bit_array.py``."""

from __future__ import annotations

import random
import threading

from cometbft_tpu_torch.wire import proto as wire


class BitArray:
    def __init__(self, bits: int = 0):
        self._bits = bits
        self._elems = [0] * ((bits + 63) // 64)
        self._mtx = threading.Lock()

    # -- core ---------------------------------------------------------------

    @property
    def size(self) -> int:
        return self._bits

    def get_index(self, i: int) -> bool:
        with self._mtx:
            return self._get(i)

    def _get(self, i: int) -> bool:
        if i >= self._bits or i < 0:
            return False
        return bool(self._elems[i // 64] >> (i % 64) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        with self._mtx:
            if i >= self._bits or i < 0:
                return False
            if v:
                self._elems[i // 64] |= 1 << (i % 64)
            else:
                self._elems[i // 64] &= ~(1 << (i % 64))
            return True

    def copy(self) -> "BitArray":
        with self._mtx:
            c = BitArray(self._bits)
            c._elems = list(self._elems)
            return c

    def or_with(self, other: "BitArray") -> "BitArray":
        """Union sized to the larger operand (bit_array.go Or)."""
        if other is None:
            return self.copy()
        c = BitArray(max(self._bits, other._bits))
        with self._mtx:
            a = list(self._elems)
        with other._mtx:
            b = list(other._elems)
        for i in range(len(c._elems)):
            v = 0
            if i < len(a):
                v |= a[i]
            if i < len(b):
                v |= b[i]
            c._elems[i] = v
        return c

    def and_with(self, other: "BitArray") -> "BitArray":
        """Intersection sized to the smaller operand (bit_array.go And)."""
        if other is None:
            return BitArray(0)
        c = BitArray(min(self._bits, other._bits))
        with self._mtx:
            a = list(self._elems)
        with other._mtx:
            b = list(other._elems)
        for i in range(len(c._elems)):
            c._elems[i] = a[i] & b[i]
        c._trim()
        return c

    def not_(self) -> "BitArray":
        c = BitArray(self._bits)
        with self._mtx:
            for i in range(len(self._elems)):
                c._elems[i] = ~self._elems[i] & ((1 << 64) - 1)
        c._trim()
        return c

    def sub(self, other: "BitArray") -> "BitArray":
        """self AND NOT other, sized to self (bit_array.go Sub)."""
        if other is None:
            return self.copy()
        c = self.copy()
        with other._mtx:
            b = list(other._elems)
        for i in range(min(len(c._elems), len(b))):
            c._elems[i] &= ~b[i] & ((1 << 64) - 1)
        c._trim()
        return c

    def _trim(self) -> None:
        """Mask bits beyond size in the last word."""
        if self._bits % 64 != 0 and self._elems:
            self._elems[-1] &= (1 << (self._bits % 64)) - 1

    def is_empty(self) -> bool:
        with self._mtx:
            return all(e == 0 for e in self._elems)

    def is_full(self) -> bool:
        with self._mtx:
            if self._bits == 0:
                return True
            for i in range(len(self._elems) - 1):
                if self._elems[i] != (1 << 64) - 1:
                    return False
            last_bits = self._bits % 64 or 64
            return self._elems[-1] == (1 << last_bits) - 1

    def pick_random(self) -> tuple[int, bool]:
        """A uniformly random true bit (bit_array.go PickRandom)."""
        with self._mtx:
            true_indices = [
                i for i in range(self._bits) if self._get(i)
            ]
        if not true_indices:
            return 0, False
        return random.choice(true_indices), True

    def num_true_bits(self) -> int:
        with self._mtx:
            return sum(bin(e).count("1") for e in self._elems)

    def update(self, other: "BitArray") -> None:
        """Copy other's contents into self (sizes must match semantics of Go:
        copies min overlap)."""
        if other is None:
            return
        with other._mtx:
            b = list(other._elems)
        with self._mtx:
            for i in range(min(len(self._elems), len(b))):
                self._elems[i] = b[i]
            self._trim()

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitArray):
            return NotImplemented
        return self._bits == other._bits and self._elems == other._elems

    def __repr__(self) -> str:
        with self._mtx:
            s = "".join("x" if self._get(i) else "_" for i in range(self._bits))
        return f"BA{{{self._bits}:{s}}}"

    # -- wire (libs/bits proto) ---------------------------------------------

    def encode(self) -> bytes:
        out = wire.field_varint(1, self._bits)
        # repeated uint64 packed
        if any(self._elems):
            packed = b"".join(
                wire.encode_uvarint(e) for e in self._elems
            )
            out += wire.tag(2, wire.WT_LEN) + wire.encode_uvarint(len(packed)) + packed
        return out

    # Decode bound: largest legitimate wire bit array is a part-set presence
    # map (max block parts) or a vote map (max validators) — cap well above
    # both so a malicious varint can't force a giant allocation.
    MAX_DECODE_BITS = 1 << 24

    @classmethod
    def decode(cls, data: bytes) -> "BitArray":
        f = wire.decode_fields(data)
        bits = wire.get_varint(f, 1)
        if bits < 0 or bits > cls.MAX_DECODE_BITS:
            raise ValueError(f"bit array size {bits} out of bounds")
        ba = cls(bits)
        raw = wire.get_bytes(f, 2)
        elems = []
        pos = 0
        while pos < len(raw):
            v, pos = wire.decode_uvarint(raw, pos)
            elems.append(v)
        for i in range(min(len(elems), len(ba._elems))):
            ba._elems[i] = elems[i]
        ba._trim()
        return ba
