"""The levels entry's leaf loads (``leaf_hash_words`` in csrc/sha256.cu) as
a numpy model, on the CPU: the big-endian message words of 0x00 || leaf
assembled from aligned 32-bit little-endian words of the flat buffer, a
funnel shift and a byte swap each, with only the aligned words that hold a
leaf byte read, the bytes outside the leaf masked off, the 0x80 pad and
the bit length put in. At every listed length and at each of the four
byte offsets of the leaf in its aligned word, the model's words equal the
padded message's (``sha256_kernel.pack_messages``) and hash (a numpy
SHA-256 compression) to hashlib's digest of 0x00 || leaf."""

import hashlib

import numpy as np
import pytest
from cometbft_tpu_torch.ops import sha256_kernel as sha

pytestmark = pytest.mark.torch_port

LENGTHS = (0, 1, 2, 3, 54, 55, 56, 63, 64, 65, 4095, 65_536)


def leaf_words_model(flat: np.ndarray, start: int, length: int) -> np.ndarray:
    """uint32[nb, 16]: the kernel's message blocks of 0x00 || flat[start:
    start + length], from the aligned words of flat (its length a multiple
    of 4) that hold a byte of the leaf."""
    mlen = length + 1
    nb = (mlen + 8) // 64 + 1
    aligned = flat.view("<u4").astype(np.uint64)
    al, sh = start >> 2, start & 3
    r8 = 8 * ((sh + 3) & 3)
    d = int(sh == 0)
    jlast = (sh + length - 1) >> 2 if length > 0 else -1
    out = np.zeros((nb, 16), np.uint64)
    for b in range(nb):
        j = 16 * b - d + np.arange(17)
        ok = (j >= 0) & (j <= jlast)
        w = np.where(ok, aligned[al + np.clip(j, 0, max(jlast, 0))], 0)
        le = ((w[:16] | (w[1:] << 32)) >> r8) & 0xFFFFFFFF  # __funnelshift_r
        be = le.astype("<u4").byteswap().astype(np.uint64)
        if b == 0 or 64 * b + 64 > length:
            q0 = 64 * b + 4 * np.arange(16)
            keep = length + 1 - q0
            shift = (8 * (4 - np.clip(keep, 1, 4))).astype(np.uint64)
            mask = np.where(keep >= 4, 0xFFFFFFFF, np.where(keep <= 0, 0, (0xFFFFFFFF << shift) & 0xFFFFFFFF))
            mask = np.where(q0 == 0, mask & 0x00FFFFFF, mask).astype(np.uint64)
            be &= mask
            pad = (keep >= 0) & (keep < 4)
            be |= np.where(pad, np.uint64(0x80) << (8 * (3 - np.clip(keep, 0, 3))).astype(np.uint64), 0)
            if b == nb - 1:
                be[14] |= (mlen * 8) >> 32
                be[15] |= (mlen * 8) & 0xFFFFFFFF
        out[b] = be
    return out.astype(np.uint32)


_ROUND = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], np.uint32)


def _rotr(x, n):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _digests(blocks: np.ndarray) -> list[bytes]:
    """SHA-256 (FIPS 180-4, in numpy) of each lane of uint32[nb, 16, lanes]
    message blocks."""
    st = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C,
                   0x1F83D9AB, 0x5BE0CD19], np.uint32)[:, None].repeat(blocks.shape[2], 1)
    with np.errstate(over="ignore"):
        for blk in blocks.astype(np.uint32):
            w = list(blk)
            for t in range(16, 64):
                s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> np.uint32(3))
                s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> np.uint32(10))
                w.append(w[t - 16] + s0 + w[t - 7] + s1)
            a, b, c, d, e, f, g, h = st
            for t in range(64):
                t1 = h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) + _ROUND[t] + w[t]
                t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
                a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
            st = st + np.stack([a, b, c, d, e, f, g, h])
    return [st[:, i].astype(">u4").tobytes() for i in range(st.shape[1])]


@pytest.mark.parametrize("length", LENGTHS)
def test_word_assembly_equals_hashlib(length):
    rng = np.random.default_rng(length)
    leaf = rng.bytes(length)
    want_blocks, want_nb = sha.pack_messages([b"\x00" + leaf])
    lanes = []
    for sh in range(4):
        # the leaf at byte offset sh of its aligned word, other bytes around it
        buf = np.frombuffer(rng.bytes(sh) + leaf + rng.bytes(8 - (sh + length) % 4), np.uint8)
        words = leaf_words_model(buf.copy(), sh, length)
        assert words.shape[0] == int(want_nb[0])
        assert np.array_equal(words, want_blocks[: words.shape[0], :, 0].astype(np.uint32))
        lanes.append(words)
    want = hashlib.sha256(b"\x00" + leaf).digest()
    assert _digests(np.stack(lanes, axis=2)) == [want] * 4
