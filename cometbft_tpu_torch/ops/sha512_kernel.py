"""Batched SHA-512 of the Ed25519 challenge R || A || M and the challenge
scalars: host packers, the plain PyTorch hash, and the ``sha512`` kernel's
wrappers.

Counterpart of ``cometbft_tpu/ops/sha512_kernel.py``. The host packers
(``blocks_for``, ``write_padding``, ``pack_messages512``) are held
byte-identical to the reference. The device entry is
``challenge_digits``: it takes the host pack buffer itself (``[N, B*128]``
bytes viewed as little-endian uint32 words, the form
``ed25519_kernel.pack_batch`` ships), per-lane block counts and the s
words, and returns the signed radix-16 digits of s and of k = digest mod L
that the ladder reads. So it covers what the reference's ``verify_core``
does around its ``hash_blocks_core`` (the transpose and byte swap of the
buffer into big-endian block words, ``digest_to_le_words``) and the scalar
half of its unpack stage (``unpack.digest_words_to_digits``,
``unpack.scalar_words_to_digits``). Lanes stop after their own block count;
a lane with 0 blocks (padding) hashes to the IV. ``scalar_digits`` does the
same from digests the host hashed (the host-hash program).

CPU tensors take the plain versions (``challenge_digits_plain``,
``scalar_digits_plain``): ``hash_blocks_plain``, which keeps 64-bit words in
int64 (two's-complement wrap is addition mod 2^64; logical right shifts are
masked arithmetic shifts), then ``unpack``'s reduction and recodes. CUDA
tensors launch the kernel (``csrc/sha512.cu``), one launch a call.
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import unpack
from cometbft_tpu_torch.ops.sha256_kernel import to_i32, to_u32

# -- constants (FIPS 180-4) --------------------------------------------------

_K = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _s64(v: int) -> int:
    """uint64 value -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_K_S = [_s64(k) for k in _K]
_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) & ((1 << (64 - n)) - 1)


def compress(state: list, w: list) -> list:
    """One SHA-512 compression over int64 rows: state and w are lists of 8
    and 16 int64[N] tensors (big-endian 64-bit words)."""
    w = list(w)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        if t < 16:
            wt = w[t]
        else:
            x15, x2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _rotr(x15, 1) ^ _rotr(x15, 8) ^ _shr(x15, 7)
            s1 = _rotr(x2, 19) ^ _rotr(x2, 61) ^ _shr(x2, 6)
            wt = w[t % 16] + s0 + w[(t - 7) % 16] + s1
            w[t % 16] = wt
        big_s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + big_s1 + ch + _K_S[t] + wt
        big_s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + big_s0 + maj
    return [s + v for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of uint32 values held in int64."""
    return (
        ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF)
    )


def hash_blocks_plain(msg_words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """The hash half of ``challenge_digits_plain``: int32[N, B*32] pack-buffer
    words + int32[N] block counts -> int32[16, N] little-endian digest words."""
    n, wpl = msg_words.shape
    bmax = wpl // 32
    x = to_u32(msg_words)
    x = _bswap32(x.reshape(n, bmax, 16, 2).permute(1, 2, 3, 0))  # [B, 16, 2, N]
    blocks = (x[:, :, 0] << 32) | x[:, :, 1]  # [B, 16, N] big-endian words
    dev = msg_words.device
    st = [torch.full((n,), _s64(v), dtype=torch.int64, device=dev) for v in _IV]
    for i in range(bmax):
        new = compress(st, [blocks[i, t] for t in range(16)])
        active = i < nblocks
        st = [torch.where(active, nv, sv) for nv, sv in zip(new, st)]
    return digest_to_le_words(st)


def digest_to_le_words(state: list) -> torch.Tensor:
    """Eight int64[N] state words -> int32[16, N] little-endian uint32
    words of the 64-byte digest stream (word 2t is the byte-swapped high
    half of state word t, word 2t+1 the low half)."""
    out = []
    for s in state:
        out.append(_bswap32((s >> 32) & _M32))
        out.append(_bswap32(s & _M32))
    return to_i32(torch.stack(out))


def challenge_digits_plain(msg_words, nblocks, s_words):
    """Plain version of ``challenge_digits``."""
    return scalar_digits_plain(hash_blocks_plain(msg_words, nblocks), s_words)


def scalar_digits_plain(k_words, s_words):
    """Plain version of ``scalar_digits``."""
    return unpack.scalar_words_to_digits(s_words), unpack.digest_words_to_digits(k_words)


def challenge_digits(msg_words: torch.Tensor, nblocks: torch.Tensor, s_words: torch.Tensor):
    """The challenge scalars of N signatures: int32[N, B*32] pack-buffer
    words (little-endian uint32 bit patterns) + int32[N] block counts +
    int32[8, N] words of s -> (s digits, k digits), int32[64, N] each, in
    [-8, 7], with k = SHA-512(R || A || M) mod L. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if msg_words.device.type == "cpu":
        return challenge_digits_plain(msg_words, nblocks, s_words)
    words = msg_words.contiguous()
    nb = nblocks.to(torch.int32).contiguous()
    sw = s_words.contiguous()
    _build.require_cuda("sha512", words, nb, sw)
    n, wpl = words.shape
    if wpl % 32 or words.data_ptr() % 16:
        raise ValueError("sha512: rows must be whole 128-byte blocks, 16-byte aligned")
    if nb.shape != (n,) or sw.shape != (8, n):
        raise ValueError(f"sha512: bad shapes {words.shape} {nb.shape} {sw.shape}")
    s_dig, k_dig = _digit_outputs(n, words.device)
    if n:
        rc = _build.lib().cmtpu_challenge_digits(
            words.data_ptr(), nb.data_ptr(), wpl, sw.data_ptr(), s_dig.data_ptr(),
            k_dig.data_ptr(), n, _build.stream_of(words),
        )
        _build.check_launch("sha512", rc)
    return s_dig, k_dig


def scalar_digits(k_words: torch.Tensor, s_words: torch.Tensor):
    """``challenge_digits`` from digests hashed on the host: int32[16, N]
    little-endian words of the 64-byte digests + int32[8, N] words of s ->
    (s digits, k digits), int32[64, N] each."""
    if k_words.device.type == "cpu":
        return scalar_digits_plain(k_words, s_words)
    kw, sw = k_words.contiguous(), s_words.contiguous()
    _build.require_cuda("sha512", kw, sw)
    n = kw.shape[1]
    if kw.shape != (16, n) or sw.shape != (8, n):
        raise ValueError(f"sha512: bad shapes {kw.shape} {sw.shape}")
    s_dig, k_dig = _digit_outputs(n, kw.device)
    if n:
        rc = _build.lib().cmtpu_scalar_digits(
            kw.data_ptr(), sw.data_ptr(), s_dig.data_ptr(), k_dig.data_ptr(), n,
            _build.stream_of(kw),
        )
        _build.check_launch("sha512", rc)
    return s_dig, k_dig


def _digit_outputs(n: int, device):
    return tuple(torch.empty((64, n), dtype=torch.int32, device=device) for _ in range(2))


# -- host packers (held byte-identical to the reference) ---------------------


def blocks_for(lens: np.ndarray) -> np.ndarray:
    """Message byte lengths -> SHA-512 block counts (0x80 + 16-byte len)."""
    return ((lens + 17 + 127) // 128).astype(np.int32)


def write_padding(buf: np.ndarray, lens: np.ndarray, nblocks: np.ndarray) -> None:
    """Write the FIPS 180-4 pad into buf uint8[n, B*128] rows holding
    messages of the given byte lengths: the 0x80 terminator plus the
    128-bit big-endian bit length at each row's last-block end (messages
    here are < 2^53 bits, so the low 64 bits suffice)."""
    n = buf.shape[0]
    idx = np.arange(n)
    buf[idx, lens] = 0x80
    ends = nblocks.astype(np.int64) * 128
    bl_bytes = (lens * 8).astype(">u8").view(np.uint8).reshape(n, 8)
    for k in range(8):
        buf[idx, ends - 8 + k] = bl_bytes[:, k]


def pack_buffer512(msgs: list[bytes]):
    """Pad messages into the pack buffer: (uint8[n, B*128], int32[n])."""
    n = len(msgs)
    lens = np.fromiter((len(m) for m in msgs), np.int64, n)
    nblocks = blocks_for(lens)
    bmax = int(nblocks.max()) if n else 1
    buf = np.zeros((n, bmax * 128), np.uint8)
    for i, m in enumerate(msgs):
        buf[i, : lens[i]] = np.frombuffer(m, np.uint8)
    write_padding(buf, lens, nblocks)
    return buf, nblocks


def pack_messages512(msgs: list[bytes]):
    """Pad + pack messages into SHA-512 blocks as the reference lays them
    out: (uint32[B, 2, 16, N] big-endian hi/lo words, int32[N])."""
    buf, nblocks = pack_buffer512(msgs)
    n, bmax = buf.shape[0], buf.shape[1] // 128
    words = buf.view(">u4").reshape(n, bmax, 32).astype(np.uint32)
    hi = words[:, :, 0::2]
    lo = words[:, :, 1::2]
    out = np.stack([hi, lo], axis=1).transpose(2, 1, 3, 0)
    return np.ascontiguousarray(out), nblocks


def digest_words_to_bytes(le_words) -> list[bytes]:
    """int32[16, N] little-endian digest words -> N 64-byte digests (host)."""
    w = np.ascontiguousarray(np.asarray(le_words).T).astype("<u4")  # [N, 16]
    return [bytes(r) for r in w.view(np.uint8).reshape(-1, 64)]
