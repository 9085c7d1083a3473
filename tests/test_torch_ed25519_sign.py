"""The port's pure Ed25519 signing (``crypto/ed25519_pure``) against the
JAX package's keys: the fixed-base table product ``base_mult`` equals the
double-and-add ``scalar_mult(k, BASE)`` at edge and seeded scalars, and
keys, signatures and single ZIP-215 verdicts equal the reference's."""

import random

import pytest

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.crypto import ed25519_pure as ref_pure
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.crypto import ed25519_pure as pure

pytestmark = pytest.mark.torch_port

EDGE = [0, 1, 2, 15, 16, 17, 255, 256, pure.L - 1, pure.L, pure.L + 1,
        2**252, 2**254 + 8, 2**255 - 1, 2**256 - 1]


@pytest.mark.parametrize("seed", [None, 19])
def test_base_mult_equals_double_and_add(seed):
    rng = random.Random(seed)
    scalars = EDGE if seed is None else [rng.getrandbits(256) for _ in range(48)]
    for k in scalars:
        got, want = pure.base_mult(k), pure.scalar_mult(k, pure.BASE)
        assert pure.point_equal(got, want), k
        assert pure.point_compress(got) == pure.point_compress(want), k


def test_keys_and_signatures_equal_the_reference():
    rng = random.Random(7)
    for i in range(32):
        secret = b"sign-%d" % i
        key, ref_key = ed25519.gen_priv_key_from_secret(secret), ref_ed.gen_priv_key_from_secret(secret)
        assert key.bytes() == ref_key.bytes()
        for n in (0, 1, 64, rng.randrange(2, 600)):
            msg = rng.randbytes(n)
            sig = key.sign(msg)
            assert sig == ref_key.sign(msg)
            assert pure.verify_zip215(key.pub_key().bytes(), msg, sig)
            bad = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
            assert (pure.verify_zip215(key.pub_key().bytes(), msg, bad)
                    == ref_pure.verify_zip215(ref_key.pub_key().bytes(), msg, bad) is False)
