"""The Merkle proof operators in the port (``crypto/merkle/proof_op``,
``proof_value``, ``proof_key_path``) against the JAX package: the same key
paths, the same ``ValueOp`` proof op bytes, the same verdicts and error
texts through each package's ``ProofRuntime``, and the provable kvstore's
proven ``Query`` equal in both packages and verified by either runtime. No
tolerance."""

import hashlib

import numpy as np
import pytest

from cometbft_tpu.abci import types as ref_abci
from cometbft_tpu.abci.example.kvstore import KVStoreApplication as RefKV
from cometbft_tpu.abci.wire import _dec_proof_ops as ref_dec_proof_ops
from cometbft_tpu.abci.wire import _enc_proof_ops as ref_enc_proof_ops
from cometbft_tpu.crypto.merkle import Proof as RefProof
from cometbft_tpu.crypto.merkle import proof_key_path as ref_kp
from cometbft_tpu.crypto.merkle import proof_op as ref_op
from cometbft_tpu.crypto.merkle import proof_value as ref_pv
from cometbft_tpu.crypto.merkle import proofs_from_byte_slices as ref_proofs
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.merkle import proof_key_path as kp
from cometbft_tpu_torch.crypto.merkle import proof_op as op
from cometbft_tpu_torch.crypto.merkle import proof_value as pv
from cometbft_tpu_torch.wire.types import decode_proof_ops, encode_proof_ops

pytestmark = pytest.mark.torch_port

SEED = 16


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return (type(e).__name__, str(e))


def _kv_pairs(n: int, rng) -> list[tuple[bytes, bytes]]:
    keys = {bytes(rng.integers(97, 123, int(rng.integers(1, 9)), dtype=np.uint8)) for _ in range(n)}
    return [(k, bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8)))
            for k in sorted(keys)]


def _leaves(pairs, wire):
    return [wire.encode_bytes_len_prefixed(k)
            + wire.encode_bytes_len_prefixed(hashlib.sha256(v).digest()) for k, v in pairs]


def test_merkle_is_a_package_with_the_old_names():
    """``crypto/merkle`` became a package: its names and the proofs path stay."""
    for name in ("Proof", "proofs_from_byte_slices", "hash_from_byte_slices", "leaf_hash",
                 "proofs_from_byte_slices_pure", "_device_proofs", "MAX_AUNTS",
                 "compute_hash_from_aunts", "last_root_path"):
        assert hasattr(merkle, name), name
    assert merkle.__file__.endswith("merkle/__init__.py")


@pytest.mark.parametrize("path", ["/a/b", "/x:00FF/k%2Fslash", "/", "/x:zz", "noslash", "",
                                  "/%E2%9C%93/x:", "/a//b"])
def test_key_path_to_keys(path):
    assert _outcome(lambda: kp.key_path_to_keys(path)) == \
        _outcome(lambda: ref_kp.key_path_to_keys(path))


def test_key_path_strings():
    port = kp.KeyPath().append_key(b"app", kp.KeyEncoding.URL).append_key(
        b"\x00\xff/", kp.KeyEncoding.HEX).append_key("a/b ✓".encode(), kp.KeyEncoding.URL)
    ref = ref_kp.KeyPath().append_key(b"app", ref_kp.KeyEncoding.URL).append_key(
        b"\x00\xff/", ref_kp.KeyEncoding.HEX).append_key("a/b ✓".encode(), ref_kp.KeyEncoding.URL)
    assert str(port) == str(ref)
    assert kp.key_path_to_keys(str(port)) == ref_kp.key_path_to_keys(str(ref))


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_value_op_bytes_and_verdicts(n):
    """A ValueOp over the same SimpleMap leaves: the same proof op bytes, the
    same root, the same verdict and error text for the right value, a wrong
    value, a wrong key path and a path with a key left over."""
    from cometbft_tpu.wire import proto as ref_wire
    from cometbft_tpu_torch.wire import proto as wire

    rng = np.random.default_rng(SEED + n)
    pairs = _kv_pairs(n, rng)
    root, proofs = merkle.proofs_from_byte_slices(_leaves(pairs, wire))
    ref_root, ref_proofs_ = ref_proofs(_leaves(pairs, ref_wire))
    assert root == ref_root
    runtime, ref_runtime = op.default_proof_runtime(), ref_op.default_proof_runtime()
    for i, (k, v) in enumerate(pairs):
        pop = pv.ValueOp(k, proofs[i]).proof_op()
        ref_pop = ref_pv.ValueOp(k, ref_proofs_[i]).proof_op()
        assert (pop.type, pop.key, pop.data) == (ref_pop.type, ref_pop.key, ref_pop.data)
        ops = op.ProofOps(ops=[pop])
        ref_ops = ref_op.ProofOps(ops=[ref_pop])
        path = str(kp.KeyPath().append_key(k, kp.KeyEncoding.HEX))
        for args in ((root, path, v), (root, path, v + b"!"), (root, "/x:00", v),
                     (root, path + "/x:01", v), (b"\x00" * 32, path, v)):
            assert _outcome(lambda: runtime.verify_value(ops, *args)) == \
                _outcome(lambda: ref_runtime.verify_value(ref_ops, *args))
        assert _outcome(lambda: runtime.verify_absence(ops, root, path)) == \
            _outcome(lambda: ref_runtime.verify_absence(ref_ops, root, path))
        decoded = pv.value_op_decoder(pop)
        assert decoded.key == k and decoded.proof == proofs[i]


def test_runtime_errors():
    port, ref = op.default_proof_runtime(), ref_op.default_proof_runtime()
    assert _outcome(lambda: port.register_op_decoder(pv.PROOF_OP_VALUE, pv.value_op_decoder)) == \
        _outcome(lambda: ref.register_op_decoder(ref_pv.PROOF_OP_VALUE, ref_pv.value_op_decoder))
    assert _outcome(lambda: port.decode(op.ProofOp(type="iavl:v"))) == \
        _outcome(lambda: ref.decode(ref_op.ProofOp(type="iavl:v")))
    assert _outcome(lambda: pv.value_op_decoder(op.ProofOp(type="x"))) == \
        _outcome(lambda: ref_pv.value_op_decoder(ref_op.ProofOp(type="x")))
    bad = pv.ValueOp(b"k", merkle.Proof(total=1, index=0, leaf_hash=b"\x00" * 32))
    ref_bad = ref_pv.ValueOp(b"k", RefProof(total=1, index=0, leaf_hash=b"\x00" * 32))
    for args in ([b"v"], [], [b"a", b"b"]):
        assert _outcome(lambda: bad.run(args)) == _outcome(lambda: ref_bad.run(args))
    empty, ref_empty = op.ProofOperators(), ref_op.ProofOperators()
    assert _outcome(lambda: empty.verify(b"r", "/k", [b"r"])) == \
        _outcome(lambda: ref_empty.verify(b"r", "/k", [b"r"]))


@pytest.mark.parametrize("n", [0, 1, 3])
def test_proof_ops_wire(n):
    """ProofOps bytes: the port's codec and the reference's ``abci/wire``."""
    rng = np.random.default_rng(SEED * 3 + n)
    ops = [op.ProofOp(type=["simple:v", "", "iavl:v"][i % 3],
                      key=bytes(rng.integers(0, 256, i, dtype=np.uint8)),
                      data=bytes(rng.integers(0, 256, 3 * i, dtype=np.uint8))) for i in range(n)]
    ref_ops = [ref_op.ProofOp(type=o.type, key=o.key, data=o.data) for o in ops]
    encoded = encode_proof_ops(ops)
    assert encoded == ref_enc_proof_ops(ref_ops)
    assert decode_proof_ops(encoded) == ops
    assert [(o.type, o.key, o.data) for o in ref_dec_proof_ops(encoded)] == \
        [(o.type, o.key, o.data) for o in ops]
    assert convert.proof_ops_from_wire(encoded) == op.ProofOps(ops=ops)


def _provable_pair(rng):
    port, ref = KVStoreApplication(provable=True), RefKV(provable=True)
    txs = [b"%s=%s" % (k, v.hex().encode()) for k, v in _kv_pairs(24, rng)] + [b"raw", b"p=1"]
    for height in range(2):
        for app, mod in ((port, abci), (ref, ref_abci)):
            app.begin_block(mod.RequestBeginBlock())
            for tx in txs[height::2]:
                app.deliver_tx(mod.RequestDeliverTx(tx=tx))
            app.commit()
    assert port.app_hash == ref.app_hash
    return port, ref, txs


def test_provable_kvstore_proven_query_matches_and_verifies():
    port, ref, txs = _provable_pair(np.random.default_rng(SEED))
    keys = [tx.split(b"=")[0] for tx in txs if b"=" in tx] + [b"raw", b"absent"]
    for key in keys:
        q = port.query(abci.RequestQuery(data=key, prove=True))
        rq = ref.query(ref_abci.RequestQuery(data=key, prove=True))
        assert (q.value, q.log, q.height, q.key) == (rq.value, rq.log, rq.height, rq.key)
        assert encode_proof_ops(q.proof_ops) == ref_enc_proof_ops(rq.proof_ops)
        if not q.proof_ops:
            assert key == b"absent"
            continue
        path = "/x:" + key.hex().upper()
        ops = convert.proof_ops_from_wire(encode_proof_ops(q.proof_ops))
        ref_ops = ref_op.ProofOps(ops=ref_dec_proof_ops(ref_enc_proof_ops(rq.proof_ops)))
        op.default_proof_runtime().verify_value(ops, port.app_hash, path, q.value)
        ref_op.default_proof_runtime().verify_value(ref_ops, ref.app_hash, path, rq.value)
        # Each package's runtime takes the other's proof (the same bytes).
        op.default_proof_runtime().verify_value(
            op.ProofOps(ops=[op.ProofOp(o.type, o.key, o.data) for o in rq.proof_ops]),
            ref.app_hash, path, rq.value)
        assert _outcome(lambda: op.default_proof_runtime().verify_value(
            ops, port.app_hash, path, q.value + b"x")) == _outcome(
            lambda: ref_op.default_proof_runtime().verify_value(
                ref_ops, ref.app_hash, path, rq.value + b"x"))
    unproven = port.query(abci.RequestQuery(data=keys[0]))
    assert unproven.proof_ops == [] == ref.query(ref_abci.RequestQuery(data=keys[0])).proof_ops
