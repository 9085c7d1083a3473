"""The light proxy of the port (``light/proxy.py``) held to the JAX
package's, modelled on its ``tests/test_light_proxy.py`` and
``test_light_attack_e2e.py``: a live one-validator port node with a
provable kvstore, a port light client over its RPC, and a ``LightProxy`` in
front whose every route is verified:

- a proven ``abci_query`` round trip, its value checked against the light
  client's verified app hash, and headers, commits and validators;
- a tampered value and an answer stripped of its proofs refused with the JAX
  package's errors;
- the port proxy's JSON answers equal to the JAX package's proxy's over the
  same node (its light client over the same RPC);
- a forked witness detected, and its evidence committed by the node.

Waits are liveness guards, never time bounds."""

import base64
import os
from dataclasses import replace

import pytest

import torch_nodes as tn
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light.client import Client, TrustOptions
from cometbft_tpu_torch.light.provider import HTTPProvider
from cometbft_tpu_torch.light.proxy import default_merkle_key_path_fn
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.rpc.client import HTTPClient, RPCClientError

pytestmark = pytest.mark.torch_port

CHAIN = "torch-lproxy-chain"
SECRET = b"torch-lproxy"
TXS = [b"alpha=1", b"beta=2", b"gamma=three"]


@pytest.fixture(scope="module")
def live_node(tmp_path_factory):
    """A one-validator port node (default_new_node, provable kvstore, RPC on
    127.0.0.1:0) with TXS committed; its genesis at the wall clock, so that
    the light clients' trusting period holds."""
    from cometbft_tpu.crypto import ed25519 as ref_ed
    from cometbft_tpu.types import GenesisDoc, GenesisValidator, cmttime
    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.sidecar import backend

    old = backend._backend
    backend.set_backend(backend.CpuBackend())
    tmp = tmp_path_factory.mktemp("lproxy")
    pub = ref_ed.gen_priv_key_from_secret(SECRET).pub_key()
    gen = GenesisDoc(chain_id=CHAIN, genesis_time=cmttime.now(),
                     validators=[GenesisValidator(pub.address(), pub, 10, "v0")])
    gen.validate_and_complete()
    p = tn.PKGS["port"]
    os.makedirs(tmp / "keys", exist_ok=True)
    key = tn.pv_key_json(p, SECRET, str(tmp / "keys" / "v.json"))
    home = tn.write_home(p, str(tmp / "home"), tn.node_config(p, p2p__laddr=""),
                         gen.to_json(), pv_key_json=key)
    node = tn.load_node(p, home, app=KVStoreApplication(provable=True))
    node.start()
    try:
        for tx in TXS:
            node.mempool.check_tx(tx)
        tn.wait(lambda: node.block_store.height() >= 5 and all(
            node.block_store.load_block(h) is not None for h in range(1, 5)), "the chain stalled")
        from cometbft_tpu_torch.abci import types as abci

        tn.wait(lambda: node.proxy_app.query.query(
            abci.RequestQuery(path="/store", data=b"gamma")).value == b"three",
            "the txs never committed")
        yield node
    finally:
        node.stop()
        backend._backend = old


class Tamperer:
    """An RPC client that corrupts abci_query values or strips the proofs."""

    def __init__(self, inner, corrupt=False, strip_proofs=False):
        self.inner, self.corrupt, self.strip_proofs = inner, corrupt, strip_proofs

    def call(self, method, **params):
        res = self.inner.call(method, **params)
        if method == "abci_query":
            if self.strip_proofs:
                res["response"].pop("proofOps", None)
            if self.corrupt:
                res["response"]["value"] = base64.b64encode(b"evil").decode()
        return res


def _proxy(node, pkg="port", wrap=None):
    """A proxy of package ``pkg`` over its own light client and HTTP client,
    trusting the node's height 1."""
    if pkg == "port":
        from cometbft_tpu_torch.light import proxy as mod

        Cl, TO, Prov, Store, DB, HC = Client, TrustOptions, HTTPProvider, LightStore, MemDB, HTTPClient
    else:
        from cometbft_tpu.libs.db import MemDB as DB
        from cometbft_tpu.light import proxy as mod
        from cometbft_tpu.light.client import Client as Cl
        from cometbft_tpu.light.client import TrustOptions as TO
        from cometbft_tpu.light.provider import HTTPProvider as Prov
        from cometbft_tpu.light.store import LightStore as Store
        from cometbft_tpu.rpc.client import HTTPClient as HC
    url = f"http://127.0.0.1:{node.rpc_port}"
    provider = Prov(CHAIN, HC(url))
    lb1 = provider.light_block(1)
    client = Cl(CHAIN, TO(period_ns=3600 * 10**9, height=1, hash=lb1.hash()), provider, [],
                Store(DB()))
    rpc = HC(url)
    proxy = mod.LightProxy(client, wrap(rpc) if wrap else rpc, port=0)
    proxy.start()
    return proxy


@pytest.fixture
def proxies(live_node):
    made = []

    def make(*args, **kw):
        made.append(_proxy(live_node, *args, **kw))
        return HTTPClient(f"http://127.0.0.1:{made[-1].port}", timeout=120)

    yield make
    for p in made:
        p.stop()


def test_verified_abci_query_roundtrip(live_node, proxies):
    cli = proxies()
    for key, value in ((b"alpha", b"1"), (b"beta", b"2"), (b"gamma", b"three")):
        res = cli.abci_query("/store", key, prove=True)
        assert base64.b64decode(res["response"]["value"]) == value
        assert res["response"]["proofOps"]["ops"], "the proof rides through"
    status = cli.call("status")
    assert status["light_client"] is True and int(status["sync_info"]["latest_block_height"]) >= 1
    assert cli.call("health") == {}


@pytest.mark.parametrize("wrap,text", [
    (lambda rpc: Tamperer(rpc, corrupt=True), "proof verification failed"),
    (lambda rpc: Tamperer(rpc, strip_proofs=True), "no proof ops"),
], ids=["tampered", "stripped"])
def test_doctored_answers_refused_as_the_reference(proxies, wrap, text):
    errors = []
    for pkg in ("port", "reference"):
        cli = proxies(pkg, wrap)
        with pytest.raises(RPCClientError, match=text) as e:
            cli.abci_query("/store", b"alpha", prove=True)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_proxy_answers_equal_the_reference_proxy(proxies):
    port, ref = proxies("port"), proxies("reference")
    for method, params in (("header", {"height": "2"}), ("commit", {"height": "3"}),
                           ("validators", {"height": "2"}),
                           ("validators", {"height": "3", "page": "1", "per_page": "1"})):
        assert port.call(method, **params) == ref.call(method, **params), method
    a, b = (c.abci_query("/store", b"beta", prove=True) for c in (port, ref))
    a["response"].pop("height")
    b["response"].pop("height")
    assert a == b
    for bad in ({"height": "999999"},):
        outcome = []
        for c in (port, ref):
            with pytest.raises(RPCClientError) as e:
                c.call("header", **bad)
            outcome.append(str(e.value).split(":")[0])
        assert outcome[0] == outcome[1]


def test_key_path_equals_the_reference():
    from cometbft_tpu.light.proxy import default_merkle_key_path_fn as ref_fn

    for path, key in (("/store", b"k"), ("/store/acc/key", b"\x00\xff"), ("", b""),
                      ("/store/a/b/key", b"x y")):
        assert default_merkle_key_path_fn(path, key) == ref_fn(path, key)


def test_forked_witness_detected_and_its_evidence_committed(live_node):
    """test_light_attack_e2e.py on the port: a witness serving a forged
    header at height 3 with the validator's real signature; the port's
    detector raises ErrLightClientAttack and reports the evidence to the
    node's RPC, and the node commits it in a block."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.light.detector import ErrLightClientAttack
    from cometbft_tpu_torch.light.provider import MockProvider
    from cometbft_tpu_torch.types import BlockID, Commit, Vote
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE, SignedHeader
    from cometbft_tpu_torch.types.light_block import LightBlock
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.priv_validator import MockPV
    from cometbft_tpu_torch.types.vote import vote_to_commit_sig

    pv = MockPV(ed25519.gen_priv_key_from_secret(SECRET))
    url = f"http://127.0.0.1:{live_node.rpc_port}"
    fork_h = 3

    class ForkingWitness(MockProvider):
        def __init__(self):
            super().__init__(CHAIN, {})
            self.real = HTTPProvider(CHAIN, HTTPClient(url))

        def light_block(self, height):
            lb = self.real.light_block(height)
            if height != fork_h:
                return lb
            header = replace(lb.signed_header.header, app_hash=b"\xee" * 32)
            bid = BlockID(header.hash(), PartSetHeader(1, b"\x05" * 32))
            val = lb.validator_set.validators[0]
            vote = pv.sign_vote(CHAIN, Vote(type=PRECOMMIT_TYPE, height=height, round=0,
                                            block_id=bid, timestamp=header.time.add_nanos(10**9),
                                            validator_address=val.address, validator_index=0))
            commit = Commit(height=height, round=0, block_id=bid,
                            signatures=[vote_to_commit_sig(vote)])
            return LightBlock(signed_header=SignedHeader(header, commit),
                              validator_set=lb.validator_set)

    primary = HTTPProvider(CHAIN, HTTPClient(url))
    client = Client(CHAIN, TrustOptions(period_ns=3600 * 10**9, height=1,
                                        hash=primary.light_block(1).hash()),
                    primary, [ForkingWitness()], LightStore(MemDB()))
    with pytest.raises(ErrLightClientAttack):
        client.verify_light_block_at_height(fork_h)
    found = []

    def committed():
        for h in range(1, live_node.block_store.height() + 1):
            blk = live_node.block_store.load_block(h)
            found.extend(ev for ev in (blk.evidence if blk else [])
                         if isinstance(ev, LightClientAttackEvidence))
        return found

    tn.wait(committed, "the light-client attack evidence was never committed")
    ev = found[0]
    assert ev.conflicting_block.signed_header.header.height == fork_h
    assert ev.total_voting_power == 10 and len(ev.byzantine_validators) == 1
