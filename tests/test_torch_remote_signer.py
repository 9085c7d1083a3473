"""The remote signer of the port (``privval/signer.py``) held to the JAX
package's, modelled on its ``tests/test_remote_signer.py``:

- the port's ``SignerClient`` against the JAX package's ``SignerServer``,
  and the reverse: the same public key and the same signatures, byte for
  byte, as the FilePV signs in process;
- a double sign refused with the JAX package's ``RemoteSignerError`` code
  and text, and not retried;
- the double-sign guard surviving a signer restart;
- a port node (``default_new_node`` with ``priv_validator_laddr``) that
  commits with its key in a signer process of either package.

Waits are liveness guards, never time bounds."""

import os
import signal
import subprocess
import sys
import types

import pytest

import cometbft_tpu.privval as ref_privval
import cometbft_tpu.privval.signer as ref_signer
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.types import BlockID as RefBlockID
from cometbft_tpu.types import Time as RefTime
from cometbft_tpu.types import Vote as RefVote
from cometbft_tpu.types.part_set import PartSetHeader as RefPSH
from cometbft_tpu.types.proposal import Proposal as RefProposal
import cometbft_tpu_torch.privval as privval
import cometbft_tpu_torch.privval.signer as signer
import torch_nodes as tn
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.types import BlockID, Time, Vote
from cometbft_tpu_torch.types.block import PREVOTE_TYPE
from cometbft_tpu_torch.types.part_set import PartSetHeader
from cometbft_tpu_torch.types.proposal import Proposal

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = "torch-signer-chain"

SIDES = {
    "port": types.SimpleNamespace(pv=privval, s=signer, ed=ed25519, Vote=Vote, BlockID=BlockID,
                                  PSH=PartSetHeader, Time=Time, Proposal=Proposal,
                                  module="cometbft_tpu_torch"),
    "reference": types.SimpleNamespace(pv=ref_privval, s=ref_signer, ed=ref_ed, Vote=RefVote,
                                       BlockID=RefBlockID, PSH=RefPSH, Time=RefTime,
                                       Proposal=RefProposal, module="cometbft_tpu"),
}


def _vote(side, height=2, block_hash=b"\x01" * 32):
    return side.Vote(type=PREVOTE_TYPE, height=height, round=0,
                     block_id=side.BlockID(block_hash, side.PSH(1, b"\x02" * 32)),
                     timestamp=side.Time(1700000000, 0), validator_address=b"\x03" * 20,
                     validator_index=0)


def _proposal(side):
    return side.Proposal(height=3, round=0, pol_round=-1,
                         block_id=side.BlockID(b"\x07" * 32, side.PSH(1, b"\x08" * 32)),
                         timestamp=side.Time(1700000001, 0))


class Wired:
    """A listener endpoint and client of package ``client`` and a signer
    server of package ``server``, over a unix socket, the server's FilePV in
    files under ``tmp``."""

    def __init__(self, tmp, client: str, server: str, secret: bytes = b"torch-remote-pv"):
        self.c, self.sv, self.tmp = SIDES[client], SIDES[server], tmp
        self.laddr = f"unix://{tmp}/pv-{client}-{server}.sock"
        self.endpoint = self.c.s.SignerListenerEndpoint(self.laddr, accept_timeout=60.0)
        self.key, self.state = str(tmp / f"key-{server}.json"), str(tmp / f"state-{server}.json")
        pv = self.sv.pv.FilePV(self.sv.ed.gen_priv_key_from_secret(secret), self.key, self.state)
        pv.save()
        self.server = self.sv.s.SignerServer(self.laddr, CHAIN, pv)
        self.server.start()
        self.client = self.c.s.SignerClient(self.endpoint, CHAIN)

    def restart_server(self):
        self.server.stop()
        pv = self.sv.pv.FilePV.load(self.key, self.state)
        self.server = self.sv.s.SignerServer(self.laddr, CHAIN, pv)
        self.server.start()

    def close(self):
        self.server.stop()
        self.endpoint.close()


@pytest.fixture
def wired(tmp_path):
    made = []

    def make(client, server, **kw):
        made.append(Wired(tmp_path, client, server, **kw))
        return made[-1]

    yield make
    for w in made:
        w.close()


@pytest.mark.parametrize("client,server", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_signatures_equal_the_reference(wired, tmp_path, client, server):
    w = wired(client, server)
    c = w.c
    assert w.client.ping()
    want_pv = ref_privval.FilePV(ref_ed.gen_priv_key_from_secret(b"torch-remote-pv"))
    assert w.client.get_pub_key().bytes() == want_pv.get_pub_key().bytes()
    assert w.client.address() == want_pv.get_pub_key().address()
    v = w.client.sign_vote(CHAIN, _vote(c))
    want_v = want_pv.sign_vote(CHAIN, _vote(SIDES["reference"]))
    assert v.signature == want_v.signature and v.encode() == want_v.encode()
    p = w.client.sign_proposal(CHAIN, _proposal(c))
    want_p = want_pv.sign_proposal(CHAIN, _proposal(SIDES["reference"]))
    assert p.signature == want_p.signature and p.encode() == want_p.encode()


@pytest.mark.parametrize("client,server", [("port", "reference"), ("reference", "port"),
                                           ("port", "port")])
def test_double_sign_refused_and_not_retried(wired, client, server):
    w = wired(client, server)
    requests = []
    orig = w.endpoint.request
    w.endpoint.request = lambda num, body: requests.append(num) or orig(num, body)
    retry = w.c.s.RetrySignerClient(w.client, retries=3, timeout=0.05)
    retry.sign_vote(CHAIN, _vote(w.c, block_hash=b"\x01" * 32))
    with pytest.raises(w.c.s.RemoteSignerError) as e:
        retry.sign_vote(CHAIN, _vote(w.c, block_hash=b"\x09" * 32))
    assert requests == [signer.SIGN_VOTE_REQUEST] * 2  # the refusal is not retried
    assert e.value.code == 2 and "conflicting data" in e.value.description


def test_frames_and_errors_are_the_reference_s():
    names = ("PUB_KEY_REQUEST", "PUB_KEY_RESPONSE", "SIGN_VOTE_REQUEST", "SIGNED_VOTE_RESPONSE",
             "SIGN_PROPOSAL_REQUEST", "SIGNED_PROPOSAL_RESPONSE", "PING_REQUEST", "PING_RESPONSE")
    assert [getattr(signer, n) for n in names] == [getattr(ref_signer, n) for n in names]
    assert [getattr(signer, n) for n in names] == list(range(1, 9))
    err = signer.RemoteSignerError(2, "boom")
    assert signer._enc_signer_error(err) == ref_signer._enc_signer_error(
        ref_signer.RemoteSignerError(2, "boom"))
    back = ref_signer._dec_signer_error(signer._enc_signer_error(err))
    assert (back.code, back.description) == (2, "boom")
    assert signer._frame(7, b"") == ref_signer._frame(7, b"")
    # An unknown request is answered with code 1, as the JAX package does.
    pv = privval.FilePV(ed25519.gen_priv_key_from_secret(b"x"))
    ref_pv = ref_privval.FilePV(ref_ed.gen_priv_key_from_secret(b"x"))
    assert signer.SignerServer("", CHAIN, pv)._handle(42, b"") == \
        ref_signer.SignerServer("", CHAIN, ref_pv)._handle(42, b"")


@pytest.mark.parametrize("client,server", [("port", "reference"), ("reference", "port")])
def test_guard_survives_a_signer_restart(wired, client, server):
    """The state file keeps the last sign: a restarted signer refuses a
    conflicting vote at the same height, round and step, and signs the same
    vote again with the same signature (file.go:318)."""
    w = wired(client, server)
    signed = w.client.sign_vote(CHAIN, _vote(w.c, block_hash=b"\x01" * 32))
    w.restart_server()
    retry = w.c.s.RetrySignerClient(w.client, retries=200, timeout=0.05)
    again = retry.sign_vote(CHAIN, _vote(w.c, block_hash=b"\x01" * 32))
    assert again.signature == signed.signature
    with pytest.raises(w.c.s.RemoteSignerError):
        retry.sign_vote(CHAIN, _vote(w.c, block_hash=b"\x0a" * 32))


def test_stop_ends_the_port_signer_thread(tmp_path):
    w = Wired(tmp_path, "port", "port")
    try:
        assert w.client.ping()
        thread = w.server._thread
        w.server.stop()
        assert not thread.is_alive()
        w.endpoint.accept_timeout = 0.2
        with pytest.raises((ConnectionError, TimeoutError)):
            w.client.get_pub_key()  # nothing answers after stop()
    finally:
        w.endpoint.close()


@pytest.fixture
def cpu_backend():
    port = tn.PKGS["port"].backend
    old = port._backend
    port.set_backend(port.CpuBackend())
    yield
    port._backend = old


@pytest.mark.parametrize("signer_pkg", ["port", "reference"])
def test_port_node_commits_with_a_signer_process(tmp_path, cpu_backend, signer_pkg):
    """A one-validator port node built by ``default_new_node`` with
    ``priv_validator_laddr``: its key lives in a signer process (``python -m
    ...privval.signer``), and blocks commit through the socket; ``stop()``
    closes the endpoint and leaves no thread of the node."""
    from cometbft_tpu.types import GenesisDoc, GenesisValidator

    secret = b"torch-node-remote-pv"
    side = SIDES[signer_pkg]
    key_file, state_file = str(tmp_path / "key.json"), str(tmp_path / "state.json")
    side.pv.FilePV(side.ed.gen_priv_key_from_secret(secret), key_file, state_file).save()
    pub = ref_ed.gen_priv_key_from_secret(secret).pub_key()
    gen = GenesisDoc(chain_id=CHAIN, genesis_time=RefTime(1_700_000_000, 0),
                     validators=[GenesisValidator(pub.address(), pub, 10, "v0")])
    gen.validate_and_complete()
    laddr = f"unix://{tmp_path}/node-pv.sock"
    p = tn.PKGS["port"]
    home = str(tmp_path / "home")
    tn.write_home(p, home, tn.node_config(p, rpc__laddr="", p2p__laddr="",
                                          base__priv_validator_laddr=laddr), gen.to_json())
    # The signer dials with backoff; the node's build asks it for the key.
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{side.module}.privval.signer", "--addr", laddr,
         "--chain-id", CHAIN, "--key-file", key_file, "--state-file", state_file],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    node = None
    try:
        node = tn.load_node(p, home)
        assert type(node.priv_validator).__name__ == "RetrySignerClient"
        node.start()
        tn.wait(lambda: node.block_store.height() >= 3,
                f"the remote-signed chain stalled at {node.block_store.height()}")
        commit = node.block_store.load_seen_commit(3)
        assert commit.signatures[0].validator_address == pub.address()
    finally:
        if node is not None:
            node.stop()
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    assert node.threads_left_at_stop == 0
    assert node.priv_validator.client.endpoint._running is False
