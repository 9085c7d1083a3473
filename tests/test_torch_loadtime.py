"""The port's load generator (``loadtime.py``, ``cmd loadtime``) against the
JAX package's, after ``tests/test_loadtime.py``:

- the payload bytes, signed envelopes and parses are the reference's;
- ``build_report`` gives the reference's report, field for field and in
  its JSON, on the reference test's store double and on a real block store
  of loadtime txs;
- a short ``run_load`` (4 validators over TCP, one connection), bare and
  signed, covers exactly the blocks asked with txs committed; it waits for
  blocks, never for wall time (the reference's run is a non-strict xfail
  for its wall-clock window).

Waits are liveness guards, never time bounds."""

import json
import re
from dataclasses import asdict

import pytest

from cometbft_tpu import loadtime as ref_loadtime
from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu_torch import loadtime
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.sidecar import backend
from cometbft_tpu_torch.store import BlockStore

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("seq,now_ns,size", [
    (0, 0, 64), (7, 123456789, 64), (2**40, 1_700_000_000_123_456_789, 64),
    (3, 5, 8), (12, 99, 200), (1, 1, 0),
])
def test_payloads_are_the_references(seq, now_ns, size):
    tx = loadtime.make_payload(seq, now_ns, size)
    assert tx == ref_loadtime.make_payload(seq, now_ns, size)
    assert loadtime.parse_payload(tx) == ref_loadtime.parse_payload(tx) == now_ns
    priv = ed25519.gen_priv_key_from_secret(b"load-sender-0")
    ref_priv = ref_ed.gen_priv_key_from_secret(b"load-sender-0")
    signed = loadtime.make_signed_payload(priv, seq, now_ns, size, priority=3)
    assert signed == ref_loadtime.make_signed_payload(ref_priv, seq, now_ns, size, priority=3)
    assert loadtime.parse_payload(signed) == ref_loadtime.parse_payload(signed) == now_ns


@pytest.mark.parametrize("tx", [
    b"", b"not-a-load-tx", b"load/malformed", b"load/1/notanumber/x", b"load/1/2",
    b"\xce", b"\xce" + b"\x01" * 40, b"\xce\x01" + b"\x00" * 200,
])
def test_parse_refuses_what_the_reference_refuses(tx):
    assert loadtime.parse_payload(tx) == ref_loadtime.parse_payload(tx)


class _Blk:
    def __init__(self, t, txs):
        class T:
            seconds = int(t)
            nanos = int(round((t - int(t)) * 1e9))

        self.header = type("H", (), {"time": T()})()
        self.data = type("D", (), {"txs": txs})()


class _Store:
    def __init__(self, blocks):
        self._b = blocks

    def load_block(self, h):
        return self._b.get(h)


def test_report_math_is_the_references():
    t0 = 1700000000.0
    mk = loadtime.make_payload
    store = _Store({
        1: _Blk(t0 + 0.0, [mk(0, int((t0 - 0.05) * 1e9))]),
        2: _Blk(t0 + 1.0, []),
        3: _Blk(t0 + 3.0, [mk(1, int((t0 + 1.5) * 1e9)), b"other", mk(2, int(t0 * 1e9))]),
        5: _Blk(t0 + 3.5, [mk(3, int((t0 + 9) * 1e9))]),  # created after its block
    })
    rep, ref = loadtime.build_report(store, 1, 6), ref_loadtime.build_report(store, 1, 6)
    assert asdict(rep) == asdict(ref)
    assert json.loads(rep.to_json()) == json.loads(ref.to_json())
    assert rep.blocks == 4 and rep.txs_committed == 4
    assert abs(rep.block_interval_mean_s - 3.5 / 3) < 1e-9
    assert rep.tx_latency_max_s == pytest.approx(3.0)


def test_report_over_a_real_block_store_is_the_references(tmp_path, cpu_backend):
    """A port node commits loadtime txs into a sqlite home; the port's
    report over its BlockStore equals the reference's over the reference's
    BlockStore on the same file."""
    import time

    from cometbft_tpu.libs.db import new_db as ref_new_db
    from cometbft_tpu.store import BlockStore as RefBlockStore
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.abci.client import LocalClientCreator
    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    pv = FilePV(ed25519.gen_priv_key_from_secret(b"loadtime-store"))
    gen = GenesisDoc(chain_id="lt", genesis_time=cmttime.now(), validators=[
        GenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(), 10, "v0")])
    gen.validate_and_complete()
    cfg = test_config().set_root(str(tmp_path))
    cfg.base.db_backend = "sqlite"
    cfg.rpc.laddr = cfg.p2p.laddr = ""
    nd = Node(cfg, gen, pv, LocalClientCreator(KVStoreApplication()))
    nd.start()
    # A block's time is its LastCommit's (BFT time), which may precede a tx
    # it holds: the report clamps such a latency to 0. The payloads are
    # stamped 10 s early, so that every latency is positive.
    try:
        for k in range(20):
            nd.mempool.check_tx(loadtime.make_payload(k, time.time_ns() - 10 * 10**9))
            if k % 5 == 4:
                h = nd.block_store.height()
                deadline = time.monotonic() + 180
                while nd.block_store.height() <= h or nd.mempool.size():
                    assert time.monotonic() < deadline, "the node stopped committing"
                    time.sleep(0.01)
    finally:
        nd.stop()
    end = nd.block_store.height()
    rep = loadtime.build_report(BlockStore(new_db("blockstore", "sqlite", cfg.base.db_path())),
                                1, end)
    ref = ref_loadtime.build_report(
        RefBlockStore(ref_new_db("blockstore", "sqlite", cfg.base.db_path())), 1, end)
    assert asdict(rep) == asdict(ref)
    assert rep.blocks == end and rep.txs_committed == 20 and rep.tx_latency_max_s > 0


@pytest.fixture
def cpu_backend():
    old = backend._backend
    backend.set_backend(backend.CpuBackend())
    yield
    backend._backend = old


@pytest.mark.parametrize("signed", [False, True], ids=["bare", "signed"])
def test_run_load_covers_exactly_the_blocks_asked(cpu_backend, signed):
    rep = loadtime.run_load(n_vals=4, rate=60, min_blocks=3, connections=1,
                            timeout_s=300, signed=signed)
    assert rep.blocks == 3 and rep.end_height - rep.start_height == 2
    assert rep.txs_committed > 0 and rep.tx_latency_p50_s > 0
    assert rep.block_interval_mean_s > 0
    assert rep.rate_requested == 60 and rep.connections == 1
    assert rep.submit_errors == 0 and rep.stop_errors == 0
    assert rep.submitted >= rep.txs_committed
    assert sorted(json.loads(rep.to_json())) == sorted(asdict(ref_loadtime.Report()))


def test_cli_loadtime_prints_the_report(cpu_backend, monkeypatch, capsys):
    from cometbft_tpu_torch.cmd.__main__ import main as cli

    monkeypatch.setenv("CMTPU_BACKEND", "cpu")
    assert cli(["loadtime", "--rate", "40", "--blocks", "2", "--validators", "4",
                "--signed", "--backend", "cpu"]) == 0
    out = capsys.readouterr()
    rep = json.loads(out.out.strip().splitlines()[-1])
    assert rep["blocks"] == 2 and rep["txs_committed"] > 0 and rep["connections"] == 1
    last = out.err.strip().splitlines()[-1]
    assert re.fullmatch(r"loadtime: submitted (\d+); submit errors 0; stop errors 0", last)
    assert int(last.split()[2].rstrip(";")) >= rep["txs_committed"]
