"""Load generation + block-interval/latency report (CometBFT's
test/loadtime/{cmd,payload,report} and test/e2e/runner/benchmark.go:14-56),
the port's copy of ``cometbft_tpu/loadtime.py``: the same payloads and
report fields.

The reference's loadtime tool pumps transactions whose payload embeds the
creation time, then a report tool reads the committed chain back and derives
tx latency (block time - creation time); the e2e runner's Benchmark reports
mean/σ/min/max block interval over a window of consecutive blocks.  This
module is both halves against an in-process devnet: `run_load` drives a
4-validator TCP devnet at a target tx rate until the window has passed,
`build_report` recovers latencies from the committed payloads.

Run by `python -m cometbft_tpu_torch.cmd loadtime`. The devnet's nodes
verify through the process backend (``sidecar.backend.get_backend()``):
the card unless ``CMTPU_BACKEND=cpu``. The window opens once a block has
committed under load (the JAX package sleeps 1 s), and the wait for the
window's blocks polls the store. A submission that raises is counted on the
report (``submit_errors``, ``last_submit_error``: attributes outside its
JSON), where the JAX package passes over it; so is a node whose ``stop()``
raised (``stop_errors``), and so are the txs submitted over the run
(``submitted``).
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, fields


@dataclass
class Report:
    """mean/σ/min/max block interval + tx latency (benchmark.go:14-21,
    loadtime/report/report.go)."""

    blocks: int = 0
    start_height: int = 0
    end_height: int = 0
    txs_committed: int = 0
    duration_s: float = 0.0
    block_interval_mean_s: float = 0.0
    block_interval_stddev_s: float = 0.0
    block_interval_min_s: float = 0.0
    block_interval_max_s: float = 0.0
    tx_latency_mean_s: float = 0.0
    tx_latency_p50_s: float = 0.0
    tx_latency_p95_s: float = 0.0
    tx_latency_max_s: float = 0.0
    tx_per_s: float = 0.0
    blocks_per_s: float = 0.0
    rate_requested: int = 0
    connections: int = 0

    # Counted, outside the JSON: the txs the generator submitted over the
    # whole run, submissions that raised, nodes whose stop raised.
    submitted = 0
    submit_errors = 0
    last_submit_error = None
    stop_errors = 0

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})


def make_payload(seq: int, now_ns: int, size: int = 64) -> bytes:
    """loadtime/payload: id + creation time in the tx, padded to size."""
    base = b"load/%d/%d/" % (seq, now_ns)
    return base + b"x" * max(0, size - len(base))


def make_signed_payload(
    priv, seq: int, now_ns: int, size: int = 64, priority: int = 0
) -> bytes:
    """A loadtime payload wrapped in a SignedTxEnvelope, so load generation
    exercises the QoS ingress preverify path (mempool/ingress.py)."""
    from cometbft_tpu_torch.mempool.ingress import encode_envelope

    return encode_envelope(
        priv, make_payload(seq, now_ns, size), priority=priority, nonce=seq
    )


def parse_payload(tx: bytes) -> int | None:
    """Creation time (ns) if this is a loadtime tx (enveloped or bare)."""
    if tx and tx[0] == 0xCE:  # SignedTxEnvelope: latency lives in the payload
        try:
            from cometbft_tpu_torch.mempool.ingress import decode_envelope

            env = decode_envelope(tx)
        except Exception:
            return None
        if env is None:
            return None
        tx = env.payload
    if not tx.startswith(b"load/"):
        return None
    try:
        return int(tx.split(b"/", 3)[2])
    except (IndexError, ValueError):
        return None


def build_report(block_store, start_height: int, end_height: int) -> Report:
    """Walk committed blocks: intervals from consecutive header times
    (benchmark.go splitIntoBlockIntervals), latencies from payloads."""
    rep = Report(start_height=start_height, end_height=end_height)
    times: list[float] = []
    latencies: list[float] = []
    for h in range(start_height, end_height + 1):
        blk = block_store.load_block(h)
        if blk is None:
            continue
        t = blk.header.time.seconds + blk.header.time.nanos / 1e9
        times.append(t)
        for tx in blk.data.txs:
            created_ns = parse_payload(bytes(tx))
            if created_ns is not None:
                rep.txs_committed += 1
                latencies.append(max(0.0, t - created_ns / 1e9))
    rep.blocks = len(times)
    if len(times) >= 2:
        intervals = [b - a for a, b in zip(times, times[1:])]
        rep.duration_s = times[-1] - times[0]
        rep.block_interval_mean_s = sum(intervals) / len(intervals)
        rep.block_interval_stddev_s = math.sqrt(
            sum((x - rep.block_interval_mean_s) ** 2 for x in intervals)
            / len(intervals)
        )
        rep.block_interval_min_s = min(intervals)
        rep.block_interval_max_s = max(intervals)
        if rep.duration_s > 0:
            rep.blocks_per_s = (rep.blocks - 1) / rep.duration_s
            rep.tx_per_s = rep.txs_committed / rep.duration_s
    if latencies:
        latencies.sort()
        rep.tx_latency_mean_s = sum(latencies) / len(latencies)
        rep.tx_latency_p50_s = latencies[len(latencies) // 2]
        rep.tx_latency_p95_s = latencies[int(len(latencies) * 0.95)]
        rep.tx_latency_max_s = latencies[-1]
    return rep


def run_load(
    n_vals: int = 4,
    rate: int = 200,
    min_blocks: int = 100,
    connections: int = 1,
    timeout_s: float = 120.0,
    signed: bool = False,
    log=lambda s: None,
) -> Report:
    """Drive an in-process TCP devnet at `rate` tx/s (split over
    `connections` submitter threads, loadtime's `-c`) until `min_blocks`
    consecutive blocks have been produced under load; report over exactly
    that window.  With ``signed=True`` each connection signs its txs into
    SignedTxEnvelopes and submits through the node's ingress pipeline, so
    the run measures admission through batched signature pre-verification
    rather than bare FIFO insertion."""
    if rate <= 0 or connections <= 0 or min_blocks <= 0:
        raise ValueError("rate, connections, and min_blocks must be positive")
    from cometbft_tpu_torch.abci.client import LocalClientCreator
    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    pvs = [
        FilePV(ed25519.gen_priv_key_from_secret(b"load-val-%d" % i))
        for i in range(n_vals)
    ]
    gen = GenesisDoc(
        chain_id="loadtime-devnet",
        genesis_time=cmttime.now(),
        validators=[
            GenesisValidator(pv.get_pub_key().address(), pv.get_pub_key(), 10, f"v{i}")
            for i, pv in enumerate(pvs)
        ],
    )
    gen.validate_and_complete()
    nodes = []
    rep = None
    stop = threading.Event()
    try:
        for pv in pvs:
            cfg = test_config()
            cfg.base.db_backend = "memdb"
            cfg.rpc.laddr = ""
            cfg.p2p.laddr = "tcp://127.0.0.1:0"
            nodes.append(Node(cfg, gen, pv, LocalClientCreator(KVStoreApplication())))
        for nd in nodes:
            nd.start()
        addrs = [nd.switch.node_info.listen_addr for nd in nodes]
        for i, nd in enumerate(nodes):
            for j, a in enumerate(addrs):
                if i != j:
                    nd.switch.dial_peer(a)
        seq_lock = threading.Lock()
        seq = [0]
        errors: list[BaseException] = []

        def submitter(conn_idx: int):
            # Each connection paces itself to rate/connections tx/s
            per = rate / connections
            next_t = time.monotonic()
            sender_priv = (
                ed25519.gen_priv_key_from_secret(b"load-sender-%d" % conn_idx)
                if signed
                else None
            )
            while not stop.is_set():
                with seq_lock:
                    k = seq[0]
                    seq[0] += 1
                nd = nodes[conn_idx % n_vals]
                if signed:
                    tx = make_signed_payload(sender_priv, k, time.time_ns())
                    target = nd.ingress or nd.mempool
                else:
                    tx = make_payload(k, time.time_ns())
                    target = nd.mempool
                try:
                    target.check_tx(tx)
                except Exception as e:  # counted on the report
                    with seq_lock:
                        errors.append(e)
                next_t += 1.0 / per
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        threads = [
            threading.Thread(target=submitter, args=(c,), daemon=True)
            for c in range(connections)
        ]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout_s
        # let load reach steady state before opening the window: one block
        # committed under load
        _wait_height(nodes[0], nodes[0].block_store.height() + 1, deadline, log)
        start_h = nodes[0].block_store.height() + 1
        target_h = start_h + min_blocks - 1
        _wait_height(nodes[0], target_h, deadline, log)
        stop.set()
        for t in threads:
            t.join(timeout=2)
        end_h = min(nodes[0].block_store.height(), target_h)
        rep = build_report(nodes[0].block_store, start_h, end_h)
        rep.rate_requested = rate
        rep.connections = connections
        rep.submitted = seq[0]
        rep.submit_errors = len(errors)
        rep.last_submit_error = errors[-1] if errors else None
        return rep
    finally:
        stop.set()
        stop_errors = 0
        for nd in nodes:
            try:
                nd.stop()
            except Exception:  # counted on the report
                stop_errors += 1
        if rep is not None:
            rep.stop_errors = stop_errors


def _wait_height(node, target_h: int, deadline: float, log) -> None:
    """Poll the node's store until it holds ``target_h`` or the deadline
    passes; log each new height."""
    last = None
    while time.monotonic() < deadline:
        h = node.block_store.height()
        if h >= target_h:
            return
        if h != last:
            log(f"loadtime: height {h}/{target_h}")
            last = h
        time.sleep(0.05)
