"""In-memory kvstore application (abci/example/kvstore/kvstore.go) plus the
persistent variant with validator updates (persistent_kvstore.go:
"val:pubkeybase64!power" txs), the port's copy of
``cometbft_tpu/abci/example/kvstore.py``.

A proven query (``RequestQuery.prove`` on a provable store) needs the
ValueOp proof operator (``crypto/merkle/proof_value``), which is not ported:
it raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import base64
import json

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.libs.db import DB, MemDB

_STATE_KEY = b"stateKey"
_KV_PAIR_PREFIX = b"kvPairKey:"

VALIDATOR_TX_PREFIX = "val:"

CODE_TYPE_OK = 0
CODE_TYPE_ENCODING_ERROR = 1
CODE_TYPE_BAD_NONCE = 2
CODE_TYPE_UNAUTHORIZED = 3
CODE_TYPE_EXECUTED = 5
CODE_TYPE_REJECTED = 6


def _put_varint_8(v: int) -> bytes:
    """Go binary.PutVarint into an 8-byte buffer (kvstore.go Commit)."""
    uv = (v << 1) if v >= 0 else ((-v) << 1) - 1
    out = bytearray()
    while True:
        b = uv & 0x7F
        uv >>= 7
        if uv:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    out.extend(b"\x00" * (8 - len(out)))
    return bytes(out[:8])


class KVStoreApplication(abci.Application):
    """abci/example/kvstore/kvstore.go: tx is "key=value" or raw bytes;
    AppHash = varint(size) in 8 bytes."""

    def __init__(
        self,
        db: DB | None = None,
        retain_blocks: int = 0,
        snapshot_interval: int = 0,
        snapshot_chunk_size: int = 65536,
        provable: bool = False,
    ):
        self.db = db or MemDB()
        self.retain_blocks = retain_blocks
        # Provable mode: AppHash is the SimpleMap Merkle root over the kv
        # pairs and /store queries answer with ValueOp proofs — what the
        # light proxy's verified abci_query needs (light/rpc/client.go:166;
        # CometBFT's kvstore itself doesn't prove, its e2e app does).
        self.provable = provable
        # State-sync snapshots (CometBFT's test/e2e/app/app.go:22-60 — the
        # purpose-built e2e app is the one that snapshots; plain kvstore.go
        # doesn't). Off unless snapshot_interval > 0.
        self.snapshot_interval = snapshot_interval
        self.snapshot_chunk_size = snapshot_chunk_size
        self._snapshots: dict[tuple, tuple[abci.Snapshot, list[bytes]]] = {}
        self._restore: tuple[abci.Snapshot, list] | None = None
        self._tx_to_remove: set[bytes] = set()
        st = self.db.get(_STATE_KEY)
        if st:
            d = json.loads(st)
            self.size = d["size"]
            self.height = d["height"]
            self.app_hash = base64.b64decode(d["app_hash"]) if d["app_hash"] else b""
        else:
            self.size = 0
            self.height = 0
            self.app_hash = b""

    def _save_state(self) -> None:
        self.db.set(
            _STATE_KEY,
            json.dumps(
                {
                    "size": self.size,
                    "height": self.height,
                    "app_hash": base64.b64encode(self.app_hash).decode(),
                }
            ).encode(),
        )

    def info(self, req):
        return abci.ResponseInfo(
            data=json.dumps({"size": self.size}),
            version="1.0.0",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def check_tx(self, req):
        if len(req.tx) == 0:
            return abci.ResponseCheckTx(code=CODE_TYPE_REJECTED)
        if req.type == abci.CHECK_TX_TYPE_RECHECK and req.tx in self._tx_to_remove:
            return abci.ResponseCheckTx(code=CODE_TYPE_EXECUTED, gas_wanted=1)
        return abci.ResponseCheckTx(code=CODE_TYPE_OK, gas_wanted=1)

    def begin_block(self, req):
        self._tx_to_remove = set()
        return abci.ResponseBeginBlock()

    def deliver_tx(self, req):
        parts = req.tx.split(b"=", 1)
        if len(parts) == 2:
            key, value = parts
        else:
            key = value = req.tx
        self.db.set(_KV_PAIR_PREFIX + key, value)
        self.size += 1
        events = [
            abci.Event(
                type="app",
                attributes=[
                    abci.EventAttribute("creator", "Cosmoshi Netowoko", True),
                    abci.EventAttribute("key", key.decode("utf-8", "replace"), True),
                    abci.EventAttribute("index_key", "index is working", True),
                    abci.EventAttribute("noindex_key", "index is working", False),
                ],
            )
        ]
        return abci.ResponseDeliverTx(code=CODE_TYPE_OK, events=events)

    def process_proposal(self, req):
        for tx in req.txs:
            if len(tx) == 0:
                return abci.ResponseProcessProposal(status=abci.PROCESS_PROPOSAL_REJECT)
        return abci.ResponseProcessProposal(status=abci.PROCESS_PROPOSAL_ACCEPT)

    def commit(self):
        if self.provable:
            from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices

            app_hash = hash_from_byte_slices(self._kv_leaves()[1])
        else:
            app_hash = _put_varint_8(self.size)
        self.app_hash = app_hash
        self.height += 1
        self._save_state()
        if self.snapshot_interval and self.height % self.snapshot_interval == 0:
            self._take_snapshot()
        resp = abci.ResponseCommit(data=app_hash)
        if self.retain_blocks > 0 and self.height >= self.retain_blocks:
            resp.retain_height = self.height - self.retain_blocks + 1
        return resp

    # -- state-sync snapshots (test/e2e/app/snapshots.go shape) ---------------

    def _snapshot_blob(self) -> bytes:
        pairs = {}
        for k, v in self.db.iterator():
            if k.startswith(_KV_PAIR_PREFIX):
                pairs[base64.b64encode(k[len(_KV_PAIR_PREFIX):]).decode()] = (
                    base64.b64encode(v).decode()
                )
        return json.dumps(
            {
                "height": self.height,
                "size": self.size,
                "app_hash": base64.b64encode(self.app_hash).decode(),
                "pairs": pairs,
            },
            sort_keys=True,
        ).encode()

    def _take_snapshot(self) -> None:
        import hashlib

        blob = self._snapshot_blob()
        cs = self.snapshot_chunk_size
        chunks = [blob[i : i + cs] for i in range(0, len(blob), cs)] or [b""]
        snap = abci.Snapshot(
            height=self.height,
            format=1,
            chunks=len(chunks),
            hash=hashlib.sha256(blob).digest(),
        )
        self._snapshots[(snap.height, snap.format)] = (snap, chunks)

    def list_snapshots(self, req):
        return abci.ResponseListSnapshots(
            snapshots=[s for s, _ in self._snapshots.values()]
        )

    def load_snapshot_chunk(self, req):
        entry = self._snapshots.get((req.height, req.format))
        if entry is None or not (0 <= req.chunk < len(entry[1])):
            return abci.ResponseLoadSnapshotChunk()
        return abci.ResponseLoadSnapshotChunk(chunk=entry[1][req.chunk])

    def offer_snapshot(self, req):
        snap = req.snapshot
        if snap is None or snap.format != 1 or snap.chunks < 1:
            return abci.ResponseOfferSnapshot(
                result=abci.OFFER_SNAPSHOT_REJECT_FORMAT
            )
        self._restore = (snap, [None] * snap.chunks)
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def apply_snapshot_chunk(self, req):
        import hashlib

        if self._restore is None:
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_CHUNK_REJECT_SNAPSHOT
            )
        snap, chunks = self._restore
        if not (0 <= req.index < len(chunks)):
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_RETRY)
        chunks[req.index] = req.chunk
        if any(c is None for c in chunks):
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)
        blob = b"".join(chunks)
        if hashlib.sha256(blob).digest() != snap.hash:
            # Whole snapshot is bad: refetch everything, drop the senders.
            self._restore = (snap, [None] * len(chunks))
            return abci.ResponseApplySnapshotChunk(
                result=abci.APPLY_CHUNK_RETRY_SNAPSHOT,
                refetch_chunks=list(range(len(chunks))),
            )
        d = json.loads(blob)
        for k, v in d["pairs"].items():
            self.db.set(
                _KV_PAIR_PREFIX + base64.b64decode(k), base64.b64decode(v)
            )
        self.height = d["height"]
        self.size = d["size"]
        self.app_hash = base64.b64decode(d["app_hash"])
        self._save_state()
        self._restore = None
        return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)

    def query(self, req):
        value = self.db.get(_KV_PAIR_PREFIX + req.data)
        resp = abci.ResponseQuery(
            code=CODE_TYPE_OK,
            key=req.data,
            value=value or b"",
            log="exists" if value is not None else "does not exist",
            height=self.height,
        )
        if req.prove and self.provable and value is not None:
            resp.proof_ops = self._prove(req.data)
        return resp

    # -- provable-state helpers ------------------------------------------------

    def _kv_leaves(self) -> tuple[list[bytes], list[bytes]]:
        """Sorted keys and their SimpleMap leaf encodings
        (crypto/merkle KVPair form: len-prefixed key || len-prefixed
        SHA256(value) — the shape ValueOp.run reconstructs)."""
        import hashlib

        from cometbft_tpu_torch.wire.proto import encode_bytes_len_prefixed

        items = []
        for k, v in self.db.iterator(_KV_PAIR_PREFIX, _KV_PAIR_PREFIX + b"\xff"):
            items.append((k[len(_KV_PAIR_PREFIX):], v))
        items.sort()
        keys = [k for k, _ in items]
        leaves = [
            encode_bytes_len_prefixed(k)
            + encode_bytes_len_prefixed(hashlib.sha256(v).digest())
            for k, v in items
        ]
        return keys, leaves

    def _prove(self, key: bytes) -> list:
        raise NotImplementedError(
            "proven kvstore queries need crypto/merkle/proof_value (ValueOp), "
            "which is not ported"
        )


class PersistentKVStoreApplication(KVStoreApplication):
    """abci/example/kvstore/persistent_kvstore.go: adds validator-set changes
    driven by "val:base64(pubkey)!power" transactions."""

    def __init__(self, db: DB | None = None, **kwargs):
        super().__init__(db, **kwargs)
        self._val_updates: list[abci.ValidatorUpdate] = []
        self._validators: dict[bytes, int] = {}  # pubkey bytes -> power
        raw = self.db.get(b"validatorsKey")
        if raw:
            self._validators = {
                base64.b64decode(k): v for k, v in json.loads(raw).items()
            }

    def _save_validators(self) -> None:
        self.db.set(
            b"validatorsKey",
            json.dumps(
                {base64.b64encode(k).decode(): v for k, v in self._validators.items()}
            ).encode(),
        )

    def init_chain(self, req):
        for vu in req.validators:
            self._validators[vu.pub_key.bytes()] = vu.power
        self._save_validators()
        return abci.ResponseInitChain()

    def begin_block(self, req):
        self._val_updates = []
        return super().begin_block(req)

    def deliver_tx(self, req):
        if req.tx.startswith(VALIDATOR_TX_PREFIX.encode()):
            return self._exec_validator_tx(req.tx)
        return super().deliver_tx(req)

    def _exec_validator_tx(self, tx: bytes):
        body = tx[len(VALIDATOR_TX_PREFIX) :]
        parts = body.split(b"!")
        if len(parts) != 2:
            return abci.ResponseDeliverTx(
                code=CODE_TYPE_ENCODING_ERROR,
                log="expected 'pubkeyB64!power'",
            )
        try:
            pub_bytes = base64.b64decode(parts[0])
            power = int(parts[1])
        except Exception:
            return abci.ResponseDeliverTx(
                code=CODE_TYPE_ENCODING_ERROR, log="malformed validator tx"
            )
        pub = ed25519.PubKey(pub_bytes)
        if power == 0 and pub_bytes not in self._validators:
            return abci.ResponseDeliverTx(
                code=CODE_TYPE_UNAUTHORIZED,
                log="cannot remove non-existent validator",
            )
        if power == 0:
            self._validators.pop(pub_bytes, None)
        else:
            self._validators[pub_bytes] = power
        self._save_validators()
        self._val_updates.append(abci.ValidatorUpdate(pub_key=pub, power=power))
        return abci.ResponseDeliverTx(code=CODE_TYPE_OK)

    def end_block(self, req):
        return abci.ResponseEndBlock(validator_updates=list(self._val_updates))

    def query(self, req):
        if req.path == "/val":
            power = self._validators.get(req.data, 0)
            return abci.ResponseQuery(
                code=CODE_TYPE_OK, key=req.data, value=str(power).encode()
            )
        return super().query(req)
