"""FIFO mempool with async CheckTx validation and LRU dedup cache
(mempool/clist_mempool.go + mempool/cache.go), the port's copy of
``cometbft_tpu/mempool/clist_mempool.py``.

Ordering is insertion-FIFO (CometBFT's concurrent linked list —
an OrderedDict here, same iteration semantics). Survivors are re-checked
against the app after every block commit (clist_mempool.go:45-49).
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.types.tx import tx_key


@dataclass
class MempoolTx:
    """mempool/clist_mempool.go mempoolTx."""

    height: int  # height when validated
    gas_wanted: int
    tx: bytes
    senders: set
    lane: int = 0  # QoS priority lane (higher drains first at reap)
    seq: int = 0  # admission order, FIFO tiebreak within a lane


class TxCache:
    """LRU cache of seen tx keys (mempool/cache.go:120)."""

    def __init__(self, size: int):
        self._size = size
        self._map: collections.OrderedDict[bytes, None] = collections.OrderedDict()
        self._mtx = threading.Lock()

    def push(self, tx: bytes) -> bool:
        """False if already present (cache.go Push)."""
        k = tx_key(tx)
        with self._mtx:
            if k in self._map:
                self._map.move_to_end(k)
                return False
            if len(self._map) >= self._size:
                self._map.popitem(last=False)
            self._map[k] = None
            return True

    def remove(self, tx: bytes) -> None:
        with self._mtx:
            self._map.pop(tx_key(tx), None)

    def reset(self) -> None:
        with self._mtx:
            self._map.clear()

    def has(self, tx: bytes) -> bool:
        with self._mtx:
            return tx_key(tx) in self._map


class NopTxCache:
    def push(self, tx: bytes) -> bool:
        return True

    def remove(self, tx: bytes) -> None:
        pass

    def reset(self) -> None:
        pass

    def has(self, tx: bytes) -> bool:
        return False


class ErrTxInCache(Exception):
    def __init__(self):
        super().__init__("tx already exists in cache")


class ErrMempoolIsFull(Exception):
    def __init__(self, num_txs, max_txs, txs_bytes, max_bytes):
        super().__init__(
            f"mempool is full: number of txs {num_txs} (max: {max_txs}), "
            f"total txs bytes {txs_bytes} (max: {max_bytes})"
        )


class ErrTxTooLarge(Exception):
    def __init__(self, max_size, actual):
        super().__init__(f"Tx too large. Max size is {max_size}, but got {actual}")


class ErrPreCheck(Exception):
    pass


class CListMempool:
    """mempool/clist_mempool.go:30-520."""

    def __init__(
        self,
        config,
        proxy_app_conn,
        height: int = 0,
        pre_check=None,
        post_check=None,
    ):
        self.config = config
        self.proxy_app = proxy_app_conn
        self.height = height
        self.pre_check = pre_check
        self.post_check = post_check
        self._txs: collections.OrderedDict[bytes, MempoolTx] = collections.OrderedDict()
        self._txs_bytes = 0
        self._mtx = threading.RLock()  # update lock (held during block commit)
        # Guards ``_txs`` and ``_txs_bytes`` alone, held only for the data
        # access. A first-time CheckTx answer inserts under it and never
        # waits for the update lock: a socket or gRPC client answers on one
        # dispatch thread, and an answer blocked there on a commit would
        # stall the recheck answers queued behind it until the wave's 10 s
        # timeout (F10; Go's resCbFirstTime takes no update lock either).
        self._txs_mtx = threading.Lock()
        self.cache = (
            TxCache(config.cache_size) if config.cache_size > 0 else NopTxCache()
        )
        self.recheck_txs: list[bytes] = []
        self._notified_available = threading.Event()
        self.tx_available_callback = None
        self._admit_seq = 0

    # -- Mempool interface (mempool/mempool.go:32) ---------------------------

    def lock(self) -> None:
        self._mtx.acquire()

    def unlock(self) -> None:
        self._mtx.release()

    def size(self) -> int:
        return len(self._txs)

    def size_bytes(self) -> int:
        return self._txs_bytes

    def flush_app_conn(self) -> None:
        self.proxy_app.flush()

    def flush(self) -> None:
        """Remove all txs + reset cache (clist_mempool.go Flush)."""
        with self._mtx, self._txs_mtx:
            self._txs.clear()
            self._txs_bytes = 0
            self.cache.reset()

    def check_tx(self, tx: bytes, callback=None, sender: str = "", lane: int = 0) -> None:
        """clist_mempool.go:202-280 CheckTx: size/pre-check, cache dedup,
        async app CheckTx, insertion via resCbFirstTime. ``lane`` tags the
        entry's QoS priority lane (0 = legacy/lowest) for lane-aware reap."""
        with self._mtx:
            tx_size = len(tx)
            if self.size() >= self.config.size or (
                self._txs_bytes + tx_size > self.config.max_txs_bytes
            ):
                raise ErrMempoolIsFull(
                    self.size(), self.config.size, self._txs_bytes, self.config.max_txs_bytes
                )
            if tx_size > self.config.max_tx_bytes:
                raise ErrTxTooLarge(self.config.max_tx_bytes, tx_size)
            if self.pre_check:
                try:
                    self.pre_check(tx)
                except Exception as e:
                    raise ErrPreCheck(str(e)) from e
            if not self.cache.push(tx):
                # Record the sender on the existing entry (clist_mempool.go:240).
                k = tx_key(tx)
                with self._txs_mtx:
                    entry = self._txs.get(k)
                    if entry is not None and sender:
                        entry.senders.add(sender)
                raise ErrTxInCache()

        def on_res(res: abci.ResponseCheckTx):
            self._res_cb_first_time(tx, sender, res, lane=lane)
            if callback:
                callback(res)

        self.proxy_app.check_tx_async(abci.RequestCheckTx(tx=tx), on_res)

    def _res_cb_first_time(
        self, tx: bytes, sender: str, res: abci.ResponseCheckTx, lane: int = 0
    ):
        post_ok = True
        if self.post_check:
            try:
                self.post_check(tx, res)
            except Exception:
                post_ok = False
        if res.code == abci.CODE_TYPE_OK and post_ok:
            with self._txs_mtx:
                # Re-check capacity at insertion time: other txs may have
                # been admitted since the pre-flight check
                # (clist_mempool.go:386 resCbFirstTime re-runs isFull).
                if self.size() >= self.config.size or (
                    self._txs_bytes + len(tx) > self.config.max_txs_bytes
                ):
                    self.cache.remove(tx)
                    return
                k = tx_key(tx)
                if k not in self._txs:
                    self._admit_seq += 1
                    self._txs[k] = MempoolTx(
                        height=self.height,
                        gas_wanted=res.gas_wanted,
                        tx=tx,
                        senders={sender} if sender else set(),
                        lane=lane,
                        seq=self._admit_seq,
                    )
                    self._txs_bytes += len(tx)
            self._notify_tx_available()
        else:
            # invalid: remove from cache so it can be resubmitted (if KeepInvalid off)
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(tx)

    def _notify_tx_available(self) -> None:
        """Fire once per height (clist_mempool.go notifyTxsAvailable latch)."""
        if (
            self.size() > 0
            and self.tx_available_callback
            and not self._notified_available.is_set()
        ):
            self._notified_available.set()
            self.tx_available_callback()

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        """Lane-aware ReapMaxBytesMaxGas: high-priority lanes drain first,
        FIFO (admission seq) within a lane. With no ingress wired every tx
        sits in lane 0 and this degenerates to CometBFT's pure FIFO."""
        with self._mtx:
            with self._txs_mtx:
                entries = list(self._txs.values())
            total_bytes = 0
            total_gas = 0
            out = []
            if any(m.lane for m in entries):
                entries.sort(key=lambda m: (-m.lane, m.seq))
            for mtx in entries:
                tx_len = len(mtx.tx) + 5  # amino/proto overhead bound
                if max_bytes > -1 and total_bytes + tx_len > max_bytes:
                    break
                if max_gas > -1 and total_gas + mtx.gas_wanted > max_gas:
                    break
                total_bytes += tx_len
                total_gas += mtx.gas_wanted
                out.append(mtx.tx)
            return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        with self._mtx, self._txs_mtx:
            txs = [m.tx for m in self._txs.values()]
        return txs if n < 0 else txs[:n]

    def update(
        self, height: int, txs: list[bytes], deliver_tx_responses, pre_check, post_check
    ) -> None:
        """clist_mempool.go:560-640 Update: called with the mempool lock held
        after every commit. Removes committed txs, re-checks survivors."""
        self.height = height
        self._notified_available.clear()
        if pre_check:
            self.pre_check = pre_check
        if post_check:
            self.post_check = post_check
        for i, tx in enumerate(txs):
            res = deliver_tx_responses[i]
            if res.code == abci.CODE_TYPE_OK:
                self.cache.push(tx)  # committed: keep in cache to block replays
            elif not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            k = tx_key(tx)
            with self._txs_mtx:
                entry = self._txs.pop(k, None)
                if entry is not None:
                    self._txs_bytes -= len(entry.tx)
        if self._txs and self.config.recheck:
            self._recheck_txs()

    def _recheck_txs(self) -> None:
        """Re-run CheckTx(RECHECK) on survivors; drop newly-invalid ones.

        The survivor snapshot is taken under ``_txs_mtx`` (concurrent admission
        must not tear the iteration), and the rechecks go through the async
        proxy as one pipelined wave closed by a single flush — N txs cost
        one round trip to a socket/grpc app instead of N.
        """
        with self._txs_mtx:
            snapshot = list(self._txs.items())
        if not snapshot:
            return
        results: list = [None] * len(snapshot)
        pending = threading.Event()
        remaining = [len(snapshot)]
        rlock = threading.Lock()

        def on_res(i: int):
            def cb(res: abci.ResponseCheckTx):
                results[i] = res
                with rlock:
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        pending.set()

            return cb

        for i, (_, entry) in enumerate(snapshot):
            self.proxy_app.check_tx_async(
                abci.RequestCheckTx(tx=entry.tx, type=abci.CHECK_TX_TYPE_RECHECK),
                on_res(i),
            )
        self.proxy_app.flush()
        pending.wait(timeout=10.0)
        for (k, entry), res in zip(snapshot, results):
            if res is None:  # transport died mid-wave; keep the tx
                continue
            post_ok = True
            if self.post_check:
                try:
                    self.post_check(entry.tx, res)
                except Exception:
                    post_ok = False
            if res.code != abci.CODE_TYPE_OK or not post_ok:
                with self._txs_mtx:
                    gone = self._txs.pop(k, None)
                    if gone is not None:
                        self._txs_bytes -= len(gone.tx)
                if not self.config.keep_invalid_txs_in_cache:
                    self.cache.remove(entry.tx)

    def txs_front(self):
        """Iteration hook for the gossip reactor."""
        with self._txs_mtx:
            return list(self._txs.values())
