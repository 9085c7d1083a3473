"""Light chains for the port's light-client tests
(``tests/test_torch_light_client.py``, ``test_torch_light_gateway.py``,
``test_torch_evidence.py``): the JAX package's own ``test_light.ChainMaker``
over ``MockPV`` keys from fixed secrets, carried to the port by
``LightBlock.encode()``, and the doubles both packages' clients run on.

Both packages verify on a host backend installed with their own
``set_backend``, wrapped in a ``Recording`` backend that keeps each batch's
size and engine class: the JAX package's ``CpuBackend`` and the port's
``CpuBackend`` (the native batch verifier from 16 signatures, the pure
ZIP-215 check below).
"""

from __future__ import annotations

import hashlib
import threading

from test_light import CHAIN_ID, HOUR_NS, T0, ChainMaker

from cometbft_tpu.crypto import ed25519 as ref_ed
from cometbft_tpu.libs.db import MemDB as RefMemDB
from cometbft_tpu.light import client as ref_client
from cometbft_tpu.light import provider as ref_provider
from cometbft_tpu.light.store import LightStore as RefLightStore
from cometbft_tpu.sidecar import backend as ref_backend
from cometbft_tpu.sidecar import engine as ref_engine
from cometbft_tpu.types.cmttime import Time as RefTime
from cometbft_tpu.types.priv_validator import MockPV as RefMockPV
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light import client as port_client
from cometbft_tpu_torch.light import provider as port_provider
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.sidecar import backend as port_backend
from cometbft_tpu_torch.sidecar import engine as port_engine
from cometbft_tpu_torch.types import LightBlock, Time

__all__ = ["CHAIN_ID", "HOUR_NS", "T0", "ChainMaker"]

TRUSTING_NS = 2 * HOUR_NS


def ref_pool(tag: bytes, n: int) -> list:
    return [RefMockPV(ref_ed.gen_priv_key_from_secret(hashlib.sha256(b"%s-%d" % (tag, i)).digest()))
            for i in range(n)]


def chain(tag: bytes, n_vals: int = 4, heights: int = 20, rotate: int = 0, pool=None,
          app_hash: bytes = b"\x00" * 32) -> ChainMaker:
    """A reference chain over keys from fixed secrets (the same chain every
    run, so that hashes and evidence bytes can be compared)."""
    pool = pool or ref_pool(tag, n_vals + rotate * heights)
    return ChainMaker(n_vals=n_vals, heights=heights, rotate=rotate, pool=pool, app_hash=app_hash)


def port_blocks(blocks: dict) -> dict:
    """The port's LightBlocks, decoded from the reference's wire bytes."""
    return {h: LightBlock.decode(lb.encode()) for h, lb in blocks.items()}


class Recording:
    """A backend that keeps each batch's size and engine class (``engine``
    is the package's engine module) and can be told to raise: on every
    call of the classes in ``fail_classes``, or on every call while
    ``armed`` is set."""

    def __init__(self, inner, engine, fail_classes=()):
        self.inner = inner
        self.engine = engine
        self.fail_classes = set(fail_classes)
        self.armed = False
        self.batches: list[int] = []
        self.classes: list[int] = []
        self._lock = threading.Lock()

    def batch_verify(self, pubs, msgs, sigs):
        klass = self.engine.current_class()
        with self._lock:
            self.batches.append(len(pubs))
            self.classes.append(klass)
        if self.armed or klass in self.fail_classes:
            raise RuntimeError(f"planted backend failure (class {klass})")
        return self.inner.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


class Pair:
    """The two packages' modules and backends side by side."""

    def __init__(self, fail_classes=()):
        self.ref = Recording(ref_backend.CpuBackend(), ref_engine, fail_classes)
        self.port = Recording(port_backend.CpuBackend(), port_engine, fail_classes)

    def __enter__(self):
        self._saved = (ref_backend._backend, port_backend._backend)
        ref_backend.set_backend(self.ref)
        port_backend.set_backend(self.port)
        ref_ed._verified.clear()
        ed25519._verified.clear()
        return self

    def __exit__(self, *exc):
        ref_backend.set_backend(self._saved[0])
        port_backend.set_backend(self._saved[1])
        ref_ed._verified.clear()
        ed25519._verified.clear()


def make_provider(pkg: str, blocks: dict):
    """A MockProvider of the package that records the heights it served."""
    base = ref_provider.MockProvider if pkg == "ref" else port_provider.MockProvider

    class Counting(base):
        def __init__(self):
            super().__init__(CHAIN_ID, blocks)
            self.fetched: list[int] = []

        def light_block(self, height):
            self.fetched.append(height)
            return super().light_block(height)

    return Counting()


def make_client(pkg: str, blocks: dict, trust_height: int = 1, provider=None, witnesses=(),
                **kw):
    """The package's Client over a fresh MemDB store, trusting
    ``blocks[trust_height]``."""
    mod = ref_client if pkg == "ref" else port_client
    store = RefLightStore(RefMemDB()) if pkg == "ref" else LightStore(MemDB())
    provider = provider or make_provider(pkg, blocks)
    return mod.Client(
        CHAIN_ID,
        mod.TrustOptions(period_ns=TRUSTING_NS, height=trust_height,
                         hash=blocks[trust_height].hash()),
        provider, list(witnesses), store, **kw)


def now(pkg: str, seconds: int):
    return RefTime(seconds, 0) if pkg == "ref" else Time(seconds, 0)


def outcome(fn):
    """None, or the (type name, text) of what fn raised."""
    try:
        fn()
        return None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


def store_items(client) -> list:
    return [(bytes(k), bytes(v)) for k, v in client.store._db.iterator()]


def trace(client) -> list:
    return [(h, client.store.light_block(h).hash()) for h in client.store._heights()]
