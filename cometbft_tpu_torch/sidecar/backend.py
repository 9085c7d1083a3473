"""The port's verification backends.

Counterpart of ``cometbft_tpu/sidecar/backend.py``: its own copy of the
``VerifyBackend`` contract (``batch_verify(pubs, msgs, sigs) -> (ok,
bitmap)`` and ``merkle_root(leaves) -> bytes``) and three tiers:

- ``TorchBackend`` mirrors ``TpuBackend`` on the PyTorch/CUDA device tier;
- ``CpuBackend`` is the host anchor: the native C batch verifier
  (``cometbft_tpu_torch/native``) from 16 signatures, the pure ZIP-215
  oracle one signature at a time below that;
- ``HybridBackend`` splits one batch between the card and the native host
  MSM by a rate model and runs both shares at once; a root goes to the card
  or the native tree by a root cost model.

Each has the reference's duck type, so a host that runs the reference's
consensus code can install one through that package's own ``set_backend``.
``LockedBackend`` and ``device_backend`` are what the port's sidecar server
(``sidecar/service.py``) builds its device tier from, and the supervised
chain (``sidecar/supervisor.py``) stacks these tiers. ``get_backend`` serves
the process default that ``CMTPU_BACKEND`` names (``auto``: the supervised
chain behind the coalescing scheduler).
"""

from __future__ import annotations

import os
import threading
import time

from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import ed25519_pure
from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
from cometbft_tpu_torch.device import resolve


class VerifyBackend:
    """Interface for the device tier."""

    name = "abstract"

    def batch_verify(
        self, pubs: list[bytes], msgs: list[bytes], sigs: list[bytes]
    ) -> tuple[bool, list[bool]]:
        raise NotImplementedError

    def merkle_root(self, leaves: list[bytes]) -> bytes:
        raise NotImplementedError


# Below this, one signature at a time beats the MSM's fixed costs (two
# decompressions a signature, window bookkeeping).
_NATIVE_BATCH_MIN = 16


class CpuBackend(VerifyBackend):
    """The host tier: the native C batch verifier (one random-linear-
    combination equation over a Pippenger MSM) from ``_NATIVE_BATCH_MIN``
    signatures, the pure ZIP-215 oracle one signature at a time below it.
    A batch of 16 or more waits for the native build and raises if it
    failed; it never runs per-signature pure Python."""

    name = "cpu"

    def __init__(self):
        # Start gcc off the calling thread, so that a first small batch
        # does not wait for it.
        native.ensure_built_async()

    def batch_verify(self, pubs, msgs, sigs):
        if len(pubs) >= _NATIVE_BATCH_MIN:
            return native.batch_verify(pubs, msgs, sigs)
        results = [ed25519_pure.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
        return all(results), results

    def merkle_root(self, leaves):
        return hash_from_byte_slices(leaves)


class TorchBackend(VerifyBackend):
    """Batch verification and Merkle roots on one PyTorch device: ``cuda``
    by default (raises when there is none), ``cpu`` only when asked."""

    name = "torch"

    def __init__(self, device=None):
        from cometbft_tpu_torch.ops import ed25519_kernel, merkle_kernel

        self.device = resolve(device)
        self._ed = ed25519_kernel
        self._merkle = merkle_kernel

    def batch_verify(self, pubs, msgs, sigs):
        return self._ed.batch_verify(pubs, msgs, sigs, device=self.device)

    def merkle_root(self, leaves):
        return self._merkle.merkle_root_fused(leaves, device=self.device)

    def mesh_width(self) -> int:
        """The routing width: this process's CUDA devices, 1 on the CPU."""
        return self._ed.mesh_width(self.device)

    def warmup(self, buckets=None, merkle_leaves=None) -> None:
        """Build the kernels and run each program once at the given batch
        buckets and leaf counts (``ed25519_kernel.warmup``)."""
        self._ed.warmup(buckets, merkle_leaves, device=self.device)


# The rate model's seeds, as chip_smoke.py's hybrid phase derives them, on
# an NVIDIA H100 80GB HBM3 at a 700.00 W power limit with its host's cores:
# the host rate from CpuBackend at the 10,240-signature commit (47.86
# sigs/ms: 213.96 ms), the card's fixed cost a dispatch and its rate from
# TorchBackend's walls at 1,024 and 10,240 signatures (3.27 and 17.17 ms:
# 1.72 ms plus 662.87 sigs/ms; another run of the phase gave 58.03, 1.66 ms
# and 910.40). The host pack is most of the card's slope, so a faster or
# slower host moves these; the model corrects them a call. The engine's
# dispatch-wall model starts from the card's two.
HOST_SIGS_PER_MS = 48.0  # CMTPU_HOST_RATE
CARD_SIGS_PER_MS = 663.0  # CMTPU_DEV_RATE
CARD_DISPATCH_MS = 1.7  # CMTPU_DEV_OVERHEAD_MS

# The root cost model's seeds, from chip_smoke.py's hybrid phase on the same
# NVIDIA H100 80GB HBM3 (700.00 W) and host, the mean of three runs (PERF.md
# §5): medians of 5 of TorchBackend's and the native tree's roots at 1,000,
# 10,000 and 65,536 leaves of 17 bytes (native 0.39-0.49, 3.70-4.48 and
# 28.1-31.3 ms; the card 0.27-0.34, 0.85-1.30 and 4.6-6.9 ms): the host's
# rate at 65,536 (2,334, 2,094 and 2,322 leaves/ms), the card's line through
# 1,000 and 65,536 (14,844, 9,747 and 11,826 leaves/ms over 0.206, 0.198 and
# 0.260 ms). The card pays a fixed cost a root and then its leaf rate (the
# host's leaf join and copy are most of it); the native tree pays no fixed
# cost, and wins under ~600 leaves. ``HybridBackend.warmup`` replaces them
# with its own timings.
CARD_ROOT_MS = 0.22
CARD_LEAVES_PER_MS = 12_100.0
HOST_LEAVES_PER_MS = 2_250.0


class HybridBackend(VerifyBackend):
    """The card and the host working one batch at once.

    The card pays a fixed cost a dispatch (the host pack, the copies) and
    then verifies fast; the native host MSM pays no fixed cost and verifies
    slower. ``batch_verify`` splits a batch at a bucket-aligned point that a
    rate model picks (``_plan``), submits the device share
    (``ed25519_kernel.batch_verify_submit``: packed on the calling thread,
    launched on the device-owner thread), runs the host share on the
    calling thread, and joins the bitmaps. The model is corrected from every
    measured call (``_update_rates``). A Merkle root takes the card or the
    native host tree, whichever the root cost model prices lower
    (``_root_on_card``): the card's fixed cost and leaf rate against the
    native tree's leaf rate, seeded from ``CARD_ROOT_MS``,
    ``CARD_LEAVES_PER_MS`` and ``HOST_LEAVES_PER_MS`` and timed again by
    ``warmup``.

    ``device`` None means ``cuda`` (raises without a card); ``"cpu"`` runs
    the device share on the plain PyTorch path, for the tests.
    """

    name = "hybrid"

    def __init__(self, device=None):
        from cometbft_tpu_torch.ops import ed25519_kernel

        self._torch = TorchBackend(device)
        self.device = self._torch.device
        self._ek = ed25519_kernel
        self._native = native
        self._cpu = CpuBackend()
        # Cards one dispatch spreads over: the planner prices the mesh as one
        # large device (the per-card rate times the width, one overhead).
        self._n_dev = ed25519_kernel.mesh_width(self.device)
        # Seeds of the rate model, corrected by an EMA after every call:
        # sigs/ms a card, host sigs/ms and the fixed ms a device dispatch
        # costs (measured where HOST_SIGS_PER_MS says).
        self._dev_rate = float(os.environ.get("CMTPU_DEV_RATE", CARD_SIGS_PER_MS))
        self._host_rate = float(os.environ.get("CMTPU_HOST_RATE", HOST_SIGS_PER_MS))
        self._dev_overhead = float(os.environ.get("CMTPU_DEV_OVERHEAD_MS", CARD_DISPATCH_MS))
        # A batch under CMTPU_HYBRID_MIN goes to the host anchor unplanned.
        # Unset, the planner prices every batch: with the seeds above the
        # card takes a share from 83 signatures, where CARD_DISPATCH_MS and
        # a bucket's lanes first undercut the host's time, and the host
        # share is the native MSM at any size.
        self._min_split = int(os.environ.get("CMTPU_HYBRID_MIN", "0"))
        self._rate_lock = threading.Lock()
        # (batch bucket, block bucket, mesh width) of the programs that ran
        # once in this process: a first launch builds the kernel library and
        # must not be charged to the steady-state model.
        self._warmed: set[tuple] = set()
        # Measured device wall a (batch bucket, mesh width), an EMA of the
        # calls where the device was the straggler. The device's cost is
        # affine (a fixed cost plus a slope a lane), so walls measured at
        # their buckets beat one rate.
        self._dev_wall: dict[tuple[int, int], float] = {}
        # A bias of at most 3 buckets on the ladder: when the device finishes
        # first its wall is not observable (collect() does not block), so
        # the rate model alone cannot learn to give it more; the bias moves
        # the split one bucket toward the tier that sat idle.
        self._bias = 0
        # The root cost model: the card's fixed ms and leaves/ms a root, the
        # native tree's leaves/ms.
        self._root_fixed = CARD_ROOT_MS
        self._card_leaf_rate = CARD_LEAVES_PER_MS
        self._host_leaf_rate = HOST_LEAVES_PER_MS
        # The share and the stage walls of the last call, and where the last
        # root ran ("card" or "host").
        self.last_share = 0
        self.last_timing: dict = {}
        self.last_root = ""

    def _plan(self, n: int) -> int:
        """The device share (a bucket size; 0 is all host, n all device)
        that minimizes the predicted max(device time, host time)."""
        ek = self._ek
        # A snapshot under the lock: _update_rates inserts keys from
        # straggler-collect threads. Only walls seen at this width apply.
        n_dev = self._n_dev
        with self._rate_lock:
            walls = {b: w for (b, nd), w in self._dev_wall.items() if nd == n_dev}
        mesh_rate = self._dev_rate * n_dev

        def dev_ms(b):  # padded lanes cost what real ones do
            bucket = ek.bucket_for(b, n_dev)
            wall = walls.get(bucket)
            if wall is not None:
                return wall
            obs = sorted(walls.items())
            if len(obs) >= 2:  # affine fit over the widest observed span
                (b1, w1), (b2, w2) = obs[0], obs[-1]
                slope = max((w2 - w1) / (b2 - b1), 0.0)
                return max(w1 + slope * (bucket - b1), 1.0)
            if len(obs) == 1:
                b1, w1 = obs[0]
                if bucket > b1:
                    return w1 + (bucket - b1) / mesh_rate
                # a smaller bucket still pays the fixed dispatch cost
                return max(w1 - (b1 - bucket) / mesh_rate, self._dev_overhead)
            return bucket / mesh_rate + self._dev_overhead

        def host_ms(k):
            return k / self._host_rate

        ladder = [*[b for b in ek.BUCKETS if b < n], n]
        best_b, best_cost = 0, host_ms(n)
        for b in ladder:
            cost = max(dev_ms(b), host_ms(n - b))
            if cost < best_cost:
                best_b, best_cost = b, cost
        if best_b > 0 and self._bias:
            i = ladder.index(best_b) + self._bias
            best_b = ladder[max(0, min(i, len(ladder) - 1))]
        return best_b

    def batch_verify(self, pubs, msgs, sigs):
        n = len(pubs)
        if n == 0:
            return False, []
        if n < self._min_split:
            self.last_share = 0
            return self._cpu.batch_verify(pubs, msgs, sigs)
        if self._native.ready() is None:
            # The native library is still building: the card serves.
            return self._torch.batch_verify(pubs, msgs, sigs)
        res, _ = self._routed_call(pubs, msgs, sigs, self._plan(n))
        return res

    def _routed_call(self, pubs, msgs, sigs, share, between=None, on_card=None):
        """One planned verification: all host (share <= 0), all device
        (share >= n) or the split, with the model updated from what it
        measured. ``between`` (optional) runs on the host after the host
        share, while the device works (``verify_and_root``'s native tree);
        ``on_card`` (optional) runs right after the device share is submitted,
        so that its launches queue behind the share's (``verify_and_root``'s
        root on the card). Returns ((ok, bitmap), the one's result)."""
        n = len(pubs)
        extra = None
        if share <= 0:
            if on_card is not None:
                extra = on_card()
            # The native MSM at any size, as the host rate prices it: the
            # anchor's per-signature pure Python below 16 is no host share.
            self.last_share = 0
            t0 = time.perf_counter()
            res = self._native.batch_verify(pubs, msgs, sigs)
            host_ms = (time.perf_counter() - t0) * 1000
            with self._rate_lock:
                if host_ms > 1:
                    r = min(max(n / host_ms, 5.0), 5000.0)
                    self._host_rate += 0.3 * (r - self._host_rate)
                self._decay_bias()
            if between is not None:
                extra = between()
            return res, extra
        share = min(share, n)
        self.last_share = share
        t0 = time.perf_counter()
        collect = self._ek.batch_verify_submit(pubs[:share], msgs[:share], sigs[:share],
                                               device=self.device)
        t_disp = time.perf_counter()
        card_root_s = 0.0
        if on_card is not None:
            # Behind the share's launches: started earlier, this thread's
            # host work would hold the interpreter while the device-owner
            # thread waits to launch.
            collect.launched.wait()
            extra = on_card()
            card_root_s = time.perf_counter() - t_disp
        if share < n:
            ok_h, bits_h = self._native.batch_verify(pubs[share:], msgs[share:], sigs[share:])
        else:
            ok_h, bits_h = True, []
        t_host = time.perf_counter()
        if between is not None:
            extra = between()
        t_wait = time.perf_counter()
        ok_d, bits_d = collect()
        t_dev = time.perf_counter()
        self._update_rates(collect.program_key, share, n - share, t0, t_disp, t_host, t_wait, t_dev,
                           card_root_s)
        return (ok_d and ok_h, bits_d + bits_h), extra

    def _update_rates(self, key, n_dev, n_host, t0, t_disp, t_host, t_wait, t_dev,
                      card_root_s=0.0):
        """EMA the rate model from this call. The host share ran alone in
        [t_disp, t_host], after ``card_root_s`` seconds of a root on the
        card. The device wall is observable only when the device was the
        straggler (collect(), entered at t_wait, blocked) and no root shared
        the card with it; otherwise nothing about it is learned. A program's
        first dispatch is left out too: it may carry the kernel build."""
        alpha = 0.3
        host_ms = (t_host - t_disp - card_root_s) * 1000
        dev_ms = (t_dev - t0) * 1000
        warm_key = (*key, self._n_dev)
        first_use = warm_key not in self._warmed
        self._warmed.add(warm_key)
        self.last_timing = {
            "n_dev": n_dev,
            "mesh_devices": self._n_dev,
            "n_host": n_host,
            "pack_dispatch_ms": round((t_disp - t0) * 1000, 2),
            "host_msm_ms": round(host_ms, 2),
            "overlap_extra_ms": round((t_wait - t_host) * 1000, 2),
            "dev_wait_ms": round((t_dev - t_wait) * 1000, 2),
            "dev_wall_ms": round(dev_ms, 2),
            "total_ms": round((t_dev - t0) * 1000, 2),
            "first_use": first_use,
            "bias": self._bias,
        }
        if card_root_s:
            self.last_timing["card_root_ms"] = round(card_root_s * 1000, 2)
        with self._rate_lock:
            if host_ms > 1:
                r = min(max(n_host / host_ms, 5.0), 5000.0)
                self._host_rate += alpha * (r - self._host_rate)
            if card_root_s:
                return  # the root's launches and sync shared the card's wall
            straggler = t_dev - t_wait > 0.001
            if straggler and not first_use and dev_ms > self._dev_overhead:
                # The learned rate stays a card's (the mesh's over its width).
                r = n_dev / (dev_ms - self._dev_overhead) / self._n_dev
                r = min(max(r, 5.0), 5000.0)
                self._dev_rate += alpha * (r - self._dev_rate)
                wall_key = (key[0], self._n_dev)
                prev = self._dev_wall.get(wall_key, dev_ms)
                self._dev_wall[wall_key] = prev + alpha * (dev_ms - prev)
            wait_ms = (t_dev - t_wait) * 1000
            if n_host == 0:
                # An all-device call says nothing of an idle tier: decay
                # toward the model's choice, so that no extreme absorbs.
                self._decay_bias()
            elif not first_use:
                if not straggler:
                    self._bias = min(self._bias + 1, 3)  # the device sat idle
                elif wait_ms > 0.2 * max(dev_ms, 1.0):
                    self._bias = max(self._bias - 1, -3)  # the device lagged

    def _decay_bias(self):
        if self._bias > 0:
            self._bias -= 1
        elif self._bias < 0:
            self._bias += 1

    def _root_on_card(self, n: int) -> bool:
        """Whether a root of n leaves goes to the card: its predicted time
        (the fixed cost plus n over the card's leaf rate) under the native
        tree's (n over the host's leaf rate), or the native library is not
        built yet. A small tree, where the fixed cost dominates, stays on
        the host."""
        if self._native.ready() is None:
            return True
        return self._root_fixed + n / self._card_leaf_rate < n / self._host_leaf_rate

    def merkle_root(self, leaves):
        if self._root_on_card(len(leaves)):
            self.last_root = "card"
            return self._torch.merkle_root(leaves)
        self.last_root = "host"
        return self._native.merkle_root(leaves)

    def mesh_width(self) -> int:
        return self._n_dev

    def verify_and_root(self, pubs, msgs, sigs, leaves):
        """A commit's verification and its block's root together. A root on
        the card is launched right after the device share, behind it on the
        card; a root on the host runs after the host's MSM share, while the
        device share is in flight. Returns ((ok, bitmap), root)."""
        n = len(pubs)
        if n == 0:
            return (False, []), self.merkle_root(leaves)
        if n < self._min_split or self._native.ready() is None:
            return self.batch_verify(pubs, msgs, sigs), self.merkle_root(leaves)
        if self._root_on_card(len(leaves)):
            self.last_root = "card"
            return self._routed_call(pubs, msgs, sigs, self._plan(n),
                                     on_card=lambda: self._torch.merkle_root(leaves))
        self.last_root = "host"
        return self._routed_call(pubs, msgs, sigs, self._plan(n),
                                 between=lambda: self._native.merkle_root(leaves))

    def warmup(self, buckets=None, merkle_leaves=None) -> None:
        """Build the native library (raises if gcc fails), warm the card
        (``TorchBackend.warmup``), then time one all-device call at each
        bucket (``ed25519_kernel.WARM_BUCKETS`` by default) as the model's
        wall there. ``_plan`` prices a bucket it has seen by its wall and
        one it has not from the walls around it; with one commit's wall
        alone it extrapolates down by the learned rate, which prices a
        small batch far above the card's fixed cost. Last, it times one root
        each way at each of ``merkle_leaves`` (``ed25519_kernel.WARM_LEAVES``
        by default) as the root cost model (``_time_roots``)."""
        self._native.load()
        self._torch.warmup(buckets, merkle_leaves)
        msg = b"\x00" * 120  # two SHA-512 blocks, as a vote
        for b in buckets or self._ek.WARM_BUCKETS:
            b = self._ek.bucket_for(b, self._n_dev)
            t0 = time.perf_counter()
            collect = self._ek.batch_verify_submit(
                [b"\x00" * 32] * b, [msg] * b, [b"\x00" * 64] * b, device=self.device)
            collect()
            wall = (time.perf_counter() - t0) * 1000
            with self._rate_lock:
                self._dev_wall[(collect.program_key[0], self._n_dev)] = wall
                self._warmed.add((*collect.program_key, self._n_dev))
        self._time_roots(merkle_leaves or self._ek.WARM_LEAVES)

    def _time_roots(self, counts) -> None:
        """Roots on the card and on the native tree at each leaf count, the
        least of 3 each: the host's leaf rate from the largest tree; the
        card's fixed cost and leaf rate from the line through the smallest
        and the largest (from the largest alone over the fixed cost it has,
        for one count)."""
        card, host = {}, {}
        for n in sorted(set(counts)):
            leaves = [b"\x00"] * n
            card[n] = host[n] = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                self._torch.merkle_root(leaves)
                t1 = time.perf_counter()
                self._native.merkle_root(leaves)
                t2 = time.perf_counter()
                card[n] = min(card[n], (t1 - t0) * 1000)
                host[n] = min(host[n], (t2 - t1) * 1000)
        lo, hi = min(card), max(card)
        self._host_leaf_rate = hi / max(host[hi], 1e-3)
        slope = (card[hi] - card[lo]) / (hi - lo) if hi > lo else 0.0
        if slope > 0:
            self._card_leaf_rate = 1.0 / slope
            self._root_fixed = max(card[lo] - lo * slope, 0.0)
        else:
            self._card_leaf_rate = hi / max(card[hi] - self._root_fixed, 1e-3)


class LockedBackend(VerifyBackend):
    """Serializes every device call of a wrapped backend behind one lock.

    The sidecar server puts this under its coalescing scheduler: the
    scheduler's one dispatcher merges requests from many connections into
    one dispatch, and the lock keeps one caller on the card at a time for
    the calls that bypass the scheduler (roots, warm-up)."""

    def __init__(self, inner: VerifyBackend, lock: threading.Lock):
        self.inner = inner
        self.name = getattr(inner, "name", "device")
        self._device_lock = lock

    def batch_verify(self, pubs, msgs, sigs):
        with self._device_lock:
            return self.inner.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        with self._device_lock:
            return self.inner.merkle_root(leaves)

    def mesh_width(self) -> int:
        mw = getattr(self.inner, "mesh_width", None)
        return int(mw()) if mw is not None else 1


DEVICE_CHOICES = ("torch", "hybrid", "cpu")


def device_backend(choice: str = "torch") -> VerifyBackend:
    """The sidecar's device tier: ``torch`` is ``TorchBackend()`` on
    ``cuda`` (raises without a card), ``hybrid`` is ``HybridBackend()`` (the
    card and the native host MSM; raises without a card), ``cpu`` the plain
    PyTorch path, only when asked for. Nothing falls back to the CPU on its
    own."""
    if choice == "torch":
        return TorchBackend()
    if choice == "hybrid":
        return HybridBackend()
    if choice == "cpu":
        return TorchBackend(device="cpu")
    raise ValueError(f"unknown sidecar device {choice!r}; expected one of {DEVICE_CHOICES}")


BACKEND_CHOICES = ("auto", "grpc", "torch", "hybrid", "cpu")

_backend: VerifyBackend | None = None
# Whether _backend was built here (then set_backend closes it) or installed.
_built_here = False
_lock = threading.Lock()


def _hybrid_tier(chain) -> HybridBackend | None:
    """The chain's hybrid tier, unwrapped from a fault-injection wrapper."""
    for tier in chain.tiers:
        b = tier.backend
        while not isinstance(b, HybridBackend) and getattr(b, "inner", None) is not None:
            b = b.inner
        if isinstance(b, HybridBackend):
            return b
    return None


def _make_backend() -> VerifyBackend:
    """The process default that ``CMTPU_BACKEND`` names (the reference's
    choices, with ``torch`` for the device tier):

    - ``auto`` (the default): the supervised chain (``build_resilient()``:
      ``[fanout ->] [grpc ->] hybrid -> cpu``) behind a
      ``CoalescingScheduler``, or bare under ``CMTPU_COALESCE=0``. Its hybrid
      tier is warmed here (``HybridBackend.warmup``: the kernels, the card's
      walls at the warm buckets, the root cost model), so that the first
      small batch is priced from measured walls; the stall is paid once, at
      the first ``get_backend()``. Without a card it raises, as
      ``build_resilient()`` does;
    - ``grpc``: the port's ``GrpcBackend`` to ``CMTPU_SIDECAR_ADDR``;
    - ``torch``: ``TorchBackend()``; ``hybrid``: ``HybridBackend()`` (both
      raise without a card);
    - ``cpu``: ``CpuBackend()``, the host anchor.

    ``tpu`` raises: the port's device tier is ``torch``."""
    choice = os.environ.get("CMTPU_BACKEND", "auto").lower()
    if choice == "tpu":
        raise ValueError("CMTPU_BACKEND=tpu names the JAX package's TPU tier; "
                         "the port's device tier is CMTPU_BACKEND=torch")
    if choice not in BACKEND_CHOICES:
        raise ValueError(f"unknown CMTPU_BACKEND {choice!r}; expected one of {BACKEND_CHOICES}")
    if choice == "grpc":
        from cometbft_tpu_torch.sidecar.service import GrpcBackend

        return GrpcBackend(os.environ.get("CMTPU_SIDECAR_ADDR", "127.0.0.1:26670"))
    if choice == "torch":
        return TorchBackend()
    if choice == "hybrid":
        return HybridBackend()
    if choice == "cpu":
        return CpuBackend()
    from cometbft_tpu_torch.sidecar.supervisor import build_resilient

    chain = build_resilient()
    hybrid = _hybrid_tier(chain)
    if hybrid is not None:
        try:
            hybrid.warmup()
        except BaseException:
            chain.close()
            raise
    if os.environ.get("CMTPU_COALESCE", "1") == "0":
        return chain
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler

    return CoalescingScheduler(chain)


def get_backend() -> VerifyBackend:
    """The process-wide backend: ``_make_backend()``'s on first use, unless
    one was installed with ``set_backend``."""
    global _backend, _built_here
    if _backend is None:
        with _lock:
            if _backend is None:
                _backend = _make_backend()
                _built_here = True
    return _backend


def set_backend(backend: VerifyBackend | None) -> None:
    """Override the process-wide backend (tests, node bootstrap). A default
    that ``get_backend`` built is closed (the scheduler's dispatcher thread,
    the chain's sockets); an installed one is left to its owner."""
    global _backend, _built_here
    with _lock:
        old, owned = _backend, _built_here
        _backend, _built_here = backend, False
    if owned and old is not None and old is not backend:
        close = getattr(old, "close", None)
        if close is not None:
            close()
