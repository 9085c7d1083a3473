"""The port's ``HybridBackend``: the card and the native host MSM working one
batch at once, run here as ``HybridBackend(device="cpu")`` (the device share
on the plain PyTorch path). Held to the reference: the planner's decisions
equal ``cometbft_tpu.sidecar.backend.HybridBackend._plan``'s over a grid of
batch sizes and rate/wall/bias states; the bitmaps at every forced share
(all host, a split, all device) equal the reference native verifier's;
``verify_and_root``'s root equals ``hash_from_byte_slices``; the device
share's program key equals the reference packer's bucket pair. The cases of
``tests/test_hybrid.py`` are mirrored one for one."""

from __future__ import annotations

import threading

import pytest

from cometbft_tpu import native as ref_native
from cometbft_tpu.crypto import ed25519
from cometbft_tpu.crypto.merkle import hash_from_byte_slices
from cometbft_tpu.ops import ed25519_kernel as ref_ek
from cometbft_tpu.sidecar import backend as ref_be
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.sidecar import backend as be

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain device path is thousands of small tensor operations: one
    thread runs them faster than eight, and leaves the cores to the other
    test workers (eight threads a worker under -n 6 oversubscribe them)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(n, tag=b"hyb"):
    pvs = [ed25519.gen_priv_key_from_secret(tag + b"-%d" % i) for i in range(n)]
    pubs = [pv.pub_key().bytes() for pv in pvs]
    msgs = [b"hybrid-msg-%d" % i for i in range(n)]
    sigs = [pv.sign(m) for pv, m in zip(pvs, msgs)]
    return pubs, msgs, sigs


def _env(monkeypatch, min_split=8, dev_rate=1000.0, host_rate=1000.0):
    monkeypatch.setenv("CMTPU_HYBRID_MIN", str(min_split))
    monkeypatch.setenv("CMTPU_DEV_RATE", str(dev_rate))
    monkeypatch.setenv("CMTPU_HOST_RATE", str(host_rate))
    monkeypatch.setenv("CMTPU_DEV_OVERHEAD_MS", "0")


def _hybrid(monkeypatch, **kw):
    _env(monkeypatch, **kw)
    hb = be.HybridBackend(device="cpu")
    assert hb._n_dev == 1 and hb.device.type == "cpu"
    return hb


def _ref_hybrid(monkeypatch, **kw):
    """The reference's HybridBackend under the same knobs, priced at one
    chip (its conftest mesh has 8 virtual devices)."""
    _env(monkeypatch, **kw)
    hb = ref_be.HybridBackend()
    hb._n_dev = 1
    return hb


@pytest.fixture(scope="module", autouse=True)
def native_built():
    """Both libraries built before any hybrid plans (the hybrid routes to
    the device alone while its native library builds)."""
    from cometbft_tpu_torch import native

    native.load()
    ref_native._load()


def test_plan_picks_interior_bucket(monkeypatch):
    hb = _hybrid(monkeypatch)
    # Equal rates, no overhead: 48 splits at bucket 32 (host 16), not all
    # device padded to 128 and not all host.
    assert hb._plan(48) == 32 == _ref_hybrid(monkeypatch)._plan(48)


def test_split_batch_all_valid(monkeypatch):
    hb = _hybrid(monkeypatch)
    pubs, msgs, sigs = _batch(48)
    assert hb.batch_verify(pubs, msgs, sigs) == (True, [True] * 48)
    assert hb.last_share == 32


def test_split_batch_bitmap_exact_across_boundary(monkeypatch):
    hb = _hybrid(monkeypatch)
    pubs, msgs, sigs = _batch(48)
    # One bad signature in the device share, one in the host share, and a
    # tampered message right at the split (index 32).
    bad = {3, 32, 45}
    sigs[3] = sigs[3][:-1] + bytes([sigs[3][-1] ^ 1])
    msgs[32] = msgs[32] + b"!"
    sigs[45] = b"\x00" * 64
    ok, bits = hb.batch_verify(pubs, msgs, sigs)
    assert not ok
    assert [i for i, b in enumerate(bits) if not b] == sorted(bad)
    assert (ok, bits) == ref_native.batch_verify(pubs, msgs, sigs)


@pytest.mark.parametrize("share", [0, 8, 32, 48])
def test_forced_shares_match_reference(monkeypatch, share):
    """Every forced share gives the reference native verifier's bitmap, on
    a commit whose bad indices fall on both sides of the split."""
    hb = _hybrid(monkeypatch)
    pubs, msgs, sigs = _batch(48, tag=b"forced")
    sigs[5] = sigs[5][:40] + bytes([sigs[5][40] ^ 8]) + sigs[5][41:]
    sigs[40] = sigs[40][:32] + (ek.L + 3).to_bytes(32, "little")
    msgs[47] = b"tampered"
    (ok, bits), extra = hb._routed_call(pubs, msgs, sigs, share)
    assert extra is None and hb.last_share == share
    assert (ok, bits) == ref_native.batch_verify(pubs, msgs, sigs)
    assert [i for i, b in enumerate(bits) if not b] == [5, 40, 47]


def test_small_batch_routes_host(monkeypatch):
    hb = _hybrid(monkeypatch, min_split=64)
    hb._torch.batch_verify = lambda *a: pytest.fail("the device tier must not run")
    monkeypatch.setattr(ek, "batch_verify_submit", lambda *a, **k: pytest.fail("no device share"))
    pubs, msgs, sigs = _batch(24)
    assert hb.batch_verify(pubs, msgs, sigs) == (True, [True] * 24)


def _default_hybrid(monkeypatch):
    for name in ("CMTPU_HYBRID_MIN", "CMTPU_DEV_RATE", "CMTPU_HOST_RATE", "CMTPU_DEV_OVERHEAD_MS"):
        monkeypatch.delenv(name, raising=False)
    return be.HybridBackend(device="cpu")


def test_default_plans_every_batch(monkeypatch):
    """Unset, CMTPU_HYBRID_MIN leaves every batch to the planner, which
    starts from the card's measured seeds: the card takes a share from 83
    signatures, a commit of 150 splits at the 128 bucket, 1,024 go all to
    the card, and one signature stays on the host."""
    hb = _default_hybrid(monkeypatch)
    assert hb._min_split == 0
    assert (hb._dev_rate, hb._host_rate, hb._dev_overhead) == (
        be.CARD_SIGS_PER_MS, be.HOST_SIGS_PER_MS, be.CARD_DISPATCH_MS)
    assert next(n for n in range(1, 2049) if hb._plan(n) > 0) == 83
    assert [hb._plan(n) for n in (1, 40, 150, 1024)] == [0, 0, 128, 1024]


def test_default_host_share_is_the_native_msm(monkeypatch):
    """A batch the planner leaves to the host runs the native MSM, under 16
    signatures too (the anchor's per-signature pure Python is no host
    share), with the reference native verifier's bitmap."""
    hb = _default_hybrid(monkeypatch)
    monkeypatch.setattr(be.ed25519_pure, "verify_zip215", lambda *a: pytest.fail("pure Python ran"))
    monkeypatch.setattr(ek, "batch_verify_submit", lambda *a, **k: pytest.fail("no device share"))
    pubs, msgs, sigs = _batch(4, tag=b"few")
    sigs[2] = b"\x00" * 64
    got = hb.batch_verify(pubs, msgs, sigs)
    assert got == ref_native.batch_verify(pubs, msgs, sigs) == (False, [True, True, False, True])
    assert hb.last_share == 0


def test_default_commit_of_150_splits_with_the_card(monkeypatch):
    """A commit of a typical validator set is no longer all host: 128 on
    the card, 22 on the native MSM, the bitmap exact on both sides."""
    hb = _default_hybrid(monkeypatch)
    pubs, msgs, sigs = _batch(150, tag=b"c150")
    sigs[7] = sigs[7][:-1] + bytes([sigs[7][-1] ^ 1])
    msgs[140] = msgs[140] + b"!"
    ok, bits = hb.batch_verify(pubs, msgs, sigs)
    assert hb.last_share == 128
    assert (ok, bits) == ref_native.batch_verify(pubs, msgs, sigs)
    assert [i for i, b in enumerate(bits) if not b] == [7, 140]


def test_warmup_times_the_card_at_each_bucket(monkeypatch):
    """warmup leaves a measured wall (and a warmed program key) at each
    bucket it is given, on top of the walls the model already holds."""
    hb = _default_hybrid(monkeypatch)
    hb._dev_wall = {(10240, 1): 13.9}
    hb.warmup(buckets=(5, 32))
    assert set(hb._dev_wall) == {(8, 1), (32, 1), (10240, 1)}
    assert hb._dev_wall[(8, 1)] > 0 and hb._dev_wall[(32, 1)] > 0
    assert {(8, 2, 1), (32, 2, 1)} <= hb._warmed


def test_warmup_measures_both_sides_of_a_small_plan(monkeypatch):
    """warmup times WARM_TIMINGS all-device calls at each bucket and keeps
    the least as its wall, then times the native MSM at the smallest
    bucket's size and keeps the least as the host's rate. On a slow host
    (a 128-lane card call of 3.5 ms, its pack included) the seeded host
    rate would leave 150 signatures all to the host for good; measured, the
    host is slower too and the card takes the 128 bucket. One slow sample
    (the first at 128) does not set a wall."""
    hb = _default_hybrid(monkeypatch)
    submitted, hosted = [], []

    def submit(pubs, msgs, sigs, device=None):
        submitted.append(len(pubs))

        def collect():
            return True, [True] * len(pubs)

        collect.program_key = (len(pubs), 2)
        return collect

    class Native:
        @staticmethod
        def load():
            pass

        @staticmethod
        def batch_verify(pubs, msgs, sigs):
            hosted.append(len(pubs))
            return True, [True] * len(pubs)

    # Two clock reads a timing: the card at 128 (9.0, 3.5, 4.0 ms) and at
    # 1024 (6.0, 5.0, 5.5 ms), then the host at 128 (8.0, 6.0, 7.0 ms).
    ticks = iter([0.0, 0.009, 1.0, 1.0035, 2.0, 2.004, 3.0, 3.006, 4.0, 4.005, 5.0, 5.0055,
                  6.0, 6.008, 7.0, 7.006, 8.0, 8.007])
    monkeypatch.setattr(hb._ek, "batch_verify_submit", submit)
    monkeypatch.setattr(hb._torch, "warmup", lambda *a: None)
    monkeypatch.setattr(hb, "_time_roots", lambda counts: None)
    monkeypatch.setattr(hb, "_native", Native)
    monkeypatch.setattr(be, "time", type("Clock", (), {"perf_counter": staticmethod(
        lambda: next(ticks))}))
    hb._dev_wall = {(10240, 1): 24.0}
    hb.warmup(buckets=(1024, 128))
    assert be.WARM_TIMINGS == 3
    assert submitted == [128] * 3 + [1024] * 3 and hosted == [128] * 3
    assert hb._dev_wall[(128, 1)] == pytest.approx(3.5)
    assert hb._dev_wall[(1024, 1)] == pytest.approx(5.0)
    assert hb._host_rate == pytest.approx(128 / 6.0)
    assert hb._plan(150) == 128
    hb._host_rate = be.HOST_SIGS_PER_MS
    assert hb._plan(150) == 0


def test_walls_around_a_commit_price_it_with_the_card(monkeypatch):
    """With one commit's wall alone the planner extrapolates down by the
    learned rate and leaves 150 signatures to the host; with the walls a
    warmup measures around it, it gives the card the 128 bucket. The walls
    and rates are those of an H100 run of chip_smoke.py's hybrid phase."""
    hb = _default_hybrid(monkeypatch)
    hb._dev_rate, hb._host_rate = 3379.6, 41.1
    hb._dev_wall = {(10240, 1): 13.94}
    assert hb._plan(150) == 0
    hb._dev_wall.update({(128, 1): 1.25, (1024, 1): 2.01})
    assert [hb._plan(n) for n in (1, 150, 1024, 10240)] == [0, 128, 1024, 10240]


def test_native_missing_falls_back_to_device(monkeypatch):
    hb = _hybrid(monkeypatch)

    class _NoNative:
        @staticmethod
        def ready():
            return None

    hb._native = _NoNative()
    called = {}

    def _fake_dev(p, m, s):
        called["n"] = len(p)
        return True, [True] * len(p)

    hb._torch.batch_verify = _fake_dev
    pubs, msgs, sigs = _batch(12)
    ok, _ = hb.batch_verify(pubs, msgs, sigs)
    assert ok and called["n"] == 12


def test_verify_and_root_overlap(monkeypatch):
    hb = _hybrid(monkeypatch)
    pubs, msgs, sigs = _batch(48)
    leaves = [b"leaf-%d" % i for i in range(100)]
    (ok, bits), root = hb.verify_and_root(pubs, msgs, sigs, leaves)
    assert ok and all(bits) and hb.last_share == 32
    assert root == hash_from_byte_slices(leaves) == hb.merkle_root(leaves)


def test_rate_ema_stays_clamped(monkeypatch):
    hb = _hybrid(monkeypatch)
    pubs, msgs, sigs = _batch(48)
    for _ in range(3):
        hb.batch_verify(pubs, msgs, sigs)
    assert 5.0 <= hb._dev_rate <= 5000.0
    assert 5.0 <= hb._host_rate <= 5000.0


def test_sidecar_env_selects_hybrid(monkeypatch):
    """CMTPU_SIDECAR_DEVICE=hybrid builds the hybrid: on a host without a
    card it raises (no fallback); with the card's place taken by the CPU it
    serves."""
    from cometbft_tpu_torch.sidecar.service import SidecarServer

    import torch

    assert "hybrid" in be.DEVICE_CHOICES
    monkeypatch.setenv("CMTPU_SIDECAR_DEVICE", "hybrid")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SidecarServer("127.0.0.1:0")

    class CpuHybrid(be.HybridBackend):
        def __init__(self):
            super().__init__(device="cpu")

    monkeypatch.setattr(be, "HybridBackend", CpuHybrid)
    server = SidecarServer("127.0.0.1:0")
    try:
        assert server.backend.name == "hybrid" and isinstance(server.backend, CpuHybrid)
    finally:
        server.shutdown()


def test_all_device_path_feeds_model_and_decays_bias(monkeypatch):
    """All-device calls keep updating the model and decay the bias, so a
    bias-climbed all-device plan is no absorbing state."""
    hb = _hybrid(monkeypatch, dev_rate=5000.0, host_rate=5.0)
    hb._bias = 3
    pubs, msgs, sigs = _batch(48)
    assert hb._plan(48) >= 48  # the model says all device
    assert hb.batch_verify(pubs, msgs, sigs) == (True, [True] * 48)
    assert hb.last_share == 48
    assert hb._bias == 2  # decayed, not frozen
    # The first call was the program's first use; the second records a
    # device wall for the bucket.
    hb.batch_verify(pubs, msgs, sigs)
    assert hb._bias == 1
    assert (ek.bucket_for(48, 1), hb._n_dev) in hb._dev_wall


def test_small_batches_do_not_touch_controller(monkeypatch):
    hb = _hybrid(monkeypatch, min_split=64)
    hb._bias = 2
    pubs, msgs, sigs = _batch(16)
    assert hb.batch_verify(pubs, msgs, sigs) == (True, [True] * 16)
    assert hb._bias == 2 and hb._dev_wall == {}


def test_multi_device_routing_shards_the_device_share(monkeypatch):
    """With a width of 8 (virtual CPU shards), the hybrid's device share
    routes over the lane-split program with the exact bitmap; a spy shows
    the sharded program ran."""
    monkeypatch.setattr(ek, "mesh_width", lambda device=None: 8)
    sh = ek._sharded_verify("cpu")
    assert sh is not None and sh[0] == 8
    called = {}

    def spy(*ops):
        called["sharded"] = True
        return sh[1](*ops)

    monkeypatch.setattr(ek, "_sharded_verify", lambda device: (sh[0], spy))
    _env(monkeypatch, dev_rate=5000.0, host_rate=5.0)
    hb = be.HybridBackend(device="cpu")
    assert hb.mesh_width() == 8
    pubs, msgs, sigs = _batch(48, tag=b"mdev")
    sigs[7] = b"\x00" * 64
    msgs[40] = msgs[40] + b"x"
    ok, bits = hb.batch_verify(pubs, msgs, sigs)
    assert hb.last_share == 48
    assert not ok and [i for i, b in enumerate(bits) if not b] == [7, 40]
    assert called.get("sharded"), "the device share did not route over the mesh"


def test_plan_snapshots_dev_wall_under_rate_lock(monkeypatch):
    """_plan races _update_rates, which inserts wall keys from
    straggler-collect threads under _rate_lock: the plan works from a
    locked snapshot and never sees the dict change size."""
    hb = _hybrid(monkeypatch)
    stop = threading.Event()
    failures = []

    def writer():
        k = 0
        while not stop.is_set():
            k += 1
            with hb._rate_lock:
                hb._dev_wall[(128 * (k % 64 + 1), 1)] = 1.0 + (k % 7)
                if k % 5 == 0:
                    hb._dev_wall.pop((128 * ((k * 31) % 64 + 1), 1), None)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        for _ in range(2000):
            try:
                share = hb._plan(4096)
            except RuntimeError as e:
                failures.append(e)
                break
            assert share >= 0
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    assert not failures, f"_plan raced the rate model: {failures[0]}"


def test_plan_prices_mesh_as_one_large_device(monkeypatch):
    """Symmetric rates split a batch evenly at one card; a width of 8 is
    priced as one 8x-faster device and takes ~8/9 of it, as the
    reference's planner does."""
    hb = _hybrid(monkeypatch, dev_rate=100.0, host_rate=100.0)
    ref = _ref_hybrid(monkeypatch, dev_rate=100.0, host_rate=100.0)
    assert hb._plan(9216) == ref._plan(9216) == 4096
    hb._n_dev = ref._n_dev = 8
    assert hb._plan(9216) == ref._plan(9216) == 8192


def test_dev_walls_keyed_by_mesh_width(monkeypatch):
    """A wall seen at one width does not apply at another."""
    hb = _hybrid(monkeypatch, dev_rate=100.0, host_rate=100.0)
    with hb._rate_lock:
        hb._dev_wall[(8192, 1)] = 1e9  # a poisoned one-card wall
    hb._n_dev = 8
    assert hb._plan(9216) == 8192  # the width-1 wall does not apply
    hb._n_dev = 1
    assert hb._plan(9216) == 0  # at width 1 it routes all host


def test_warm_keys_include_mesh_width(monkeypatch):
    """A first dispatch at a new width is a first use, even when the same
    (batch, block) program ran at another width."""
    hb = _hybrid(monkeypatch)
    ts = (0.0, 0.001, 0.002, 0.002, 0.050)
    hb._update_rates((128, 2), 128, 0, *ts)
    assert hb.last_timing["first_use"]
    hb._update_rates((128, 2), 128, 0, *ts)
    assert not hb.last_timing["first_use"]
    hb._n_dev = 8
    hb._update_rates((128, 2), 128, 0, *ts)
    assert hb.last_timing["first_use"], "a width change re-warms"


def test_update_rates_matches_reference(monkeypatch):
    """The same measured call sequence moves both models the same way:
    rates, walls, bias and the stage record."""
    hb = _hybrid(monkeypatch, dev_rate=300.0, host_rate=80.0)
    ref = _ref_hybrid(monkeypatch, dev_rate=300.0, host_rate=80.0)
    calls = [
        ((1024, 2), 1024, 3072, (0.0, 0.002, 0.030, 0.030, 0.036)),  # device straggles
        ((1024, 2), 1024, 3072, (0.0, 0.002, 0.030, 0.030, 0.045)),
        ((1024, 2), 1024, 3072, (0.0, 0.002, 0.040, 0.040, 0.0405)),  # device idle
        ((4096, 2), 4096, 0, (0.0, 0.003, 0.003, 0.003, 0.020)),
        ((4096, 2), 4096, 0, (0.0, 0.003, 0.003, 0.003, 0.018)),
        ((512, 4), 512, 100, (0.0, 0.001, 0.005, 0.005, 0.0052)),
    ]
    for key, n_dev, n_host, ts in calls:
        hb._update_rates(key, n_dev, n_host, *ts)
        ref._update_rates(key, n_dev, n_host, *ts)
        assert hb.last_timing == ref.last_timing
        assert (hb._dev_rate, hb._host_rate, hb._bias) == (ref._dev_rate, ref._host_rate, ref._bias)
        assert hb._dev_wall == ref._dev_wall
        assert all(hb._plan(n) == ref._plan(n) for n in (2048, 5000, 10240, 40000))


_GRID_N = (8, 9, 31, 48, 100, 1000, 2048, 2049, 4096, 6000, 9216, 10240, 20000, 40000)
_GRID_STATES = [
    # (dev_rate, host_rate, overhead_ms, walls {(bucket, width): ms}, bias, width)
    (1000.0, 1000.0, 0.0, {}, 0, 1),
    (100.0, 70.0, 8.0, {}, 0, 1),
    (900.0, 60.0, 2.5, {}, 1, 1),
    (900.0, 60.0, 2.5, {}, -2, 1),
    (5000.0, 5.0, 0.0, {}, 3, 1),
    (5.0, 5000.0, 0.0, {}, -3, 1),
    (100.0, 100.0, 0.0, {}, 0, 8),
    (300.0, 80.0, 1.0, {(10240, 1): 14.0}, 0, 1),
    (300.0, 80.0, 1.0, {(1024, 1): 3.0, (10240, 1): 14.0}, 0, 1),
    (300.0, 80.0, 1.0, {(1024, 1): 3.0, (10240, 1): 2.0, (4096, 1): 9.0}, 2, 1),
    (300.0, 80.0, 1.0, {(8192, 8): 4.0, (8192, 1): 1e9}, 0, 8),
    (300.0, 80.0, 6.0, {(512, 1): 0.5}, -1, 1),
]


@pytest.mark.parametrize("state", range(len(_GRID_STATES)))
def test_plan_matches_reference_over_grid(monkeypatch, state):
    """_plan equals the reference's for every batch size of the grid, in
    each rate, wall, bias and width state."""
    dev_rate, host_rate, overhead, walls, bias, width = _GRID_STATES[state]
    hb = _hybrid(monkeypatch)
    ref = _ref_hybrid(monkeypatch)
    for h in (hb, ref):
        h._dev_rate, h._host_rate, h._dev_overhead = dev_rate, host_rate, overhead
        h._dev_wall = dict(walls)
        h._bias, h._n_dev = bias, width
    got = [hb._plan(n) for n in _GRID_N]
    assert got == [ref._plan(n) for n in _GRID_N]
    assert all(0 <= g <= max(n, max(ek.BUCKETS)) for g, n in zip(got, _GRID_N))


def test_program_key_matches_reference_packer(monkeypatch):
    """The device share's collect() carries (batch bucket, block bucket),
    the reference packer's key for the same batch; the model uses it to
    leave a program's first launch out."""
    pubs, msgs, sigs = _batch(20, tag=b"key")
    msgs[3] = b"m" * 300  # three SHA-512 blocks: block bucket 4
    collect = ek.batch_verify_submit(pubs, msgs, sigs, device="cpu")
    assert collect.program_key == ref_ek._bucket_key(ref_ek.pack_batch(pubs, msgs, sigs)[0])
    assert collect.program_key == (32, 4)
    ok, bits = collect()
    assert bits == [i != 3 for i in range(20)] and not ok


def test_hybrid_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        be.HybridBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        be.device_backend("hybrid")
