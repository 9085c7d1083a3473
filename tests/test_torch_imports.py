"""Boundaries of the port: it imports neither jax nor the JAX package (the
native loader, the supervisor, chaos, the fleet tier, the BN254 chain, the
tooling, the types, commit verification, blocksync, the light client,
evidence, sigbatch and the RPC codec included), it never falls back to the
CPU when CUDA is asked for (the hybrid tier and the chains neither), and a
missing CUDA compiler is an error, not a silent switch to the plain
versions."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cometbft_tpu_torch
from cometbft_tpu_torch import device
from cometbft_tpu_torch.crypto import bn254_pure
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import bn254_kernel as tbk
from cometbft_tpu_torch.ops import edwards as ted
from cometbft_tpu_torch.ops import ladder
from cometbft_tpu_torch.ops import merkle_kernel as tmk
from cometbft_tpu_torch.ops import multihost, sharded
from cometbft_tpu_torch.ops import sha512_kernel as ts5
from cometbft_tpu_torch.crypto.bn254 import build_bn254_chain
from cometbft_tpu_torch.sidecar.backend import TorchBackend, device_backend
from cometbft_tpu_torch.sidecar.supervisor import build_resilient

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]


def _modules():
    names = ["cometbft_tpu_torch"]
    for info in pkgutil.walk_packages(cometbft_tpu_torch.__path__, "cometbft_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_imports_without_jax():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter."""
    mods = _modules()
    assert "cometbft_tpu_torch.ops.ladder" in mods and len(mods) >= 20
    assert {"cometbft_tpu_torch.ops.bn254_kernel", "cometbft_tpu_torch.crypto.bn254_pure"} <= set(mods)
    assert {
        "cometbft_tpu_torch.wire.proto",
        "cometbft_tpu_torch.sidecar.engine",
        "cometbft_tpu_torch.sidecar.scheduler",
        "cometbft_tpu_torch.sidecar.service",
        "cometbft_tpu_torch.ops.sharded",
        "cometbft_tpu_torch.ops.multihost",
        "cometbft_tpu_torch.native",
        "cometbft_tpu_torch.sidecar.chaos",
        "cometbft_tpu_torch.sidecar.supervisor",
        "cometbft_tpu_torch.crypto.bn254",
        "cometbft_tpu_torch.sidecar.fanout",
        "cometbft_tpu_torch.libs.pprof",
        "cometbft_tpu_torch.entry",
        "cometbft_tpu_torch.probe.device",
        "cometbft_tpu_torch.crypto.tmhash",
        "cometbft_tpu_torch.crypto.ed25519",
        "cometbft_tpu_torch.crypto.encoding",
        "cometbft_tpu_torch.crypto.batch",
        "cometbft_tpu_torch.types",
        "cometbft_tpu_torch.types.cmttime",
        "cometbft_tpu_torch.types.block",
        "cometbft_tpu_torch.types.canonical",
        "cometbft_tpu_torch.types.vote",
        "cometbft_tpu_torch.types.validator",
        "cometbft_tpu_torch.types.validator_set",
        "cometbft_tpu_torch.types.light_block",
        "cometbft_tpu_torch.types.validation",
        "cometbft_tpu_torch.light",
        "cometbft_tpu_torch.light.verifier",
        "cometbft_tpu_torch.convert",
        "cometbft_tpu_torch.config",
        "cometbft_tpu_torch.types.params",
        "cometbft_tpu_torch.types.tx",
        "cometbft_tpu_torch.types.evidence",
        "cometbft_tpu_torch.types.part_set",
        "cometbft_tpu_torch.types.genesis",
        "cometbft_tpu_torch.types.results",
        "cometbft_tpu_torch.types.priv_validator",
        "cometbft_tpu_torch.libs.bit_array",
        "cometbft_tpu_torch.libs.db",
        "cometbft_tpu_torch.libs.fail",
        "cometbft_tpu_torch.wire.types",
        "cometbft_tpu_torch.state",
        "cometbft_tpu_torch.state.state",
        "cometbft_tpu_torch.state.validation",
        "cometbft_tpu_torch.state.store",
        "cometbft_tpu_torch.state.execution",
        "cometbft_tpu_torch.store",
        "cometbft_tpu_torch.abci",
        "cometbft_tpu_torch.abci.types",
        "cometbft_tpu_torch.abci.client",
        "cometbft_tpu_torch.abci.example.kvstore",
        "cometbft_tpu_torch.proxy",
        "cometbft_tpu_torch.mempool",
        "cometbft_tpu_torch.mempool.clist_mempool",
        "cometbft_tpu_torch.blocksync",
        "cometbft_tpu_torch.blocksync.pool",
        "cometbft_tpu_torch.blocksync.reactor",
        "cometbft_tpu_torch.p2p",
        "cometbft_tpu_torch.p2p.reactor",
        "cometbft_tpu_torch.light.store",
        "cometbft_tpu_torch.light.provider",
        "cometbft_tpu_torch.light.client",
        "cometbft_tpu_torch.light.detector",
        "cometbft_tpu_torch.light.mmr",
        "cometbft_tpu_torch.light.bundle",
        "cometbft_tpu_torch.light.origin",
        "cometbft_tpu_torch.light.gateway",
        "cometbft_tpu_torch.evidence",
        "cometbft_tpu_torch.evidence.verify",
        "cometbft_tpu_torch.evidence.pool",
        "cometbft_tpu_torch.evidence.reactor",
        "cometbft_tpu_torch.crypto.sigbatch",
        "cometbft_tpu_torch.rpc",
        "cometbft_tpu_torch.rpc.json_codec",
    } <= set(mods)
    from cometbft_tpu_torch.crypto import bn254

    assert bn254.PubKey.__module__ == "cometbft_tpu_torch.crypto.bn254"
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'cometbft_tpu' or k.startswith('cometbft_tpu.'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_blocksync_verifies_on_the_card_by_default(monkeypatch):
    """The blocksync path verifies through ``crypto/ed25519.BatchVerifier``
    and the process default (``get_backend()``, ``CMTPU_BACKEND=auto``):
    without a card that raises, it does not drop to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback path is not reachable")
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.sidecar import backend

    monkeypatch.delenv("CMTPU_BACKEND", raising=False)
    prev = backend._backend
    backend._backend = None
    try:
        bv = ed25519.BatchVerifier()
        bv.add(ed25519.PubKey(bytes(32)), b"never-cached", bytes(64))
        assert len(bv) == 1
        with pytest.raises(RuntimeError, match="CUDA"):
            bv.verify()
    finally:
        backend._backend = prev


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the no-fallback path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        tbk.Bn254DeviceBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        tbk.multi_miller_values([(bn254_pure.G1, bn254_pure.G2)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmk.proofs_from_byte_slices_device([b"a", b"b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        device_backend()
    with pytest.raises(RuntimeError, match="CUDA"):
        device_backend("hybrid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_resilient()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_bn254_chain()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.make_mesh(["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.distributed_init("tcp://127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmk.merkle_root_pow2(np.zeros((8, 2), np.uint32))
    assert TorchBackend(device="cpu").device.type == "cpu"
    assert tbk.Bn254DeviceBackend(device="cpu").device.type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "FALLBACK_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()


def test_wrappers_never_take_the_plain_path_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    meta = torch.device("meta")
    digits = torch.zeros((64, 4), dtype=torch.int32, device=meta)
    point = tuple(torch.zeros((17, 4), dtype=torch.int32, device=meta) for _ in range(4))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ladder.verify_lanes(digits, digits, torch.stack(point).repeat(1, 1, 2),
                            torch.zeros(8, dtype=torch.bool, device=meta))
    words = torch.zeros((8, 4), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        ted.decompress_words(words, words)
    with pytest.raises(ValueError, match="CUDA"):
        ts5.challenge_digits(
            torch.zeros((4, 64), dtype=torch.int32, device=meta),
            torch.zeros(4, dtype=torch.int32, device=meta),
            words,
        )
    with pytest.raises(ValueError, match="CUDA"):
        ts5.scalar_digits(torch.zeros((16, 4), dtype=torch.int32, device=meta), words)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.leaf_core(
            torch.zeros((1, 16, 4), dtype=torch.int32, device=meta),
            torch.zeros(4, dtype=torch.int32, device=meta),
        )
    with pytest.raises(ValueError, match="CUDA"):
        tmk.inner_core(point[0][:8], point[1][:8])
    with pytest.raises(ValueError, match="CUDA"):
        tmk.tree_root(torch.zeros(4, dtype=torch.uint8, device=meta),
                      torch.arange(5, dtype=torch.int64, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        tmk.tree_levels_raw(torch.zeros(4, dtype=torch.uint8, device=meta),
                            torch.arange(5, dtype=torch.int64, device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        tmk.digest_tree_root(point[0][:8])
    with pytest.raises(ValueError, match="CUDA"):
        tbk.miller_values(torch.zeros((8, 2, 13), dtype=torch.float64, device=meta),
                          *(torch.zeros((8, 2, 2, 13), dtype=torch.float64, device=meta)
                            for _ in range(3)))
    assert _build.LAUNCHES == before


def test_bn254_cuda_request_without_a_built_library_raises(monkeypatch, tmp_path):
    """With CUDA reported and no nvcc, the backend's ping says the kernel
    library cannot load, and a CUDA dispatch raises (here at the copy to
    the card this CPU build of PyTorch cannot make) instead of taking the
    plain version: no dispatch is counted and no launch."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "FALLBACK_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    backend = tbk.Bn254DeviceBackend()
    assert backend.device.type == "cuda"
    assert backend.ping() is False
    before, counts = dict(_build.LAUNCHES), tbk.counters()
    with pytest.raises((RuntimeError, AssertionError)):
        tbk.multi_miller_values([(bn254_pure.G1, bn254_pure.G2)], device="cuda")
    assert _build.LAUNCHES == before and tbk.counters() == counts


def test_cpu_wrappers_count_no_launches():
    before = dict(_build.LAUNCHES)
    tmk.merkle_root([b"a", b"b", b"c", b"d"], device="cpu")
    tmk.proofs_from_byte_slices_device([b"a", b"b", b"c"], device="cpu")
    tmk.digest_tree_root(torch.zeros((8, 5), dtype=torch.int32))
    tmk.merkle_root_fused([b"a", b"b"], device="cpu")
    assert _build.LAUNCHES == before
    tbk.miller_values(*tbk.operands_to_device(tbk._pack([(bn254_pure.G1, bn254_pure.G2)], 1), "cpu"))
    assert _build.LAUNCHES == before
    assert set(_build.LAUNCHES) == {"ladder", "decompress", "sha512", "sha256", "bn254"}


def test_every_kernel_source_is_built():
    srcs = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    assert srcs == ["bn254", "decompress", "ladder", "sha256", "sha512"]
    text = (_build.SRC_DIR / "ladder.cu").read_text()
    assert "cometbft_tpu/ops/pallas_ladder.py:_ladder_kernel" in text
    assert "cometbft_tpu/ops/bn254_kernel.py:352" in (_build.SRC_DIR / "bn254.cu").read_text()
    sha256 = (_build.SRC_DIR / "sha256.cu").read_text()
    assert "cometbft_tpu/ops/merkle_kernel.py:235" in sha256
    assert "cometbft_tpu/ops/merkle_kernel.py:214" in sha256
    assert "cmtpu_sha256_digest_tree" in sha256 and "cmtpu_sha256_digest_tree" in _build._SIGNATURES
