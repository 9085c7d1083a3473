"""The port's logger (``cometbft_tpu_torch/libs/log.py``) held to the JAX
package's on fixed records: the same plain and JSON lines, the same level
filter with per-module overrides, the same bound context and the same
level names. Modelled on the package's
``tests/test_libs_autofile_log.py::test_logger_plain_and_json_and_filter``;
both clocks are pinned, so the lines are equal byte for byte."""

import io
import json
import time

import pytest

from cometbft_tpu.libs import log as ref_log
from cometbft_tpu_torch import version
from cometbft_tpu_torch.libs import log

pytestmark = pytest.mark.torch_port

NOW = 1_760_000_000.123456

RECORDS = [
    ("debug", "hidden at info", {"h": 1}),
    ("info", "enterNewRound", {"h": 5, "r": 0}),
    ("info", "", {}),
    ("error", "bad thing", {"err": "boom", "raw": b"\x01\x02\xff" * 8}),
    ("info", "a message longer than the forty-four columns of the plain format",
     {"module": "p2p", "peer": "ab" * 20}),
    ("debug", "loud", {"module": "statesync", "y": 2.5, "none": None, "ok": True}),
    ("error", "object values", {"obj": ValueError("x"), "t": (1, 2)}),
]


def _emit(mod, fmt: str, level: str, module_levels=None, bind=None) -> str:
    buf = io.StringIO()
    logger = mod.new_logger(buf, fmt=fmt, level=level, module_levels=module_levels)
    if bind:
        logger = logger.with_(**bind)
    for lvl, msg, kv in RECORDS:
        getattr(logger, lvl)(msg, **kv)
    return buf.getvalue()


@pytest.fixture(autouse=True)
def _fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)


@pytest.mark.parametrize("fmt", ["plain", "json"])
@pytest.mark.parametrize("level", ["debug", "info", "error", "none"])
def test_lines_equal_the_reference(fmt, level):
    got = _emit(log, fmt, level)
    assert got == _emit(ref_log, fmt, level)
    if level == "none":
        assert got == ""


@pytest.mark.parametrize("fmt", ["plain", "json"])
def test_module_filter_and_bound_context_equal_the_reference(fmt):
    levels = {"statesync": "debug", "p2p": "error"}
    got = _emit(log, fmt, "info", levels, bind={"module": "consensus", "node": "n0"})
    assert got == _emit(ref_log, fmt, "info", levels, bind={"module": "consensus",
                                                            "node": "n0"})
    got = _emit(log, fmt, "error", levels)
    assert got == _emit(ref_log, fmt, "error", levels)
    assert "loud" in got and "quiet" not in got


def test_plain_and_json_shapes():
    buf = io.StringIO()
    log.new_logger(buf, fmt="plain", level="info").with_(module="consensus").info(
        "enterNewRound", h=5, r=0)
    line = buf.getvalue()
    assert line.startswith("I[") and "module=consensus h=5 r=0" in line
    buf = io.StringIO()
    log.new_logger(buf, fmt="json", level="debug").error("bad thing", err="boom", raw=b"\x01\x02")
    rec = json.loads(buf.getvalue())
    assert rec == {"level": "E", "ts": NOW, "msg": "bad thing", "err": "boom", "raw": "0102"}


@pytest.mark.parametrize("name", ["debug", "INFO", "Error", "none", "warn", ""])
def test_parse_level_equals_the_reference(name):
    try:
        want = ref_log.parse_level(name)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            log.parse_level(name)
        assert str(got.value) == str(e)
    else:
        assert log.parse_level(name) == want


def test_nop_logger_is_silent_and_binds_to_itself():
    nop = log.NopLogger()
    assert nop.with_(module="x") is nop
    nop.debug("never", anything=1)
    nop.info("never")
    nop.error("never", err="x")


def test_version_constants_equal_the_reference():
    from cometbft_tpu import version as ref_version

    for name in ("__version__", "CMT_SEM_VER", "ABCI_SEM_VER", "ABCI_VERSION",
                 "P2P_PROTOCOL", "BLOCK_PROTOCOL"):
        assert getattr(version, name) == getattr(ref_version, name)
