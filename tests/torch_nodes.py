"""Nodes of either package for the port's node tests
(``tests/test_torch_node.py``, a helper, not a test file): a home on disk
written by the package's own functions (``config/toml.write_config_file``,
the genesis JSON, ``FilePV``, ``NodeKey``, and optionally stores filled from
a chain's database items), a node built from it by ``default_new_node``, and
waits that are liveness guards under a loaded host, never time bounds."""

from __future__ import annotations

import os
import time
import types

import cometbft_tpu.config as ref_config
import cometbft_tpu.config.toml as ref_toml
import cometbft_tpu.libs.db as ref_db
import cometbft_tpu.node.node as ref_node
import cometbft_tpu.p2p.key as ref_key
import cometbft_tpu.privval as ref_privval
import cometbft_tpu.sidecar.backend as ref_backend
import cometbft_tpu.types.genesis as ref_genesis
import cometbft_tpu_torch.config as config
import cometbft_tpu_torch.config.toml as toml
import cometbft_tpu_torch.libs.db as db
import cometbft_tpu_torch.node.node as node
import cometbft_tpu_torch.p2p.key as key
import cometbft_tpu_torch.privval as privval
import cometbft_tpu_torch.sidecar.backend as backend
import cometbft_tpu_torch.types.genesis as genesis

WAIT_S = 180.0

PKGS = {
    "port": types.SimpleNamespace(
        name="port", config=config, toml=toml, db=db, node=node, key=key, privval=privval,
        backend=backend, genesis=genesis),
    "reference": types.SimpleNamespace(
        name="reference", config=ref_config, toml=ref_toml, db=ref_db, node=ref_node,
        key=ref_key, privval=ref_privval, backend=ref_backend, genesis=ref_genesis),
}


def wait(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def node_config(p, **fields):
    """``test_config()`` with p2p and RPC on 127.0.0.1:0 and a loopback
    address book; ``fields`` are ``section__field=value`` overrides."""
    cfg = p.config.test_config()
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.addr_book_strict = False  # loopback is unroutable under strict
    for k, v in fields.items():
        section, _, field = k.partition("__")
        setattr(getattr(cfg, section), field, v)
    return cfg


def write_home(p, home: str, cfg, gen_json: str, items=(), pv_key_json: str | None = None):
    """A node's home: config.toml, the genesis, the FilePV (its key file
    given, or a fresh key), the node key, and, for a sqlite home, the
    block store and the state store filled with ``items``."""
    cfg.set_root(home)
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(cfg.base.db_path(), exist_ok=True)
    p.toml.write_config_file(os.path.join(home, "config", "config.toml"), cfg)
    with open(cfg.base.genesis_path(), "w") as f:
        f.write(gen_json)
    if pv_key_json is not None:
        with open(cfg.base.priv_validator_key_path(), "w") as f:
            f.write(pv_key_json)
    p.privval.FilePV.load_or_generate(cfg.base.priv_validator_key_path(),
                                      cfg.base.priv_validator_state_path())
    p.key.NodeKey.load_or_gen(cfg.base.node_key_path())
    if items:
        assert cfg.base.db_backend == "sqlite"
        for name in ("blockstore", "state"):
            store = p.db.new_db(name, "sqlite", cfg.base.db_path())
            for k, v in items:
                store.set(k, v)
            store.close()
    return home


def load_node(p, home: str, app=None):
    """``default_new_node`` over the home's config.toml, as a CLI would."""
    cfg = p.toml.load_toml(os.path.join(home, "config", "config.toml"))
    cfg.set_root(home)
    return p.node.default_new_node(cfg, app=app)


def pv_key_json(p, secret: bytes, path: str) -> str:
    """A FilePV key file for the ed25519 key of ``secret``, written by the
    package's own FilePV."""
    from importlib import import_module

    ed = import_module(p.backend.__name__.rsplit(".", 2)[0] + ".crypto.ed25519")
    pv = p.privval.FilePV(ed.gen_priv_key_from_secret(secret), path, path + ".state")
    pv.save()
    with open(path) as f:
        return f.read()
