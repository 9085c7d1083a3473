"""The node's config and its TOML in the port (``cometbft_tpu_torch/config``)
held to the JAX package's: every section and field with the same defaults,
``render_toml`` byte-identical, each package loading the other's file to
equal fields, unknown keys refused with the same text, ``CMT_*`` environment
overrides acting the same, and ``validate_basic`` giving the same errors.
Modelled on the package's ``tests/test_config_toml.py``."""

import dataclasses

import pytest

from cometbft_tpu import config as ref_config
from cometbft_tpu.config import toml as ref_toml
from cometbft_tpu_torch import config, convert
from cometbft_tpu_torch.config import toml

pytestmark = pytest.mark.torch_port

SECTIONS = ("base",) + toml._SECTIONS


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _edited(mod):
    """A config with a field changed in every section, of every type."""
    cfg = mod.default_config()
    cfg.base.moniker = 'bench "node" \\ 1'
    cfg.base.db_backend = "memdb"
    cfg.rpc.laddr = "tcp://0.0.0.0:9999"
    cfg.rpc.cors_allowed_origins = ("https://a.example", "*")
    cfg.p2p.seeds = "aa@1.2.3.4:26656,bb@5.6.7.8:1"
    cfg.p2p.addr_book_strict = False
    cfg.p2p.send_rate = 1
    cfg.mempool.ingress_sender_rps = 12.5
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = ("http://a:26657", "http://b:26657")
    cfg.blocksync.version = "v1"
    cfg.consensus.timeout_commit = 2.5
    cfg.consensus.create_empty_blocks_interval = 3
    cfg.storage.discard_abci_responses = True
    cfg.tx_index.indexer = "null"
    cfg.instrumentation.namespace = "ns"
    return cfg


@pytest.mark.parametrize("section", SECTIONS)
def test_every_section_and_default_equals_the_reference(section):
    got = _fields(getattr(config.default_config(), section))
    want = _fields(getattr(ref_config.default_config(), section))
    assert got == want
    assert list(got) == list(want)  # the same order: the file renders in it


def test_test_config_equals_the_reference():
    assert _fields(config.test_config()) == _fields(ref_config.test_config())
    assert config.test_config().p2p.laddr == ""


@pytest.mark.parametrize("make", ["default", "test", "edited"])
def test_render_is_byte_identical(make):
    cfgs = {"default": (config.default_config(), ref_config.default_config()),
            "test": (config.test_config(), ref_config.test_config()),
            "edited": (_edited(config), _edited(ref_config))}[make]
    assert toml.render_toml(cfgs[0]) == ref_toml.render_toml(cfgs[1])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_loads_the_others_file(tmp_path, writer):
    path = str(tmp_path / "config.toml")
    if writer == "port":
        toml.write_config_file(path, _edited(config))
    else:
        ref_toml.write_config_file(path, _edited(ref_config))
    got, want = toml.load_toml(path), ref_toml.load_toml(path)
    assert _fields(got) == _fields(want)
    assert got.base.moniker == 'bench "node" \\ 1'
    assert got.statesync.rpc_servers == ("http://a:26657", "http://b:26657")
    assert got.mempool.size == config.Config().mempool.size  # untouched defaults survive
    with open(path) as f:
        assert _fields(convert.config_from_toml(f.read())) == _fields(want)


def test_roundtrip_keeps_every_field(tmp_path):
    path = str(tmp_path / "config.toml")
    cfg = _edited(config)
    toml.write_config_file(path, cfg)
    loaded = toml.load_toml(path)
    assert _fields(loaded) == _fields(cfg)


@pytest.mark.parametrize("body", [
    '[p2p]\nladdr = "tcp://0.0.0.0:1"\ntypo_key = 3\n',
    'typo_top = "x"\n',
    '[nosuch]\nkey = 1\n',
    '[consensus]\ntimeout_commit = "soon"\n',
    '[p2p]\npex = 1\n',
    '[mempool]\nsize = 1.5\n',
])
def test_load_refuses_what_the_reference_refuses(tmp_path, body):
    path = str(tmp_path / "config.toml")
    with open(path, "w") as f:
        f.write(body)
    with pytest.raises(ValueError) as got:
        toml.load_toml(path)
    with pytest.raises(ValueError) as want:
        ref_toml.load_toml(path)
    assert str(got.value) == str(want.value)


def test_load_layers_over_a_given_config(tmp_path):
    path = str(tmp_path / "config.toml")
    with open(path, "w") as f:
        f.write("[consensus]\ntimeout_commit = 9\n")
    got = toml.load_toml(path, config.test_config())
    want = ref_toml.load_toml(path, ref_config.test_config())
    assert _fields(got) == _fields(want)
    assert got.consensus.timeout_commit == 9.0 and got.consensus.timeout_propose == 0.4


ENV = {
    "CMT_BASE_LOG_LEVEL": "debug",
    "CMT_P2P_SEEDS": "x@1.1.1.1:1,y@2.2.2.2:2",
    "CMT_RPC_LADDR": "tcp://0.0.0.0:9999",
    "CMT_RPC_CORS_ALLOWED_ORIGINS": "a,b,,c",
    "CMT_CONSENSUS_TIMEOUT_COMMIT": "0.75",
    "CMT_STATESYNC_ENABLE": "true",
    "CMT_P2P_PEX": "0",
    "CMT_MEMPOOL_SIZE": "77",
    "CMT_TX_INDEX_INDEXER": "null",
    "CMT_NOSUCH_FIELD": "1",
    "CMT_P2P_NOSUCH": "1",
    "UNRELATED": "zzz",
}


def test_env_overrides_act_the_same():
    got = toml.apply_env_overrides(config.default_config(), dict(ENV))
    want = ref_toml.apply_env_overrides(ref_config.default_config(), dict(ENV))
    assert _fields(got) == _fields(want)
    assert got.base.log_level == "debug" and got.p2p.pex is False
    assert got.tx_index.indexer == "null" and got.rpc.cors_allowed_origins == ("a", "b", "c")


def test_env_override_with_a_bad_bool_raises_the_same():
    env = {"CMT_P2P_PEX": "maybe"}
    with pytest.raises(ValueError) as got:
        toml.apply_env_overrides(config.default_config(), env)
    with pytest.raises(ValueError) as want:
        ref_toml.apply_env_overrides(ref_config.default_config(), env)
    assert str(got.value) == str(want.value)


BAD = [
    ("base", "db_backend", "leveldb"),
    ("consensus", "timeout_propose", -1.0),
    ("consensus", "timeout_prevote", -0.5),
    ("consensus", "timeout_precommit", -2.0),
    ("consensus", "timeout_commit", -0.1),
    ("mempool", "size", -1),
    ("mempool", "ingress_lanes", 0),
    ("mempool", "ingress_sender_rps", -1.0),
    ("mempool", "ingress_queue_max", 0),
]


@pytest.mark.parametrize("section,field,value", BAD)
def test_validate_basic_gives_the_same_errors(section, field, value):
    got, want = config.default_config(), ref_config.default_config()
    for cfg in (got, want):
        setattr(getattr(cfg, section), field, value)
    with pytest.raises(ValueError) as e:
        got.validate_basic()
    with pytest.raises(ValueError) as ref_e:
        want.validate_basic()
    assert str(e.value) == str(ref_e.value)


def test_validate_basic_accepts_the_defaults():
    config.default_config().validate_basic()
    config.test_config().validate_basic()


def test_paths_and_set_root_equal_the_reference():
    got = config.default_config().set_root("/home/node")
    want = ref_config.default_config().set_root("/home/node")
    for name in ("genesis_path", "priv_validator_key_path", "priv_validator_state_path",
                 "node_key_path", "db_path"):
        assert getattr(got.base, name)() == getattr(want.base, name)()
    assert got.consensus.wal_path() == want.consensus.wal_path()
    assert got.consensus.commit_time(5.0) == want.consensus.commit_time(5.0)
    for r in range(4):
        assert got.consensus.round_timeout_budget(r) == want.consensus.round_timeout_budget(r)
