"""config.toml rendering + loading + env overrides
(config/toml.go WriteConfigFile template and viper's TOML-file +
CMT_-prefixed-environment layering in cmd/cometbft/main.go), the port's
copy of ``cometbft_tpu/config/toml.py``. The rendering is byte-identical to
that module's, its first line included, so either package loads the other's
file.

The file mirrors the dataclass tree: top-level keys from BaseConfig, one
[section] per sub-config. Environment overrides use CMT_<SECTION>_<FIELD>
(CMT_BASE_* for the top level), applied AFTER the file — same precedence
as CometBFT."""

from __future__ import annotations

import dataclasses
import os

from cometbft_tpu_torch.libs import tomlcompat as tomllib

from cometbft_tpu_torch.config.config import Config

_SECTIONS = (
    "rpc",
    "p2p",
    "mempool",
    "statesync",
    "blocksync",
    "consensus",
    "storage",
    "tx_index",
    "instrumentation",
)


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (tuple, list)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot render {type(v)} into toml")


def _fields(obj) -> dict:
    return {
        f.name: getattr(obj, f.name)
        for f in dataclasses.fields(obj)
        if f.name != "root_dir"
    }


def render_toml(config: Config) -> str:
    out = ["# Generated by cometbft_tpu init (config/toml.go analog).", ""]
    for k, v in _fields(config.base).items():
        out.append(f"{k} = {_toml_value(v)}")
    for section in _SECTIONS:
        out.append("")
        out.append(f"[{section}]")
        for k, v in _fields(getattr(config, section)).items():
            out.append(f"{k} = {_toml_value(v)}")
    return "\n".join(out) + "\n"


def write_config_file(path: str, config: Config) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(render_toml(config))


def _apply(obj, data: dict, where: str) -> None:
    valid = {f.name: f.type for f in dataclasses.fields(obj)}
    for k, v in data.items():
        if k not in valid:
            raise ValueError(f"unknown config key {where}{k}")
        cur = getattr(obj, k)
        if isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        if isinstance(cur, float) and isinstance(v, int):
            v = float(v)
        if cur is not None and not isinstance(v, type(cur)) and not (
            isinstance(cur, float) and isinstance(v, (int, float))
        ):
            raise ValueError(
                f"config key {where}{k}: expected {type(cur).__name__}, got {type(v).__name__}"
            )
        setattr(obj, k, v)


def load_toml(path: str, config: Config | None = None) -> Config:
    """Layer a config.toml over defaults (or the given config)."""
    config = config or Config()
    with open(path, "rb") as f:
        data = tomllib.load(f)
    return apply_toml(config, data)


def apply_toml(config: Config, data: dict) -> Config:
    """Layer a parsed config.toml (``tomllib`` output) over ``config``."""
    sections = {k: v for k, v in data.items() if isinstance(v, dict)}
    top = {k: v for k, v in data.items() if not isinstance(v, dict)}
    _apply(config.base, top, "")
    for name, body in sections.items():
        if name not in _SECTIONS:
            raise ValueError(f"unknown config section [{name}]")
        _apply(getattr(config, name), body, f"{name}.")
    return config


def _coerce(cur, raw: str):
    if isinstance(cur, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"not a bool: {raw!r}")
    if isinstance(cur, int):
        return int(raw)
    if isinstance(cur, float):
        return float(raw)
    if isinstance(cur, tuple):
        return tuple(x for x in raw.split(",") if x)
    return raw


def apply_env_overrides(config: Config, environ=None) -> Config:
    """CMT_BASE_LOG_LEVEL=debug, CMT_P2P_SEEDS=..., CMT_RPC_LADDR=... —
    highest-precedence layer, like CometBFT's viper env binding."""
    environ = environ if environ is not None else os.environ
    targets = {"base": config.base}
    targets.update({s: getattr(config, s) for s in _SECTIONS})
    for key, raw in environ.items():
        if not key.startswith("CMT_"):
            continue
        rest = key[4:].lower()
        section, _, field = rest.partition("_")
        while section:
            obj = targets.get(section)
            if obj is not None and hasattr(obj, field):
                setattr(obj, field, _coerce(getattr(obj, field), raw))
                break
            # section names with underscores (tx_index): shift one segment
            nxt, _, field2 = field.partition("_")
            if not field2:
                break
            section, field = f"{section}_{nxt}", field2
    return config
