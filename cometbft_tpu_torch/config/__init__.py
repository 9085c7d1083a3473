"""Node configuration tree (config/config.go and toml.go), the port's copy of
``cometbft_tpu/config``.

Nested dataclasses mirror CometBFT's sections; ``config/toml.py`` renders and
parses the node's config file; durations are seconds (float) here.
"""

from cometbft_tpu_torch.config.config import (
    BaseConfig,
    BlockSyncConfig,
    Config,
    ConsensusConfig,
    InstrumentationConfig,
    MempoolConfig,
    P2PConfig,
    RPCConfig,
    StateSyncConfig,
    StorageConfig,
    TxIndexConfig,
    default_config,
    test_config,
)

__all__ = [
    "BaseConfig",
    "BlockSyncConfig",
    "Config",
    "ConsensusConfig",
    "InstrumentationConfig",
    "MempoolConfig",
    "P2PConfig",
    "RPCConfig",
    "StateSyncConfig",
    "StorageConfig",
    "TxIndexConfig",
    "default_config",
    "test_config",
]
