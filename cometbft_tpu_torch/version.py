"""Version constants (version/version.go:6-13), the port's copy of
``cometbft_tpu/version.py``."""

__version__ = "0.1.0"

# Version of the replicated capability surface we target.
CMT_SEM_VER = "0.38.0-dev"

# ABCI semantic version implemented by the ABCI boundary (CometBFT's
# version/version.go:9 ABCISemVer = "1.0.0").
ABCI_SEM_VER = "1.0.0"
ABCI_VERSION = ABCI_SEM_VER

# P2P and Block protocol versions (version/version.go:17-24).
P2P_PROTOCOL = 8
BLOCK_PROTOCOL = 11
