"""The light client (light/ in CometBFT), the port's copy of
``cometbft_tpu/light``.

- verifier: stateless VerifyAdjacent / VerifyNonAdjacent / VerifyBackwards
- client:   the bisecting Client with its trusted store and witness check
- detector: divergence detection and LightClientAttackEvidence
- provider: the Provider interface (mock, block store, http)
- store:    the DB-backed trusted LightBlock store
- mmr:      an append-only RFC-6962 accumulator over committed headers
- gateway:  a node's shared verification service for syncing clients
- bundle:   content-addressed checkpoint artifacts (static cold sync)
- origin:   builds a node's checkpoint bundles and exports them

The verified RPC proxy (``light/proxy.py``) waits for the RPC server.
"""

from cometbft_tpu_torch.light.bundle import (
    Bundle,
    BundleError,
    DirBundleSource,
    MemoryBundleSource,
    RemoteBundleSource,
)
from cometbft_tpu_torch.light.client import Client, TrustOptions
from cometbft_tpu_torch.light.gateway import (
    GatewayError,
    LightGateway,
    RemoteGateway,
)
from cometbft_tpu_torch.light.mmr import MMR
from cometbft_tpu_torch.light.origin import BundleOrigin
from cometbft_tpu_torch.light.provider import (
    BlockStoreProvider,
    ErrLightBlockNotFound,
    ErrNoResponse,
    HTTPProvider,
    MockProvider,
    Provider,
)
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.light import verifier

__all__ = [
    "Client",
    "TrustOptions",
    "Provider",
    "MockProvider",
    "HTTPProvider",
    "BlockStoreProvider",
    "LightStore",
    "LightGateway",
    "RemoteGateway",
    "GatewayError",
    "Bundle",
    "BundleError",
    "BundleOrigin",
    "DirBundleSource",
    "MemoryBundleSource",
    "RemoteBundleSource",
    "MMR",
    "verifier",
    "ErrLightBlockNotFound",
    "ErrNoResponse",
]
