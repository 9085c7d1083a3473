"""Statesync (statesync/ in CometBFT), the port's copy of
``cometbft_tpu/statesync``: bootstrap a fresh node from application snapshots
instead of replaying the whole chain.

Flow: discover snapshots from peers (channel 0x60) → offer the best one to
the local app (ABCI OfferSnapshot) → fetch + apply chunks in parallel
(channel 0x61, ABCI ApplySnapshotChunk) → verify the restored app against
the light-client-trusted app hash → bootstrap state/block stores → hand off
to blocksync, then consensus.
"""

from cometbft_tpu_torch.statesync.reactor import StatesyncReactor
from cometbft_tpu_torch.statesync.stateprovider import LightClientStateProvider, StateProvider
from cometbft_tpu_torch.statesync.syncer import (
    ErrAbort,
    ErrNoSnapshots,
    ErrRejectSnapshot,
    Syncer,
)

__all__ = [
    "StatesyncReactor",
    "Syncer",
    "StateProvider",
    "LightClientStateProvider",
    "ErrAbort",
    "ErrNoSnapshots",
    "ErrRejectSnapshot",
]
