"""Statesync (statesync/ in CometBFT), the port's copy of what
``cometbft_tpu/statesync`` serves: the wire messages (channels 0x60 and 0x61)
and the reactor, whose serving side answers snapshot and chunk requests from
the local app. The syncing side (``Syncer``, ``LightClientStateProvider``)
is not ported yet; a node with ``statesync.enable`` raises and names it.
"""

from cometbft_tpu_torch.statesync.reactor import StatesyncReactor

__all__ = ["StatesyncReactor"]
