"""Peer exchange: discovery reactor + address book (p2p/pex/pex_reactor.go,
p2p/pex/addrbook.go), the port's copy of ``cometbft_tpu/p2p/pex``."""

from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook, NetAddress
from cometbft_tpu_torch.p2p.pex.reactor import PEX_CHANNEL, PexReactor

__all__ = ["AddrBook", "NetAddress", "PexReactor", "PEX_CHANNEL"]
