"""Peer-to-peer networking (p2p/ in CometBFT), the port's copy of
``cometbft_tpu/p2p``: node keys and node info, ``SecretConnection`` (the STS
handshake over X25519 and merlin, framed ChaCha20-Poly1305),
``MConnection`` with its receive demux and flow-rate monitors, the TCP
``MultiplexTransport``, the ``Switch`` and the reactor base with the channel
IDs. PEX, the address book and its reactor, is ``p2p/pex``."""

from cometbft_tpu_torch.p2p.key import NodeKey, node_id_from_pub_key
from cometbft_tpu_torch.p2p.reactor import Reactor

__all__ = ["NodeKey", "Reactor", "node_id_from_pub_key"]
