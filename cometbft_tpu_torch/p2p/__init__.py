"""Peer-to-peer networking (p2p/ in CometBFT): the port has the reactor base
and the channel IDs (``p2p/reactor.py``) so far."""
