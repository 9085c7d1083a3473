"""The p2p connection layer (p2p/conn/ in CometBFT)."""
