"""Consensus: the Tendermint BFT state machine (consensus/ in CometBFT),
the port's copy of ``cometbft_tpu/consensus``: the state machine, its WAL,
the reactor and the Handshaker's replay (``replay.py``)."""
