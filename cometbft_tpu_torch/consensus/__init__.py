"""Consensus: the Tendermint BFT state machine (consensus/ in CometBFT),
the port's copy of ``cometbft_tpu/consensus`` without its reactor and
replay, which wait for the p2p and node slices."""
