"""ABCI — the application blockchain interface (abci/ in CometBFT), the
port's copy of the types, the local client and the kvstore example of
``cometbft_tpu/abci``.

The boundary between consensus middleware and the replicated application:
14 methods over 4 logical connections (consensus, mempool, query, snapshot)
per abci/types/application.go:13-35 (ABCI 1.0).
"""
