"""JSON-RPC 2.0 transport (rpc/jsonrpc/ in CometBFT)."""
