"""RPC / API layer (rpc/ in CometBFT), the port's copy of
``cometbft_tpu/rpc``: ``json_codec`` (RPC JSON to types), ``jsonrpc.server``
(``JSONRPCServer``), ``core`` (``Environment`` and the route table) and
``client`` (``HTTPClient``, ``LocalClient``, ``MockClient``). The gRPC
broadcast server waits for its slice."""
