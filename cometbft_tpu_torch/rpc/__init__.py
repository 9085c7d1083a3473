"""RPC payload codecs (rpc/ in CometBFT): the port has ``json_codec``, which
the light client's HTTP provider decodes with; the RPC server and its HTTP
client are not ported yet."""
