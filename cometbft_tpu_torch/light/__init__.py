"""The light client's verification (light/ in CometBFT): the port has its
stateless verifier, ``light/verifier.py``; the bisecting client, its
provider, store and detector are not ported yet."""
