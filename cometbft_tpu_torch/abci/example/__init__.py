"""Example ABCI applications (abci/example/ in CometBFT)."""
