"""PrivValidator interface + in-memory signer (types/priv_validator.go), the
port's copy of ``cometbft_tpu/types/priv_validator.py``. A proposal is
duck-typed (``sign_bytes(chain_id)`` and a ``signature`` field): the
proposal type waits for the consensus slice."""

from __future__ import annotations

from dataclasses import replace

from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.types.vote import Vote


class PrivValidator:
    """types/priv_validator.go:14-22: signer abstraction used by consensus."""

    def get_pub_key(self):
        raise NotImplementedError

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        """Returns the vote with signature set (mutating in Go; functional here)."""
        raise NotImplementedError

    def sign_proposal(self, chain_id: str, proposal):
        raise NotImplementedError


class MockPV(PrivValidator):
    """In-memory signer for tests (types/priv_validator.go:47-130)."""

    def __init__(self, priv_key=None, break_proposal_sig=False, break_vote_sig=False):
        self.priv_key = priv_key or ed25519.gen_priv_key()
        self.break_proposal_sig = break_proposal_sig
        self.break_vote_sig = break_vote_sig

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        use_chain_id = "incorrect-chain-id" if self.break_vote_sig else chain_id
        sig = self.priv_key.sign(vote.sign_bytes(use_chain_id))
        return replace(vote, signature=sig)

    def sign_proposal(self, chain_id: str, proposal):
        use_chain_id = "incorrect-chain-id" if self.break_proposal_sig else chain_id
        sig = self.priv_key.sign(proposal.sign_bytes(use_chain_id))
        return replace(proposal, signature=sig)

    def address(self) -> bytes:
        return self.get_pub_key().address()
