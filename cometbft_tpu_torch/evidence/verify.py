"""Evidence verification (evidence/verify.go), the port's copy of
``cometbft_tpu/evidence/verify.py``.

Duplicate votes (evidence/verify.go:116 VerifyDuplicateVote) check their two
signatures through ``crypto/sigbatch`` in one batch; light-client attacks
(:128 VerifyLightClientAttack) verify the conflicting commit with
VerifyCommitLightTrusting or VerifyCommitLight (``types/validation``), whose
signatures go to the backend in one call: the card's ``sha512`` ->
``decompress`` -> ``ladder`` by default.
"""
from __future__ import annotations

from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.validation import Fraction


def verify_evidence(ev, state, state_store, block_store) -> None:
    """evidence/verify.go:20-100 verify(): age checks then type dispatch."""
    height = state.last_block_height
    ev_params = state.consensus_params.evidence
    age_num_blocks = height - ev.height()

    block_meta = block_store.load_block_meta(ev.height())
    if block_meta is None:
        raise ValueError(f"failed to verify evidence: missing block for height {ev.height()}")
    ev_time = block_meta.header.time
    age_duration_ns = state.last_block_time.unix_nanos() - ev_time.unix_nanos()
    if (
        age_duration_ns > ev_params.max_age_duration_ns
        and age_num_blocks > ev_params.max_age_num_blocks
    ):
        raise ValueError(
            f"evidence from height {ev.height()} is too old; evidence can not be older than "
            f"{ev_params.max_age_num_blocks} blocks"
        )

    if isinstance(ev, DuplicateVoteEvidence):
        val_set = state_store.load_validators(ev.height())
        verify_duplicate_vote(ev, state.chain_id, val_set)
        if ev.timestamp != ev_time:
            raise ValueError(
                f"evidence has a different time to the block it is associated with "
                f"({ev.timestamp} != {ev_time})"
            )
    elif isinstance(ev, LightClientAttackEvidence):
        common_vals = state_store.load_validators(ev.common_height)
        trusted_header = block_store.load_block_meta(ev.height())
        if trusted_header is None:
            raise ValueError(f"no header at height {ev.height()}")
        verify_light_client_attack(
            ev,
            common_vals,
            trusted_header.header,
            state.chain_id,
        )
        if ev.timestamp != ev_time:
            raise ValueError("evidence has a different time to the block it is associated with")
    else:
        raise ValueError(f"unrecognized evidence type: {type(ev)}")


def verify_duplicate_vote(ev: DuplicateVoteEvidence, chain_id: str, val_set) -> None:
    """evidence/verify.go:116-190."""
    _, val = val_set.get_by_address(ev.vote_a.validator_address)
    if val is None:
        raise ValueError(
            f"address {ev.vote_a.validator_address.hex().upper()} was not a validator at height {ev.height()}"
        )
    pub_key = val.pub_key
    # H/R/S must match; votes must differ by block ID; addresses equal.
    va, vb = ev.vote_a, ev.vote_b
    if va.height != vb.height or va.round != vb.round or va.type != vb.type:
        raise ValueError("duplicate votes must be for the same height/round/step")
    if va.validator_address != vb.validator_address:
        raise ValueError("duplicate votes must be from the same validator")
    if va.block_id == vb.block_id:
        raise ValueError("duplicate votes must be for different blocks")
    # Correct total power / validator power recorded.
    if ev.validator_power != val.voting_power:
        raise ValueError(
            f"validator power from evidence and our validator set does not match "
            f"({ev.validator_power} != {val.voting_power})"
        )
    if ev.total_voting_power != val_set.total_voting_power():
        raise ValueError(
            f"total voting power from the evidence and our validator set does not match "
            f"({ev.total_voting_power} != {val_set.total_voting_power()})"
        )
    # vote.verify semantics, but the two signatures ride ONE batched
    # dispatch through the micro-batch window — duplicate-vote evidence
    # always carries exactly two sigs from the same key.
    from cometbft_tpu_torch.crypto import sigbatch
    from cometbft_tpu_torch.types.vote import VoteError

    addr = pub_key.address()
    if addr != va.validator_address or addr != vb.validator_address:
        raise VoteError("invalid validator address")
    ok_a, ok_b = sigbatch.verify_triples(
        [pub_key, pub_key],
        [va.sign_bytes(chain_id), vb.sign_bytes(chain_id)],
        [va.signature, vb.signature],
    )
    if not ok_a or not ok_b:
        raise VoteError("invalid signature")


def verify_light_client_attack(
    ev: LightClientAttackEvidence, common_vals, trusted_header, chain_id: str
) -> None:
    """evidence/verify.go:128-230 (condensed): the conflicting header must
    carry a commit that a light client would have accepted from the common
    validators (1/3 trust) or the conflicting validator set itself (2/3)."""
    sh = ev.conflicting_block.signed_header
    if ev.common_height != sh.header.height:
        # Forward-lunatic or non-adjacent: common validators with 1/3 trust.
        common_vals.verify_commit_light_trusting(chain_id, sh.commit, Fraction(1, 3))
    else:
        if ev.conflicting_block.validator_set is None:
            raise ValueError("missing conflicting validator set")
        ev.conflicting_block.validator_set.verify_commit_light(
            chain_id,
            sh.commit.block_id,
            sh.header.height,
            sh.commit,
        )
    # The conflicting header must actually conflict with what we committed.
    if trusted_header.hash() == sh.header.hash():
        raise ValueError("trusted header matches conflicting header; no attack")
