"""Stateless light-client verification (light/verifier.go), the port's copy
of ``cometbft_tpu/light/verifier.py``.

VerifyNonAdjacent is the skipping-verification core: the trust level (1/3
by default) of the last trusted validator set must have signed the new
header (VerifyCommitLightTrusting), and more than 2/3 of the new header's
own set (VerifyCommitLight). Both go through ``types/validation``, so an
ed25519 set's signatures are batch-verified on the card."""

from __future__ import annotations

from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.block import SignedHeader
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.validation import ErrNotEnoughVotingPowerSigned, Fraction

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class ErrOldHeaderExpired(Exception):
    def __init__(self, expired_at: Time, now: Time):
        self.expired_at = expired_at
        self.now = now
        super().__init__(f"old header has expired at {expired_at} (now: {now})")


class ErrInvalidHeader(Exception):
    pass


class ErrNewValSetCantBeTrusted(Exception):
    """< trustLevel of the trusted set signed the new header — the caller
    should bisect (light/errors.go)."""


def validate_trust_level(lvl: Fraction) -> None:
    """light/verifier.go:196-204: must be within [1/3, 1]."""
    if lvl.numerator * 3 < lvl.denominator or lvl.numerator > lvl.denominator or (
        lvl.denominator == 0
    ):
        raise ValueError(f"trustLevel must be within [1/3, 1], given {lvl}")


def header_expired(h: SignedHeader, trusting_period_ns: int, now: Time) -> bool:
    """light/verifier.go:207-210."""
    expiration = h.header.time.add_nanos(trusting_period_ns)
    return not expiration.after(now)


def _verify_new_header_and_vals(
    untrusted: SignedHeader, untrusted_vals, trusted: SignedHeader, now: Time,
    max_clock_drift_ns: int,
) -> None:
    """light/verifier.go:153-192."""
    try:
        untrusted.validate_basic(trusted.header.chain_id)
    except ValueError as e:
        raise ErrInvalidHeader(f"untrusted.ValidateBasic failed: {e}") from e
    if untrusted.header.height <= trusted.header.height:
        raise ErrInvalidHeader(
            f"expected new header height {untrusted.header.height} to be greater "
            f"than old header height {trusted.header.height}"
        )
    if not untrusted.header.time.after(trusted.header.time):
        raise ErrInvalidHeader(
            f"expected new header time {untrusted.header.time} after old header "
            f"time {trusted.header.time}"
        )
    if not untrusted.header.time.before(now.add_nanos(max_clock_drift_ns)):
        raise ErrInvalidHeader(
            f"new header has a time from the future {untrusted.header.time} "
            f"(now: {now}, drift: {max_clock_drift_ns}ns)"
        )
    if untrusted.header.validators_hash != untrusted_vals.hash():
        raise ErrInvalidHeader(
            f"expected new header validators ({untrusted.header.validators_hash.hex()}) "
            f"to match supplied set ({untrusted_vals.hash().hex()})"
        )


def verify_non_adjacent(
    trusted: SignedHeader,
    trusted_vals,
    untrusted: SignedHeader,
    untrusted_vals,
    trusting_period_ns: int,
    now: Time,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
) -> None:
    """light/verifier.go:32-80 VerifyNonAdjacent."""
    if untrusted.header.height == trusted.header.height + 1:
        raise ValueError("headers must be non adjacent in height")
    if header_expired(trusted, trusting_period_ns, now):
        raise ErrOldHeaderExpired(
            trusted.header.time.add_nanos(trusting_period_ns), now
        )
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now, max_clock_drift_ns)
    try:
        validation.verify_commit_light_trusting(
            trusted.header.chain_id, trusted_vals, untrusted.commit, trust_level
        )
    except ErrNotEnoughVotingPowerSigned as e:
        raise ErrNewValSetCantBeTrusted(str(e)) from e
    # Always last: untrustedVals can be made huge to DoS the light client.
    try:
        validation.verify_commit_light(
            trusted.header.chain_id,
            untrusted_vals,
            untrusted.commit.block_id,
            untrusted.header.height,
            untrusted.commit,
        )
    except Exception as e:
        raise ErrInvalidHeader(str(e)) from e


def verify_adjacent(
    trusted: SignedHeader,
    untrusted: SignedHeader,
    untrusted_vals,
    trusting_period_ns: int,
    now: Time,
    max_clock_drift_ns: int,
) -> None:
    """light/verifier.go:93-133 VerifyAdjacent."""
    if untrusted.header.height != trusted.header.height + 1:
        raise ValueError("headers must be adjacent in height")
    if header_expired(trusted, trusting_period_ns, now):
        raise ErrOldHeaderExpired(
            trusted.header.time.add_nanos(trusting_period_ns), now
        )
    _verify_new_header_and_vals(untrusted, untrusted_vals, trusted, now, max_clock_drift_ns)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise ErrInvalidHeader(
            f"expected old header next validators "
            f"({trusted.header.next_validators_hash.hex()}) to match new header "
            f"validators ({untrusted.header.validators_hash.hex()})"
        )
    try:
        validation.verify_commit_light(
            trusted.header.chain_id,
            untrusted_vals,
            untrusted.commit.block_id,
            untrusted.header.height,
            untrusted.commit,
        )
    except Exception as e:
        raise ErrInvalidHeader(str(e)) from e


def verify(
    trusted: SignedHeader,
    trusted_vals,
    untrusted: SignedHeader,
    untrusted_vals,
    trusting_period_ns: int,
    now: Time,
    max_clock_drift_ns: int,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
) -> None:
    """light/verifier.go:136-151 Verify: adjacent or skipping."""
    if untrusted.header.height != trusted.header.height + 1:
        verify_non_adjacent(
            trusted, trusted_vals, untrusted, untrusted_vals,
            trusting_period_ns, now, max_clock_drift_ns, trust_level,
        )
    else:
        verify_adjacent(
            trusted, untrusted, untrusted_vals, trusting_period_ns, now,
            max_clock_drift_ns,
        )


def verify_backwards(untrusted_header, trusted_header) -> None:
    """light/verifier.go:213-245 VerifyBackwards: hash-chain one height down."""
    try:
        untrusted_header.validate_basic()
    except ValueError as e:
        raise ErrInvalidHeader(str(e)) from e
    if untrusted_header.chain_id != trusted_header.chain_id:
        raise ErrInvalidHeader("header belongs to another chain")
    if not untrusted_header.time.before(trusted_header.time):
        raise ErrInvalidHeader(
            f"expected older header time {untrusted_header.time} to be before "
            f"newer header time {trusted_header.time}"
        )
    if trusted_header.last_block_id.hash != untrusted_header.hash():
        raise ErrInvalidHeader(
            f"older header hash {untrusted_header.hash().hex()} does not match "
            f"trusted header's last block "
            f"{trusted_header.last_block_id.hash.hex()}"
        )
