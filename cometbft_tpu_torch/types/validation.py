"""Commit verification engines (types/validation.go), the port's copy of
``cometbft_tpu/types/validation.py``.

The three modes (VerifyCommit, VerifyCommitLight,
VerifyCommitLightTrusting) share three engines: aggregate (one BN254
pairing product through ``crypto/bn254.get_bn254_backend()``, the card's
``bn254`` kernel by default), batch (a whole commit through
``crypto/batch`` to ``sidecar/backend.get_backend()``, the card's
``sha512`` -> ``decompress`` -> ``ladder`` by default) and single (one
signature at a time on the host). The semantics are the reference's,
including which signatures each mode ignores or counts, and the batch
engine's "first bad signature" error read from the backend's bitmap without
verifying again.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.types.block import BlockID, Commit

BATCH_VERIFY_THRESHOLD = 2  # types/validation.go:12


@dataclass(frozen=True)
class Fraction:
    """libs/math.Fraction (trust level, e.g. 1/3)."""

    numerator: int
    denominator: int


class ErrNotEnoughVotingPowerSigned(Exception):
    def __init__(self, got: int, needed: int):
        self.got = got
        self.needed = needed
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, needed more than {needed}"
        )


class ErrInvalidCommitHeight(Exception):
    def __init__(self, expected: int, actual: int):
        super().__init__(
            f"Invalid commit -- wrong height: {expected} vs {actual}"
        )


class ErrInvalidCommitSignatures(Exception):
    def __init__(self, expected: int, actual: int):
        super().__init__(
            f"Invalid commit -- wrong set size: {expected} vs {actual}"
        )


def _batch_key_type(vals, commit: Commit) -> str | None:
    """The single key type shared by EVERY validator in the set, if that
    type is batch-capable — else None. CometBFT keys this decision on
    the proposer alone (validation.go:145-150), which mis-batches a mixed
    set: a bn254 signature fed into the ed25519 batch engine is a type
    error, not a clean reject. Homogeneous sets batch; mixed sets fall back
    to the per-signature scalar engine, which dispatches per key."""
    if len(commit.signatures) < BATCH_VERIFY_THRESHOLD:
        return None
    kt = None
    for val in vals.validators:
        pk = val.pub_key
        if pk is None:
            return None
        t = pk.type()
        if kt is None:
            kt = t
        elif t != kt:
            return None
    if kt is None or not crypto_batch.supports_batch_verifier(kt):
        return None
    return kt


def _should_batch_verify(vals, commit: Commit) -> bool:
    return _batch_key_type(vals, commit) is not None


def verify_commit(chain_id: str, vals, block_id: BlockID, height: int, commit: Commit) -> None:
    """+2/3 signed AND all signatures valid (types/validation.go:25-51).
    Checks every signature: apps may reward precommit inclusion."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    ignore = lambda c: c.is_absent()
    count = lambda c: c.for_block_flag()
    if commit.is_aggregate():
        _verify_commit_aggregate(
            chain_id, vals, commit, voting_power_needed, ignore, count, True
        )
    elif _should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count, True, True
        )
    else:
        _verify_commit_single(
            chain_id, vals, commit, voting_power_needed, ignore, count, True, True
        )


def verify_commit_light(
    chain_id: str, vals, block_id: BlockID, height: int, commit: Commit
) -> None:
    """+2/3 signed; stops counting at quorum (types/validation.go:59-84)."""
    _verify_basic_vals_and_commit(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    ignore = lambda c: not c.for_block_flag()
    count = lambda c: True
    if commit.is_aggregate():
        _verify_commit_aggregate(
            chain_id, vals, commit, voting_power_needed, ignore, count, True
        )
    elif _should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count, False, True
        )
    else:
        _verify_commit_single(
            chain_id, vals, commit, voting_power_needed, ignore, count, False, True
        )


def verify_commit_light_trusting(
    chain_id: str, vals, commit: Commit, trust_level: Fraction
) -> None:
    """trustLevel of a (possibly different) validator set signed this commit
    (types/validation.go:94-135); lookups are by address."""
    from cometbft_tpu_torch.types.validator_set import safe_mul

    if vals is None:
        raise ValueError("nil validator set")
    if trust_level.denominator == 0:
        raise ValueError("trustLevel has zero Denominator")
    if commit is None:
        raise ValueError("nil commit")
    total_mul, overflow = safe_mul(vals.total_voting_power(), trust_level.numerator)
    if overflow:
        raise OverflowError(
            "int64 overflow while calculating voting power needed. please provide "
            "smaller trustLevel numerator"
        )
    voting_power_needed = total_mul // trust_level.denominator
    ignore = lambda c: not c.for_block_flag()
    count = lambda c: True
    if commit.is_aggregate():
        _verify_commit_aggregate(
            chain_id, vals, commit, voting_power_needed, ignore, count, False
        )
    elif _should_batch_verify(vals, commit):
        _verify_commit_batch(
            chain_id, vals, commit, voting_power_needed, ignore, count, False, False
        )
    else:
        _verify_commit_single(
            chain_id, vals, commit, voting_power_needed, ignore, count, False, False
        )


def _verify_commit_aggregate(
    chain_id: str,
    vals,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig,
    count_sig,
    look_up_by_index: bool,
) -> None:
    """One pairing product stands in for every per-signature check.

    The aggregate is indivisible, so the semantics are deliberately stricter
    than the per-vote engines: the bitmap must mirror the non-absent entries
    exactly, every aggregated signer must resolve to a bn254 key in the
    verifying set, and the whole product is checked even in the light modes
    (there is no "stop at quorum" for a single G2 sum — nil votes ride along,
    which can only make acceptance stricter, never a wrong-accept). A reject
    is loud: there is no silent downgrade to scalar verification, because a
    poisoned aggregate has no per-signature form to fall back to.

    In trusting mode (look_up_by_index=False) a signer outside the trusted
    set leaves the product uncheckable — that raises, and the light client
    degrades to bisection exactly as it does for any failed trusting check.
    """
    from cometbft_tpu_torch.crypto import bn254

    n = len(commit.signatures)
    if len(commit.agg_bitmap) != (n + 7) // 8:
        raise ValueError("aggregate bitmap length mismatch")
    seen_vals: dict[int, int] = {}
    pubs: list[bytes] = []
    msgs: list[bytes] = []
    tallied = 0
    all_sign_bytes = commit.vote_sign_bytes_all(chain_id)
    for idx, commit_sig in enumerate(commit.signatures):
        in_agg = commit.agg_signer(idx)
        if commit_sig.is_absent():
            if in_agg:
                raise ValueError(
                    f"aggregate bitmap set for absent CommitSig #{idx}"
                )
            continue
        if not in_agg:
            raise ValueError(
                f"aggregate bitmap clear for signed CommitSig #{idx}"
            )
        if commit_sig.signature:
            raise ValueError(
                f"per-signature bytes present in aggregate commit (#{idx})"
            )
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                raise ValueError(
                    f"aggregate commit signer #{idx} unknown to the verifying set"
                )
            if val_idx in seen_vals:
                raise ValueError(
                    f"double vote from {val} ({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx
        pk = val.pub_key
        if pk is None or pk.type() != bn254.KEY_TYPE:
            raise ValueError(
                f"aggregate commit requires bn254 keys (validator #{idx})"
            )
        pubs.append(pk.bytes())
        msgs.append(all_sign_bytes[idx])
        if not ignore_sig(commit_sig) and count_sig(commit_sig):
            tallied += val.voting_power
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(tallied, voting_power_needed)
    if not pubs:
        raise ValueError("aggregate commit with no signers")
    if not bn254.get_bn254_backend().aggregate_verify(
        pubs, msgs, commit.agg_signature
    ):
        raise ValueError(
            f"invalid aggregate signature for commit at height {commit.height}"
        )


def _verify_commit_batch(
    chain_id: str,
    vals,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig,
    count_sig,
    count_all_signatures: bool,
    look_up_by_index: bool,
) -> None:
    """types/validation.go:152-256: the device call site."""
    kt = _batch_key_type(vals, commit)
    if kt is None:
        raise ValueError(
            "unsupported signature algorithm or insufficient signatures for batch verification"
        )
    bv = crypto_batch.create_batch_verifier(kt)
    seen_vals: dict[int, int] = {}
    batch_sig_idxs: list[int] = []
    tallied = 0
    all_sign_bytes = commit.vote_sign_bytes_all(chain_id)
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise ValueError(
                    f"double vote from {val} ({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx
        bv.add(val.pub_key, all_sign_bytes[idx], commit_sig.signature)
        batch_sig_idxs.append(idx)
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(tallied, voting_power_needed)
    ok, valid_sigs = bv.verify()
    if ok:
        return
    for i, sig_ok in enumerate(valid_sigs):
        if not sig_ok:
            idx = batch_sig_idxs[i]
            sig = commit.signatures[idx]
            raise ValueError(
                f"wrong signature (#{idx}): {sig.signature.hex().upper()}"
            )
    raise RuntimeError("BUG: batch verification failed with no invalid signatures")


def _verify_commit_single(
    chain_id: str,
    vals,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig,
    count_sig,
    count_all_signatures: bool,
    look_up_by_index: bool,
) -> None:
    """types/validation.go:265-340."""
    seen_vals: dict[int, int] = {}
    tallied = 0
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise ValueError(
                    f"double vote from {val} ({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx
        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        if not val.pub_key.verify_signature(vote_sign_bytes, commit_sig.signature):
            raise ValueError(
                f"wrong signature (#{idx}): {commit_sig.signature.hex().upper()}"
            )
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(tallied, voting_power_needed)


def speculative_verify_triples(
    chain_id: str,
    trusted_vals,
    untrusted_vals,
    commit: Commit,
    trust_level: Fraction | None,
) -> list[tuple]:
    """(pub_key, sign_bytes, signature) triples a hop's commit checks WILL
    verify — the speculative-bisection feeder (light/client.py).

    A non-adjacent hop runs verify_commit_light_trusting (old set, by
    address) then verify_commit_light (new set, by index); both walk the
    commit's signatures in order and stop at their quorum, and a
    signature's verify triple is identical in both (sign bytes depend only
    on the commit and chain id, never on the verifying set). This returns
    the union prefix both engines would touch, so prewarming the
    verified-triple cache with it makes the sequential checks pure cache
    hits without changing what they decide. trust_level=None means an
    adjacent hop: only the light-check prefix applies.

    Speculation must never fail a client, so malformed input returns []
    and unresolvable entries are skipped rather than raised on.
    """
    from cometbft_tpu_torch.types.validator_set import safe_mul

    if commit is None or untrusted_vals is None:
        return []
    if commit.is_aggregate():
        return []  # one pairing product; no per-sig triples to prewarm
    if untrusted_vals.size() != len(commit.signatures):
        return []  # light check will reject this hop; nothing to prewarm
    light_needed = untrusted_vals.total_voting_power() * 2 // 3
    trusting_needed = -1  # adjacent: trivially satisfied
    if trust_level is not None and trusted_vals is not None:
        total_mul, overflow = safe_mul(
            trusted_vals.total_voting_power(), trust_level.numerator
        )
        if overflow:
            return []
        trusting_needed = total_mul // trust_level.denominator
    all_sign_bytes = commit.vote_sign_bytes_all(chain_id)
    triples: list[tuple] = []
    light_tally = 0
    trusting_tally = 0
    seen: set[int] = set()
    for idx, commit_sig in enumerate(commit.signatures):
        if not commit_sig.for_block_flag():
            continue  # both engines ignore non-BlockIDFlagCommit entries
        light_live = light_tally <= light_needed
        trusting_live = trusting_tally <= trusting_needed
        if not light_live and not trusting_live:
            break
        val = untrusted_vals.validators[idx]
        if light_live:
            light_tally += val.voting_power
            triples.append(
                (val.pub_key, all_sign_bytes[idx], commit_sig.signature)
            )
        if trusting_live:
            t_idx, t_val = trusted_vals.get_by_address(
                commit_sig.validator_address
            )
            if t_val is not None and t_idx not in seen:
                seen.add(t_idx)
                trusting_tally += t_val.voting_power
                # The trusting engine keys its triple by the TRUSTED set's
                # pubkey (address lookup); normally identical to the new
                # set's, so the light triple above already covers it.
                if not light_live or t_val.pub_key.bytes() != val.pub_key.bytes():
                    triples.append(
                        (
                            t_val.pub_key,
                            all_sign_bytes[idx],
                            commit_sig.signature,
                        )
                    )
    return triples


def _verify_basic_vals_and_commit(vals, commit, height: int, block_id: BlockID) -> None:
    """types/validation.go:342-365."""
    if vals is None:
        raise ValueError("nil validator set")
    if commit is None:
        raise ValueError("nil commit")
    if vals.size() != len(commit.signatures):
        raise ErrInvalidCommitSignatures(vals.size(), len(commit.signatures))
    if height != commit.height:
        raise ErrInvalidCommitHeight(height, commit.height)
    if block_id != commit.block_id:
        raise ValueError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}"
        )
