"""Witness cross-checking and light-client attack evidence
(light/detector.go), the port's copy of ``cometbft_tpu/light/detector.py``.

After the primary's header verifies, every witness is asked for the same
height. A witness returning a DIFFERENT header for a verified height is
evidence of an attack on one of the two: the detector verifies the
witness's conflicting chain from the last header both agree on (on the card,
through ``light/verifier``), builds LightClientAttackEvidence against each
side, reports it to the other, and fails verification so the caller can
react.

Every exception the detector tolerates (a witness that cannot serve the
common-block search, a conflicting chain that fails to verify, a report
that fails) is counted on the client (``detector_errors``, the last one in
``last_detector_error``), as the JAX package's verdicts are kept: a failed
launch on the card inside the witness check drops that witness as bad and
files no evidence there, as in the JAX package, but it is counted, never
unseen.
"""
from __future__ import annotations

from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.light.provider import ErrLightBlockNotFound, ErrNoResponse
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
from cometbft_tpu_torch.types.light_block import LightBlock


def _tolerated(client, err: BaseException) -> None:
    """Count an exception the detector tolerates, on the client."""
    client.detector_errors += 1
    client.last_detector_error = err


class ErrConflictingHeaders(Exception):
    """detector.go errConflictingHeaders."""

    def __init__(self, witness_index: int, block: LightBlock):
        self.witness_index = witness_index
        self.block = block
        super().__init__(
            f"witness #{witness_index} has a different header at height "
            f"{block.height}: {block.hash().hex()}"
        )


class ErrLightClientAttack(Exception):
    pass


class ErrNoWitnesses(Exception):
    """client.go errNoWitnesses: every witness has been removed — the client
    can no longer cross-check the primary and must be reset."""


def detect_divergence(client, new_lb: LightBlock, now: Time) -> None:
    """detector.go:48 detectDivergence: compare primary header with every
    witness; on conflict, build + report evidence and raise."""
    conflicts = []
    drop = []
    for i, witness in enumerate(list(client.witnesses)):
        try:
            w_lb = witness.light_block(new_lb.height)
        except (ErrLightBlockNotFound, ErrNoResponse):
            # Unresponsive/behind witnesses are dropped (detector.go:92-100).
            drop.append(witness)
            continue
        if w_lb.hash() != new_lb.hash():
            conflicts.append((i, witness, w_lb))
    for w in drop:
        client.remove_witness(w)
    if not conflicts:
        return
    reported = 0
    for i, witness, w_lb in conflicts:
        reported += _examine_and_report(client, new_lb, witness, w_lb, now)
    if reported == 0:
        # Every conflicting witness failed verification from the common
        # trusted header — they are simply bad witnesses (already removed),
        # not proof of an attack on the primary (detector.go:105-112). But a
        # client that has lost its whole witness set can no longer detect
        # anything: surface that instead of silently trusting the primary.
        if client.had_witnesses and not client.witnesses:
            raise ErrNoWitnesses(
                "all witnesses removed; no cross-checking possible — reset "
                "the light client with fresh witnesses"
            )
        return
    raise ErrLightClientAttack(
        f"{reported} witness(es) returned verifiable conflicting headers at "
        f"height {new_lb.height}; evidence reported"
    )


def _examine_and_report(client, primary_lb, witness, witness_lb, now: Time) -> int:
    """detector.go:120-210 compareNewHeaderWithWitness + evidence build: find
    the common trusted header, VERIFY the witness's conflicting chain from it
    (examineConflictingHeaderAgainstTrace), and only then attach the
    conflicting block and report against both providers.

    Returns 1 if evidence was reported (genuine divergence), 0 if the witness
    was merely bad (its header does not verify from the common header — it is
    removed without accusing the primary)."""
    common = _find_common_block(client, witness, primary_lb.height)
    if common is not None and not _witness_chain_verifies(
        client, common, witness, witness_lb, now
    ):
        # One faulty/malicious witness must not DoS the client or file bogus
        # evidence against an honest primary: drop it and carry on.
        client.remove_witness(witness)
        return 0
    ev_against_primary = make_attack_evidence(primary_lb, common)
    ev_against_witness = make_attack_evidence(witness_lb, common)
    # The witness believes its own chain: send it evidence of the primary's
    # block, and vice versa (detector.go gatherEvidence).
    try:
        witness.report_evidence(ev_against_primary)
    except Exception as e:
        _tolerated(client, e)
    try:
        client.primary.report_evidence(ev_against_witness)
    except Exception as e:
        _tolerated(client, e)
    client.remove_witness(witness)
    return 1


def _find_common_block(client, witness, below_height: int):
    """detector.go examineConflictingHeaderAgainstTrace step 1: the latest
    block in the client's verified trace (the trusted store) that the witness
    reports with the SAME hash — the point the two chains last agreed."""
    heights = sorted(
        (h for h in client.store._heights() if h < below_height), reverse=True
    )
    for h in heights:
        trusted = client.store.light_block(h)
        if trusted is None:
            continue
        try:
            w_lb = witness.light_block(h)
        except Exception as e:
            _tolerated(client, e)
            continue
        if w_lb.hash() == trusted.hash():
            return trusted
    return None


def _witness_chain_verifies(client, common, witness, witness_lb, now: Time) -> bool:
    """detector.go examineConflictingHeaderAgainstTrace step 2: light-verify
    the witness's conflicting block from the common header, bisecting through
    the WITNESS's own chain when validator rotation breaks one-shot trust —
    a genuine fork signed by rotating validators must still be attributable."""
    if witness_lb.height <= common.height:
        return False
    trusted = common
    pending = [witness_lb]
    for _ in range(64):  # bisection depth bound (client.go maxVerifyIterations)
        if not pending:
            return True
        block = pending[-1]
        try:
            verifier.verify(
                trusted.signed_header,
                trusted.validator_set,
                block.signed_header,
                block.validator_set,
                client.trusting_period_ns,
                now,
                client.max_clock_drift_ns,
                client.trust_level,
            )
            trusted = block
            pending.pop()
        except verifier.ErrNewValSetCantBeTrusted:
            pivot = (trusted.height + block.height) // 2
            if pivot in (trusted.height, block.height):
                return False
            try:
                pending.append(witness.light_block(pivot))
            except Exception as e:
                _tolerated(client, e)
                return False
        except Exception as e:
            _tolerated(client, e)
            return False
    return False


def make_attack_evidence(conflicting: LightBlock, common: LightBlock | None):
    """types/evidence.go LightClientAttackEvidence from a conflicting block.
    Byzantine validators = signers of the conflicting commit that were in the
    common (trusted) validator set (types/evidence.go GetByzantineValidators,
    lunatic case)."""
    byzantine = []
    total_power = 0
    if common is not None:
        total_power = common.validator_set.total_voting_power()
        commit = conflicting.signed_header.commit
        for cs in commit.signatures:
            if not cs.for_block_flag():
                continue
            _, val = common.validator_set.get_by_address(cs.validator_address)
            if val is not None:
                byzantine.append(val)
    # Timestamp/total power anchor to the COMMON (trusted) block: the pool's
    # verifier compares them against ITS chain at evidence.Height() ==
    # common_height (evidence/verify.go:46), not the attacker's header.
    anchor = common if common is not None else conflicting
    return LightClientAttackEvidence(
        conflicting_block=conflicting,
        common_height=anchor.height,
        byzantine_validators=byzantine,
        total_voting_power=total_power,
        timestamp=anchor.signed_header.header.time,
    )
