"""File-based private validator with double-sign protection
(privval/file.go), the port's copy of ``cometbft_tpu/privval/file.py``.

Two files: a plaintext key file and a last-sign-state file persisted BEFORE
every signature, so a restarted validator can never sign conflicting
votes/proposals for a height/round/step it already signed
(privval/file.go:76-94 CheckHRS, :151 FilePV). Re-signing the same HRS is
allowed only when the message differs solely in timestamp (file.go:280-320).

The key and state files are the reference's JSON, byte for byte. ed25519
and bn254 keys are ported; secp256k1 and sr25519 raise an error that names
them as not ported, as ``crypto/encoding`` does.
"""

from __future__ import annotations

import base64
import json
import os
import tempfile
from dataclasses import dataclass, replace

from cometbft_tpu_torch.crypto import bn254, ed25519
from cometbft_tpu_torch.crypto.encoding import not_ported
from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE, PROPOSAL_TYPE
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.priv_validator import PrivValidator
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.wire import proto as wire

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_TYPE_TO_STEP = {
    PROPOSAL_TYPE: STEP_PROPOSE,
    PREVOTE_TYPE: STEP_PREVOTE,
    PRECOMMIT_TYPE: STEP_PRECOMMIT,
}


class DoubleSignError(Exception):
    pass


# Key-type registry (privval/file.go GenFilePV takes a keyType string routed
# to the crypto package's keygen; the JSON names are the amino-era type tags
# each crypto package registers). The reference's other two key types, by
# type and by private-key name, raise as not ported.
_KEY_MODULES = (ed25519, bn254)
KEY_TYPES = ("ed25519", "secp256k1", "sr25519", "bn254")
_BY_KEY_TYPE = {m.KEY_TYPE: m for m in _KEY_MODULES}
_BY_PRIV_NAME = {m.PRIV_KEY_NAME: m for m in _KEY_MODULES}
_NOT_PORTED = {
    "secp256k1": "secp256k1", "tendermint/PrivKeySecp256k1": "secp256k1",
    "sr25519": "sr25519", "tendermint/PrivKeySr25519": "sr25519",
}


@dataclass
class LastSignState:
    """privval/file.go:40-140 FilePVLastSignState."""

    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""
    file_path: str = ""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """file.go:76-94: False-with-error on regression; True when same HRS
        with an existing signature (caller may re-sign timestamp changes)."""
        if self.height > height:
            raise DoubleSignError(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}. Got {round_}, last round {self.round}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at height {height} round {round_}. "
                        f"Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no SignBytes found")
                    if not self.signature:
                        raise RuntimeError("pv: Signature is nil but SignBytes is not!")
                    return True
        return False

    def save(self) -> None:
        if not self.file_path:
            return
        data = json.dumps(
            {
                "height": str(self.height),
                "round": self.round,
                "step": self.step,
                "signature": base64.b64encode(self.signature).decode() if self.signature else None,
                "signbytes": self.sign_bytes.hex().upper() if self.sign_bytes else None,
            },
            indent=2,
        )
        _atomic_write(self.file_path, data)

    @classmethod
    def load(cls, path: str) -> "LastSignState":
        with open(path) as f:
            d = json.load(f)
        if not isinstance(d, dict):
            # Loud, typed failure: this file IS the double-sign guard —
            # callers must never be tempted to catch-and-regenerate.
            raise ValueError(f"corrupt last-sign state {path}: not an object")
        return cls(
            height=int(d.get("height", "0")),
            round=d.get("round", 0),
            step=d.get("step", 0),
            signature=base64.b64decode(d["signature"]) if d.get("signature") else b"",
            sign_bytes=bytes.fromhex(d["signbytes"]) if d.get("signbytes") else b"",
            file_path=path,
        )


class FilePV(PrivValidator):
    """privval/file.go:151-400."""

    def __init__(self, priv_key, key_file_path: str = "", state_file_path: str = ""):
        self.priv_key = priv_key
        self.key_file_path = key_file_path
        self.last_sign_state = LastSignState(file_path=state_file_path)

    # -- construction / persistence ------------------------------------------

    @classmethod
    def generate(
        cls,
        key_file_path: str = "",
        state_file_path: str = "",
        key_type: str = ed25519.KEY_TYPE,
    ) -> "FilePV":
        """privval/file.go GenFilePV: fresh key of the requested type."""
        if key_type in _NOT_PORTED:
            raise not_ported(_NOT_PORTED[key_type])
        mod = _BY_KEY_TYPE.get(key_type)
        if mod is None:
            raise ValueError(
                f"unsupported privval key type {key_type!r} (want one of {KEY_TYPES})"
            )
        return cls(mod.gen_priv_key(), key_file_path, state_file_path)

    @classmethod
    def load(cls, key_file_path: str, state_file_path: str) -> "FilePV":
        with open(key_file_path) as f:
            d = json.load(f)
        name = d["priv_key"].get("type", ed25519.PRIV_KEY_NAME)
        if name in _NOT_PORTED:
            raise not_ported(_NOT_PORTED[name])
        mod = _BY_PRIV_NAME.get(name)
        if mod is None:
            raise ValueError(f"unknown priv_key type {name!r} in {key_file_path}")
        priv_raw = base64.b64decode(d["priv_key"]["value"])
        pv = cls(mod.PrivKey(priv_raw), key_file_path, state_file_path)
        if os.path.exists(state_file_path):
            pv.last_sign_state = LastSignState.load(state_file_path)
            pv.last_sign_state.file_path = state_file_path
        return pv

    @classmethod
    def load_or_generate(
        cls,
        key_file_path: str,
        state_file_path: str,
        key_type: str = ed25519.KEY_TYPE,
    ) -> "FilePV":
        if os.path.exists(key_file_path):
            return cls.load(key_file_path, state_file_path)
        pv = cls.generate(key_file_path, state_file_path, key_type=key_type)
        pv.save()
        return pv

    def save(self) -> None:
        pub = self.priv_key.pub_key()
        mod = _BY_KEY_TYPE[self.priv_key.type()]
        data = json.dumps(
            {
                "address": pub.address().hex().upper(),
                "pub_key": {
                    "type": mod.PUB_KEY_NAME,
                    "value": base64.b64encode(pub.bytes()).decode(),
                },
                "priv_key": {
                    "type": mod.PRIV_KEY_NAME,
                    "value": base64.b64encode(self.priv_key.bytes()).decode(),
                },
            },
            indent=2,
        )
        if self.key_file_path:
            _atomic_write(self.key_file_path, data)
        self.last_sign_state.save()

    # -- PrivValidator interface ----------------------------------------------

    def get_pub_key(self):
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> Vote:
        """file.go:230-290 signVote: HRS check, same-HRS timestamp re-sign."""
        height, round_, step = vote.height, vote.round, _TYPE_TO_STEP[vote.type]
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)
        sign_bytes = vote.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                return replace(vote, signature=lss.signature)
            ts = _checked_vote_timestamp(lss.sign_bytes, sign_bytes)
            if ts is not None:
                # Only the timestamp differs: re-use the previous timestamp+sig.
                return replace(vote, timestamp=ts, signature=lss.signature)
            raise DoubleSignError("conflicting data")
        sig = self.priv_key.sign(sign_bytes)
        self._save_signed(height, round_, step, sign_bytes, sig)
        return replace(vote, signature=sig)

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> Proposal:
        """file.go:300-350 signProposal."""
        height, round_, step = proposal.height, proposal.round, STEP_PROPOSE
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)
        sign_bytes = proposal.sign_bytes(chain_id)
        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                return replace(proposal, signature=lss.signature)
            ts = _checked_proposal_timestamp(lss.sign_bytes, sign_bytes)
            if ts is not None:
                return replace(proposal, timestamp=ts, signature=lss.signature)
            raise DoubleSignError("conflicting data")
        sig = self.priv_key.sign(sign_bytes)
        self._save_signed(height, round_, step, sign_bytes, sig)
        return replace(proposal, signature=sig)

    def _save_signed(self, height, round_, step, sign_bytes, sig) -> None:
        self.last_sign_state.height = height
        self.last_sign_state.round = round_
        self.last_sign_state.step = step
        self.last_sign_state.signature = sig
        self.last_sign_state.sign_bytes = sign_bytes
        self.last_sign_state.save()

    def address(self) -> bytes:
        return self.get_pub_key().address()


def _atomic_write(path: str, data: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _strip_timestamp_field(sign_bytes: bytes, field_num: int):
    """Drop the canonical timestamp field from length-delimited sign bytes;
    returns (stripped, timestamp) — the equality basis for same-HRS re-signs
    (privval/file.go checkVotesOnlyDifferByTimestamp)."""
    body_len, pos = wire.decode_uvarint(sign_bytes, 0)
    body = sign_bytes[pos : pos + body_len]
    fields_out = b""
    ts = None
    p = 0
    while p < len(body):
        key, p2 = wire.decode_uvarint(body, p)
        fnum, wt = key >> 3, key & 7
        if wt == wire.WT_VARINT:
            _, p3 = wire.decode_uvarint(body, p2)
        elif wt == wire.WT_FIXED64:
            p3 = p2 + 8
        elif wt == wire.WT_LEN:
            ln, p2b = wire.decode_uvarint(body, p2)
            p3 = p2b + ln
        else:
            return None, None
        if fnum == field_num and wt == wire.WT_LEN:
            ln, p2b = wire.decode_uvarint(body, p2)
            ts = Time.decode(body[p2b : p2b + ln])
        else:
            fields_out += body[p:p3]
        p = p3
    return fields_out, ts


def _checked_vote_timestamp(last_sign_bytes: bytes, new_sign_bytes: bytes):
    """If the two canonical votes differ only in timestamp (field 5), return
    the LAST timestamp (to be reused); else None."""
    last_stripped, last_ts = _strip_timestamp_field(last_sign_bytes, 5)
    new_stripped, _ = _strip_timestamp_field(new_sign_bytes, 5)
    if last_stripped is None or new_stripped is None:
        return None
    return last_ts if last_stripped == new_stripped else None


def _checked_proposal_timestamp(last_sign_bytes: bytes, new_sign_bytes: bytes):
    """Same for canonical proposals (timestamp is field 6)."""
    last_stripped, last_ts = _strip_timestamp_field(last_sign_bytes, 6)
    new_stripped, _ = _strip_timestamp_field(new_sign_bytes, 6)
    if last_stripped is None or new_stripped is None:
        return None
    return last_ts if last_stripped == new_stripped else None
