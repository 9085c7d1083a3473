"""The data types of blocks and commit verification (types/ in CometBFT), the
port's copies of ``cometbft_tpu/types``: blocks and their parts, headers,
commits and their canonical sign bytes, votes, validators and validator
sets, light blocks, and the three commit-verification modes; the modules
``params``, ``tx``, ``evidence``, ``part_set``, ``genesis``, ``results`` and
``priv_validator`` hold the rest that blocks need."""

from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    Block,
    BlockID,
    BlockMeta,
    Commit,
    CommitSig,
    Consensus,
    Data,
    Header,
    PartSetHeader,
    SignedHeader,
)
from cometbft_tpu_torch.types.cmttime import Time
from cometbft_tpu_torch.types.light_block import LightBlock
from cometbft_tpu_torch.types.validation import (
    Fraction,
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
from cometbft_tpu_torch.types.validator import Validator
from cometbft_tpu_torch.types.validator_set import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote

__all__ = [
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
    "PRECOMMIT_TYPE",
    "PREVOTE_TYPE",
    "Block",
    "BlockID",
    "BlockMeta",
    "Commit",
    "CommitSig",
    "Consensus",
    "Data",
    "Fraction",
    "Header",
    "LightBlock",
    "PartSetHeader",
    "SignedHeader",
    "Time",
    "Validator",
    "ValidatorSet",
    "Vote",
    "verify_commit",
    "verify_commit_light",
    "verify_commit_light_trusting",
]
