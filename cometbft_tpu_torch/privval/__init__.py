"""Validator signing (privval/ in CometBFT), the port's copy of
``cometbft_tpu/privval``: the file-backed signer with its double-sign
protection, and the remote signer (``privval/signer``)."""

from cometbft_tpu_torch.privval.file import FilePV, LastSignState
from cometbft_tpu_torch.privval.signer import (
    RemoteSignerError,
    RetrySignerClient,
    SignerClient,
    SignerListenerEndpoint,
    SignerServer,
)

__all__ = [
    "FilePV",
    "LastSignState",
    "RemoteSignerError",
    "RetrySignerClient",
    "SignerClient",
    "SignerListenerEndpoint",
    "SignerServer",
]
