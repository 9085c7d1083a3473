"""Validator signing (privval/ in CometBFT), the port's copy of
``cometbft_tpu/privval`` as far as consensus runs it: the file-backed
signer with its double-sign protection. The remote signer waits for the
node slice."""

from cometbft_tpu_torch.privval.file import FilePV, LastSignState

__all__ = ["FilePV", "LastSignState"]
