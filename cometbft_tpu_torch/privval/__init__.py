"""Validator signing (privval/ in CometBFT), the port's copy of
``cometbft_tpu/privval`` as far as consensus runs it: the file-backed
signer with its double-sign protection. The remote signer
(``privval/signer``) is not ported yet; the node raises for
``base.priv_validator_laddr`` and names it."""

from cometbft_tpu_torch.privval.file import FilePV, LastSignState

__all__ = ["FilePV", "LastSignState"]
