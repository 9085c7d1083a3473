"""``python -m cometbft_tpu_torch.sidecar``: run the port's verification
sidecar server on the card (``CMTPU_SIDECAR_ADDR``, ``CMTPU_SIDECAR_DEVICE``,
``CMTPU_SIDECAR_WARM``)."""

from cometbft_tpu_torch.sidecar.service import main

if __name__ == "__main__":
    main()
