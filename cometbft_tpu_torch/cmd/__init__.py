"""The node CLI (`python -m cometbft_tpu_torch.cmd`), the port's copy of
``cometbft_tpu/cmd``."""
