"""Node assembly (node/node.go NewNode and OnStart), the port's copy of
``cometbft_tpu/node``."""

from cometbft_tpu_torch.node.node import Node, default_new_node

__all__ = ["Node", "default_new_node"]
