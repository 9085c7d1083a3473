"""Node identity (p2p/key.go), the port's copy of ``cometbft_tpu/p2p/key.py``.

ID = hex(address(pubkey)) — 20 bytes of SHA256(pubkey), lowercase hex
(p2p/key.go:120).
"""

from __future__ import annotations

import base64
import json
import os

from cometbft_tpu_torch.crypto import ed25519


def node_id_from_pub_key(pub) -> str:
    return pub.address().hex()


class NodeKey:
    """p2p/key.go NodeKey."""

    def __init__(self, priv_key=None):
        self.priv_key = priv_key or ed25519.gen_priv_key()

    @property
    def id(self) -> str:
        return node_id_from_pub_key(self.priv_key.pub_key())

    def pub_key(self):
        return self.priv_key.pub_key()

    def save_as(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "priv_key": {
                        "type": "tendermint/PrivKeyEd25519",
                        "value": base64.b64encode(self.priv_key.bytes()).decode(),
                    }
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            d = json.load(f)
        try:
            return cls(ed25519.PrivKey(base64.b64decode(d["priv_key"]["value"])))
        except (KeyError, TypeError, ValueError) as e:
            # ValueError covers binascii.Error (bad base64) and wrong-length
            # keys — the common corruption modes.
            raise ValueError(f"corrupt node key {path}: {e}") from None

    @classmethod
    def load_or_gen(cls, path: str) -> "NodeKey":
        if os.path.exists(path):
            return cls.load(path)
        nk = cls()
        nk.save_as(path)
        return nk
