"""Key paths for generalized Merkle proofs (crypto/merkle/proof_key_path.go), the
port's copy of ``cometbft_tpu/crypto/merkle/proof_key_path.py``.

Keys are /-separated, URL-escaped or upper-hex (`x:`-prefixed); both encodings
decode identically.
"""

from __future__ import annotations

import enum
import urllib.parse
from dataclasses import dataclass


class KeyEncoding(enum.IntEnum):
    URL = 0
    HEX = 1


@dataclass(frozen=True)
class Key:
    name: bytes
    enc: KeyEncoding


class KeyPath(tuple):
    def append_key(self, key: bytes, enc: KeyEncoding) -> "KeyPath":
        return KeyPath(self + (Key(key, enc),))

    def __str__(self) -> str:
        res = ""
        for key in self:
            if key.enc == KeyEncoding.URL:
                res += "/" + urllib.parse.quote(key.name.decode("utf-8"), safe="")
            elif key.enc == KeyEncoding.HEX:
                res += "/x:" + key.name.hex().upper()
            else:
                raise ValueError("unexpected key encoding type")
        return res


def key_path_to_keys(path: str) -> list[bytes]:
    """Decode a /-prefixed path into raw keys (proof_key_path.go:86-108)."""
    if not path or path[0] != "/":
        raise ValueError("key path string must start with a forward slash '/'")
    parts = path[1:].split("/")
    keys: list[bytes] = []
    for i, part in enumerate(parts):
        if part.startswith("x:"):
            try:
                keys.append(bytes.fromhex(part[2:]))
            except ValueError as e:
                raise ValueError(f"decoding hex-encoded part #{i}: /{part}: {e}") from e
        else:
            keys.append(urllib.parse.unquote(part).encode("utf-8"))
    return keys
