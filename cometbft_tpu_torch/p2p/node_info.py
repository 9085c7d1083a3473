"""Node info exchanged during the p2p handshake (p2p/node_info.go), the port's
copy of ``cometbft_tpu/p2p/node_info.py``: the same proto bytes.

Compatibility: same block protocol version, same network (chain id), and at
least one common channel (node_info.go CompatibleWith).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from cometbft_tpu_torch.wire import proto as wire

MAX_NUM_CHANNELS = 16


@dataclass
class ProtocolVersion:
    p2p: int = 8
    block: int = 11
    app: int = 0


@dataclass
class NodeInfo:
    """p2p/node_info.go DefaultNodeInfo."""

    protocol_version: ProtocolVersion = dfield(default_factory=ProtocolVersion)
    node_id: str = ""
    listen_addr: str = ""
    network: str = ""
    version: str = "0.1.0"
    channels: bytes = b""
    moniker: str = ""
    tx_index: str = "on"
    rpc_address: str = ""

    def validate_basic(self) -> None:
        if not self.node_id:
            raise ValueError("no node ID")
        if len(self.channels) > MAX_NUM_CHANNELS:
            raise ValueError(f"too many channels ({len(self.channels)})")
        if len(set(self.channels)) != len(self.channels):
            raise ValueError("duplicate channel ids")

    def compatible_with(self, other: "NodeInfo") -> None:
        """node_info.go CompatibleWith."""
        if self.protocol_version.block != other.protocol_version.block:
            raise ValueError(
                f"peer is on a different Block version. Got {other.protocol_version.block}, "
                f"expected {self.protocol_version.block}"
            )
        if self.network != other.network:
            raise ValueError(
                f"peer is on a different network. Got {other.network!r}, expected {self.network!r}"
            )
        if self.channels and other.channels:
            if not set(self.channels) & set(other.channels):
                raise ValueError(f"peer has no common channels. Our {self.channels.hex()}; theirs {other.channels.hex()}")

    def encode(self) -> bytes:
        pv = (
            wire.field_varint(1, self.protocol_version.p2p)
            + wire.field_varint(2, self.protocol_version.block)
            + wire.field_varint(3, self.protocol_version.app)
        )
        out = wire.field_message(1, pv, emit_empty=True)
        out += wire.field_string(2, self.node_id)
        out += wire.field_string(3, self.listen_addr)
        out += wire.field_string(4, self.network)
        out += wire.field_string(5, self.version)
        out += wire.field_bytes(6, self.channels)
        out += wire.field_string(7, self.moniker)
        other = wire.field_string(1, self.tx_index) + wire.field_string(2, self.rpc_address)
        out += wire.field_message(8, other, emit_empty=True)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "NodeInfo":
        f = wire.decode_fields(data)
        pvf = wire.decode_fields(wire.get_bytes(f, 1))
        other = wire.decode_fields(wire.get_bytes(f, 8))
        return cls(
            protocol_version=ProtocolVersion(
                wire.get_uvarint(pvf, 1), wire.get_uvarint(pvf, 2), wire.get_uvarint(pvf, 3)
            ),
            node_id=wire.get_string(f, 2),
            listen_addr=wire.get_string(f, 3),
            network=wire.get_string(f, 4),
            version=wire.get_string(f, 5),
            channels=wire.get_bytes(f, 6),
            moniker=wire.get_string(f, 7),
            tx_index=wire.get_string(other, 1),
            rpc_address=wire.get_string(other, 2),
        )

    def to_json(self) -> dict:
        return {
            "protocol_version": {
                "p2p": str(self.protocol_version.p2p),
                "block": str(self.protocol_version.block),
                "app": str(self.protocol_version.app),
            },
            "id": self.node_id,
            "listen_addr": self.listen_addr,
            "network": self.network,
            "version": self.version,
            "channels": self.channels.hex(),
            "moniker": self.moniker,
            "other": {"tx_index": self.tx_index, "rpc_address": self.rpc_address},
        }
