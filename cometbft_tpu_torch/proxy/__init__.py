"""proxy.AppConns: the four named ABCI connections multiplexed over one
client (proxy/app_conn.go:17-56, proxy/multi_app_conn.go), the port's copy
of ``cometbft_tpu/proxy/__init__.py``.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci.client import Client, ClientCreator, LocalClientCreator


class AppConns:
    """proxy/multi_app_conn.go: consensus/mempool/query/snapshot connections."""

    def __init__(self, creator: ClientCreator):
        self._creator = creator
        self.consensus: Client | None = None
        self.mempool: Client | None = None
        self.query: Client | None = None
        self.snapshot: Client | None = None

    def start(self) -> None:
        self.query = self._creator.new_abci_client()
        self.snapshot = self._creator.new_abci_client()
        self.mempool = self._creator.new_abci_client()
        self.consensus = self._creator.new_abci_client()

    def stop(self) -> None:
        # multi_app_conn.OnStop: each connection owns a socket + reader
        # thread (socket/gRPC transports) that must be torn down, not
        # dropped — dropping leaks the thread and the app-side connection.
        for client in (self.consensus, self.mempool, self.query, self.snapshot):
            close = getattr(client, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass
        self.consensus = self.mempool = self.query = self.snapshot = None


def new_app_conns(creator: ClientCreator) -> AppConns:
    conns = AppConns(creator)
    return conns


def local_client_creator(app) -> LocalClientCreator:
    return LocalClientCreator(app)
