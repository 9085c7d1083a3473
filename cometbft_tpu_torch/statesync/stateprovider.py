"""Trusted state for statesync via the light client
(statesync/stateprovider.go:27-48 in CometBFT), the port's copy of
``cometbft_tpu/statesync/stateprovider.py``.

The syncer must not trust peers about what the restored app SHOULD hash to —
the app hash, validator sets, and commit all come from light-client-verified
headers. A snapshot at height H restored the app state AFTER block H, so its
hash appears in header H+1 (stateprovider.go AppHash), and rebuilding
sm.State needs the validator sets at H, H+1, and H+2."""

from __future__ import annotations

from cometbft_tpu_torch.libs.db import MemDB
from cometbft_tpu_torch.light.client import Client, TrustOptions
from cometbft_tpu_torch.light.store import LightStore
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.types.cmttime import now as time_now
from cometbft_tpu_torch.types.params import ConsensusParams


class StateProvider:
    """stateprovider.go StateProvider interface."""

    def app_hash(self, height: int) -> bytes:
        raise NotImplementedError

    def commit(self, height: int):
        raise NotImplementedError

    def state(self, height: int) -> State:
        raise NotImplementedError


class LightClientStateProvider(StateProvider):
    """stateprovider.go:51-90 lightClientStateProvider: wraps a light.Client
    over one or more providers (RPC in production, mocks in tests)."""

    def __init__(
        self,
        chain_id: str,
        primary,
        witnesses: list,
        trust_height: int,
        trust_hash: bytes,
        trust_period_ns: int = 168 * 3600 * 10**9,
        initial_height: int = 1,
        consensus_params: ConsensusParams | None = None,
        now=None,
    ):
        self.chain_id = chain_id
        self.initial_height = initial_height
        self._params = consensus_params or ConsensusParams()
        self._now = now or time_now
        self._client = Client(
            chain_id,
            TrustOptions(
                period_ns=trust_period_ns, height=trust_height, hash=trust_hash
            ),
            primary,
            witnesses,
            LightStore(MemDB()),
        )

    def _verified(self, height: int):
        return self._client.verify_light_block_at_height(height, self._now())

    def app_hash(self, height: int) -> bytes:
        """stateprovider.go AppHash: header H+1 carries the app hash of the
        state after block H."""
        return self._verified(height + 1).signed_header.header.app_hash

    def commit(self, height: int):
        """The verified commit FOR block `height` (saved as the seen commit
        so consensus can build on it)."""
        return self._verified(height).signed_header.commit

    def state(self, height: int) -> State:
        """stateprovider.go State: rebuild sm.State for last_block_height =
        `height` from verified headers at H, H+1, H+2."""
        lb_last = self._verified(height)
        lb_cur = self._verified(height + 1)
        lb_next = self._verified(height + 2)
        header_cur = lb_cur.signed_header.header
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=height,
            last_block_id=header_cur.last_block_id,
            last_block_time=lb_last.signed_header.header.time,
            last_validators=lb_last.validator_set,
            validators=lb_cur.validator_set,
            next_validators=lb_next.validator_set,
            last_height_validators_changed=height + 1,
            consensus_params=self._params,
            last_height_consensus_params_changed=self.initial_height,
            last_results_hash=header_cur.last_results_hash,
            app_hash=header_cur.app_hash,
        )
