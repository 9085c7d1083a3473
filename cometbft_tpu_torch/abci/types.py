"""ABCI request/response types + Application interface
(abci/types/application.go, proto/tendermint/abci/types.proto), the port's
copy of ``cometbft_tpu/abci/types.py``.

Dataclasses mirror the proto schema field-for-field; see wire.py for the
socket serialization. Code 0 means OK everywhere (abci/types/result.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

CODE_TYPE_OK = 0

# CheckTxType (abci.proto CheckTxType)
CHECK_TX_TYPE_NEW = 0
CHECK_TX_TYPE_RECHECK = 1

# ResponseOfferSnapshot.Result / ResponseApplySnapshotChunk.Result
OFFER_SNAPSHOT_UNKNOWN = 0
OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5

APPLY_CHUNK_UNKNOWN = 0
APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3
APPLY_CHUNK_RETRY_SNAPSHOT = 4
APPLY_CHUNK_REJECT_SNAPSHOT = 5

# ProcessProposal status (abci.proto ResponseProcessProposal.ProposalStatus)
PROCESS_PROPOSAL_UNKNOWN = 0
PROCESS_PROPOSAL_ACCEPT = 1
PROCESS_PROPOSAL_REJECT = 2


@dataclass
class EventAttribute:
    key: str = ""
    value: str = ""
    index: bool = False


@dataclass
class Event:
    type: str = ""
    attributes: list = dfield(default_factory=list)


@dataclass
class ValidatorUpdate:
    """abci.ValidatorUpdate: proto PublicKey bytes + power."""

    pub_key: object = None  # crypto PubKey
    power: int = 0


@dataclass
class CommitInfo:
    """abci.LastCommitInfo: who signed the last block (for incentives)."""

    round: int = 0
    votes: list = dfield(default_factory=list)  # list[VoteInfo]


@dataclass
class VoteInfo:
    validator_address: bytes = b""
    validator_power: int = 0
    signed_last_block: bool = False


@dataclass
class Misbehavior:
    """abci.Misbehavior (evidence forwarded to the app)."""

    type: int = 0  # 0 unknown, 1 duplicate vote, 2 light client attack
    validator_address: bytes = b""
    validator_power: int = 0
    height: int = 0
    time_seconds: int = 0
    total_voting_power: int = 0


MISBEHAVIOR_DUPLICATE_VOTE = 1
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


# -- requests ----------------------------------------------------------------


@dataclass
class RequestEcho:
    message: str = ""


@dataclass
class RequestFlush:
    pass


@dataclass
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class RequestInitChain:
    time_seconds: int = 0
    chain_id: str = ""
    consensus_params: object = None
    validators: list = dfield(default_factory=list)  # list[ValidatorUpdate]
    app_state_bytes: bytes = b""
    initial_height: int = 0


@dataclass
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class RequestBeginBlock:
    hash: bytes = b""
    header: object = None  # types.Header
    last_commit_info: CommitInfo = dfield(default_factory=CommitInfo)
    byzantine_validators: list = dfield(default_factory=list)


@dataclass
class RequestCheckTx:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_NEW


@dataclass
class RequestDeliverTx:
    tx: bytes = b""


@dataclass
class RequestEndBlock:
    height: int = 0


@dataclass
class RequestCommit:
    pass


@dataclass
class RequestListSnapshots:
    pass


@dataclass
class RequestOfferSnapshot:
    snapshot: Snapshot | None = None
    app_hash: bytes = b""


@dataclass
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass
class RequestPrepareProposal:
    max_tx_bytes: int = 0
    txs: list = dfield(default_factory=list)
    local_last_commit: CommitInfo = dfield(default_factory=CommitInfo)
    misbehavior: list = dfield(default_factory=list)
    height: int = 0
    time_seconds: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class RequestProcessProposal:
    txs: list = dfield(default_factory=list)
    proposed_last_commit: CommitInfo = dfield(default_factory=CommitInfo)
    misbehavior: list = dfield(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time_seconds: int = 0
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


# -- responses ---------------------------------------------------------------


@dataclass
class ResponseException:
    error: str = ""


@dataclass
class ResponseEcho:
    message: str = ""


@dataclass
class ResponseFlush:
    pass


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class ResponseInitChain:
    consensus_params: object = None
    validators: list = dfield(default_factory=list)
    app_hash: bytes = b""


@dataclass
class ResponseQuery:
    code: int = 0
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: list = dfield(default_factory=list)
    height: int = 0
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseBeginBlock:
    events: list = dfield(default_factory=list)


@dataclass
class ResponseCheckTx:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = dfield(default_factory=list)
    codespace: str = ""
    sender: str = ""
    priority: int = 0
    mempool_error: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseDeliverTx:
    code: int = 0
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list = dfield(default_factory=list)
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class ResponseEndBlock:
    validator_updates: list = dfield(default_factory=list)
    consensus_param_updates: object = None
    events: list = dfield(default_factory=list)


@dataclass
class ResponseCommit:
    data: bytes = b""  # the AppHash
    retain_height: int = 0


@dataclass
class ResponseListSnapshots:
    snapshots: list = dfield(default_factory=list)


@dataclass
class ResponseOfferSnapshot:
    result: int = OFFER_SNAPSHOT_UNKNOWN


@dataclass
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


@dataclass
class ResponseApplySnapshotChunk:
    result: int = APPLY_CHUNK_UNKNOWN
    refetch_chunks: list = dfield(default_factory=list)
    reject_senders: list = dfield(default_factory=list)


@dataclass
class ResponsePrepareProposal:
    txs: list = dfield(default_factory=list)


@dataclass
class ResponseProcessProposal:
    status: int = PROCESS_PROPOSAL_UNKNOWN

    def is_accepted(self) -> bool:
        return self.status == PROCESS_PROPOSAL_ACCEPT


class Application:
    """The 14-method application interface (abci/types/application.go:13-35).
    Subclass and override; the base returns empty/OK responses (BaseApplication)."""

    # Info/Query connection
    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery(code=CODE_TYPE_OK)

    # Mempool connection
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx(code=CODE_TYPE_OK)

    # Consensus connection
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def prepare_proposal(self, req: RequestPrepareProposal) -> ResponsePrepareProposal:
        """Default: include txs unchanged up to max_tx_bytes
        (abci/types/application.go BaseApplication.PrepareProposal)."""
        total = 0
        out = []
        for tx in req.txs:
            total += len(tx) + 5
            if req.max_tx_bytes > 0 and total > req.max_tx_bytes:
                break
            out.append(tx)
        return ResponsePrepareProposal(txs=out)

    def process_proposal(self, req: RequestProcessProposal) -> ResponseProcessProposal:
        return ResponseProcessProposal(status=PROCESS_PROPOSAL_ACCEPT)

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        return ResponseDeliverTx(code=CODE_TYPE_OK)

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    # State-sync connection
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot()

    def load_snapshot_chunk(self, req: RequestLoadSnapshotChunk) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(self, req: RequestApplySnapshotChunk) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk()

    # Echo (connection handshake)
    def echo(self, req: RequestEcho) -> ResponseEcho:
        return ResponseEcho(message=req.message)
