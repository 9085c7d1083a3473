"""Carry-across between the reference package's numpy state and the port's
tensors (this system's counterpart of converting weights).

The reference keeps its constants and packed operands as numpy arrays
(``int32[17, N]`` field limbs, ``int32[9, 4, 17, 1]`` for the fixed-base
table, the 4- or 5-tuple ``pack_batch`` returns; for BN254 the float64
operands ``p1``, ``qa``, ``q1a``, ``q2a`` of its ``_pack`` and the
``(n, 6, 2, 13)`` Miller values its program returns; for Merkle proofs the
tuple of ``uint32[8, m]`` tree levels of ``_leaves_to_levels_core``). These
helpers turn
them into the port's tensors and back, so the tests can hand one input to
both implementations. They take numpy arrays and import nothing of the
reference.

The state of commit verification is its wire bytes: ``commit_from_wire``,
``signed_header_from_wire`` and ``validator_set_from_wire`` take what the
reference's ``Commit.encode()``, ``SignedHeader.encode()`` and its
validators' public-key proto bytes and powers give, and return the port's
objects, which encode to the same bytes.

The state of blocksync is a node's blocks and its stores: ``block_from_wire``
takes a block's proto bytes (a ``block_response``'s payload, the reference's
``Block.encode()``), ``state_from_store_bytes`` the bytes a state store keeps
under ``stateKey``, and ``stores_from_items`` a database's key-value items
(a reference node's ``MemDB.iterator()``), which it copies into a port
``MemDB`` under a port ``BlockStore`` and ``StateStore``: the keys and values
are the same bytes in both packages.

The light client's state is wire bytes and a file: ``light_block_from_wire``
takes a light block's proto bytes (``LightBlock.encode()``, a light store's
values), ``evidence_from_wire`` an evidence's ``Evidence`` oneof bytes
(``types/evidence.encode_evidence``, an evidence pool's values), and
``mmr_from_state_file`` / ``mmr_to_state_file`` read and write the MMR
state file the gateway and the bundle origin share, byte-identical in both
packages.

Consensus carries wire bytes and files: ``proposal_from_wire`` takes a
proposal's proto bytes (``Proposal.encode()``), ``vote_set_from_reference``
builds a port ``VoteSet`` by replaying a reference vote set's votes (their
``Vote.encode()`` bytes, in the order they were added) over the same
validators, ``file_pv_from_state_files`` loads a ``FilePV`` from the
reference's key and last-sign-state JSON files, and
``wal_messages_from_file`` reads a consensus WAL the reference wrote (the
frames are the same bytes in both packages).

The network carries a node's identity and its handshake: ``node_key_from_file``
loads a ``NodeKey`` from the reference's ``node_key.json`` and
``node_key_from_seed`` makes one from an ed25519 seed (the same ID as the
reference's key of that seed); ``node_info_from_wire`` takes the
``NodeInfo`` proto bytes the handshake swaps (``NodeInfo.encode()``), and
``p2p_config_from_fields`` a ``P2PConfig`` from the reference's fields
(``dataclasses.asdict`` of its ``P2PConfig``).

The RPC tier carries indexes and proofs: ``indexers_from_items`` puts a
reference index's DB items under the port's ``KVTxIndexer`` and
``KVBlockIndexer``, and ``proof_ops_from_wire`` takes a query's proof ops
as proto bytes (tendermint.crypto.ProofOps).

A node carries its config file and its address book: ``config_from_toml``
loads a ``config.toml`` the reference rendered into a port ``Config`` (the
rendering is the same bytes in both packages), and ``addr_book_from_file``
loads the reference's ``addrbook.json`` into a port ``AddrBook``.

Statesync carries a snapshot and a state: ``snapshot_from_wire`` takes an
``abci.Snapshot``'s proto bytes (what ``ListSnapshots`` answers; its chunks
are plain bytes), and ``state_to_store_bytes`` gives a restored ``State`` as
the bytes a state store keeps, which the reference's ``_decode_state`` reads
(``state_from_store_bytes`` is the other way). A remote signer's last-sign
state is its FilePV's state file (``file_pv_from_state_files``).
"""

from __future__ import annotations

import numpy as np
import torch

from cometbft_tpu_torch.crypto import encoding
from cometbft_tpu_torch.ops import bn254_kernel, merkle_kernel
from cometbft_tpu_torch.types import Commit, SignedHeader, Validator, ValidatorSet


def _tensor(a, device) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)  # same bits; this PyTorch has no uint32 arithmetic
    return torch.from_numpy(arr.copy()).to(device)


def operands_from_jax(operands, device="cpu") -> tuple:
    """The reference's ``pack_batch`` operands (A, R, S words int32[8, N],
    then either the pack buffer uint32[N, B*32] and block counts int32[N],
    or host-hashed digest words int32[16, N]) -> int32 tensors."""
    if len(operands) not in (4, 5):
        raise ValueError(f"expected 4 or 5 operands, got {len(operands)}")
    return tuple(_tensor(o, device) for o in operands)


def point_from_jax(point, device="cpu") -> tuple:
    """(X, Y, Z, T) as int32[17, N] arrays -> four int32 tensors."""
    return tuple(_tensor(c, device).to(torch.int32) for c in point)


def point_to_jax(point) -> tuple:
    """Four int32[17, N] tensors -> numpy int32 arrays."""
    return tuple(c.detach().to(torch.int32).cpu().numpy() for c in point)


def table_b_from_jax(table, device="cpu") -> torch.Tensor:
    """The reference's TABLE_B_PRE, int32[9, 4, 17, 1] -> tensor."""
    t = _tensor(table, device)
    if tuple(t.shape) != (9, 4, 17, 1):
        raise ValueError(f"expected a [9, 4, 17, 1] table, got {tuple(t.shape)}")
    return t.to(torch.int32)


def bn254_operands_from_jax(operands, device="cpu") -> tuple:
    """The reference's BN254 ``_pack`` operands: p1 float64 (n, 2, 13) and
    qa, q1a, q2a float64 (n, 2, 2, 13) -> float64 tensors."""
    if len(operands) != 4:
        raise ValueError(f"expected 4 operands (p1, qa, q1a, q2a), got {len(operands)}")
    p1, *qs = (torch.from_numpy(np.ascontiguousarray(o, dtype=np.float64)).to(device)
               for o in operands)
    n = p1.shape[0]
    if tuple(p1.shape) != (n, 2, 13) or any(tuple(q.shape) != (n, 2, 2, 13) for q in qs):
        raise ValueError(f"bad BN254 operand shapes {[tuple(o.shape) for o in (p1, *qs)]}")
    return (p1, *qs)


def bn254_values_from_jax(out) -> list:
    """(n, 6, 2, 13) Miller values (loose float64 limbs, the reference's
    program output, or the port's) -> n Fp12 values as host ints mod P."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    return bn254_kernel.unpack_values(np.asarray(out, dtype=np.float64))


def bn254_values_to_jax(values) -> np.ndarray:
    """n Fp12 values (6 pairs of ints) -> (n, 6, 2, 13) float64 canonical
    limbs, the layout of the reference's program output."""
    out = np.zeros((len(values), 6, 2, 13), dtype=np.float64)
    for lane, v in enumerate(values):
        for k in range(6):
            for c in range(2):
                out[lane, k, c] = bn254_kernel.to_limbs(v[k][c] % bn254_kernel.P)
    return out


def levels_from_jax(levels, device="cpu") -> torch.Tensor:
    """The reference's tree levels, a sequence of uint32[8, m] arrays
    (leaves first) -> int32[total, 8], the levels entry's layout."""
    levels = [np.asarray(lv) for lv in levels]
    rows = merkle_kernel.level_rows(levels[0].shape[1]) if levels else []
    if [lv.shape for lv in levels] != [(8, count) for _, count in rows]:
        raise ValueError(f"not the levels of one tree: {[lv.shape for lv in levels]}")
    return _tensor(np.concatenate([lv.T for lv in levels]), device)


def levels_to_jax(levels) -> tuple:
    """int32[total, 8] levels -> the reference's tuple of uint32[8, m]
    arrays, leaves first (the leaf count follows from total)."""
    arr = np.ascontiguousarray(levels.detach().cpu().numpy()).view(np.uint32)
    total, n = arr.shape[0], max(1, (arr.shape[0] - 64) // 2)
    while merkle_kernel.level_rows(n)[-1][0] + 1 < total:
        n += 1
    rows = merkle_kernel.level_rows(n)
    if rows[-1][0] + 1 != total or arr.shape[1:] != (8,):
        raise ValueError(f"{tuple(arr.shape)} is not the levels of any tree")
    return tuple(np.ascontiguousarray(arr[base : base + count].T) for base, count in rows)


def commit_from_wire(encoded: bytes) -> Commit:
    """A commit from its proto bytes (the reference's ``Commit.encode()``)."""
    return Commit.decode(encoded)


def signed_header_from_wire(encoded: bytes) -> SignedHeader:
    """A signed header from its proto bytes (``SignedHeader.encode()``)."""
    return SignedHeader.decode(encoded)


def validator_set_from_wire(validators) -> ValidatorSet:
    """A validator set from (public-key proto bytes, voting power) pairs,
    one a validator (the reference's ``pub_key_to_proto(v.pub_key)`` and
    ``v.voting_power``): the set is built as the reference builds it, so
    its order, proposer priorities, hash and encoding are the same."""
    return ValidatorSet([Validator.new(encoding.pub_key_from_proto(pk), power)
                         for pk, power in validators])


def block_from_wire(encoded: bytes):
    """A block from its proto bytes (``Block.encode()``)."""
    from cometbft_tpu_torch.types.block import Block

    return Block.decode(encoded)


def state_from_store_bytes(raw: bytes):
    """The chain state a state store keeps under ``stateKey``."""
    from cometbft_tpu_torch.state.store import _decode_state

    return _decode_state(raw)


def stores_from_items(items):
    """(BlockStore, StateStore) over a port ``MemDB`` holding ``items``, the
    (key, value) pairs of a node's database."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.state.store import StateStore
    from cometbft_tpu_torch.store import BlockStore

    db = MemDB()
    for k, v in items:
        db.set(bytes(k), bytes(v))
    return BlockStore(db), StateStore(db)


def light_block_from_wire(encoded: bytes):
    """A light block from its proto bytes (``LightBlock.encode()``)."""
    from cometbft_tpu_torch.types.light_block import LightBlock

    return LightBlock.decode(encoded)


def evidence_from_wire(encoded: bytes):
    """Duplicate-vote or light-client-attack evidence from its ``Evidence``
    oneof bytes (``encode_evidence(ev)``)."""
    from cometbft_tpu_torch.types.evidence import decode_evidence

    return decode_evidence(encoded)


def mmr_from_state_file(path: str):
    """The MMR a state file holds (``light/mmr.save_state``'s layout);
    raises ``MMRStateError`` on a file that does not check."""
    from cometbft_tpu_torch.light.mmr import load_state

    return load_state(path)


def mmr_to_state_file(mmr, path: str) -> None:
    """Write ``mmr``'s state file, which the JAX package's ``load_state``
    reads."""
    from cometbft_tpu_torch.light.mmr import save_state

    save_state(mmr, path)


def proposal_from_wire(encoded: bytes):
    """A proposal from its proto bytes (``Proposal.encode()``)."""
    from cometbft_tpu_torch.types.proposal import Proposal

    return Proposal.decode(encoded)


def vote_set_from_reference(chain_id: str, height: int, round_: int, signed_msg_type: int,
                            validators, votes, peer_maj23s=None):
    """A port ``VoteSet`` over ``validators`` ((public-key proto bytes,
    power) pairs, as ``validator_set_from_wire`` takes them), built by
    replaying a reference vote set: first its peers' +2/3 claims
    (``peer_maj23s``: peer id -> ``BlockID.encode()`` bytes), then its votes
    (``Vote.encode()`` bytes) in the order they were added. A conflicting
    vote that the reference kept (its block is claimed by a peer) is kept
    here too; its ``ErrVoteConflictingVotes`` is the replay's, not an
    error."""
    from cometbft_tpu_torch.types.block import BlockID
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.types.vote_set import ErrVoteConflictingVotes, VoteSet

    vs = VoteSet(chain_id, height, round_, signed_msg_type, validator_set_from_wire(validators))
    for peer, bid in (peer_maj23s or {}).items():
        vs.set_peer_maj23(peer, BlockID.decode(bid))
    for raw in votes:
        try:
            vs.add_vote(Vote.decode(raw))
        except ErrVoteConflictingVotes:
            pass
    return vs


def file_pv_from_state_files(key_path: str, state_path: str):
    """The ``FilePV`` the reference's key file and last-sign-state file
    describe (its JSON layout); the port writes the same bytes back."""
    from cometbft_tpu_torch.privval.file import FilePV

    return FilePV.load(key_path, state_path)


def wal_messages_from_file(path: str) -> list:
    """The ``TimedWALMessage``s of the consensus WAL at ``path``, in order."""
    from cometbft_tpu_torch.consensus.wal import read_messages

    return read_messages(path)


def node_key_from_file(path: str):
    """A ``NodeKey`` from a ``node_key.json`` (the reference's
    ``NodeKey.save_as``): the same private key, so the same node ID."""
    from cometbft_tpu_torch.p2p.key import NodeKey

    return NodeKey.load(path)


def node_key_from_seed(seed: bytes):
    """A ``NodeKey`` over the ed25519 key of a 32-byte seed."""
    from cometbft_tpu_torch.crypto import ed25519, ed25519_pure
    from cometbft_tpu_torch.p2p.key import NodeKey

    return NodeKey(ed25519.PrivKey(bytes(seed) + ed25519_pure.public_key(bytes(seed))))


def node_info_from_wire(encoded: bytes):
    """A ``NodeInfo`` from its proto bytes; it encodes to the same bytes."""
    from cometbft_tpu_torch.p2p.node_info import NodeInfo

    return NodeInfo.decode(encoded)


def indexers_from_items(items):
    """The port's ``KVTxIndexer`` and ``KVBlockIndexer`` over one ``MemDB``
    holding a reference index's (key, value) pairs (its indexers' DB items,
    the tx and block indexes in one DB or two): the keys and values are the
    same bytes in both packages."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.state.txindex import KVBlockIndexer, KVTxIndexer

    db = MemDB()
    for k, v in items:
        db.set(bytes(k), bytes(v))
    return KVTxIndexer(db), KVBlockIndexer(db)


def proof_ops_from_wire(encoded: bytes):
    """A ``crypto/merkle.proof_op.ProofOps`` from its proto bytes
    (tendermint.crypto.ProofOps, as ``ResponseQuery.proof_ops`` carries it)."""
    from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOps
    from cometbft_tpu_torch.wire.types import decode_proof_ops

    return ProofOps(ops=decode_proof_ops(encoded))


def p2p_config_from_fields(fields: dict):
    """A ``P2PConfig`` from a mapping of the reference's fields."""
    import dataclasses

    from cometbft_tpu_torch.config import P2PConfig

    return P2PConfig(**{f.name: fields[f.name] for f in dataclasses.fields(P2PConfig)})


def config_from_toml(text: str):
    """A port ``Config`` from the text of a ``config.toml`` (the reference's
    ``render_toml``), layered over the defaults as ``load_toml`` does."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.config.toml import apply_toml
    from cometbft_tpu_torch.libs import tomlcompat

    return apply_toml(Config(), tomlcompat.loads(text))


def addr_book_from_file(path: str, strict: bool = True):
    """A port ``AddrBook`` loaded from the reference's ``addrbook.json``."""
    from cometbft_tpu_torch.p2p.pex import AddrBook

    return AddrBook(path, strict=strict)


def snapshot_from_wire(encoded: bytes):
    """An ``abci.Snapshot`` from its proto bytes (types.proto Snapshot)."""
    from cometbft_tpu_torch.abci import wire

    return wire._dec_snapshot(encoded)


def state_to_store_bytes(state) -> bytes:
    """A ``State`` as the bytes a state store keeps under ``stateKey``."""
    from cometbft_tpu_torch.state.store import _encode_state

    return _encode_state(state)
