"""Smoke run of the PyTorch/CUDA port (cometbft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --bn254-lanes   # only the bn254 kernel's times
    python3 chip_smoke.py --blocksync     # only the blocksync path (and what it needs)
    python3 chip_smoke.py --light         # only the light path (and what it needs)
    python3 chip_smoke.py --consensus     # only the consensus path (and what it needs)
    python3 chip_smoke.py --network       # only the network path (and what it needs)
    python3 chip_smoke.py --rpc           # only the RPC path (and what it needs)
    python3 chip_smoke.py --node          # only the node path (and what it needs)
    python3 chip_smoke.py --ingress       # only the node path's (j), timed three times
    python3 chip_smoke.py --statesync     # only the statesync path (and what it needs)
    python3 chip_smoke.py --ops           # only the ops path (and what it needs), timed

Drives the port's paths at the repo's headline sizes. The Ed25519 / Merkle
path is the ``VerifyBackend`` contract through ``TorchBackend()``: one
10,240-signature commit (vote-shaped challenges) plus the RFC-6962 root of
a 65,536-leaf block. The proofs path is ``proofs_from_byte_slices_device``
(one inclusion proof a transaction or block part) at that block, at 10,000
leaves and at a 21 MiB block's 336 parts of 64 KiB. The sidecar path is the
port's entry point, ``SidecarServer`` over a local socket. The BN254 path is
the aggregate-commit contract through ``Bn254DeviceBackend()``: one
10,240-validator aggregate commit (README "Aggregate BLS commits") and a
16-vote bitmap batch. The hybrid path is ``HybridBackend()`` (the card and
the native host MSM) at the commit and block, and the chain path the
supervised chains (``build_resilient()``, ``build_bn254_chain()``) with and
without an injected fault. The auto path is the process default
(``get_backend()`` under ``CMTPU_BACKEND=auto``), the fanout path the fleet
tier (two port sidecars, one in another process, and the local hybrid), the
proofs paths ``crypto/merkle``'s selection, the tooling path the
profiling endpoints, ``entry.py`` and the device probe, the commit path
commit verification (``types/validation``, ``light/verifier``) of a
10,240-validator set's commits and hops, the blocksync path a fresh
node syncing a 10,240-validator chain (and a 150-validator one) from peers
through ``blocksync/reactor.BlocksyncReactor``, which verifies each window
of commits in one backend call and applies each block through
``state/execution.BlockExecutor``, the kvstore application and the mempool,
the light path the light client (``light/client.Client``: bisection
whose descent prewarms a whole hop chain's commits in one backend call),
its gateway, the detector and the evidence pool over those chains, and the
consensus path the state machine (``consensus/state.ConsensusState``,
whose receive routine prebatches each drain's votes in one backend call):
the simnet of 150 validators and one node following the 10,240-validator
chain's consensus, and the network path the same node fed over TCP by 8
peers through the port's p2p stack (``p2p/``: SecretConnection,
MConnection, the Switch) and ``consensus/reactor.ConsensusReactor``, with a
4-validator mesh over TCP and over ``simnet/transport.SimTransport``, and
the RPC path a restart through ``consensus/replay.Handshaker``, a light
client syncing the 10,240-validator chain over HTTP from the port's
``rpc/jsonrpc/server.JSONRPCServer`` (``rpc/core`` routes, ``rpc/client``)
and a one-validator chain served over RPC with proven answers
(``state/txindex``, ``crypto/merkle/proof_op``), and the node path the
port's ``node/node.Node`` as ``default_new_node`` builds it from a home on
disk: a node admitting signed transactions through its QoS ingress
(``mempool/ingress``) over HTTP, a fresh node catching up with the
10,240-validator chain over TCP (blocksync, PEX, the consensus catch-up),
and an operator's validator (its key in a signer process,
``privval/signer``; its app behind the ABCI socket, ``abci/``; a
``light/proxy.LightProxy`` in front of its RPC), and the statesync path a
fresh node joining the 10,240-validator chain by statesync
(``statesync/syncer``, ``statesync/stateprovider``: a snapshot from a peer,
verified by the light client over HTTP, restored over the ABCI socket).
In order:

  1. prints the PyTorch version and the card (name, power limit);
  2. builds the CUDA kernels from ``cometbft_tpu_torch/ops/csrc``; then
     (after the issue rates of step 4 are measured) starts two processes
     that load them: ``python -m cometbft_tpu_torch.sidecar`` on
     127.0.0.1:0 (the fleet's remote shard, warmed) and ``python -m
     cometbft_tpu_torch.probe.device``, and waits for both to be done with
     their first use of the card before anything is timed;
  3. makes the fixtures from fixed seeds (keys, signatures, leaves, parts);
  4. holds each kernel against its plain PyTorch version on the card at the
     main path's shapes (exact equality; bn254 equal mod P), and times both
     (the kernel by CUDA events over back-to-back launches and by its own
     device time in a torch.profiler trace, ``kernel_ms``): sha512's
     ``challenge_digits`` on the commit and on a ragged batch up to 32
     blocks with a zero-block lane (k also against hashlib), and its
     ``scalar_digits`` with the all-ones and zero digests, s = L - 1 and
     s = 0; ``decompress_words`` on the commit's A and R words with the
     ZIP-215 edge encodings mixed in; the ladder (fused with the
     cofactored epilogue) at every group width it is built for, timed in
     turns, verdict and accumulator; the sha256 tree entry at the 65,536-
     and 10,000-leaf roots, its leaf and inner entries level by level, and
     its levels entry (every tree level, what the proofs run) at 65,536 and
     10,000 leaves, at the part set, its ragged form and a short/long mix
     (the long-leaf sets' plain version on the CPU, in the process pool the
     fixtures are signed in, started after the build, while the card's
     comparisons run), and the part set's block cut into leaves of several
     lengths under each leaf load and chunk; the bn254 Miller loop at 8,192, 4,096 and 32
     lanes (the aggregate's two chunks, the vote batch) with edge lanes (the padding lane, coordinates 0, 1 and
     P - 1, off-curve field elements); prints ptxas's registers and spills,
     the ladder's and bn254's launch shapes and, where cuobjdump exists,
     the ladder's SASS instruction mix, the measured issue rates of the
     instructions it runs on (``cometbft_tpu_torch/probe``) and the
     issue-time estimate they give;
  5. runs the Ed25519 / Merkle path (launch counters zeroed just before):
     the valid commit, the commit with localized corruptions, the ZIP-215
     edge batch, an oversized message (host-hash program), the 65,536- and
     10,000-leaf roots, each against its expected answer, and asserts one
     sha512, one decompress and one ladder launch a batch and two sha256
     launches a root; then times ``verify_10k_commit_plus_64k_merkle_ms``
     and its stage split, and traces one such call (``torch.profiler``:
     each kernel's device time, and the device's busy time over the call);
  6. runs the proofs path (counters zeroed just before): at each size the
     root and every proof equal the host's ``proofs_from_byte_slices_pure``,
     every 97th proof and the last verify, two sha256 launches a proof set;
     then times ``proofs_64k_ms``, its stage split and the host's time;
  7. runs the sidecar path: ``SidecarServer`` on 127.0.0.1:0 in this
     process serving ``TorchBackend()``, warmed; the port's ``GrpcBackend``
     sends every request of step 5 through the socket (the commit streamed
     in chunks) and the commit once more unary, each answer held as in step
     5, three launches a verify dispatch and two a root; then times
     ``sidecar_verify_10k_commit_plus_64k_merkle_ms`` beside the in-process
     headline, with the warm-up's seconds and the scheduler's counters; the
     server's and client's threads end at shutdown;
  8. runs the BN254 path (counters zeroed just before): the 10,240-validator
     aggregate accepts, the aggregate with one signer's share left out
     rejects, each in two bn254 launches (8,192 lanes + a bucket of 4,096),
     and the 16-vote batch with one bad signature gives the exact bitmap in
     one launch; then the aggregate's stage split (parse and decompress,
     hash, pack, kernel, unpack, Fp12 product, final exponentiation);
  9. runs the hybrid path (counters zeroed after TorchBackend's answers):
     ``HybridBackend()`` warmed as the sidecar warms it (the native host
     library built, the card's walls at 128, 1,024 and 10,240), three forced
     shares through ``_routed_call`` (0, all host; HYBRID_SPLIT, which puts
     the corrupted commit's bad indices on both sides; the whole commit)
     on the valid and the corrupted commit, each bitmap equal to
     TorchBackend's, ``verify_and_root`` equal to TorchBackend's bitmap and
     root, then HYBRID_CALLS planned calls; three launches a call with a
     device share, none else; prints the planner's shares, ``last_timing``
     and learned rates, then the medians of the hybrid, TorchBackend and
     CpuBackend at the commit, the roots and ``verify_and_root``, the rate
     seeds this run gives (``sidecar/backend.HOST_SIGS_PER_MS`` and the
     card's two), and the same three medians (and the native MSM's) at the
     smaller batches of HYBRID_SMALL_SIGS, each bitmap checked, with the
     share the planner gave the card; the roots at HYBRID_ROOT_LEAVES, the
     native tree against the card (bytes equal, medians of 5), and the root
     cost model's seeds they give (``CARD_ROOT_MS``, ``CARD_LEAVES_PER_MS``,
     ``HOST_LEAVES_PER_MS``); the warmed hybrid's 65,536-leaf root must go
     to the card (two sha256 launches);
 10. runs the chain path (counters zeroed): ``build_resilient()`` serves
     the commit, the corrupted commit and the root from ``hybrid`` with no
     degradation; the hybrid wrapped in a ChaosBackend at error rate 1.0
     degrades to ``cpu`` with the same bitmaps;
     ``ResilientBackend(build_bn254_chain())`` serves the 16-vote batch's
     exact bitmap from ``bn254-device`` (one bn254 launch), then, its
     device tier wrapped at error rate 1.0, from ``bn254-host``;
 11. runs the auto path: a fresh ``get_backend()`` under
     ``CMTPU_BACKEND=auto`` (the coalesced chain, its hybrid warmed), then,
     counts zeroed, the commit, the corrupted commit and AUTO_SIGS' smaller
     batches, each bitmap equal to TorchBackend's, served by ``hybrid`` with
     no degradation, the first 150-signature call with a share on the card;
     medians of 5 beside TorchBackend's; ``set_backend(None)`` closes it;
 12. runs the fanout path: medians of the fleet's commit beside
     TorchBackend's and its walls at FANOUT_FIT_SIGS (its fixed cost,
     ``fanout.FANOUT_DISPATCH_MS``); counts zeroed, ``build_resilient()``
     headed by ``fanout`` of width 3, exact bitmaps; the other process
     killed, one redistribution and exact bits, the root failed over;
 13. runs the proofs paths (counts zeroed): the card and the native host
     pass at the 65,536-leaf block and the part set, equal to the pure pass
     on every 97th proof, medians of 3, and the default's path
     (``crypto/merkle.DEVICE_PROOFS_DEFAULT``);
 14. runs the tooling (counts zeroed): ``PprofServer`` on port 0,
     ``/debug/torch/memory`` after a headline call (allocated bytes on
     cuda:0) and ``/debug/torch/trace?seconds=1`` during headline calls (a
     trace written; whether it holds the ladder's record);
     ``dryrun_multichip(2)``; ``entry()``; the device probe's PROBE OK;
 15. runs the commit path: the commit fixtures, built with the port's
     types alone (``commit_fixtures``: the 10,240-validator ed25519 set of
     step 3's keys, headers at COMMIT_HEIGHT, +1 and +5 and their commits of
     canonical precommits, each signed by its validator in a pool of
     processes; a hop the trusted set cannot trust; a 150-validator commit;
     a 16-validator BN254 aggregate commit), their build time; then, counts
     zeroed, ``types/validation`` and ``light/verifier`` under
     ``set_backend(TorchBackend())``: verify_commit and verify_commit_light
     of the commit, the adjacent and the skipping hop pass, the commit with
     5 corrupted signatures names the lowest (the backend's bitmap false at
     exactly the 5), the commit with just over 1/3 of the power absent gives
     the exact got and needed, the untrustable hop raises
     ErrNewValSetCantBeTrusted, and the BN254 aggregate (and a copy with one
     wrong signer) goes through ``get_bn254_backend()``; one sha512 /
     decompress / ladder set a commit verification that reaches the backend
     (two for the skipping hop), one bn254 launch an aggregate, no
     ChainExhausted fallback; then ``verify_commit_10k_ms``: medians of 5 of
     each commit check at 10,240 and 150 validators and of both hops, under
     ``TorchBackend()`` and the process default in turns, each call from
     freshly decoded objects and an empty verified-triple cache, and one
     call's stage split (sign bytes, tally and ``bv.add``, cache filter, the
     backend call with its pack and kernels, the hop's hashes);
 16. runs the blocksync path: a source node (the port's BlockExecutor,
     CListMempool and PersistentKVStoreApplication over a MemDB) builds
     BSYNC_HEIGHTS blocks of the 10,240-validator set of step 3's keys
     (BSYNC_TXS kvstore transactions of BSYNC_TX_BYTES a block, every
     validator signing its precommit in the process pool) and
     BSYNC_SMALL_HEIGHTS blocks of a BSYNC_SMALL-validator set; then a
     fresh node syncs each through ``BlocksyncReactor`` from two peer
     doubles that answer block requests through ``receive``. Counts zeroed,
     pipeline off, the part sets' proofs on the card
     (``CMTPU_DEVICE_PROOFS=1``), under a recording backend around
     ``TorchBackend()``, each stage timed: the synced state and stored
     blocks equal the source's; the window calls carry the window
     arithmetic's batches (20,480 signatures at 10,240 validators, 4,650 at
     150) and the later checks send only what no window covered (counted by
     lanes); each part set took the path its size gives; one sha512 /
     decompress / ladder set a backend call and two sha256 launches a part
     set on the card; no error counted. A peer serving one block with a
     flipped commit signature bit is stopped exactly once and the other
     completes the sync (``sync_errors`` 1, ``prefetch_errors`` 0). Then
     ``blocksync_10k_ms_per_block`` and ``blocksync_150_ms_per_block``:
     the default (pipeline on, the native proofs pass) under
     ``TorchBackend()`` (under ``--blocksync`` the process default too, in
     turns), BSYNC_REPS rounds, the counted runs' pipeline off beside it,
     ``pipeline_overlap_ms``, the stage split of each height; no
     ChainExhausted fallback. Last, the
     three verify kernels at each batch shape the path gave them (both
     windows, one commit, both light checks: 20,480, 10,240, 6,827, 4,650
     and 101 lanes, four lanes of each corrupted), each against its plain
     version on the same operands (the plain versions once over every
     batch's lanes joined, each batch's lanes held to its own) with max abs
     err 0 and the verdicts false at exactly the corrupted lanes, then
     timed by events;
 17. runs the light path (``light/``, ``evidence/``, ``crypto/sigbatch``):
     fixtures built with the port's types (``light_fixtures``): a
     10,240-validator chain of LIGHT_HEIGHTS heights whose set rotates
     LIGHT_ROTATE keys a height (height 1's set is step 3's keys; only the
     heights the walk fetches, LIGHT_SIGNED, are signed), a 150-validator
     chain of LIGHT_SMALL_HEIGHTS rotating LIGHT_SMALL_ROTATE a height, and
     conflicting tips of step 16's two source chains, every signature in the
     process pool; then, counts zeroed, under a recording backend around
     ``TorchBackend()``: a client syncs the 10,240-validator chain from
     height 1 to 9 (skipping, trust level 1/3, an honest witness), and the
     150-validator chain's skipping (1 to LIGHT_SMALL_HEIGHTS), sequential (1 to 20) and
     backwards (50 to 40) clients; each trace equals the same client's
     under ``CpuBackend()`` and the walk's arithmetic (``light_walk``: the
     pivots fetched, the descents, the lanes of every backend call, so that
     the hop checks after a prewarm send none); LIGHT_SWARM clients on
     threads cold-sync the 150-validator chain through one ``LightGateway``
     under the port's ``CoalescingScheduler``, in plan mode and in MMR proof
     mode (one plan computed, the rest shared, one trace, at most one lone
     client's lanes plus the gateway's prewarm, every launch from the one
     device-owner thread); a witness serving a conflicting tip of step 16's
     150-validator source is caught (ErrLightClientAttack), the evidence
     reaches an ``EvidencePool`` over the source's stores and the source's
     executor commits it in the next block; a 10,240-validator attack
     evidence verifies (3,414 lanes); a duplicate vote verifies through
     sigbatch under ``TorchBackend()`` (its private window) and the process
     default (its engine), a flipped copy is refused; every error counter
     as planted (none), one sha512 / decompress / ladder set a card call.
     Then ``light_sync_10k_ms``, ``light_sync_150_ms`` and
     ``evidence_verify_10k_ms`` (medians of LIGHT_REPS, ``TorchBackend()``,
     under ``--light`` the process default too, in turns, cold caches),
     ``light_gateway_64_ms`` in each mode, the 10,240 sync's stage split,
     the lanes of every call by its caller; last, the three verify kernels at the path's own batches
     (the largest prewarm at each size, the evidence check), four lanes of
     each corrupted, held to their plain versions and timed;
 18. runs the consensus path (``consensus/``, ``types/vote_set``,
     ``simnet/``), launch counts zeroed before it and read after. (a) The
     port's simnet (``simnet/scenario``, CONS_SIM: 150 validators, 1 block,
     seed 7, 25 ms vote buckets, the simnet's WAN defaults over 4 zones),
     with one verified-triple cache a node (``SimCaches``: as in a network
     of a process a node, each node checks every vote it receives), under a
     recording ``TorchBackend()`` and, under ``--consensus``, the process
     default: each run ok, hash agreement and safety, no straggler, every
     error counter 0 (prebatch errors, consensus failures, drain failures,
     sigbatch fallbacks), the same block hashes, commit times, simulated
     time and events under both, card lanes at every height and one sha512 /
     decompress / ladder set a card call; a flood run (2 blocks, the
     reference's flooder window on node 1 with each replay's signature bit
     flipped and sent through the vote buckets): the card refuses the bad
     lanes, they land in the nodes' failed-triple memos, no flood vote is
     admitted, the chain commits. (b) A node with no priv validator (an
     ``EventBus``, a real WAL in a temporary directory) follows heights 1 to
     CONS_HEIGHTS of step 16's 10,240-validator source through ``start()``
     and ``send_peer_message``: each height's proposal (signed by its
     proposer), block parts, 10,240 prevotes (signed in the process pool)
     and the source's seen commit as 10,240 precommits. The counted run
     (a recording ``TorchBackend()``, each stage timed, one prevote
     corrupted): the stored blocks and states (the app hash) are the
     source's at every height and each seen commit holds the source's
     signatures over 2/3 of the power; the corrupted prevote is refused by
     the card, lands in the memo and never enters the vote set; the card's
     lanes at each height at least the votes the drains prebatched; the WAL
     holds the end heights; every error counter 0. Then
     ``simnet_150_ms_per_height`` (wall ms a committed height, with the
     card's calls and lanes a height and the scalar checks) and
     ``consensus_10k_ms_per_height`` (the proposal's enqueue to the commit,
     the median of heights 2 to CONS_HEIGHTS: under ``--consensus`` of
     timed runs under ``TorchBackend()`` and the process default in turns,
     in the full run of the counted run) with the stage split of each
     height; last,
     the three verify kernels at the path's batches (the follower's largest
     and smallest prebatch, the simnet's and the flood's largest bucket),
     four lanes of each corrupted, held to plain and timed;
 19. runs the network path (``p2p/``, ``consensus/reactor``,
     ``mempool/reactor``, ``simnet/transport``), launch counts zeroed before
     it and read after. (c) Path (b)'s follower with a ConsensusReactor on a
     Switch listening on 127.0.0.1:0, dialed by NET_PEERS relays (each a
     Switch with its own NodeKey, MultiplexTransport and SecretConnection
     and a feeder reactor on the consensus channels), which send each
     height's proposal, parts, prevotes and precommits split by index mod
     NET_PEERS, each announcing the height after the next (a peer ahead:
     the follower gossips nothing back). The counted run (a recording
     ``TorchBackend()``, one prevote corrupted) holds path (b)'s gates at
     every height (blocks, states, seen commits, the corrupted prevote
     refused, card lanes at least the votes prebatched, one sha512 /
     decompress / ladder set a card call, no sha256 or bn254, no error
     counted) and the wire's: bytes sent equal bytes received on every
     connection both ways (the flowrate monitors), the demux shed nothing
     of the consensus class, the relays received only NewRoundSteps, no
     error counted on any Switch, reactor, MConnection or SecretConnection;
     then, under ``--network``, NET_TIMED rounds of (b) and (c) in turns
     under ``TorchBackend()`` and the process default:
     ``consensus_10k_wire_ms_per_height`` (median of heights 2 to
     CONS_HEIGHTS; in the full run the counted run's) beside (b)'s,
     ``AEAD_PROVIDER``, each
     connection's handshake ms, bytes and frames a height, the demux's
     counters. (d) NET_MESH validators (the port's ConsensusState,
     ConsensusReactor and MempoolReactor on a Switch each) in a full mesh
     over TCP with NET_MESH_TXS kvstore transactions entered at node 0, to
     height NET_MESH_HEIGHTS: the same block at every height on every node,
     every transaction committed on every node, no error counted;
     ``tcp_mesh_4_ms_per_height`` and the card calls. (e) The same
     validators on SimTransport over one seeded SimNetwork (the simnet's
     WAN link defaults), cut 2|2 at height NET_SIM_CUT_AT: no height
     commits in the cut; ``heal()`` alone for NET_SIM_HEAL_ONLY_S (whether
     it reached the height, reported), then, where it did not, the cut's
     connections dropped and dialed again, to height NET_SIM_HEIGHTS with
     the same blocks on every node;
     last, the three verify kernels at (c)'s largest and smallest batch,
     four lanes of each corrupted, held to plain and timed;
 20. runs the RPC path (``consensus/replay``, ``state/txindex``,
     ``rpc/``, ``crypto/merkle/proof_*``), launch counts zeroed before it
     and read after. (f) The Handshaker over copies of step 16's
     10,240-validator source stores with a fresh kvstore, event bus and KV
     indexers: (i) the app wiped, every block replayed through the app (no
     backend call) to the source's app hash and state, the indexes rebuilt
     from the stored responses holding every transaction, a doctored app
     hash refused with AppHashMismatchError's text; (ii) the crash after
     ``save_block`` (store 6, state 5, app 5): the final block through
     ``apply_block``, its 10,240-signature LastCommit verified on the card
     in one call (one verify launch set), its 4,096 transactions indexed by
     the IndexerService from the bus, no pump left after ``stop()``;
     ``handshake_replay_10k_ms`` of each from a bare run, its stage split
     from a second, instrumented run. (g) The port's JSONRPCServer in a
     process of its own (started before (f), sent (f)'s indexes after it)
     serving ``routes(Environment(...))`` over the
     source's stores and (f)'s indexes; the port's light client over
     ``HTTPProvider(HTTPClient(url))`` as primary and witness, height 1
     trusted in its store, syncs to 6 from a cold cache (a recording
     ``TorchBackend()``: three launches a card call, every one from the
     device-owner thread; the trace equal to a BlockStoreProvider client's):
     ``rpc_light_sync_10k_ms``, split by route (the port's ``HTTPClient``
     timed in place: ``_post``, the HTTP exchange, and the rest of ``call``,
     the JSON decode; 103 /validators pages a light block); a second server
     whose tip commit
     carries a flipped signature is refused (the reference's ValueError and
     text); under ``--rpc`` the default's sync too, in turns. (h)
     A one-validator chain, a port ``Node`` built by ``default_new_node``
     from a home on disk (FilePV, provable kvstore, the WAL, the ingress in
     front of CListMempool, the event bus, IndexerService, JSONRPCServer),
     takes RPC_TXS transactions
     through ``broadcast_tx_async`` over HTTP before its first height, then
     RPC_COMMIT_TXS through ``broadcast_tx_commit``; a websocket on NewBlock
     sees every height; under ``CMTPU_DEVICE_PROOFS=1`` the card's proof
     set of the first block (every proof) and every RPC_PROOF_STRIDE-th
     ``tx?prove=true`` answer over HTTP verify against its data hash, and
     proven ``abci_query`` answers through
     ``default_proof_runtime()`` against the next header's app hash, each
     card answer equal to the native pass's (every RPC_NATIVE_STRIDE-th tx),
     two sha256 launches a proof set, each from the thread that asked for
     the set (the block's on the main thread, each answer's on the server's
     request thread); ``rpc_chain_ms_per_height`` and ms a proven answer. Last, the verify kernels at the final block's 10,240
     lanes and at the HTTP sync's largest and smallest batch (four lanes of
     each corrupted) and the sha256 levels entry at the first block's
     transactions and the kv leaves, each held to its plain version and
     timed;
 21. runs the node path (``node/``, ``config/``, ``mempool/ingress``,
     ``p2p/pex``, ``statesync/``), launch counts zeroed before it and read
     after. Every node is built by ``default_new_node(load_toml(...))``
     from a home the port's own functions wrote (``write_config_file``, the
     genesis, ``FilePV``, ``NodeKey``), under ``test_config()`` with p2p
     and RPC on 127.0.0.1:0 and a loopback address book, every other field
     at the reference's default; (k)'s server process is started first,
     and builds while (j) runs. (j) A one-validator node (its own FilePV,
     the kvstore) under a recording ``TorchBackend()``: NODE_SENDERS
     senders' NODE_PER_SENDER signed envelopes each (one of each sender's
     corrupted) through ``broadcast_tx_async`` from NODE_CLIENTS HTTP
     threads, then a valid, a corrupted, a malformed and a duplicate one
     through ``broadcast_tx_sync`` (codes 0, 102, 101, 105): every valid
     envelope in exactly one block, no corrupted or malformed one at the
     app's CheckTx, the preverify lanes the sigs less the verified-triple
     cache hits, ``preverify_fallbacks`` and every error counter 0, three
     launches a card call from the device-owner thread, the
     ``ingress_stats`` route equal to ``stats()``, lanes descending within
     each block; ``node_ingress_4096_ms`` (the first send to the store of
     the height holding the last valid envelope) with its split. (k) The
     10,240-validator source's stores under a non-validator node in a
     process of its own (its Handshaker replays the app); a fresh node
     with it as persistent peer: the counted catch-up (the blocksync
     pipeline off, each stage timed): the last height but one reached by
     blocksync with the source's blocks and state, blocksync's batches
     adding up to the window arithmetic (over TCP blocks may come one at a
     time: no window is required, the light and full checks are counted),
     then the handoff to consensus and
     its catch-up of the last height within NODE_LAST_WAIT_S
     (NODE_DEEP_WAIT_S under ``--node``; reported: in both packages it can
     stall, ROADMAP §3), each address book holding the other node, PEX
     messages both ways, no error counted on either node, every verify
     launch from the device-owner thread, three a card call;
     ``node_catchup_10k_ms_per_block`` (the start to blocksync's last
     height) from that run, and under ``--node`` from bare runs under
     ``TorchBackend()`` and the process default. Last, the three verify kernels at
     (j)'s smallest, median and largest preverify batch (one valid lane
     corrupted under 8 lanes, else four; the envelopes the ingress refused
     stay rejected) and at (k)'s batches as the counted catch-up sent
     them (the first light check, full check and consensus batch, and the
     first window of each size if any came; four lanes corrupted, one under
     8 lanes), held to their plain versions and timed. (m) An operator's
     validator: a signer process (``python -m
     cometbft_tpu_torch.privval.signer`` over a FilePV) and a provable
     kvstore behind the port's ``ABCIServer`` in a process of its own, a
     one-validator node by ``default_new_node`` (``priv_validator_laddr``,
     a ``tcp://`` proxy_app) and a ``LightProxy`` trusting its height 1:
     OP_TXS txs through the proxy's ``broadcast_tx_sync`` and the heights
     that hold them, OP_QUERIES proven ``abci_query``s through it, a
     tampered and a stripped answer refused with the reference's errors,
     the signer killed and started again (the node commits
     OP_AFTER_RESTART heights more, each height's one precommit the
     signer's over the stored block); every card call a proxy header
     check of one lane, three launches from the device-owner thread;
     ``operator_ms_per_height`` and ``proxy_query_ms``;
     then, while (k)'s server is still up, the ops path (n), the operator's
     tier through the port's CLI (``cmd/``), launch counts zeroed before it
     and read after (its own ``ops`` entry; ``--ops`` runs it alone, with
     OPS_REPS timed (n1) runs under ``TorchBackend()`` and the process
     default in turns). (n1) ``rollback`` then ``replay`` called through
     ``cmd.__main__.main`` on a sqlite copy of (k)'s server's home (the
     source's stores, 6 blocks of 4,096 txs) under a recording
     ``TorchBackend()`` with a cold verified-triple cache: rollback's line
     and state the source's at 5, the replayed state the source's at 6,
     two card calls of 10,240 lanes (the Handshaker's final block's
     LastCommit, then consensus's LastCommit rebuilt from the seen
     commit), three launches a call from the device-owner thread; ``inspect`` serves status,
     block, commit and validators as over the source's home;
     ``reindex-event`` keeps every record the replay indexed live and
     finds every height's txs; ``cli_replay_10k_ms`` and the Handshaker's
     stages. (n2) ``python -m cometbft_tpu_torch.cmd init`` and ``start``
     in processes of their own (the source's genesis, (k)'s server the
     persistent peer, Prometheus, the psql sink, pprof, CMTPU_WATCHDOG,
     CMTPU_WAL_GROUP_MS, the process default): blocksync to 5 on
     ``/metrics`` (``cli_catchup_10k_ms_per_block``, ``metrics_scrape_ms``),
     the backend gauges clean and the engine's blocksync lanes the window
     arithmetic's (the pre-warm sends it no lane), a
     ``/debug/torch/trace`` window from its start holding the three verify
     kernels, the sink holding every tx of heights 1-5 once by plain SQL,
     SIGINT ending it with exit code 0, no thread left, no sampler error
     and no stall report; ``replay`` on its home gives its height. (n3)
     ``loadtime --signed`` (4 validators, 1 connection, OPS_LOAD_RATE tx/s,
     OPS_LOAD_BLOCKS blocks) under a recording ``TorchBackend()``: the
     report covers exactly those blocks, at least OPS_LOAD_MIN_SHARE of
     the asked rate times the window committed in it, no submission or
     node stop raised (the command's stderr line), ingress-class
     calls among the card calls, three launches a call from the
     device-owner thread (``loadtime_tx_latency_p50_ms``,
     ``loadtime_block_interval_mean_ms``); last, the verify kernels at
     (n)'s batches (the replay's 10,240 lanes, (k)'s window, light and full
     checks, the smallest and largest ingress batch), held to plain with
     four lanes corrupted (one under 8 lanes) and timed;
 22. runs the statesync path (``statesync/``, ``abci/``, ``light/``),
     launch counts zeroed before it and read after. (l) Its servers start
     before step 21: (g)'s RPC server over the 10,240-validator source
     (its doctored /commit at height 5), the snapshot peer's kvstore
     (``python -m cometbft_tpu_torch.abci.server persistent_kvstore
     --snapshot-interval 4``) and the snapshot peer (a non-validator port
     Node over a sqlite copy of the source's stores, that socket its
     proxy_app: its Handshaker replays blocks 1-6 through it, so the app
     holds a snapshot at 4). A fresh node by ``default_new_node`` with
     statesync on (the honest server its RPC server, height 1 trusted by
     hash, discovery SS_DISCOVERY_S), its kvstore a process behind the
     socket, the snapshot peer its persistent peer, under a recording
     ``TorchBackend()``: it restores height 4 (the state the source's but
     the field the provider sets), bootstraps and blocksyncs to 5 (gated;
     6 reported); the app saw one OfferSnapshot and one
     ApplySnapshotChunk a chunk; the card calls the light walk's six;
     three launches a call from the device-owner thread;
     ``statesync_errors`` and every error counter 0; no thread left after
     ``stop()``, no process after the phase; ``statesync_join_10k_ms``
     (to the bootstrap and to blocksync's last height) split into
     discovery, chunk fetch, apply over the socket, the provider's HTTP
     routes, the card calls, bootstrap and blocksync. Under
     ``--statesync`` also a join under the process default and the
     refusal: with the doctored server, the syncer retries the snapshot
     with the reference's error until its deadline (cut to
     SS_REFUSAL_TIMEOUT_S), the node counts one statesync error and
     blocksyncs from genesis to 5. Last, the verify kernels at (l)'s
     largest and smallest batch, four lanes of each corrupted, held to
     plain and timed;
 23. runs the mesh path (the lane-split programs) on two virtual shards of
     the card: first the sha256 digests entry against its plain version on
     every word at the block's 65,536 leaf digests and at 10,000, 3 and 1
     (timed beside its bound), then, counters zeroed, TorchBackend and
     Bn254DeviceBackend routed over the mesh (the commit, the corrupted
     commit, the 65,536-leaf root, the 10,240-validator aggregate and the
     one with a share left out), the sharded and replicated verify, the
     digest forest, the fused leaves-to-root and the commit step called
     directly, and multihost_commit_step, multihost_verify and
     MultihostShardBackend on a one-rank NCCL group: each bitmap equal to
     TorchBackend's on one device, each root the host's, each step's
     launches exact; then ``mesh_commit_step_10k_64k_ms`` (two virtual
     shards on one card, not a multi-GPU figure);
 24. prints the ``kernels`` line (launches summed over the paths, and by
     path), the card line and, last, the result line.

Any failure raises and exits nonzero, and ends the processes it started.
Without CUDA it exits nonzero before printing any result. It imports
nothing of JAX or of ``cometbft_tpu``.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_SIGS = 10_240
N_LEAVES = 65_536
N_RAGGED_LEAVES = 10_000
SEED = 20_260_417
# A block cut into parts of BLOCK_PART_SIZE_BYTES (the reference's
# types/block.py:26): 336 parts of 64 KiB, a 21 MiB block.
N_PARTS = 336
PART_BYTES = 65_536

# Hopper's 32-bit integer add / multiply-add / logic / shift rate per SM
# per clock (CUDA C Programming Guide, arithmetic throughput, cc 9.0).
INT32_OPS_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# Operation counts behind each kernel's bound (see PERF.md).
# 32x32->64 multiply-adds of one radix-2^25.5 field multiply (10 x 10
# limb products) and of one squaring (10 squares + 45 doubled cross terms)
FE_MUL_OPS = 100
FE_SQ_OPS = 55
# Ladder, a lane: the [1..8](-A) table (to_precomp, then 7 x (add_precomp 8
# + to_precomp 1)); 64 windows of 4 doublings (4 squarings and 3
# multiplies each, 4 in the last), add_precomp (8) and add_precomp_z1 (7);
# the epilogue's point_add (9) and 3 doublings without T.
LADDER_FE_MULS = 1 + 7 * 9 + 64 * (3 * 3 + 4 + 8 + 7) + 9 + 3 * 3
LADDER_FE_SQS = 64 * 4 * 4 + 3 * 4
# Decompress, a lane: the (p-5)/8 chain (251 squarings, 11 multiplies) and
# 4 squarings and 9 multiplies around it.
DECOMPRESS_FE_MULS = 11 + 9
DECOMPRESS_FE_SQS = 251 + 4
DECOMPRESS_GROUP = 1  # threads a lane (kGroup in decompress.cu)
SHA512_BLOCK_OPS = 2 * (80 * 25 + 64 * 13 + 8)  # 64-bit ops, two 32-bit ops each
# What sha512 does a lane after hashing, in 32-bit operations: k mod L
# (three folds: 18 products of 64-bit words, 4 multiply-adds and 4 adds
# each; 9 high words of 3 shifts and an or, twice; 16 words of
# add-then-subtract with carries, 16; the 4-word conditional subtraction,
# 14 a word) and the recodes of k and s (4 words of add with carry, 8
# each, and 64 digits of shift, mask and subtract).
SCALAR_LANE_OPS = 18 * 8 + 9 * 6 + 16 * 16 + 4 * 14 + 2 * (4 * 8 + 64 * 3)
SHA256_BLOCK_OPS = 64 * 25 + 48 * 13 + 8
# BN254 Miller loop, a lane, by the reference program's formulas
# (cometbft_tpu/ops/bn254_kernel.py:352): 64 doubling steps of 157 Fp
# multiplies (f^2 63: 21 Fp2 products of 3; the doubling 40, its line 54),
# 38 addition steps of 97 (the addition 43, its line 54) and 26 conversions
# into and out of Montgomery form; 136 32x32->64 products a multiply (CIOS
# over eight words: 64 for a*b, 8 quotient words, 64 for m*p). The bound
# holds to this count whatever the kernel's schedule does: that schedule's
# own count (bn254_schedule.lane_muls(), fewer, with Fp2 squares in 2
# products) is printed beside it. Bytes: P, Q, pi(Q), -pi^2(Q) in and the
# Fp12 value out, 13 float64 limbs an Fp element.
BN254_FP_MULS = 64 * 157 + 38 * 97 + 26
BN254_FP_MUL_OPS = 136
BN254_LANE_BYTES = (2 + 3 * 4 + 12) * 13 * 8
# The bn254 launches of the BN254 path: the aggregate's chunks (8,192 lanes
# and the bucket of 4,096 its 2,049 left-over lanes take) and the 16-vote
# batch (32 lanes). The earlier one-thread-a-lane kernel's time at each, by
# CUDA events on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, the kernel
# table): the team kernel fails the run where it is not faster.
BN254_LANE_COUNTS = (8192, 4096, 32)
ONE_THREAD_BN254_MS = {8192: 21.24, 4096: 21.80, 32: 17.96}
# The part set's ragged form (a block whose size is not a multiple of 64
# KiB: its last part shorter) and a mix of short leaves and long ones (every
# 5th; long on average, so the long-leaf levels launch).
RAGGED_LAST_PART = 12_345
# The levels entry's leaf loads and chunk, timed apart: the part set's block
# cut into leaves of each length, under byte loads in chunks of CHUNK (the
# short-leaf launch), byte loads in chunks of LONG_LEAF_CHUNK, and word
# loads in chunks of LONG_LEAF_CHUNK (the long-leaf launch); the lengths
# span merkle_kernel.LONG_LEAF_BYTES, where the wrapper switches.
SWEEP_LEAF_BYTES = (256, 1024, 2048, 4096, 16_384, 65_536)
N_MIX = 100
MIX_LONG = (65_536, 65_537, 4_095, 20_000, 65_535, 8_191)
N_VALIDATORS = 10_240
N_VOTES = 16
BAD_VOTE = 9


T_START = time.perf_counter()  # the run's clock, for ``stamp``


def stamp(what: str) -> None:
    """Prints the seconds since the run started beside what starts now."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# -- fixtures ----------------------------------------------------------------


class FixedBase:
    """[k]B by a precomputed table of j * 16^w * B (64 windows of 16):
    64 point additions a scalar instead of double-and-add's ~380, so
    20,480 fixture scalar multiplications take seconds."""

    def __init__(self, pure):
        self.pure = pure
        self.rows = []
        step = pure.BASE
        for _ in range(64):
            row = [pure.IDENTITY]
            for _ in range(15):
                row.append(pure.point_add(row[-1], step))
            self.rows.append(row)
            step = pure.point_add(row[15], step)

    def mult(self, k: int):
        acc = self.pure.IDENTITY
        for w in range(64):
            nib = (k >> (4 * w)) & 15
            if nib:
                acc = self.pure.point_add(acc, self.rows[w][nib])
        return acc


def sign_known(pure, fb: FixedBase, seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """The RFC 8032 signature of msg under seed, whose key pub is known
    (the pure module's sign, with [r]B from the fixed-base table)."""
    a, prefix = pure.secret_expand(seed)
    r = pure.sha512_mod_l(prefix, msg)
    rs = pure.point_compress(fb.mult(r))
    k = pure.sha512_mod_l(rs, pub, msg)
    return rs + ((r + k * a) % pure.L).to_bytes(32, "little")


def sign_batch(pure, fb: FixedBase, seeds, msgs):
    """RFC 8032 keys and signatures ([a]B from the fixed-base table too)."""
    pubs = [pure.point_compress(fb.mult(pure.secret_expand(seed)[0])) for seed in seeds]
    return pubs, [sign_known(pure, fb, *job) for job in zip(seeds, pubs, msgs)]


def make_fixtures(pure, n_sigs: int, n_leaves: int):
    """The keys (from fixed seeds) and their signatures of one message each,
    made in the pool (``sign_jobs``, as ``sign_batch`` makes them), the
    block's leaves and the part set's parts."""
    fb = FixedBase(pure)
    seeds = [hashlib.sha256(b"chip-smoke-key-%d-%d" % (SEED, i)).digest() for i in range(n_sigs)]
    msgs = [b"commit-vote-%d" % i for i in range(n_sigs)]

    def pooled(jobs):
        chunks = [jobs[i : i + 512] for i in range(0, len(jobs), 512)]
        return [x for c in sign_pool().map(sign_jobs, chunks, chunksize=1) for x in c]

    pubs = pooled([("pub", s) for s in seeds])
    sigs = pooled([("ed25519", s, p, m) for s, p, m in zip(seeds, pubs, msgs)])
    leaves = [b"bench-tx-%08d" % i for i in range(n_leaves)]
    block = np.random.default_rng(SEED).bytes(N_PARTS * PART_BYTES)
    parts = [block[i * PART_BYTES : (i + 1) * PART_BYTES] for i in range(N_PARTS)]
    return fb, seeds, pubs, msgs, sigs, leaves, parts


def _enc_int(y: int, sign: int = 0) -> bytes:
    return (y | (sign << 255)).to_bytes(32, "little")


def zip215_edge_batch(pure, pub, msg, good):
    """Non-canonical A/R, small order, s-range boundaries, malformed
    inputs and corruption in one mixed batch."""
    P, L = pure.P, pure.L
    small_order = (1).to_bytes(32, "little")
    return [
        (pub, msg, good),
        (pub, b"tampered", good),
        (pub, msg, good[:10] + bytes([good[10] ^ 1]) + good[11:]),
        (pub, msg, good[:32] + L.to_bytes(32, "little")),
        (pub, msg, b"\x11" * 32 + (L - 1).to_bytes(32, "little")),
        (small_order, msg, small_order + bytes(32)),
        (pub[:31], msg, good),
        (pub, msg, good[:63]),
        (_enc_int(P - 1), msg, good),
        (_enc_int(1 + P), msg, small_order + bytes(32)),
        (_enc_int((1 << 255) - 1), msg, good),
        (_enc_int(1, 1), msg, good),
    ]


# -- timing ------------------------------------------------------------------


def time_cuda(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_queued(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls queued behind a sleep kernel, by CUDA
    events: the host enqueues every call while the device sleeps, so the
    kernels run back to back, without the gaps a host slower than them
    leaves (the device time of a short kernel that the profiler's trace
    does not hold whole)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at 2 GHz, longer than the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_host(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound_ms(ops: float, nbytes: float, sms: int, clock_hz: float):
    t_ops = ops / (INT32_OPS_PER_SM_CLOCK * sms * clock_hz) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# SASS opcodes by the pipe that runs them, for the ladder's issue estimate
ALU_OPS = ("IADD3", "LOP3", "SHF", "LEA", "SEL", "ISETP", "MOV", "PRMT", "VIADD", "IMNMX",
           "VIMNMX", "IABS", "PLOP3", "P2R", "R2P", "FLO", "POPC")


def sass_mix(so) -> dict:
    """Static SASS instruction counts of the ladder kernel per group width
    (cuobjdump, where the toolkit has it; else empty), by class: the
    32x32->64 multiplies (IMAD.WIDE, .U32), other IMADs, shuffles, ALU
    operations and the rest (memory, branches; NOPs left out)."""
    from cometbft_tpu_torch.probe import issue_rates

    out = {}
    for g, c in sorted(issue_rates.sass_counts(so, r"ladder_verify_kernelILi(\d+)E").items()):
        c.pop("NOP", None)
        wide = {k: c[k] for k in ("IMAD.WIDE", "IMAD.WIDE.U32")}
        imad = sum(v for k, v in c.items() if k.startswith("IMAD") and k not in wide)
        shfl = sum(v for k, v in c.items() if k.startswith("SHFL"))
        alu = sum(v for k, v in c.items() if k.split(".")[0] in ALU_OPS)
        out[g] = {"instructions": sum(c.values()), **wide, "imad_other": imad, "shfl": shfl,
                  "alu": alu, "top": c.most_common(8)}
    return out


def ladder_issue_estimate(mix, rates, g, n, sms, clock_hz) -> dict:
    """Least time the ladder's instruction stream could issue in, if the
    loop runs the static mix: each lane issues the kernel's limb products
    (100 a multiply or squaring: g_sq is a g_mul) as IMAD.WIDE(.U32), and
    every other class in its static ratio to them; a warp's threads past
    its last whole group (G = 5: 2 of 32) issue too. Each class over its
    measured rate (thread-instructions a clock per SM); IMADs share one
    pipe; dispatch at 4 warps a clock per SM."""
    per_wide = n * (LADDER_FE_MULS + LADDER_FE_SQS) * FE_MUL_OPS * 32 / (32 // g * g) / (
        mix["IMAD.WIDE"] + mix["IMAD.WIDE.U32"])

    def ms(count, rate):
        return count * per_wide / (rate * sms * clock_hz) * 1e3

    t = {
        "imad_pipe": ms(mix["IMAD.WIDE"], rates["IMAD.WIDE"]["rate"])
        + ms(mix["IMAD.WIDE.U32"], rates["IMAD.WIDE.U32"]["rate"])
        + ms(mix["imad_other"], rates["IMAD"]["rate"]),
        "alu": ms(mix["alu"], rates["LOP3.LUT"]["rate"]),
        "shfl": ms(mix["shfl"], rates["SHFL.IDX"]["rate"]),
        "dispatch": ms(mix["instructions"], 128),
    }
    t["estimate"] = max(t.values())
    return t


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


# -- phases ------------------------------------------------------------------


def digits_values(digits: torch.Tensor) -> list:
    """int32[64, N] signed radix-16 digits -> the N integers they encode."""
    d = digits.cpu().numpy().astype(object)
    return [sum(int(x) << (4 * i) for i, x in enumerate(d[:, lane])) for lane in range(d.shape[1])]


def words_of(values, nbytes: int) -> np.ndarray:
    """Integers -> int32[nbytes / 4, N] little-endian words (the operand layout)."""
    from cometbft_tpu_torch.ops import unpack

    return unpack.bytes_to_words(np.stack([np.frombuffer(v.to_bytes(nbytes, "little"), np.uint8)
                                           for v in values]))


def compare_kernels(fixtures, merkle_oracle, dev, sms, clock_hz, rates):
    """Phase 4: each kernel against its plain version at the main path's
    shapes; returns the per-kernel records (without launches)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import field25519 as fe
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import sha256_kernel as sha
    from cometbft_tpu_torch.ops import sha512_kernel as s5
    from cometbft_tpu_torch.ops import unpack

    L = ek.L

    _, _, pubs, msgs, sigs, leaves, parts = fixtures
    # The long-leaf sets' plain levels run on the CPU in the pool while the
    # card's comparisons go on (compare_levels).
    cpu_plain = {name: sign_pool().apply_async(levels_plain_job, (items,))
                 for name, items in long_leaf_sets(leaves, parts).items()}
    records = {}
    operands, host_ok = ek.pack_batch(pubs, msgs, sigs)
    check(host_ok[: len(pubs)].all(), "fixture batch fails host checks")
    a_w, r_w, s_w, msg_w, msg_nb = ek.operands_to_device(operands, dev)
    n = a_w.shape[1]

    # sha512: the main path's challenge_digits, a ragged batch up to 32
    # blocks with a zero-block lane, scalar_digits on edge digests and s
    s_dig, k_dig = s5.challenge_digits(msg_w, msg_nb, s_w)
    err = max_abs_err(torch.stack([s_dig, k_dig]),
                      torch.stack(s5.challenge_digits_plain(msg_w, msg_nb, s_w)))
    rng = np.random.default_rng(SEED)
    lens = rng.integers(0, 32 * 128 - 17, 1024)
    lens[:4] = [111, 112, 0, 32 * 128 - 17]
    ragged = [rng.integers(0, 256, int(x), dtype=np.uint8).tobytes() for x in lens]
    buf, nb = s5.pack_buffer512(ragged)
    nb[5] = 0
    rw = torch.from_numpy(buf.view("<u4").view(np.int32)).to(dev)
    rnb = torch.from_numpy(nb).to(dev)
    rs = torch.from_numpy(words_of([int.from_bytes(rng.bytes(32), "little") % L for _ in ragged],
                                   32)).to(dev)
    got = torch.stack(s5.challenge_digits(rw, rnb, rs))
    err = max(err, max_abs_err(got, torch.stack(s5.challenge_digits_plain(rw, rnb, rs))))
    iv = b"".join(v.to_bytes(8, "big") for v in s5._IV)
    want_k = [int.from_bytes(iv if i == 5 else hashlib.sha512(m).digest(), "little") % L
              for i, m in enumerate(ragged)]
    check(digits_values(got[1]) == want_k, "sha512 kernel: k != hashlib digest mod L")
    k_words = s5.hash_blocks_plain(msg_w, msg_nb)
    edge_k = [2**512 - 1, 0, L - 1, L]
    k_words[:, : len(edge_k)] = torch.from_numpy(words_of(edge_k, 64)).to(dev)
    s_edge = s_w.clone()
    s_edge[:, :3] = torch.from_numpy(words_of([L - 1, 0, L - 1], 32)).to(dev)
    got = torch.stack(s5.scalar_digits(k_words, s_edge))
    err = max(err, max_abs_err(got, torch.stack(s5.scalar_digits_plain(k_words, s_edge))))
    check(digits_values(got[1][:, : len(edge_k)]) == [v % L for v in edge_k]
          and digits_values(got[0][:, :3]) == [L - 1, 0, L - 1],
          "sha512 scalar_digits: edge digests or scalars decoded wrong")
    check(err == 0, f"sha512 kernel != plain (max abs err {err})")
    blocks_hashed = int(msg_nb.sum().item())
    t_b = bound_ms(blocks_hashed * SHA512_BLOCK_OPS + n * SCALAR_LANE_OPS,
                   blocks_hashed * 128 + n * (4 + 32 + 2 * 64 * 4), sms, clock_hz)
    records["sha512"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: s5.challenge_digits(msg_w, msg_nb, s_w), 50),
        kernel_ms=kernel_ms(lambda: s5.challenge_digits(msg_w, msg_nb, s_w)),
        plain_ms=time_cuda(lambda: s5.challenge_digits_plain(msg_w, msg_nb, s_w), 2),
        bound_ms=t_b[0], bound_by=t_b[1],
        shape=f"{n} lanes x {msg_w.shape[1] // 32} blocks ({blocks_hashed} hashed)",
    )

    # decompress: the main path's A and R words with the ZIP-215 edge
    # encodings fed as raw words in the first lanes
    edge = [(1).to_bytes(32, "little"), _enc_int(1 + fe.P_INT), _enc_int(fe.P_INT - 1),
            _enc_int(fe.P_INT), _enc_int((1 << 255) - 1), _enc_int(1, 1), _enc_int(0, 1),
            b"\x11" * 32, bytes(32)]
    a_mix = a_w.clone()
    a_mix[:, : len(edge)] = torch.from_numpy(
        unpack.bytes_to_words(np.stack([np.frombuffer(e, np.uint8) for e in edge]))).to(dev)
    pt_k, ok_k = ed.decompress_words(a_mix, r_w)
    pt_p, ok_p = ed.decompress_words_plain(a_mix, r_w)
    err = max(max_abs_err(torch.stack(ed.point_freeze(pt_k)), torch.stack(ed.point_freeze(pt_p))),
              max_abs_err(ok_k, ok_p))
    check(err == 0, f"decompress kernel != plain (max abs err {err})")
    check(ok_k[: len(edge)].tolist() == [pure.point_decompress_zip215(e) is not None for e in edge],
          "decompress: an edge encoding decoded against ZIP-215")
    check(ok_k[len(edge):].all().item(), "a fixture encoding failed to decode")
    m = 2 * n
    products = m * (DECOMPRESS_FE_MULS * FE_MUL_OPS + DECOMPRESS_FE_SQS * FE_SQ_OPS)
    t_b = bound_ms(products, m * (32 + 273), sms, clock_hz)
    lpb = -(-m // sms)  # grid.cuh's balanced grid (one wave at this size)
    records["decompress"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: ed.decompress_words(a_w, r_w), 50),
        kernel_ms=kernel_ms(lambda: ed.decompress_words(a_w, r_w)),
        plain_ms=time_cuda(lambda: ed.decompress_words_plain(a_w, r_w), 2),
        bound_ms=t_b[0], bound_by=t_b[1],
        bound_ms_at_imad_wide_rate=products / (rates["IMAD.WIDE"]["rate"] * sms * clock_hz) * 1e3,
        shape=f"{m} lanes, {-(-m // lpb)} blocks of {lpb} lanes x {DECOMPRESS_GROUP} threads",
    )

    # ladder (fused with the epilogue): the main path's digits and decoded
    # A, R, at every group width; widths timed in turns
    pt, ok = ed.decompress_words(a_w, r_w)
    want, acc_p = ladder.verify_lanes_plain(s_dig, k_dig, pt, ok)
    acc_p = torch.stack(ed.point_freeze(acc_p))
    check(bool(want.all()), "plain ladder rejects a fixture signature")
    err = 0
    for g in ladder.GROUPS:
        got, acc = ladder.verify_lanes(s_dig, k_dig, pt, ok, group=g, with_acc=True)
        err = max(err, max_abs_err(got, want),
                  max_abs_err(torch.stack(ed.point_freeze(acc)), acc_p))
    check(err == 0, f"ladder kernel != plain (max abs err {err})")
    runs = {g: [] for g in ladder.GROUPS}
    for rep in range(3):
        for g in ladder.GROUPS[:: 1 if rep % 2 == 0 else -1]:
            runs[g].append(time_cuda(lambda: ladder.verify_lanes(s_dig, k_dig, pt, ok, group=g), 20))
    ms_by_group = {g: statistics.median(v) for g, v in runs.items()}
    configs = {g: ladder.launch_config(n, g) for g in ladder.GROUPS}
    print(f"ladder ms by threads a lane (median of 3 turns of 20 launches): {ms_by_group}; "
          f"runs {runs}", flush=True)
    for g, cfg in configs.items():
        print(f"ladder launch at {g} threads a lane: {cfg}", flush=True)
    t_b = bound_ms(n * (LADDER_FE_MULS * FE_MUL_OPS + LADDER_FE_SQS * FE_SQ_OPS),
                   n * (2 * 64 * 4 + 2 * 4 * 17 * 4 + 2 + 1), sms, clock_hz)
    records["ladder"] = dict(
        max_abs_err=err, ms=ms_by_group[ladder.GROUP], ms_by_group=ms_by_group,
        kernel_ms=kernel_ms(lambda: ladder.verify_lanes(s_dig, k_dig, pt, ok)),
        threads_per_lane=ladder.GROUP,
        plain_ms=time_cuda(lambda: ladder.verify_lanes_plain(s_dig, k_dig, pt, ok), 1, warmup=0),
        bound_ms=t_b[0], bound_by=t_b[1], shape=f"{n} lanes x 64 windows + epilogue",
    )

    # sha256: the 65,536-leaf block, leaf pass and every inner level
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in leaves])
    blk = torch.from_numpy(blocks.view(np.int32)).to(dev)
    nbk = torch.from_numpy(nblocks).to(dev)
    cur_k, cur_p = mk.leaf_core(blk, nbk), mk.leaf_core_plain(blk, nbk)
    err = max_abs_err(cur_k, cur_p)
    while cur_k.shape[1] > 1:
        cur_k = mk.inner_core(cur_k[:, 0::2], cur_k[:, 1::2])
        cur_p = mk.inner_core_plain(cur_p[:, 0::2], cur_p[:, 1::2])
        err = max(err, max_abs_err(cur_k, cur_p))
    check(err == 0, f"sha256 kernel != plain (max abs err {err})")

    # the tree entry (what the root path runs): two launches a root
    for part in (leaves, leaves[:N_RAGGED_LEAVES]):
        flat, offsets = mk.pack_leaves(part, dev)
        got = mk.tree_root(flat, offsets)
        err = max(err, max_abs_err(got, mk.tree_root_plain(flat, offsets)))
        check(sha.digest_words_to_bytes(got.cpu().numpy())[0] == merkle_oracle(part),
              f"sha256 tree entry: {len(part)}-leaf root != hash_from_byte_slices")
    check(err == 0, f"sha256 kernel != plain (max abs err {err})")
    flat, offsets = mk.pack_leaves(leaves, dev)
    nl = len(leaves)
    lens = np.diff(offsets.cpu().numpy())
    compressions = int(((lens + 1 + 8) // 64 + 1).sum()) + 2 * (nl - 1)
    t_b = bound_ms(compressions * SHA256_BLOCK_OPS, flat.numel() + 8 * (nl + 1) + 32,
                   sms, clock_hz)
    records["sha256"] = dict(
        max_abs_err=err,
        ms=time_cuda(lambda: mk.tree_root(flat, offsets), 50),
        kernel_ms=kernel_ms(lambda: mk.tree_root(flat, offsets), launches=2),
        queued_ms=time_queued(lambda: mk.tree_root(flat, offsets), 50),
        plain_ms=time_cuda(lambda: mk.tree_root_plain(flat, offsets), 1, warmup=0),
        bound_ms=t_b[0], bound_by=t_b[1],
        chain_floor_ms=chain_floor_ms(longest_leaf_blocks(offsets), nl, clock_hz),
        shape=f"{nl} leaves, 2 launches ({-(-nl // mk.CHUNK)} chunks of {mk.CHUNK})",
    )
    rec = records["sha256"]
    stamp("kernels: the sha256 levels entry")
    rec.update(compare_levels(leaves, parts, dev, sms, clock_hz, cpu_plain))
    rec["max_abs_err"] = max(rec["max_abs_err"], rec["levels_max_abs_err"])
    print(f"sha256 root path (tree entry, 65,536 leaves): {rec['kernel_ms']} ms CUPTI, "
          f"{rec['queued_ms']} queued, {rec['ms']} by events (before: 0.0747-0.0753 CUPTI, 0.0780 "
          f"events); levels entry at 65,536 leaves: {rec['levels_kernel_ms']} CUPTI, "
          f"{rec['levels_queued_ms']} queued, {rec['levels_ms']} by events (before: 0.0755 CUPTI, "
          f"0.0782-0.0783 events); bound {rec['bound_ms']}, chain floor {rec['chain_floor_ms']} "
          f"(levels {rec['levels_chain_floor_ms']}); at the part set: {rec['levels_partset_kernel_ms']} CUPTI, "
          f"{rec['levels_partset_queued_ms']} queued, {rec['levels_partset_ms']} by events (before: "
          f"9.001-9.055 events), bound {rec['levels_partset_bound_ms']}, chain floor "
          f"{rec['levels_partset_chain_floor_ms']}", flush=True)
    return records


def levels_bound(mk, flat, offsets, sms, clock_hz):
    """The levels entry's bound: every compression (each leaf's blocks of
    0x00 || leaf, two an inner node) at SHA256_BLOCK_OPS; the leaves and
    offsets read once, every level's 32-byte nodes written once."""
    n = offsets.shape[0] - 1
    lens = np.diff(offsets.cpu().numpy())
    compressions = int(((lens + 1 + 8) // 64 + 1).sum()) + 2 * (n - 1)
    total = mk.level_rows(n)[-1][0] + 1
    return bound_ms(compressions * SHA256_BLOCK_OPS, flat.numel() + 8 * (n + 1) + 32 * total,
                    sms, clock_hz)


def long_leaf_sets(leaves, parts) -> dict:
    """The part set, its ragged form (the last part RAGGED_LAST_PART bytes)
    and N_MIX leaves, every 5th a long one (MIX_LONG bytes of the block in
    turn) and the others short, so the long ones start at unaligned offsets
    of the joined leaves."""
    block = b"".join(parts)
    mix = [block[i * 4099 : i * 4099 + MIX_LONG[i // 5 % len(MIX_LONG)]] if i % 5 == 2
           else leaves[i % len(leaves)] for i in range(N_MIX)]
    return {"partset": parts, "partset_ragged": parts[:-1] + [parts[-1][:RAGGED_LAST_PART]],
            "mix": mix}


def levels_launch(mk, flat, offsets, chunk: int, words: bool) -> torch.Tensor:
    """The levels entry's two launches at the given chunk and leaf loads."""
    n = offsets.shape[0] - 1
    levels = torch.empty((mk.level_rows(n)[-1][0] + 1, 8), dtype=torch.int32, device=flat.device)
    mk._launch_tree(flat, offsets, n, chunk, levels, words)
    return levels


def levels_by_leaf_bytes(mk, parts, dev) -> dict:
    """{leaf bytes: {variant: [ms, ms]}}: each SWEEP_LEAF_BYTES cut of the
    part set's block under each variant, queued, in two passes in opposite
    orders; the three variants' levels must agree word for word."""
    block = b"".join(parts)
    variants = {"bytes_chunk_%d" % mk.CHUNK: (mk.CHUNK, False),
                "bytes_chunk_%d" % mk.LONG_LEAF_CHUNK: (mk.LONG_LEAF_CHUNK, False),
                "words_chunk_%d" % mk.LONG_LEAF_CHUNK: (mk.LONG_LEAF_CHUNK, True)}
    out = {}
    for nbytes in SWEEP_LEAF_BYTES:
        flat, offsets = mk.pack_leaves([block[i : i + nbytes]
                                        for i in range(0, len(block), nbytes)], dev)
        got = [levels_launch(mk, flat, offsets, *v) for v in variants.values()]
        check(all(torch.equal(got[0], g) for g in got[1:]),
              f"sha256 levels entry: the loads or chunks disagree at {nbytes}-byte leaves")
        times = {k: [] for k in variants}
        for order in (list(variants), list(variants)[::-1]):
            for k in order:
                times[k].append(time_queued(lambda: levels_launch(mk, flat, offsets, *variants[k]), 5))
        out[nbytes] = times
        print(f"sha256 levels entry, {offsets.shape[0] - 1} leaves of {nbytes} bytes (ms queued, "
              f"two passes): {times}", flush=True)
    return out


def longest_leaf_blocks(offsets) -> int:
    """SHA-256 blocks of the longest leaf's 0x00 || leaf."""
    lens = np.diff(offsets.cpu().numpy())
    return int(((lens + 1 + 8) // 64 + 1).max())


def chain_floor_ms(leaf_blocks: int, n: int, clock_hz) -> float:
    """The compressions a root of n leaves waits on one after another, on
    one warp, which issues at most one instruction a clock
    (SHA256_BLOCK_OPS each): the longest leaf's blocks, then 2 for each of
    the ceil(log2 n) levels above the leaves."""
    return (leaf_blocks + 2 * (n - 1).bit_length()) * SHA256_BLOCK_OPS / clock_hz * 1e3


def levels_plain_job(items) -> tuple:
    """Pool worker: the levels entry's plain version on the CPU over the
    leaves ``items`` (packed here as ``pack_leaves`` packs them for the
    card) -> (the levels, ms)."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    flat, offsets = mk.pack_leaves(items, "cpu")
    t0 = time.perf_counter()
    want = mk.tree_levels_raw_plain(flat, offsets)
    return want.numpy(), (time.perf_counter() - t0) * 1e3


def compare_levels(leaves, parts, dev, sms, clock_hz, cpu_plain: dict) -> dict:
    """The sha256 kernel's levels entry (the counterpart of
    merkle_kernel._leaves_to_levels_core) against tree_levels_raw_plain,
    every word, at the 65,536-leaf block, the 10,000-leaf ragged count, the
    part set, the ragged part set and the short/long mix, each at the chunk
    the wrapper picks; times at 65,536 leaves and at the part set, with the
    part set's chain floor. The plain version runs on the card, but for the
    long leaves (``long_leaf_sets``) on the CPU, on the same leaves, in the
    pool (``cpu_plain``: name -> the pending ``levels_plain_job``): its
    1,025 compressions a part run one after another, each ~2,600 tiny
    tensor operations, which cost ~66 ms a compression on the card
    (launch-bound; 68 s for the part set) against a few ms on the CPU."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    out, err = {}, 0
    sets = {"64k": leaves, "10k": leaves[:N_RAGGED_LEAVES], **long_leaf_sets(leaves, parts)}
    for name, items in sets.items():
        flat, offsets = mk.pack_leaves(items, dev)
        long = mk.long_leaves(len(items), flat.numel())
        chunk = mk.LONG_LEAF_CHUNK if long else mk.CHUNK
        got = mk.tree_levels_raw(flat, offsets)
        if name in cpu_plain:
            want, plain = cpu_plain[name].get(timeout=600)
            want, plain_dev = torch.from_numpy(want), "cpu"
        else:
            plain_dev = dev
            t0 = time.perf_counter()
            want = mk.tree_levels_raw_plain(flat, offsets)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(got.cpu(), want.cpu()))
        check(got.shape == want.shape == (mk.level_rows(len(items))[-1][0] + 1, 8),
              f"sha256 levels entry: {name} levels have shape {tuple(got.shape)}")
        print(f"sha256 levels entry, {name}: {len(items)} leaves, chunk {chunk}, word loads {long}, "
              f"equal to the plain version: {err == 0}", flush=True)
        if name not in ("64k", "partset"):
            continue
        t_b = levels_bound(mk, flat, offsets, sms, clock_hz)
        key = "levels" if name == "64k" else "levels_partset"
        out.update({
            f"{key}_ms": time_cuda(lambda: mk.tree_levels_raw(flat, offsets), 50 if name == "64k" else 5),
            f"{key}_queued_ms": time_queued(lambda: mk.tree_levels_raw(flat, offsets),
                                            50 if name == "64k" else 5),
            f"{key}_kernel_ms": kernel_ms(lambda: mk.tree_levels_raw(flat, offsets),
                                          20 if name == "64k" else 5, launches=2),
            f"{key}_plain_ms": plain, f"{key}_plain_device": str(plain_dev),
            f"{key}_bound_ms": t_b[0], f"{key}_bound_by": t_b[1],
            f"{key}_chain_floor_ms": chain_floor_ms(longest_leaf_blocks(offsets), len(items), clock_hz),
            f"{key}_shape": f"{len(items)} leaves of {len(items[0])} bytes, 2 launches (chunks of "
                            f"{chunk}), {got.shape[0]} nodes out",
        })
    check(err == 0, f"sha256 levels entry != plain (max abs err {err})")
    out["levels_max_abs_err"] = err
    stamp("kernels: the levels entry by leaf length")
    out["levels_by_leaf_bytes"] = levels_by_leaf_bytes(mk, parts, dev)
    return out


def corrupted_commit(pure, msgs, sigs):
    """The commit with 5 localized corruptions: three signatures with a bit
    flipped, one s >= L, one tampered message. Returns (msgs, sigs, the
    sorted bad indices)."""
    n = len(sigs)
    bad_sigs, bad_msgs = list(sigs), list(msgs)
    flipped = [17, n // 2 + 3, n - 1]
    for i in flipped:
        s = bytearray(bad_sigs[i])
        s[40] ^= 0x08
        bad_sigs[i] = bytes(s)
    s_ge_l, wrong_msg = n // 5, n * 7 // 8
    bad_sigs[s_ge_l] = bad_sigs[s_ge_l][:32] + (pure.L + 3).to_bytes(32, "little")
    bad_msgs[wrong_msg] = b"commit-vote-tampered"
    return bad_msgs, bad_sigs, sorted(flipped + [s_ge_l, wrong_msg])


def drive_main_path(fixtures, pure, merkle_oracle, backend):
    """Phase 5: the requests a user sends, each held to its expected answer."""
    fb, seeds, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)

    ok, bits = backend.batch_verify(pubs, msgs, sigs)
    check(ok and len(bits) == n and all(bits), "valid commit did not verify")

    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    ok, bits = backend.batch_verify(pubs, bad_msgs, bad_sigs)
    check(not ok and [i for i, b in enumerate(bits) if not b] == want_bad,
          "corrupted commit: bitmap does not localize exactly the bad signatures")

    edge = zip215_edge_batch(pure, pubs[0], msgs[0], sigs[0])
    _, bits = backend.batch_verify(*(list(c) for c in zip(*edge)))
    want = [len(p) == 32 and len(s) == 64 and pure.verify_zip215(p, m, s) for p, m, s in edge]
    check(bits == want, f"ZIP-215 edge batch: {bits} != pure {want}")

    big = b"oversized-app-message:" + bytes(range(256)) * 20
    o_pubs, o_sigs = sign_batch(pure, fb, seeds[:2], [big, msgs[1]])
    o_sigs[1] = o_sigs[1][:5] + bytes([o_sigs[1][5] ^ 1]) + o_sigs[1][6:]
    _, bits = backend.batch_verify(o_pubs + pubs[2:8], [big, msgs[1]] + msgs[2:8], o_sigs + sigs[2:8])
    check(bits == [True, False] + [True] * 6, f"oversized (host-hash) batch: {bits}")

    check(backend.merkle_root(leaves) == merkle_oracle(leaves), "65,536-leaf root mismatch")
    ragged = leaves[:N_RAGGED_LEAVES]
    check(backend.merkle_root(ragged) == merkle_oracle(ragged), "10,000-leaf root mismatch")


def trace_call(fn) -> dict:
    """One call of fn under torch.profiler: its wall ms (traced, so slower
    than untraced), the device time of each kernel and copy by name, and
    their sum (one stream, so the sum is the device's busy time). Empty
    device times mean the profiler saw no kernel: nothing is claimed then."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = time_host(fn)
    device, counts = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type.name == "CUDA":
            device[e.key] += t / 1e3
            counts[e.key] += e.count
    return {"wall_ms": wall, "device_ms": sum(device.values()),
            "kernels_ms": dict(device.most_common()), "counts": dict(counts)}


def kernel_ms(fn, reps: int = 20, launches: int = 1):
    """Mean device time of fn's kernels a call (torch.profiler, CUPTI): the
    kernels' own time, without the gaps that the host's enqueue leaves
    between launches and that CUDA events around back-to-back launches
    count. None when the trace does not hold every launch (reps x
    launches kernel records): the profiler has been seen to drop some."""
    fn()
    tr = trace_call(lambda: [fn() for _ in range(reps)])
    kernels = [k for k in tr["kernels_ms"] if not k.startswith(("Memcpy", "Memset"))]
    seen = sum(tr["counts"][k] for k in kernels)
    if seen != reps * launches:
        print(f"kernel_ms: the trace holds {seen} of {reps * launches} launches: not measured",
              flush=True)
        return None
    return sum(tr["kernels_ms"][k] for k in kernels) / reps


def stage_split(fixtures, dev):
    """One verify + root, stage by stage, each ended by a synchronize."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import sha512_kernel as s5

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    st, box = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[name] = fn()
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3

    run("pack", lambda: ek.operands_to_device(ek.pack_batch(pubs, msgs, sigs)[0], dev))
    a_w, r_w, s_w, msg_w, msg_nb = box["pack"]
    run("sha512", lambda: s5.challenge_digits(msg_w, msg_nb, s_w))
    s_dig, k_dig = box["sha512"]
    run("decompress", lambda: ed.decompress_words(a_w, r_w))
    pt, ok = box["decompress"]
    run("ladder_epilogue", lambda: ladder.verify_lanes(s_dig, k_dig, pt, ok).cpu())
    run("merkle_pack", lambda: mk.pack_leaves(leaves, dev))
    run("merkle_tree", lambda: mk.tree_root(*box["merkle_pack"]).cpu())
    check(bool(box["ladder_epilogue"].all()), "stage-split verify failed")
    return st


# -- the proofs path -----------------------------------------------------------


def proof_sets(fixtures) -> dict:
    _, _, _, _, _, leaves, parts = fixtures
    return {"64k": leaves, "10k": leaves[:N_RAGGED_LEAVES], "partset": parts}


def drive_proofs(fixtures, host) -> None:
    """The proofs path: proofs_from_byte_slices_device (on the card by
    default) at the three sizes, each root and every proof's total, index,
    leaf hash and aunts equal to the host's proofs_from_byte_slices_pure; every
    97th proof and the last verify against the root; two sha256 launches a
    proof set."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    for name, items in proof_sets(fixtures).items():
        before = _build.LAUNCHES["sha256"]
        root, proofs = mk.proofs_from_byte_slices_device(items)
        check(_build.LAUNCHES["sha256"] - before == 2, f"{name} proofs: not two sha256 launches")
        root_h, proofs_h = host.proofs_from_byte_slices_pure(items)
        check(root == root_h and len(proofs) == len(proofs_h) == len(items),
              f"{name} proofs: root or count differs from the host's")
        for i, (pd, ph) in enumerate(zip(proofs, proofs_h)):
            if (pd.total, pd.index, pd.leaf_hash, pd.aunts) != (ph.total, ph.index, ph.leaf_hash,
                                                                ph.aunts):
                fail(f"{name} proofs: proof {i} differs from the host's")
        for i in list(range(0, len(items), 97)) + [len(items) - 1]:
            proofs[i].verify(root, items[i])


def proofs_stage_split(leaves, dev) -> dict:
    """One 65,536-leaf proof set, stage by stage (each ended by a
    synchronize): pack, the two launches, the levels' device-to-host copy,
    the aunt gather, DeviceProofs."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    st, box = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[name] = fn()
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return box[name]

    flat, offsets = run("pack", lambda: mk.pack_leaves(leaves, dev))
    levels = run("levels_launches", lambda: mk.tree_levels_raw(flat, offsets))
    digests = run("levels_d2h", lambda: mk.levels_to_digests(levels))
    split = mk.split_levels(digests, len(leaves))
    aunts, counts = run("aunt_gather", lambda: mk.gather_aunts(split))
    run("device_proofs", lambda: mk.DeviceProofs(bytes(split[-1][0]), split[0], aunts, counts))
    return st


def proofs_metrics(fixtures, host, dev) -> dict:
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    leaves = fixtures[5]
    runs = [time_host(lambda: mk.proofs_from_byte_slices_device(leaves)) for _ in range(5)]
    oracle = [time_host(lambda: host.proofs_from_byte_slices_pure(leaves)) for _ in range(3)]
    splits = [proofs_stage_split(leaves, dev) for _ in range(3)]
    return {
        "metric": "proofs_64k_ms", "value": statistics.median(runs), "runs_ms": runs,
        "stages_ms": {k: statistics.median(sp[k] for sp in splits) for k in splits[0]},
        "host_oracle_ms": statistics.median(oracle), "host_oracle_runs_ms": oracle,
        "parts": {"count": N_PARTS, "bytes": PART_BYTES},
    }


# -- the sidecar path ----------------------------------------------------------


def drive_sidecar(fixtures, pure, merkle_oracle) -> dict:
    """The port's entry point: SidecarServer in this process on
    127.0.0.1:0, serving TorchBackend() on the card, warmed; the port's
    GrpcBackend drives every request of drive_main_path through the socket
    (the commit streamed in chunks), then the commit unary. Three launches a
    verify dispatch and two a root; then the headline through the socket."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.backend import TorchBackend
    from cometbft_tpu_torch.sidecar.service import GrpcBackend, SidecarServer

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    t0 = time.perf_counter()
    server = SidecarServer("127.0.0.1:0", backend=TorchBackend())
    server.warmup()
    warm_s = time.perf_counter() - t0
    server.start()
    client = GrpcBackend(server.bound_addr, timeout_s=600)
    try:
        _build.reset_launches()
        d0 = server.scheduler_counters()["dispatches"]
        drive_main_path(fixtures, pure, merkle_oracle, client)
        os.environ["CMTPU_SIDECAR_CHUNK"] = str(N_SIGS)
        try:
            ok, bits = client.batch_verify(pubs, msgs, sigs)
        finally:
            del os.environ["CMTPU_SIDECAR_CHUNK"]
        check(ok and all(bits) and len(bits) == N_SIGS, "sidecar: the unary commit did not verify")
        launches = dict(_build.LAUNCHES)
        dispatches = server.scheduler_counters()["dispatches"] - d0
        c = client.counters()
        check(c["streamed_calls"] >= 2 and c["unary_calls"] >= 3,
              f"sidecar: expected streamed and unary verifies, client counters {c}")
        check(launches == {"ladder": dispatches, "decompress": dispatches, "sha512": dispatches,
                           "sha256": 4, "bn254": 0},
              f"sidecar: expected three launches a verify dispatch ({dispatches}) and two a "
              f"root (2 roots): {launches}")
        totals = [time_host(lambda: (client.batch_verify(pubs, msgs, sigs),
                                     client.merkle_root(leaves))) for _ in range(5)]
        counters = server.scheduler_counters()
    finally:
        client.close()
        server.shutdown()
    ours = [t for t in threading.enumerate()
            if t.name in ("verify-engine", "sidecar-reader") or "process_request" in t.name]
    for t in ours:
        t.join(timeout=30)
    left = [t.name for t in ours if t.is_alive()]
    check(not left, f"sidecar: threads left after shutdown: {left}")
    return {"launches": launches, "dispatches": dispatches, "warmup_s": warm_s, "totals": totals,
            "client": c, "scheduler": counters}


# -- the BN254 path ------------------------------------------------------------


def bn254_lanes(bn, n: int):
    """n Miller lanes: the padding lane (G1, G2), coordinates 0, 1 and P - 1
    and off-curve field elements first (the formulas are polynomials, so
    kernel and plain version must agree on them too), then multiples of a
    seeded (P, Q) by repeated addition."""
    p_ = bn.P
    rng = np.random.default_rng(SEED)

    def fe():
        return int.from_bytes(rng.bytes(32), "little") % p_

    lanes = [(bn.G1, bn.G2), ((0, 0), ((0, 0), (0, 0))), ((1, 1), ((1, 1), (1, 1))),
             ((p_ - 1, p_ - 1), ((p_ - 1, p_ - 1), (p_ - 1, p_ - 1))),
             ((0, 1), ((p_ - 1, 0), (1, p_ - 1))),
             ((fe(), fe()), ((fe(), fe()), (fe(), fe()))), ((fe(), fe()), bn.G2)]
    pt = bn._g1_mul(SEED, bn.G1)
    q = bn._g2_mul(SEED + 1, bn.G2)
    while len(lanes) < n:
        lanes.append((pt, q))
        pt, q = bn._g1_add(pt, bn.G1), bn._g2_add(q, bn.G2)
    return lanes[:n]


def bn254_fixtures(bn):
    """The 10,240-validator aggregate commit: sk_i = s0 + i, so pk_i is one
    G1 addition from pk_(i-1), and the aggregate is one G2 multiply by the
    sum of the sk_i; every validator signs one shared message (the cut:
    distinct sign bytes would cost the host 10,240 hash-to-G2 runs); the
    poisoned aggregate leaves one signer's share out. Then 16 distinct
    signed votes, vote BAD_VOTE signed over another message."""
    s0 = int.from_bytes(hashlib.sha256(b"chip-smoke-bn254-%d" % SEED).digest(), "big") % (bn.R // 2)
    pk, pubs = bn._g1_mul(s0, bn.G1), []
    for _ in range(N_VALIDATORS):
        pubs.append(bn.g1_compress(pk))
        pk = bn._g1_add(pk, bn.G1)
    msg = b"chip-smoke-commit-%d" % SEED
    hm = bn._hash_to_g2_cached(msg)
    total = sum(s0 + i for i in range(N_VALIDATORS)) % bn.R
    left_out = N_VALIDATORS // 3
    v_sks = [s0 + 2 * N_VALIDATORS + i for i in range(N_VOTES)]
    v_msgs = [b"chip-smoke-vote-%d" % i for i in range(N_VOTES)]
    v_sigs = [bn.sign(sk, m) for sk, m in zip(v_sks, v_msgs)]
    v_sigs[BAD_VOTE] = bn.sign(v_sks[BAD_VOTE], b"chip-smoke-vote-other")
    return {
        "pubs": pubs, "msgs": [msg] * N_VALIDATORS,
        "agg": bn.g2_compress(bn._g2_mul(total, hm)),
        "poisoned": bn.g2_compress(bn._g2_mul((total - (s0 + left_out)) % bn.R, hm)),
        "votes": ([bn.public_key(sk) for sk in v_sks], v_msgs, v_sigs),
    }


def compare_bn254(bn, dev, sms, clock_hz, rates):
    """Phase 4 for bn254: the kernel against its plain version at each of
    BN254_LANE_COUNTS (the aggregate's 8,192-lane chunk, the 4,096-lane
    bucket of its second, the 32-lane vote batch), edge lanes first, every
    lane equal mod P; each count timed by events and held under the
    one-thread-a-lane kernel's time; the launch's registers, local bytes
    (which must be 0) and team shape printed, and the schedule's Fp
    multiplies a lane beside the bound's. Returns its record, at 8,192
    lanes (MAX_LANES)."""
    from cometbft_tpu_torch.ops import bn254_kernel as bk
    from cometbft_tpu_torch.ops import bn254_schedule as bs

    lanes = bn254_lanes(bn, max(BN254_LANE_COUNTS))
    rec = {"max_abs_err": 0, "ms_by_lanes": {}, "plain_ms_by_lanes": {}, "bound_ms_by_lanes": {},
           "fp_muls_a_lane": {"bound": BN254_FP_MULS, "schedule": bs.lane_muls()}}
    print(f"bn254 Fp multiplies a lane: {rec['fp_muls_a_lane']}", flush=True)
    for n in BN254_LANE_COUNTS:
        ops = bk.operands_to_device(bk._pack(lanes[:n], n), dev)
        got = bk.miller_values(*ops)
        want = bk.miller_values_plain(*ops)
        torch.cuda.synchronize()
        check(bool(((got >= 0) & (got < 2**21) & (got == got.floor())).all()),
              f"bn254 kernel at {n} lanes: output limbs are not canonical 21-bit limbs")
        k, p = bk.limbs_to_ints(got.cpu().numpy()), bk.limbs_to_ints(want.cpu().numpy())
        err = max(abs(int(a) - int(b)) for a, b in zip(k.ravel(), p.ravel()))
        check(err == 0, f"bn254 kernel != plain mod P at {n} lanes on "
                        f"{int((k != p).any(axis=(1, 2)).sum())} lanes")
        cfg = bk.launch_config(n)
        check(cfg["local_bytes"] == 0, f"bn254 kernel spills: {cfg}")
        ms = time_cuda(lambda: bk.miller_values(*ops), 5)
        print(f"bn254 at {n} lanes: {ms:.4f} ms by events (one thread a lane: "
              f"{ONE_THREAD_BN254_MS[n]}); launch {cfg}", flush=True)
        check(ms < ONE_THREAD_BN254_MS[n], f"bn254 at {n} lanes: {ms:.3f} ms, not faster than one "
                                           f"thread a lane's {ONE_THREAD_BN254_MS[n]} ms")
        products = n * BN254_FP_MULS * BN254_FP_MUL_OPS
        t_b = bound_ms(products, n * BN254_LANE_BYTES, sms, clock_hz)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["ms_by_lanes"][n] = ms
        rec["plain_ms_by_lanes"][n] = time_cuda(lambda: bk.miller_values_plain(*ops), 1, warmup=0)
        rec["bound_ms_by_lanes"][n] = t_b[0]
        if n == bk.MAX_LANES:
            rec.update(
                ms=ms, kernel_ms=kernel_ms(lambda: bk.miller_values(*ops), reps=5),
                plain_ms=rec["plain_ms_by_lanes"][n], bound_ms=t_b[0], bound_by=t_b[1],
                bound_ms_at_imad_wide_rate=products / (rates["IMAD.WIDE"]["rate"] * sms * clock_hz) * 1e3,
                shape=f"{n} lanes x 102 steps, {cfg['team']} threads a lane ({cfg['blocks']} blocks of "
                      f"{cfg['lanes_per_block']} lanes in {cfg['threads']} threads; {cfg['registers']} "
                      f"registers, {cfg['local_bytes']} local bytes a thread; {cfg['shared_bytes']} "
                      f"shared bytes a block, {cfg['slots']} slots a lane)",
            )
    return rec


def drive_bn254_path(fix, backend) -> dict:
    """Phase 6: the aggregate accepts, the poisoned aggregate rejects, two
    bn254 launches each; the vote batch's bitmap is exact, one launch."""
    from cometbft_tpu_torch.ops import _build

    times = {}

    def run(name, fn, launches):
        before = _build.LAUNCHES["bn254"]
        t0 = time.perf_counter()
        out = fn()
        times[name] = (time.perf_counter() - t0) * 1e3
        got = _build.LAUNCHES["bn254"] - before
        check(got == launches, f"{name}: {got} bn254 launches, expected {launches}")
        return out

    ok = run("aggregate_accept", lambda: backend.aggregate_verify(fix["pubs"], fix["msgs"], fix["agg"]), 2)
    check(ok is True, "the 10,240-validator aggregate did not verify")
    ok = run("aggregate_poisoned",
             lambda: backend.aggregate_verify(fix["pubs"], fix["msgs"], fix["poisoned"]), 2)
    check(ok is False, "the aggregate with one share left out verified")
    ok, bits = run("batch_16_votes", lambda: backend.batch_verify(*fix["votes"]), 1)
    want = [i != BAD_VOTE for i in range(N_VOTES)]
    check(not ok and bits == want, f"16-vote batch bitmap {bits} != {want}")
    return times


def bn254_stage_split(fix, bn, dev) -> dict:
    """One 10,240-validator aggregate check, stage by stage (each ended by
    a synchronize); the hash cache is emptied first, so the one shared
    message is hashed once."""
    from cometbft_tpu_torch.ops import bn254_kernel as bk

    st, box = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box[name] = fn()
        torch.cuda.synchronize()
        st[name] = (time.perf_counter() - t0) * 1e3
        return box[name]

    bn._HM_CACHE.clear()
    s, pks = run("parse_decompress", lambda: (bn.g2_unmarshal(fix["agg"]),
                                              [bn.g1_decompress(pk) for pk in fix["pubs"]]))
    hms = run("hash", lambda: [bn._hash_to_g2_cached(m) for m in fix["msgs"]])
    pairs = [((pk[0], (bn.P - pk[1]) % bn.P), hm) for pk, hm in zip(pks, hms)] + [(bn.G1, s)]
    chunks = [pairs[i: i + bk.MAX_LANES] for i in range(0, len(pairs), bk.MAX_LANES)]
    ops = run("pack", lambda: [bk.operands_to_device(bk._pack(c, bk.bucket_for(len(c))), dev)
                               for c in chunks])
    outs = run("kernel", lambda: [bk.miller_values(*o) for o in ops])
    vals = run("unpack", lambda: [v for c, o in zip(chunks, outs)
                                  for v in bk.unpack_values(o.cpu().numpy()[: len(c)])])
    f = run("f12_product", lambda: bk.f12_product(vals))
    ok = run("final_exponentiation", lambda: bn.final_exponentiation_fast(f) == bn.F12_ONE)
    check(ok, "stage-split aggregate did not verify")
    return st


# -- the mesh path -------------------------------------------------------------

# Virtual shards of the one card the mesh phase runs on: NCCL puts no two
# ranks on one card, so the split is held on repeats of one device.
# The hybrid phase: the device share forced at the split (it puts 2 of the
# corrupted commit's 5 bad indices on the device side, 3 on the host's), the
# run of planned calls the rate model learns from, and the two commit sizes
# the device's affine cost (a fixed ms plus a slope a signature) is fitted
# through for the rate seeds.
HYBRID_SPLIT = 4096
HYBRID_CALLS = 8
HYBRID_FIT_SIGS = (1024, N_SIGS)
# Batches under the commit that the planner prices too: one signature (a
# vote, a light-client header), a commit of a typical validator set, and a
# large one.
HYBRID_SMALL_SIGS = (1, 150, 1024)


def drive_hybrid_path(fixtures, pure, torch_backend):
    """The hybrid phase's checks (launches counted by the caller):
    ``_routed_call`` at shares 0, HYBRID_SPLIT and the whole commit, on the
    valid and the corrupted commit, each bitmap equal to TorchBackend's;
    ``verify_and_root`` equal to TorchBackend's bitmap and root; then
    HYBRID_CALLS planned calls; launch counts zeroed after TorchBackend's
    answers and checked: three launches a call with a device share, none
    else. Returns (the backend, the root, the plan record, the launches)."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.backend import HybridBackend
    from cometbft_tpu_torch.sidecar.service import DEFAULT_BUCKETS

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    check(min(want_bad) < HYBRID_SPLIT <= max(want_bad),
          f"the split {HYBRID_SPLIT} leaves the bad indices {want_bad} on one side")
    commits = {"valid": (msgs, sigs), "corrupted": (bad_msgs, bad_sigs)}
    want = {k: torch_backend.batch_verify(pubs, m, s) for k, (m, s) in commits.items()}
    check(want["corrupted"] == (False, [i not in want_bad for i in range(n)]),
          "TorchBackend's corrupted-commit bitmap is not the expected one")
    want_root = torch_backend.merkle_root(leaves)
    hybrid = HybridBackend()
    # As the sidecar serving it does: the native build (the hybrid routes to
    # the card alone until it is done) and the card's walls at its buckets.
    hybrid.warmup(DEFAULT_BUCKETS)
    _build.reset_launches()
    launched = 0
    for share in (0, HYBRID_SPLIT, n):
        for name, (m, s) in commits.items():
            got, _ = hybrid._routed_call(pubs, m, s, share)
            check(got == want[name], f"hybrid at share {share}, {name} commit: bitmap != TorchBackend's")
            launched += share > 0
    got, root = hybrid.verify_and_root(pubs, msgs, sigs, leaves)
    launched += hybrid.last_share > 0
    roots = hybrid.last_root == "card"
    check(got == want["valid"] and root == want_root,
          "hybrid verify_and_root: bitmap or root != TorchBackend's")
    check(hybrid.last_root == "card", f"the warmed hybrid put the {len(leaves)}-leaf root on the "
                                      f"{hybrid.last_root}, not the card")
    shares = []
    for _ in range(HYBRID_CALLS):
        check(hybrid.batch_verify(pubs, msgs, sigs) == want["valid"], "hybrid planned call: bitmap")
        shares.append(hybrid.last_share)
        launched += hybrid.last_share > 0
    plan = {"shares": shares, "plan_now": hybrid._plan(n), "last_timing": hybrid.last_timing,
            "dev_rate": hybrid._dev_rate, "host_rate": hybrid._host_rate,
            "dev_overhead_ms": hybrid._dev_overhead, "bias": hybrid._bias,
            "dev_wall_ms": {f"{b}x{w}": v for (b, w), v in hybrid._dev_wall.items()},
            "root_model": {"card_fixed_ms": hybrid._root_fixed,
                           "card_leaves_per_ms": hybrid._card_leaf_rate,
                           "host_leaves_per_ms": hybrid._host_leaf_rate}}
    return hybrid, want_root, plan, expect_launches(launched, roots, 0)


def medians_in_turns(fns: dict, reps: int = 21) -> dict:
    """Median ms of each function, the functions called in turns (one of
    each a round), so that a drift of the host's speed hits all alike; and
    how many rounds the first function won."""
    runs = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            runs[name].append(time_host(fn))
    first, *rest = runs.values()
    out = {name: statistics.median(r) for name, r in runs.items()}
    out["rounds_first_won"] = sum(all(a < r[i] for r in rest) for i, a in enumerate(first))
    out["rounds"] = reps
    return out


def hybrid_metrics(fixtures, hybrid, torch_backend) -> dict:
    """Medians of 5 at the headline commit and block: the hybrid, TorchBackend
    and CpuBackend verify; medians of 21 in turns: the hybrid's and
    TorchBackend's root, the hybrid's verify_and_root beside TorchBackend's
    verify then root; the hybrid forced to the HYBRID_SPLIT share (it moves
    the model); the rate
    model's seeds from this run (host sigs/ms from CpuBackend; the device's
    fixed ms and sigs/ms from TorchBackend's walls at HYBRID_FIT_SIGS, the
    affine fit the planner assumes); and at each of HYBRID_SMALL_SIGS the
    hybrid (bitmap checked, the card's share), TorchBackend, CpuBackend
    and the native MSM alone."""
    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.sidecar.backend import CpuBackend

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    cpu = CpuBackend()

    def median_ms(fn, reps=5):
        return statistics.median(time_host(fn) for _ in range(reps))

    out = {
        "verify_ms": {
            "hybrid": median_ms(lambda: hybrid.batch_verify(pubs, msgs, sigs)),
            "torch": median_ms(lambda: torch_backend.batch_verify(pubs, msgs, sigs)),
            "cpu": median_ms(lambda: cpu.batch_verify(pubs, msgs, sigs)),
        },
        # Pairs compared in turns, 21 each: their difference is smaller than
        # the host's drift over a phase.
        "root_ms": {
            **medians_in_turns({"hybrid": lambda: hybrid.merkle_root(leaves),
                                "torch": lambda: torch_backend.merkle_root(leaves)}),
            "hybrid_root_on": hybrid.last_root,
        },
        "verify_and_root_ms": medians_in_turns({
            "hybrid": lambda: hybrid.verify_and_root(pubs, msgs, sigs, leaves),
            "torch": lambda: (torch_backend.batch_verify(pubs, msgs, sigs),
                              torch_backend.merkle_root(leaves))}),
        "hybrid_share_after": hybrid.last_share,
        "hybrid_last_timing": hybrid.last_timing,
    }
    out["verify_ms"]["hybrid_forced_split"] = median_ms(
        lambda: hybrid._routed_call(pubs, msgs, sigs, HYBRID_SPLIT))
    out["forced_split_last_timing"] = hybrid.last_timing
    (n1, n2) = HYBRID_FIT_SIGS
    w1 = median_ms(lambda: torch_backend.batch_verify(pubs[:n1], msgs[:n1], sigs[:n1]))
    w2 = median_ms(lambda: torch_backend.batch_verify(pubs[:n2], msgs[:n2], sigs[:n2]))
    slope = (w2 - w1) / (n2 - n1)
    out["rate_seeds"] = {
        "host_rate": n / out["verify_ms"]["cpu"],
        "dev_rate": 1.0 / slope if slope > 0 else None,
        "dev_overhead_ms": w1 - n1 * slope,
        "torch_wall_ms": {n1: w1, n2: w2},
    }
    small = {}
    for k in HYBRID_SMALL_SIGS:
        p, m, s = pubs[:k], msgs[:k], sigs[:k]
        check(hybrid.batch_verify(p, m, s) == (True, [True] * k),
              f"hybrid at {k} signatures: bitmap")
        small[k] = {"hybrid": median_ms(lambda: hybrid.batch_verify(p, m, s)),
                    "hybrid_share": hybrid.last_share,
                    "torch": median_ms(lambda: torch_backend.batch_verify(p, m, s)),
                    "cpu": median_ms(lambda: cpu.batch_verify(p, m, s)),
                    "native": median_ms(lambda: native.batch_verify(p, m, s))}
    out["small_batches_ms"] = small
    out["rates_after"] = {"dev_rate": hybrid._dev_rate, "host_rate": hybrid._host_rate}
    out["roots_by_leaves"] = hybrid_roots(leaves, hybrid, torch_backend, median_ms)
    return out


# Root sizes the root cost model is measured at: a small block, a mid-size
# one and the headline block.
HYBRID_ROOT_LEAVES = (1_000, 10_000, N_LEAVES)


def hybrid_roots(leaves, hybrid, torch_backend, median_ms) -> dict:
    """The root cost model's data: at each of HYBRID_ROOT_LEAVES the native
    tree's and the card's (TorchBackend's) root, medians of 5, bytes equal,
    and the hybrid's choice; the seeds they give (the host's leaves/ms at
    the largest tree; the card's fixed ms and leaves/ms from the line
    through the smallest and the largest)."""
    from cometbft_tpu_torch import native

    rows = {}
    for k in HYBRID_ROOT_LEAVES:
        ls = leaves[:k]
        check(native.merkle_root(ls) == torch_backend.merkle_root(ls),
              f"{k}-leaf root: the native tree and the card differ")
        hybrid.merkle_root(ls)
        rows[k] = {"native": median_ms(lambda: native.merkle_root(ls)),
                   "card": median_ms(lambda: torch_backend.merkle_root(ls)),
                   "hybrid_chose": hybrid.last_root}
    lo, hi = min(rows), max(rows)
    slope = (rows[hi]["card"] - rows[lo]["card"]) / (hi - lo)
    seeds = {"HOST_LEAVES_PER_MS": hi / rows[hi]["native"],
             "CARD_LEAVES_PER_MS": 1.0 / slope if slope > 0 else None,
             "CARD_ROOT_MS": rows[lo]["card"] - lo * slope}
    return {"rows": rows, "seeds": seeds}


def drive_chain_path(fixtures, pure, bn_fix, want_root):
    """The chain phase's checks, launch counts zeroed first and checked:
    ``build_resilient()`` serves the valid and the corrupted commit and the
    root from ``hybrid``, nothing degraded; the hybrid wrapped in a
    ChaosBackend at error rate 1.0 degrades to ``cpu`` with the same
    bitmaps and root (the native tree); ``ResilientBackend(build_bn254_chain())`` serves the 16-vote
    batch's exact bitmap from ``bn254-device``, then, the device tier
    wrapped at error rate 1.0, from ``bn254-host``. Returns (the launches,
    a record)."""
    from cometbft_tpu_torch.crypto.bn254 import build_bn254_chain
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.chaos import ChaosBackend
    from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend, build_resilient

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    want_bits = {"valid": [True] * n, "corrupted": [i not in want_bad for i in range(n)]}
    commits = {"valid": (msgs, sigs), "corrupted": (bad_msgs, bad_sigs)}
    rec, launched, times = {}, 0, {}

    _build.reset_launches()
    chain = build_resilient()
    names = [t.name for t in chain.tiers]
    check(names == ["hybrid", "cpu"], f"build_resilient() chain {names}: unset CMTPU_SIDECAR_ADDR "
                                      f"and CMTPU_FAULTS for this phase")
    hybrid = chain.tiers[0].backend
    check(chain.active_tier == "hybrid", f"active tier {chain.active_tier}, not hybrid")
    for name, (m, s) in commits.items():
        t0 = time.perf_counter()
        ok, bits = chain.batch_verify(pubs, m, s)
        times[f"chain_{name}"] = (time.perf_counter() - t0) * 1e3
        launched += hybrid.last_share > 0
        check(bits == want_bits[name] and ok == all(bits), f"chain, {name} commit: bitmap")
    check(chain.merkle_root(leaves) == want_root, "chain root != TorchBackend's")
    roots = hybrid.last_root == "card"
    c = chain.counters()
    check(c["active_tier"] == "hybrid" and c["degraded_calls"] == 0 and c["trips"] == 0
          and c["deadline_exceeded"] == 0 and c["crosscheck_catches"] == 0
          and c["tiers"]["hybrid"]["calls"] == 3,
          f"the chain degraded with no fault injected: {c}")
    rec["chain"] = c

    chaos = ChaosBackend(hybrid, "error:1", seed=0)
    injected = ResilientBackend([("hybrid", chaos), ("cpu", chain.tiers[1].backend)], backoff_ms=1)
    for name, (m, s) in commits.items():
        t0 = time.perf_counter()
        ok, bits = injected.batch_verify(pubs, m, s)
        times[f"injected_{name}"] = (time.perf_counter() - t0) * 1e3
        check(bits == want_bits[name] and ok == all(bits), f"injected chain, {name} commit: bitmap")
    from cometbft_tpu_torch.crypto import merkle

    t0 = time.perf_counter()
    check(injected.merkle_root(leaves) == want_root, "injected chain: the degraded root")
    times["injected_root"] = (time.perf_counter() - t0) * 1e3
    check(merkle.last_root_path == "host-native", f"the degraded root took {merkle.last_root_path}")
    c = injected.counters()
    check(c["degraded_calls"] == 3 and chaos.injected["error"] >= 2 and c["crosscheck_catches"] == 0,
          f"the injected chain did not degrade to cpu on each call: {c}")
    rec["injected"] = c

    votes = bn_fix["votes"]
    want_votes = [i != BAD_VOTE for i in range(N_VOTES)]
    bn_chain = ResilientBackend(build_bn254_chain())
    check([t.name for t in bn_chain.tiers] == ["bn254-device", "bn254-host", "cpu"],
          f"build_bn254_chain() tiers {[t.name for t in bn_chain.tiers]}")
    t0 = time.perf_counter()
    ok, bits = bn_chain.batch_verify(*votes)
    times["bn254_chain_votes"] = (time.perf_counter() - t0) * 1e3
    c = bn_chain.counters()
    check(not ok and bits == want_votes and c["degraded_calls"] == 0
          and c["tiers"]["bn254-device"]["calls"] == 1,
          f"BN254 chain: bitmap {bits} or served by another tier than bn254-device: {c}")
    rec["bn254_chain"] = c
    tiers = build_bn254_chain()
    bn_injected = ResilientBackend([("bn254-device", ChaosBackend(tiers[0][1], "error:1", seed=0)),
                                    *tiers[1:]], backoff_ms=1)
    t0 = time.perf_counter()
    ok, bits = bn_injected.batch_verify(*votes)
    times["bn254_injected_votes"] = (time.perf_counter() - t0) * 1e3
    c = bn_injected.counters()
    check(not ok and bits == want_votes and c["degraded_calls"] == 1
          and c["tiers"]["bn254-host"]["calls"] == 1 and c["tiers"]["cpu"]["calls"] == 0,
          f"injected BN254 chain: bitmap {bits} or not served by bn254-host: {c}")
    rec["bn254_injected"] = c
    rec["times_ms"] = times
    return expect_launches(launched, roots, 1), rec


# -- the process default, the fleet, the proofs paths, the tooling ---------------

# Batches the process default serves: the commit, a typical validator set's
# commit, one vote.
AUTO_SIGS = (N_SIGS, 150, 1)


@contextlib.contextmanager
def environ(**values):
    """Set (a str) or unset (None) environment variables for the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def count_shares(hybrid) -> list:
    """Record the hybrid's device share after each of its batch_verify calls
    (three launches a call with a share): the calls of the chains' and the
    fleet's threads."""
    shares, inner = [], hybrid.batch_verify

    def counted(pubs, msgs, sigs):
        out = inner(pubs, msgs, sigs)
        shares.append(hybrid.last_share)
        return out

    hybrid.batch_verify = counted
    return shares


def drive_auto_path(fixtures, pure, torch_backend) -> dict:
    """The process default: a fresh ``get_backend()`` under
    ``CMTPU_BACKEND=auto`` (built and warmed first, outside the launch
    count), then, counts zeroed, the commit, the corrupted commit and the
    batches of AUTO_SIGS, each bitmap equal to TorchBackend's; every call
    served by the hybrid tier with no degradation; the first 150-signature
    call with a share on the card; three launches a call with a device
    share. Then medians of 5 beside the bare chain's, its hybrid tier's and
    TorchBackend's, and set_backend(None) closes it (its dispatcher thread
    ends)."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler
    from cometbft_tpu_torch.sidecar.supervisor import ResilientBackend

    _, _, pubs, msgs, sigs, _, _ = fixtures
    bad_msgs, bad_sigs, _ = corrupted_commit(pure, msgs, sigs)
    with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                 CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
        be.set_backend(None)
        t0 = time.perf_counter()
        auto = be.get_backend()
        setup_s = time.perf_counter() - t0
    check(isinstance(auto, CoalescingScheduler) and isinstance(auto.inner, ResilientBackend),
          f"CMTPU_BACKEND=auto served {type(auto).__name__}, not the coalesced chain")
    chain = auto.inner
    check([t.name for t in chain.tiers] == ["hybrid", "cpu"], f"auto chain {chain.counters()['chain']}")
    hybrid = be._hybrid_tier(chain)
    warm = {(ek.bucket_for(b, hybrid._n_dev), hybrid._n_dev) for b in ek.WARM_BUCKETS}
    check(warm <= set(hybrid._dev_wall), f"the default's hybrid was not warmed: {hybrid._dev_wall}")
    # The model the first calls are planned from: the warmed walls (ms a
    # bucket) and the host's rate (signatures a ms).
    model = {"walls_ms": {b: w for (b, _), w in sorted(hybrid._dev_wall.items())},
             "host_sigs_per_ms": hybrid._host_rate}
    shares = count_shares(hybrid)
    cases = {"commit": (pubs, msgs, sigs), "corrupted": (pubs, bad_msgs, bad_sigs)}
    cases.update({f"sigs_{k}": (pubs[:k], msgs[:k], sigs[:k]) for k in AUTO_SIGS[1:]})
    want = {name: torch_backend.batch_verify(*case) for name, case in cases.items()}
    _build.reset_launches()
    first_share = {}
    for name, (p, m, s) in cases.items():
        check(auto.batch_verify(p, m, s) == want[name], f"auto, {name}: bitmap != TorchBackend's")
        first_share[name] = hybrid.last_share
    typical = f"sigs_{AUTO_SIGS[1]}"
    check(first_share[typical] > 0,
          f"the default's first {typical} call had no share on the card: {first_share}; "
          f"planned from {model}")
    c = chain.counters()
    check(c["active_tier"] == "hybrid" and c["degraded_calls"] == 0 and c["trips"] == 0
          and c["crosscheck_catches"] == 0 and c["tiers"]["hybrid"]["calls"] == len(cases),
          f"the default's chain degraded with no fault injected: {c}")
    launches = expect_launches(sum(1 for sh in shares if sh > 0), 0, 0)

    def median_ms(fn, reps=5):
        return statistics.median(time_host(fn) for _ in range(reps))

    # Where the default's time goes: the scheduler (auto against the bare
    # chain), the supervisor's cross-check (the chain against its hybrid).
    times = {}
    for k in AUTO_SIGS:
        p, m, s = pubs[:k], msgs[:k], sigs[:k]
        times[k] = {"auto": median_ms(lambda: auto.batch_verify(p, m, s)),
                    "auto_share": hybrid.last_share,
                    "chain": median_ms(lambda: chain.batch_verify(p, m, s)),
                    "hybrid": median_ms(lambda: hybrid.batch_verify(p, m, s)),
                    "torch": median_ms(lambda: torch_backend.batch_verify(p, m, s))}
    engine = auto.engine
    be.set_backend(None)
    check(be._backend is None and not engine._thread.is_alive(),
          "set_backend(None) left the default's dispatcher running")
    return {"launches": launches, "setup_s": setup_s, "first_share": first_share,
            "warm_model": model, "times_ms": times, "counters": c,
            "root_model": {"card_fixed_ms": hybrid._root_fixed,
                           "card_leaves_per_ms": hybrid._card_leaf_rate,
                           "host_leaves_per_ms": hybrid._host_leaf_rate}}


def start_sidecar_process(device: str = "torch"):
    """``python -m cometbft_tpu_torch.sidecar`` on 127.0.0.1:0, serving
    ``CMTPU_SIDECAR_DEVICE=device`` (``TorchBackend()`` on the card) and
    warmed, in a process of its own: started after this process built the
    kernels (it loads the same library), read with ``sidecar_process_addr``."""
    env = dict(os.environ, CMTPU_SIDECAR_ADDR="127.0.0.1:0", CMTPU_SIDECAR_DEVICE=device,
               CMTPU_SIDECAR_WARM="1")
    return subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.sidecar"],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def sidecar_process_addr(proc) -> str:
    """The address the process printed, once its warm-up is complete."""
    addr, lines = None, []
    for line in proc.stdout:
        lines.append(line)
        m = re.search(r"sidecar: serving on (\S+)", line)
        if m:
            addr = m.group(1)
        if "warmup complete" in line:
            break
    check(addr is not None and proc.poll() is None,
          f"the sidecar process did not come up: {''.join(lines)[-3000:]}")
    threading.Thread(target=proc.stdout.read, daemon=True).start()  # drain the rest
    return addr


# Fleet walls at these batch sizes give the dispatch's fixed cost.
FANOUT_FIT_SIGS = (1024, N_SIGS)


def drive_fanout_path(fixtures, pure, torch_backend, proc, remote, want_root) -> dict:
    """The fleet tier on one card: two port sidecars (``proc``, another
    process serving on ``remote``, and one in this process on 127.0.0.1:0,
    both serving TorchBackend()) named by CMTPU_FANOUT_PEERS, and the local
    hybrid.
    ``build_resilient()`` is headed by ``fanout``. First the commit's median
    of 5 beside TorchBackend's and the fleet's walls at FANOUT_FIT_SIGS;
    then, counts zeroed, the commit's and the corrupted commit's bitmaps
    equal TorchBackend's, the fleet's width the sum of its shards'; then
    the other process is killed: the next commit
    shows exactly one redistribution and exact bits, and the root fails
    over past it (CMTPU_FANOUT_COOLDOWN_MS=0, so the dead shard is tried
    again). Launches counted in this process: three a verify dispatch of
    the in-process sidecar and a hybrid call with a device share, two a
    root."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar.backend import TorchBackend
    from cometbft_tpu_torch.sidecar.service import SidecarServer
    from cometbft_tpu_torch.sidecar.supervisor import build_resilient

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    want = {"valid": (True, [True] * n), "corrupted": (False, [i not in want_bad for i in range(n)])}
    server = SidecarServer("127.0.0.1:0", backend=TorchBackend()).start()
    chain = None
    try:
        with environ(CMTPU_FANOUT_PEERS=f"{remote},{server.bound_addr}",
                     CMTPU_FANOUT_COOLDOWN_MS="0", CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            chain = build_resilient()
        names = [t.name for t in chain.tiers]
        check(names == ["fanout", "hybrid", "cpu"], f"fanout chain {names}")
        fan, hybrid = chain.tiers[0].backend, chain.tiers[1].backend
        check([s.name for s in fan.shards] == ["peer0", "peer1", "local"]
              and fan.shards[2].backend is hybrid, f"fleet shards {fan.shard_widths()}")
        rec, times = {}, {}
        times["fanout_commit"] = [time_host(lambda: chain.batch_verify(pubs, msgs, sigs))
                                  for _ in range(5)]
        times["torch_commit"] = [time_host(lambda: torch_backend.batch_verify(pubs, msgs, sigs))
                                 for _ in range(5)]
        walls = {k: statistics.median(time_host(lambda: fan.batch_verify(pubs[:k], msgs[:k], sigs[:k]))
                                      for _ in range(3)) for k in FANOUT_FIT_SIGS}
        (k1, k2) = FANOUT_FIT_SIGS
        slope = (walls[k2] - walls[k1]) / (k2 - k1)
        rec["fit"] = {"walls_ms": walls, "fixed_ms": walls[k1] - k1 * slope,
                      "sigs_per_ms_a_card": 1.0 / slope / fan.mesh_width() if slope > 0 else None}
        shares = count_shares(hybrid)
        _build.reset_launches()
        d0 = server.scheduler_counters()["dispatches"]
        for name, (m, s) in {"valid": (msgs, sigs), "corrupted": (bad_msgs, bad_sigs)}.items():
            check(chain.batch_verify(pubs, m, s) == want[name], f"fanout chain, {name}: bitmap")
        check(fan.mesh_width() == 3 and chain.mesh_width() == 3,
              f"fleet width {fan.mesh_width()}, chain {chain.mesh_width()}: not the sum 3")
        c = chain.counters()
        check(c["active_tier"] == "fanout" and c["degraded_calls"] == 0
              and fan.counters()["redistributions"] == 0, f"the fleet degraded unprovoked: {c}")
        proc.kill()
        proc.wait()
        r0 = fan.counters()["redistributions"]
        check(chain.batch_verify(pubs, msgs, sigs) == want["valid"],
              "fanout chain after a shard died: bitmap")
        fc = fan.counters()
        check(fc["redistributions"] - r0 == 1 and chain.counters()["degraded_calls"] == 0,
              f"a dead shard: expected one redistribution, fanout counters {fc}")
        f0 = fc["shards"]["peer0"]["failures"]
        check(chain.merkle_root(leaves) == want_root, "fanout root after failover")
        fc = fan.counters()
        check(fc["shards"]["peer0"]["failures"] == f0 + 1,
              f"the root did not fail over past the dead shard: {fc}")
        dispatches = server.scheduler_counters()["dispatches"] - d0
        launches = expect_launches(dispatches + sum(1 for sh in shares if sh > 0), 1, 0)
        rec.update({"launches": launches, "sidecar_dispatches": dispatches, "fanout": fc,
                    "chain": chain.counters(), "times_ms": times})
        return rec
    finally:
        if chain is not None:
            chain.close()
        server.shutdown()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


PROOF_PATH_SETS = ("64k", "partset")


def drive_proofs_paths(fixtures, host) -> dict:
    """crypto/merkle's proofs path selection at the 65,536-leaf block and
    the part set: the card (CMTPU_DEVICE_PROOFS=1, two sha256 launches a
    set) and the native host pass (=0, none), each root and every 97th
    proof and the last equal to the pure pass, medians of 3 each; then the
    default (unset) takes DEVICE_PROOFS_DEFAULT's path."""
    from cometbft_tpu_torch.ops import _build

    sets = proof_sets(fixtures)
    out, device_calls = {}, 0
    _build.reset_launches()
    for name in PROOF_PATH_SETS:
        items = sets[name]
        root_p, proofs_p = host.proofs_from_byte_slices_pure(items)
        row = {}
        for path, env in (("device", "1"), ("host-native", "0")):
            with environ(CMTPU_DEVICE_PROOFS=env):
                root, proofs = host.proofs_from_byte_slices(items)
                check(host.last_proofs_path == path,
                      f"{name}: CMTPU_DEVICE_PROOFS={env} took {host.last_proofs_path}")
                check(root == root_p and len(proofs) == len(items), f"{name}, {path}: root or count")
                for i in list(range(0, len(items), 97)) + [len(items) - 1]:
                    a, b = proofs[i], proofs_p[i]
                    check((a.total, a.index, a.leaf_hash, list(a.aunts))
                          == (b.total, b.index, b.leaf_hash, b.aunts), f"{name}, {path}: proof {i}")
                row[path] = statistics.median(time_host(lambda: host.proofs_from_byte_slices(items))
                                              for _ in range(3))
                device_calls += 4 if path == "device" else 0
        with environ(CMTPU_DEVICE_PROOFS=None):
            host.proofs_from_byte_slices(items)
            row["default"] = host.last_proofs_path
            device_calls += host.last_proofs_path == "device"
        out[name] = row
    launches = expect_launches(0, device_calls, 0)
    want = "device" if host.DEVICE_PROOFS_DEFAULT else "host-native"
    check(all(r["default"] == want for r in out.values()), f"default proofs path: {out}")
    return {"launches": launches, "ms": out, "default": want}


def http_get(port: int, path: str) -> str:
    import urllib.request

    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120).read().decode()


def drive_tooling(fixtures, backend, probe_rc: int, probe_out: str) -> dict:
    """The port's tooling, counts zeroed: PprofServer on port 0 (its index,
    /debug/torch/memory after a headline call: allocated bytes on cuda:0,
    /debug/torch/trace?seconds=1 taken during headline calls: a trace
    written, and whether it holds the ladder's record);
    ``dryrun_multichip(2)`` on the card; ``entry()``; and the device probe's
    process (run after the build: its exit code and output) ended with PROBE
    OK."""
    import tempfile

    from cometbft_tpu_torch.entry import dryrun_multichip, entry
    from cometbft_tpu_torch.libs.pprof import PprofServer
    from cometbft_tpu_torch.ops import _build

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    rec = {}
    _build.reset_launches()
    headlines = 0

    def headline():
        nonlocal headlines
        backend.batch_verify(pubs, msgs, sigs)
        backend.merkle_root(leaves)
        headlines += 1

    srv = PprofServer(port=0)
    srv.start()
    tdir = tempfile.mkdtemp(prefix="torch-trace-")
    try:
        index = http_get(srv.port, "/debug/pprof/")
        check("/debug/torch/memory" in index and "/debug/torch/trace" in index, f"index: {index}")
        headline()
        mem = http_get(srv.port, "/debug/torch/memory")
        m = re.search(r"^cuda:0 .*allocated_bytes\.all\.current=(\d+)", mem, re.M)
        check(m is not None and int(m.group(1)) > 0, f"/debug/torch/memory: {mem[:500]}")
        rec["allocated_bytes_cuda0"] = int(m.group(1))
        box = {}
        t = threading.Thread(target=lambda: box.update(
            body=http_get(srv.port, f"/debug/torch/trace?seconds=1&dir={tdir}")))
        t.start()
        time.sleep(0.1)
        while t.is_alive():
            headline()
        t.join()
        body = box.get("body", "")
        m = re.search(r"trace written to (\S+):", body)
        check(m is not None and os.path.exists(m.group(1)), f"/debug/torch/trace: {body}")
        with open(m.group(1)) as f:
            names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])
                     if e.get("cat") == "kernel"}
        rec["trace"] = {"reply": body, "kernel_names": len(names),
                        "ladder_record": any("ladder_verify_kernel" in k for k in names)
                        or "not measured"}
    finally:
        srv.stop()
        import shutil

        shutil.rmtree(tdir, ignore_errors=True)
    dryrun_multichip(2)
    fn, args = entry()
    check(bool(fn(*args).all()), "entry(): the example batch did not verify")
    got = dict(_build.LAUNCHES)
    # headline calls, the dry run's two shards and entry(): three launches a
    # verify; two sha256 a headline root, the dry run's leaf hash and forest
    want_verify = headlines + 2 + 1
    check(all(got[k] == want_verify for k in ("ladder", "decompress", "sha512"))
          and got["sha256"] >= 2 * headlines + 1 and got["bn254"] == 0,
          f"tooling launches {got}: expected {want_verify} verify launch sets")
    rec["launches"] = got
    check(probe_rc == 0 and "PROBE OK" in probe_out, f"the device probe failed: {probe_out[-2000:]}")
    rec["probe"] = [line for line in probe_out.splitlines() if line.startswith("[")]
    return rec


def expect_launches(verify_calls: int, roots: int, bn254: int) -> dict:
    """The launch counts since the last reset, checked against a path's
    verify dispatches (three launches each), roots (two sha256 each) and
    bn254 launches."""
    from cometbft_tpu_torch.ops import _build

    got = dict(_build.LAUNCHES)
    want = {"ladder": verify_calls, "decompress": verify_calls, "sha512": verify_calls,
            "sha256": 2 * roots, "bn254": bn254}
    check(got == want, f"launches {got}, expected {want}")
    return got


# -- the commit path -------------------------------------------------------------

COMMIT_CHAIN_ID = "chip-smoke-chain"
COMMIT_HEIGHT = 1_000
COMMIT_T0 = 1_700_000_000
COMMIT_POWER = 10
COMMIT_SMALL = 150  # a typical validator set's commit
# Signers of the hop the trusted set cannot trust: they hold 100 of the new
# set's power each (the others 1), but only COMMIT_POWER of the trusted set's.
CANT_TRUST_SIGNERS = 3_000
N_BN254_COMMIT = 16
TRUSTING_PERIOD_NS = 14 * 24 * 3600 * 10**9
CLOCK_DRIFT_NS = 10 * 10**9
COMMIT_REPS = 5
SIGN_PROCESSES = min(8, os.cpu_count() or 1)

_worker_fb = None
_sign_pool = None


def sign_pool():
    """The one pool of SIGN_PROCESSES spawned workers that every phase
    signs its fixtures in (``sign_jobs``) and that runs the long-leaf plain
    levels (``levels_plain_job``), started at its first call (``main``
    calls it before the build, so that its workers, each importing this
    module and torch, start while the kernels build) and ended by
    ``close_sign_pool``."""
    global _sign_pool
    if _sign_pool is None:
        import multiprocessing

        _sign_pool = multiprocessing.get_context("spawn").Pool(SIGN_PROCESSES)
    return _sign_pool


def close_sign_pool() -> None:
    global _sign_pool
    if _sign_pool is not None:
        _sign_pool.terminate()
        _sign_pool.join()
        _sign_pool = None


def sign_jobs(jobs) -> list:
    """Pool worker: the signatures of ("ed25519", seed, pub, msg) and
    ("bn254", sk, msg) jobs and the public keys of ("pub", seed) jobs, by
    the pure modules."""
    global _worker_fb
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.crypto import ed25519_pure as pure

    out = []
    for kind, *args in jobs:
        if kind == "bn254":
            out.append(bn.sign(*args))
            continue
        if _worker_fb is None:
            _worker_fb = FixedBase(pure)
        if kind == "pub":  # the public key of a seed
            out.append(pure.point_compress(_worker_fb.mult(pure.secret_expand(args[0])[0])))
            continue
        out.append(sign_known(pure, _worker_fb, *args))
    return out


def commit_fixtures(fixtures) -> dict:
    """The commit phase's chain, as wire bytes, built with the port's types
    alone: the 10,240-validator ed25519 set of make_fixtures' seeds at equal
    power; headers at COMMIT_HEIGHT (h), h + 1 and h + 5 over it and their
    commits, where each validator signs its own canonical sign bytes
    (BlockIDFlagCommit, seconds equal, nanos differing, as real precommits
    are); a header at h + 6 over the same keys with CANT_TRUST_SIGNERS
    validators holding most of its power and signing, the rest absent; the
    commit of a COMMIT_SMALL-validator set; and an N_BN254_COMMIT-validator
    BN254 set's commit in aggregate form, with a copy in which one signer
    signed other bytes. Every signature is made in the pool of
    SIGN_PROCESSES processes (``sign_pool``)."""
    from cometbft_tpu_torch.crypto import bn254, ed25519
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.types import (BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig,
                                          Consensus, Header, PartSetHeader, SignedHeader, Time,
                                          Validator, ValidatorSet)
    from cometbft_tpu_torch.types.block import aggregate_commit

    _, seeds, pubs, *_ = fixtures
    secret = {ed25519.PubKey(p).address(): (s, p) for s, p in zip(seeds, pubs)}
    vals = ValidatorSet([Validator.new(ed25519.PubKey(p), COMMIT_POWER) for p in pubs])
    cant = ValidatorSet([Validator.new(v.pub_key, 100 if i < CANT_TRUST_SIGNERS else 1)
                         for i, v in enumerate(vals.validators)])
    small = ValidatorSet([Validator.new(ed25519.PubKey(p), COMMIT_POWER)
                          for p in pubs[:COMMIT_SMALL]])
    bn_sks = [int.from_bytes(hashlib.sha256(b"chip-smoke-bn254-commit-%d" % i).digest(), "big")
              % bn.R for i in range(N_BN254_COMMIT)]
    bn_sk = {bn254.PubKey(bn.public_key(sk)).address(): sk for sk in bn_sks}
    bn_vals = ValidatorSet([Validator.new(bn254.PubKey(bn.public_key(sk)), COMMIT_POWER)
                            for sk in bn_sks])

    def unsigned(height, vset, next_set, last_block_id, signers):
        header = Header(
            version=Consensus(11, 1), chain_id=COMMIT_CHAIN_ID, height=height,
            time=Time(COMMIT_T0 + 6 * height, 0), last_block_id=last_block_id,
            validators_hash=vset.hash(), next_validators_hash=next_set.hash(),
            app_hash=hashlib.sha256(b"app-%d" % height).digest(),
            proposer_address=vset.get_proposer().address)
        block_id = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
        sigs = [CommitSig(BLOCK_ID_FLAG_COMMIT, v.address,
                          Time(COMMIT_T0 + 6 * height + 1, 1_000 + 977 * i), b"")
                if i < signers else CommitSig.absent() for i, v in enumerate(vset.validators)]
        return header, Commit(height=height, round=0, block_id=block_id, signatures=sigs)

    h = COMMIT_HEIGHT
    plan = {"h": unsigned(h, vals, vals, BlockID(), N_SIGS)}
    plan["h1"] = unsigned(h + 1, vals, vals, plan["h"][1].block_id, N_SIGS)
    plan["h5"] = unsigned(h + 5, vals, vals, BlockID(), N_SIGS)
    plan["cant"] = unsigned(h + 6, cant, cant, BlockID(), CANT_TRUST_SIGNERS)
    plan["small"] = unsigned(h, small, small, BlockID(), COMMIT_SMALL)
    plan["bn254"] = unsigned(h, bn_vals, bn_vals, BlockID(), N_BN254_COMMIT)
    jobs, spans = [], {}
    for name, (_, commit) in plan.items():
        sign_bytes = commit.vote_sign_bytes_all(COMMIT_CHAIN_ID)
        start = len(jobs)
        for cs, msg in zip(commit.signatures, sign_bytes):
            if not cs.for_block_flag():
                continue
            if name == "bn254":
                jobs.append(("bn254", bn_sk[cs.validator_address], msg))
            else:
                jobs.append(("ed25519", *secret[cs.validator_address], msg))
        spans[name] = (start, len(jobs))
    wrong_at = N_BN254_COMMIT // 2
    jobs.append(("bn254", bn_sk[plan["bn254"][1].signatures[wrong_at].validator_address],
                 b"chip-smoke-not-the-sign-bytes"))
    # one chunk a bn254 job (each a hash-to-G2 and a G2 multiply), first;
    # then chunks of 512 ed25519 jobs
    bn_idx = [i for i, job in enumerate(jobs) if job[0] == "bn254"]
    ed_idx = [i for i, job in enumerate(jobs) if job[0] != "bn254"]
    chunks = [[i] for i in bn_idx] + [ed_idx[i : i + 512] for i in range(0, len(ed_idx), 512)]
    pool = sign_pool()
    results = pool.map(sign_jobs, [[jobs[i] for i in c] for c in chunks], chunksize=1)
    sig_of = {i: sig for c, res in zip(chunks, results) for i, sig in zip(c, res)}

    def signed(name):
        header, commit = plan[name]
        start, _ = spans[name]
        sigs, k = [], start
        for cs in commit.signatures:
            if cs.for_block_flag():
                cs = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, sig_of[k])
                k += 1
            sigs.append(cs)
        return SignedHeader(header, Commit(height=commit.height, round=0,
                                           block_id=commit.block_id, signatures=sigs))

    out = {name: signed(name).encode() for name in plan if name != "bn254"}
    bn_sh = signed("bn254")
    out["bn254"] = SignedHeader(bn_sh.header, aggregate_commit(bn_sh.commit, bn_vals)).encode()
    wrong = list(bn_sh.commit.signatures)
    cs = wrong[wrong_at]
    wrong[wrong_at] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                                sig_of[len(jobs) - 1])
    out["bn254_wrong"] = aggregate_commit(
        Commit(height=h, round=0, block_id=bn_sh.commit.block_id, signatures=wrong),
        bn_vals).encode()
    for name, vset in (("vals", vals), ("cant_vals", cant), ("small_vals", small),
                       ("bn254_vals", bn_vals)):
        out[name] = vset.encode()

    good = SignedHeader.decode(out["h"]).commit
    n = len(good.signatures)
    bad_at = sorted({17, n // 5, n // 2 + 3, n * 7 // 8, n - 1})
    sigs = list(good.signatures)
    for i in bad_at:
        s = bytearray(sigs[i].signature)
        s[40] ^= 0x08
        sigs[i] = CommitSig(sigs[i].block_id_flag, sigs[i].validator_address, sigs[i].timestamp,
                            bytes(s))
    out["corrupted"] = Commit(height=h, round=0, block_id=good.block_id, signatures=sigs).encode()
    out["corrupted_at"] = bad_at
    # just over 1/3 of the power absent: the last n // 3 + 1 signers
    absent = n // 3 + 1
    out["insufficient"] = Commit(height=h, round=0, block_id=good.block_id,
                                 signatures=good.signatures[: n - absent]
                                 + [CommitSig.absent()] * absent).encode()
    out["insufficient_power"] = ((n - absent) * COMMIT_POWER, n * COMMIT_POWER * 2 // 3)
    return out


class BitmapRecorder:
    """A backend that records each bitmap its inner backend returns."""

    def __init__(self, inner):
        self.inner = inner
        self.bitmaps: list[list] = []

    def batch_verify(self, pubs, msgs, sigs):
        ok, bits = self.inner.batch_verify(pubs, msgs, sigs)
        self.bitmaps.append(list(bits))
        return ok, bits

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


def raises(exc_type, fn):
    """The exception of type exc_type that fn() raises; fails otherwise."""
    try:
        fn()
    except exc_type as e:
        return e
    fail(f"{getattr(fn, '__name__', fn)} did not raise {exc_type.__name__}")


def commit_workloads(cf) -> dict:
    """name -> (prepare, call): prepare() decodes the workload's objects
    afresh from cf's bytes (no memo of an earlier call survives) and clears
    the verified-triple cache; call(objects) runs the user's entry point."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.types import Fraction, SignedHeader, Time, ValidatorSet, validation

    h = COMMIT_HEIGHT
    now = Time(COMMIT_T0 + 6 * h + 3600, 0)

    def commit_of(key, vals_key):
        def prepare():
            ed25519._verified.clear()
            return ValidatorSet.decode(cf[vals_key]), SignedHeader.decode(cf[key]).commit
        return prepare

    def hop_of(key, vals_key):
        def prepare():
            ed25519._verified.clear()
            return (SignedHeader.decode(cf["h"]), ValidatorSet.decode(cf["vals"]),
                    SignedHeader.decode(cf[key]), ValidatorSet.decode(cf[vals_key]))
        return prepare

    def full(args):
        vals, commit = args
        validation.verify_commit(COMMIT_CHAIN_ID, vals, commit.block_id, h, commit)

    def light(args):
        vals, commit = args
        validation.verify_commit_light(COMMIT_CHAIN_ID, vals, commit.block_id, h, commit)

    def adjacent(args):
        trusted, _, untrusted, uvals = args
        verifier.verify_adjacent(trusted, untrusted, uvals, TRUSTING_PERIOD_NS, now,
                                 CLOCK_DRIFT_NS)

    def non_adjacent(args):
        verifier.verify_non_adjacent(*args, TRUSTING_PERIOD_NS, now, CLOCK_DRIFT_NS,
                                     Fraction(1, 3))

    return {
        "verify_commit_10k": (commit_of("h", "vals"), full),
        "verify_commit_light_10k": (commit_of("h", "vals"), light),
        f"verify_commit_{COMMIT_SMALL}": (commit_of("small", "small_vals"), full),
        f"verify_commit_light_{COMMIT_SMALL}": (commit_of("small", "small_vals"), light),
        "hop_adjacent_10k": (hop_of("h1", "vals"), adjacent),
        "hop_non_adjacent_10k": (hop_of("h5", "vals"), non_adjacent),
    }


def drive_commit_path(cf, torch_backend) -> dict:
    """The commit phase's gates, launch counts zeroed first: under
    ``set_backend(TorchBackend())``, verify_commit and verify_commit_light
    of the good 10,240-validator commit, the adjacent hop (h -> h + 1) and
    the skipping hop (h -> h + 5, trust level 1/3) pass; the commit with 5
    corrupted signatures raises "wrong signature (#i)" for the lowest, the
    backend's bitmap false exactly at the 5; the commit with just over 1/3
    of the power absent raises ErrNotEnoughVotingPowerSigned with the exact
    got and needed; the hop to h + 6 raises ErrNewValSetCantBeTrusted; then
    the BN254 aggregate commit verifies through ``get_bn254_backend()``
    (the process default, its device tier first) and the copy with one
    wrong signer raises. One sha512 / decompress / ladder set a commit
    verification that reaches the backend (two for the skipping hop: its
    light check sends what the trusting check left uncached), one bn254
    launch an aggregate, no ChainExhausted fallback."""
    from cometbft_tpu_torch.crypto import bn254, ed25519
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import (Commit, Fraction, SignedHeader, Time, ValidatorSet,
                                          validation)

    h = COMMIT_HEIGHT
    work = commit_workloads(cf)
    recorder = BitmapRecorder(torch_backend)
    fallbacks = ed25519.scalar_fallbacks
    be.set_backend(recorder)
    _build.reset_launches()
    try:
        for name in ("verify_commit_10k", "verify_commit_light_10k", "hop_adjacent_10k",
                     "hop_non_adjacent_10k"):
            prepare, call = work[name]
            call(prepare())
        sizes = [len(b) for b in recorder.bitmaps]
        light_n = N_SIGS * 2 // 3 + 1
        trusting_n = N_SIGS // 3 + 1
        check(sizes == [N_SIGS, light_n, light_n, trusting_n, light_n - trusting_n]
              and all(all(b) for b in recorder.bitmaps), f"good commit batches {sizes}")

        vals = ValidatorSet.decode(cf["vals"])
        ed25519._verified.clear()
        bad = Commit.decode(cf["corrupted"])
        e = raises(ValueError, lambda: validation.verify_commit(
            COMMIT_CHAIN_ID, vals, bad.block_id, h, bad))
        first = cf["corrupted_at"][0]
        check(str(e).startswith(f"wrong signature (#{first}): "), f"corrupted commit: {e}")
        bits = recorder.bitmaps[-1]
        check([i for i, b in enumerate(bits) if not b] == cf["corrupted_at"],
              "corrupted commit: the bitmap is not false exactly at the corrupted indices")

        short = Commit.decode(cf["insufficient"])
        e = raises(validation.ErrNotEnoughVotingPowerSigned, lambda: validation.verify_commit(
            COMMIT_CHAIN_ID, vals, short.block_id, h, short))
        check((e.got, e.needed) == cf["insufficient_power"],
              f"insufficient power: got {e.got}, needed {e.needed}")

        now = Time(COMMIT_T0 + 6 * h + 3600, 0)
        raises(verifier.ErrNewValSetCantBeTrusted, lambda: verifier.verify_non_adjacent(
            SignedHeader.decode(cf["h"]), vals, SignedHeader.decode(cf["cant"]),
            ValidatorSet.decode(cf["cant_vals"]), TRUSTING_PERIOD_NS, now, CLOCK_DRIFT_NS,
            Fraction(1, 3)))
        check(len(recorder.bitmaps) == 6, f"{len(recorder.bitmaps)} backend calls, expected 6")

        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FAULTS=None):
            bn254.set_bn254_backend(None)
            bn_backend = bn254.get_bn254_backend()
        bn_vals = ValidatorSet.decode(cf["bn254_vals"])
        agg = SignedHeader.decode(cf["bn254"]).commit
        check(agg.is_aggregate(), "the BN254 commit is not in aggregate form")
        t0 = time.perf_counter()
        validation.verify_commit(COMMIT_CHAIN_ID, bn_vals, agg.block_id, h, agg)
        agg_ms = (time.perf_counter() - t0) * 1e3
        wrong = Commit.decode(cf["bn254_wrong"])
        e = raises(ValueError, lambda: validation.verify_commit(
            COMMIT_CHAIN_ID, bn_vals, wrong.block_id, h, wrong))
        check(str(e) == f"invalid aggregate signature for commit at height {h}",
              f"wrong BN254 signer: {e}")
        counters = bn_backend.inner.counters()
        check(counters["tiers"]["bn254-device"]["calls"] == 2 and counters["degraded_calls"] == 0,
              f"the BN254 aggregates were not served by bn254-device: {counters}")
        launches = expect_launches(6, 0, 2)
    finally:
        be.set_backend(None)
        bn254.set_bn254_backend(None)
    check(ed25519.scalar_fallbacks == fallbacks, "a verification took the ChainExhausted fallback")
    return {"launches": launches, "batches": [len(b) for b in recorder.bitmaps],
            "bn254_aggregate_ms": agg_ms, "bn254_chain": counters}


def commit_stage_split(cf, torch_backend, dev) -> dict:
    """One verify_commit of the 10,240-validator commit under
    ``TorchBackend()``, from a freshly decoded commit and an empty cache,
    stage by stage, each ended by a synchronize: the sign bytes
    (``vote_sign_bytes_all``), the tally loop and ``bv.add`` (with the
    basic checks before it), the cache filter, the backend call (then its
    pack and kernels, each stage_split's way, on the same triples), the
    merge into the cache; and the hop's ``ValidatorSet.hash`` and
    ``Header.hash`` of freshly decoded objects."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Commit, Header, SignedHeader, ValidatorSet, validation

    marks, box = {}, {}

    def mark(name):
        torch.cuda.synchronize()
        marks[name] = time.perf_counter()

    class Marked:
        def batch_verify(self, pubs, msgs, sigs):
            mark("backend_in")
            out = torch_backend.batch_verify(pubs, msgs, sigs)
            mark("backend_out")
            box["triples"] = (pubs, msgs, sigs)
            return out

    sign_bytes_all, verify = Commit.vote_sign_bytes_all, ed25519.BatchVerifier.verify

    def timed_sign_bytes(commit, chain_id):
        mark("sign_bytes_in")
        out = sign_bytes_all(commit, chain_id)
        mark("sign_bytes_out")
        return out

    def timed_verify(bv):
        mark("verify_in")
        out = verify(bv)
        mark("verify_out")
        return out

    vals = ValidatorSet.decode(cf["vals"])
    commit = SignedHeader.decode(cf["h"]).commit
    ed25519._verified.clear()
    be.set_backend(Marked())
    Commit.vote_sign_bytes_all, ed25519.BatchVerifier.verify = timed_sign_bytes, timed_verify
    try:
        mark("start")
        validation.verify_commit(COMMIT_CHAIN_ID, vals, commit.block_id, COMMIT_HEIGHT, commit)
        mark("end")
    finally:
        Commit.vote_sign_bytes_all, ed25519.BatchVerifier.verify = sign_bytes_all, verify
        be.set_backend(None)
    ms = lambda a, b: (marks[b] - marks[a]) * 1e3  # noqa: E731
    st = {"total": ms("start", "end"), "sign_bytes": ms("sign_bytes_in", "sign_bytes_out"),
          "tally_and_add": ms("start", "verify_in") - ms("sign_bytes_in", "sign_bytes_out"),
          "cache_filter": ms("verify_in", "backend_in"),
          "backend_call": ms("backend_in", "backend_out"),
          "merge_and_cache_put": ms("backend_out", "verify_out"),
          "after_verify": ms("verify_out", "end")}
    pubs, msgs, sigs = box["triples"]
    inner = stage_split((None, None, pubs, msgs, sigs, [b"\x00"], None), dev)
    st.update({f"backend_{k}": v for k, v in inner.items() if not k.startswith("merkle")})
    fresh_vals = ValidatorSet.decode(cf["vals"])
    fresh_header = Header.decode(SignedHeader.decode(cf["h1"]).header.encode())
    st["hop_validator_set_hash"] = time_host(fresh_vals.hash)
    st["hop_header_hash"] = time_host(fresh_header.hash)
    return st


def commit_metrics(cf, torch_backend, auto, dev) -> dict:
    """Medians of COMMIT_REPS of each workload of ``commit_workloads``
    under ``set_backend(TorchBackend())`` and under the process default
    (``auto``, the backend ``CMTPU_BACKEND=auto`` builds), in turns, each
    call from freshly decoded objects and an empty cache; and the median
    stage split of 3 calls."""
    from cometbft_tpu_torch.sidecar import backend as be

    work = commit_workloads(cf)
    runs = {name: {"torch": [], "auto": []} for name in work}
    try:
        for rep in range(COMMIT_REPS):
            tiers = [("torch", torch_backend), ("auto", auto)]
            for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
                be.set_backend(backend)
                for name, (prepare, call) in work.items():
                    args = prepare()
                    runs[name][tier].append(time_host(lambda: call(args)))
    finally:
        be.set_backend(None)
    medians = {name: {tier: statistics.median(v) for tier, v in r.items()}
               for name, r in runs.items()}
    splits = [commit_stage_split(cf, torch_backend, dev) for _ in range(3)]
    stages = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    return {"medians_ms": medians, "runs_ms": runs, "stages_ms": stages}


# -- the blocksync path ----------------------------------------------------------

BSYNC_CHAIN_ID = "chip-smoke-bsync"
BSYNC_T0 = 1_700_000_000
BSYNC_POWER = 10
# The 10,240-validator chain: the source builds BSYNC_HEIGHTS heights, a
# fresh node syncs BSYNC_HEIGHTS - 1 of them (the last block's LastCommit
# verifies the one before it). The 150-validator chain is long enough for one
# full window of PREFETCH_WINDOW (32) blocks.
BSYNC_HEIGHTS = 6
BSYNC_SMALL = COMMIT_SMALL
BSYNC_SMALL_HEIGHTS = 33
BSYNC_TXS = 4_096  # within the default mempool.size of 5,000: the proposer reaps them all
BSYNC_TX_BYTES = 250
BSYNC_BAD_HEIGHT = 10  # the bad peer's block at this height carries a flipped commit signature
BSYNC_REPS = 1  # timed rounds: one keeps the whole run, light phase included, near 630 s
BSYNC_SIGN_CHUNK = 512


def bsync_tx(height: int, i: int) -> bytes:
    """A kvstore transaction of BSYNC_TX_BYTES bytes, ``key=value``; keys
    rise with the height and index (the app's sorted store appends)."""
    head = b"h%04d-tx%05d=" % (height, i)
    return (head + hashlib.sha256(head).hexdigest().encode() * 4)[:BSYNC_TX_BYTES]


class BsyncPeer:
    """A peer double that serves a source chain's blocks: a block request
    is answered at once, through the syncing reactor's ``receive``, by the
    encoded ``block_response`` (``corrupt`` maps a height to other bytes)."""

    def __init__(self, peer_id: str, responses: list, corrupt=None):
        self.id = peer_id
        self.responses = responses
        self.corrupt = dict(corrupt or {})
        self.reactor = None
        self.stopped = False

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        from cometbft_tpu_torch.blocksync import reactor as br

        if self.stopped:
            return False
        kind, payload = br.decode_message(msg)
        if kind == "block_request":
            if payload in self.corrupt:
                reply = self.corrupt[payload]
            elif payload <= len(self.responses):
                reply = self.responses[payload - 1]
            else:
                reply = br.encode_no_block_response(payload)
            self.reactor.receive(chan_id, self, reply)
        elif kind == "status_request":
            self.reactor.receive(chan_id, self, br.encode_status_response(len(self.responses), 1))
        return True


class BsyncSwitch:
    """A switch double: peers by id, and the peers it stopped."""

    def __init__(self, reactor):
        self.reactor = reactor
        self.peers: dict = {}
        self.stops: list = []

    def get_peer(self, peer_id):
        return self.peers.get(peer_id)

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        for p in list(self.peers.values()):
            p.try_send(chan_id, msg)

    def stop_peer_for_error(self, peer, reason) -> None:
        self.stops.append(peer.id)
        peer.stopped = True
        self.peers.pop(peer.id, None)
        self.reactor.remove_peer(peer, reason)


def bsync_node(gen):
    """A fresh node from genesis: the port's PersistentKVStoreApplication
    behind the local ABCI client, CListMempool, a MemDB under BlockStore and
    StateStore, and BlockExecutor (no evidence pool, no event bus)."""
    from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication
    from cometbft_tpu_torch.config import MempoolConfig
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.proxy import AppConns, local_client_creator
    from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
    from cometbft_tpu_torch.store import BlockStore

    state = make_genesis_state(gen)
    conns = AppConns(local_client_creator(PersistentKVStoreApplication()))
    conns.start()
    mempool = CListMempool(MempoolConfig(), conns.mempool)
    db = MemDB()
    ss, bs = StateStore(db), BlockStore(db)
    ss.save(state)
    return {"state": state, "executor": BlockExecutor(ss, conns.consensus, mempool, None, bs),
            "block_store": bs, "state_store": ss, "mempool": mempool, "db": db}


def bsync_source(seeds, pubs, n_heights: int, n_txs: int, pool) -> dict:
    """A source node's chain: a genesis of the given keys at equal power,
    then n_heights blocks, each proposed by the port's BlockExecutor from
    n_txs kvstore transactions admitted to its CListMempool, applied to its
    PersistentKVStoreApplication, and committed by every validator (each
    signs its canonical precommit in the process pool). Returns the genesis,
    each block's encoded block_response, the source's state after each
    height (store bytes), its blocks' bytes and its part counts, and the
    node itself (its stores and executor) with its last state, which the
    light phase goes on with."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.state import store as state_store
    from cometbft_tpu_torch.types import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, Time
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    secret = {ed25519.PubKey(p).address(): (s, p) for s, p in zip(seeds, pubs)}
    gen = GenesisDoc(chain_id=BSYNC_CHAIN_ID, genesis_time=Time(BSYNC_T0, 0), validators=[
        GenesisValidator(ed25519.PubKey(p).address(), ed25519.PubKey(p), BSYNC_POWER, "")
        for p in pubs])
    gen.validate_and_complete()
    node = bsync_node(gen)
    state, ex, mempool = node["state"], node["executor"], node["mempool"]
    last_commit = Commit(height=0, round=0)
    responses, states, blocks, parts_count = [], [], [], []
    for h in range(1, n_heights + 1):
        for i in range(n_txs):
            mempool.check_tx(bsync_tx(h, i))
        block = ex.create_proposal_block(h, state, last_commit,
                                         state.validators.get_proposer().address)
        check(len(block.data.txs) == n_txs, f"height {h}: the proposer reaped "
              f"{len(block.data.txs)} of {n_txs} transactions")
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        unsigned = Commit(height=h, round=0, block_id=bid, signatures=[
            CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, block.header.time.add_nanos(
                10**9 + 977 * i), b"") for i, v in enumerate(state.validators.validators)])
        msgs = unsigned.vote_sign_bytes_all(BSYNC_CHAIN_ID)
        jobs = [("ed25519", *secret[cs.validator_address], m)
                for cs, m in zip(unsigned.signatures, msgs)]
        chunks = [jobs[i : i + BSYNC_SIGN_CHUNK] for i in range(0, len(jobs), BSYNC_SIGN_CHUNK)]
        sigs = [s for chunk in pool.map(sign_jobs, chunks, chunksize=1) for s in chunk]
        commit = Commit(height=h, round=0, block_id=bid, signatures=[
            CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, sig)
            for cs, sig in zip(unsigned.signatures, sigs)])
        node["block_store"].save_block(block, parts, commit)
        state, _ = ex.apply_block(state, bid, block)
        responses.append(br.encode_block_response(block))
        blocks.append(block.encode())
        states.append(state_store._encode_state(state))
        parts_count.append(parts.total)
        last_commit = commit
    return {"gen": gen, "responses": responses, "states": states, "blocks": blocks,
            "parts": parts_count, "n_vals": len(pubs), "node": node, "state": state}


def bsync_flipped(source, height: int) -> bytes:
    """The source's block at height as a block_response whose LastCommit's
    first signature has one bit flipped (the header left as it was)."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.types.block import Block, Commit, CommitSig

    block = Block.decode(source["blocks"][height - 1])
    sigs = list(block.last_commit.signatures)
    cs = sigs[0]
    sigs[0] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                        bytes([cs.signature[0] ^ 0x01]) + cs.signature[1:])
    block.last_commit = Commit(height=block.last_commit.height, round=block.last_commit.round,
                               block_id=block.last_commit.block_id, signatures=sigs)
    return br.encode_block_response(block)


class BsyncRecorder:
    """A backend that records the size of each batch it is asked to verify
    and which check asked (``BsyncStages.check``): the window, the light
    check or validate_block's full check (None: no check of the sync
    loop's, as consensus's after the handoff); with ``keep``, its triples
    too (the kernel comparisons run on them)."""

    def __init__(self, inner, stages=None, keep: bool = False):
        self.inner = inner
        self.stages = stages
        self.keep = keep
        self.calls: list = []
        self.triples: list = []

    def batch_verify(self, pubs, msgs, sigs):
        who = self.stages.check if self.stages is not None else None
        self.calls.append((who, len(pubs)))
        if self.keep:
            self.triples.append((list(pubs), list(msgs), list(sigs)))
        return self.inner.batch_verify(pubs, msgs, sigs)

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)


class BsyncStages:
    """Wraps the sync loop's stages with timers, each stage ended by a
    synchronize: a block_response's decode (in ``receive``), then per applied height
    ``make_part_set`` (with the proofs path it took), the window
    (``_prefetch_verify_window``, its sign bytes, ``bv.add`` and the backend
    call), ``verify_commit_light``, ``validate_block`` (twice a height: the
    reactor's, then ``apply_block``'s) with its set hashes and its
    ``verify_commit``, ``save_block`` and ``apply_block``. It also counts the
    lanes each check sends (through a BsyncRecorder). Installed on the
    port's classes for one run (``with``)."""

    def __init__(self):
        self.decode: list = []
        self.heights: list = []
        self.check = None
        self.lanes: list = []  # (height index, check, lanes) of each backend call
        self._cur = None
        self._saved = []

    def _wrap(self, owner, name, stage, check=None):
        orig = getattr(owner, name)
        timer = self

        def wrapper(*args, **kwargs):
            prev = timer.check
            if check is not None:
                timer.check = check
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                timer.check = prev
                timer.add(stage, ms)
                if stage == "make_part_set" and timer._cur is not None:
                    from cometbft_tpu_torch.crypto import merkle

                    timer._cur["proofs_path"] = merkle.last_proofs_path

        self._saved.append((owner, name, orig))
        setattr(owner, name, wrapper)

    def add(self, stage, ms):
        if self._cur is not None:
            self._cur.setdefault(stage, []).append(ms)

    def __enter__(self):
        from cometbft_tpu_torch.blocksync import reactor as br
        from cometbft_tpu_torch.state import BlockExecutor
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types import ValidatorSet
        from cometbft_tpu_torch.types.block import Block

        timer = self
        orig_try = br.BlocksyncReactor._try_sync_one

        def try_sync_one(reactor):
            timer._cur = {}
            ok = orig_try(reactor)
            if ok:
                timer.heights.append(timer._cur)
            timer._cur = None
            return ok

        self._saved.append((br.BlocksyncReactor, "_try_sync_one", orig_try))
        br.BlocksyncReactor._try_sync_one = try_sync_one
        orig_decode = br.decode_message

        def decode_message(data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig_decode(data)
            torch.cuda.synchronize()
            if out[0] == "block_response":
                timer.decode.append((time.perf_counter() - t0) * 1e3)
            return out

        self._saved.append((br, "decode_message", orig_decode))
        br.decode_message = decode_message
        self._wrap(Block, "make_part_set", "make_part_set")
        self._wrap(br.BlocksyncReactor, "_prefetch_verify_window", "window", "window")
        self._wrap(ValidatorSet, "verify_commit_light", "verify_commit_light", "light")
        self._wrap(BlockExecutor, "validate_block", "validate_block")
        self._wrap(ValidatorSet, "hash", "validator_set_hash")
        self._wrap(ValidatorSet, "verify_commit", "verify_commit", "full")
        self._wrap(BlockStore, "save_block", "save_block")
        self._wrap(BlockExecutor, "apply_block", "apply_block")
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()


def bsync_run(source, backend, pipeline: bool, corrupt=None) -> dict:
    """Sync a fresh node from two peer doubles serving the source (``p1``
    with ``corrupt``'s blocks in place of the source's), through the port's
    BlocksyncReactor under ``set_backend(backend)``, driven on this thread:
    make the requests, try sync steps until none applies, until caught up.
    Returns the wall time over the applied heights, the heights, the stops,
    the reactor's counters and the node."""
    from cometbft_tpu_torch.blocksync import reactor as br
    from cometbft_tpu_torch.sidecar import backend as be

    node = bsync_node(source["gen"])
    peers = [BsyncPeer("p1", source["responses"], corrupt), BsyncPeer("p2", source["responses"])]
    applied = []
    with environ(CMTPU_BLOCKSYNC_PIPELINE="1" if pipeline else "0"):
        reactor = br.BlocksyncReactor(state=node["state"], block_exec=node["executor"],
                                      block_store=node["block_store"], block_sync=True)
    switch = BsyncSwitch(reactor)
    reactor.set_switch(switch)
    be.set_backend(backend)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in peers:
            p.reactor = reactor
            switch.peers[p.id] = p
            reactor.add_peer(p)
        while True:
            reactor.pool.make_requests()
            progressed = False
            while True:
                h = reactor.pool.height
                if not reactor._try_sync_one():
                    break
                applied.append(h)
                progressed = True
            if reactor.pool.is_caught_up() or not progressed:
                break
        reactor._pipeline_wait()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    return {"wall_ms": wall, "ms_per_block": wall / max(1, len(applied)), "applied": applied,
            "stops": list(switch.stops), "prefetch_errors": reactor.prefetch_errors,
            "sync_errors": reactor.sync_errors, "last_sync_error": repr(reactor.last_sync_error),
            "last_prefetch_error": repr(reactor.last_prefetch_error),
            "pipeline_overlap_ms": reactor.pipeline_overlap_ms, "node": node,
            "state": reactor.state}


def bsync_same_chain(source, run, upto: int) -> None:
    """The synced node's state is the source's after height upto, and its
    stored blocks, metas and commits are the source's bytes."""
    from cometbft_tpu_torch.state import store as state_store
    from cometbft_tpu_torch.types.block import Block

    check(run["applied"] == list(range(1, upto + 1)), f"applied heights {run['applied']}")
    check(state_store._encode_state(run["state"]) == source["states"][upto - 1],
          f"the synced state differs from the source's at height {upto}")
    stored = run["node"]["state_store"]._db.get(b"stateKey")
    check(stored == source["states"][upto - 1], "the synced node's stored state differs")
    bs = run["node"]["block_store"]
    for h in range(1, upto + 1):
        check(bs.load_block(h).encode() == source["blocks"][h - 1],
              f"stored block {h} differs from the source's")
        check(bs.load_block_meta(h).block_id.hash == Block.decode(source["blocks"][h - 1]).hash(),
              f"stored meta {h} differs")


def bsync_gates(source, torch_backend, stages: BsyncStages) -> dict:
    """The counted run of one chain: pipeline off (the batches are then
    deterministic), under a BsyncRecorder around ``TorchBackend()``, stages
    timed. Gates: the chain synced whole; the window's batches are the
    window arithmetic (PREFETCH_MAX_SIGS // n blocks a window, a window
    covers one block fewer than it holds: at 10,240 validators two commits,
    20,480 lanes, at heights 1 and 3, and none at 5 where two blocks are left;
    at 150 one window of 31 commits, 4,650 lanes); the checks after a window
    send nothing (the verified-triple cache), but the last height's light
    check, which no window covered (2/3 of the set + 1 lanes); no error."""
    n, heights = source["n_vals"], len(source["blocks"])
    recorder = BsyncRecorder(torch_backend, stages)
    with stages:
        run = bsync_run(source, recorder, pipeline=False)
    bsync_same_chain(source, run, heights - 1)
    check((run["prefetch_errors"], run["sync_errors"], run["stops"]) == (0, 0, []),
          f"errors in a clean sync: {run['prefetch_errors']}, {run['sync_errors']}, "
          f"{run['stops']}, {run['last_prefetch_error']}, {run['last_sync_error']}")
    want_windows, want_later = bsync_window_arithmetic(n, heights)
    windows = [k for who, k in recorder.calls if who == "window"]
    later = {who: [k for w, k in recorder.calls if w == who] for who in ("light", "full")}
    check(windows == want_windows, f"window batches {windows}, expected {want_windows}")
    check(later == want_later, f"the checks after the windows sent {later}; the window "
          f"arithmetic leaves {want_later}")
    checks = sum(len(h.get("verify_commit_light", [])) + len(h.get("verify_commit", []))
                 for h in stages.heights)
    paths = [h.get("proofs_path") for h in stages.heights]
    want_paths = ["device" if p >= 32 else "pure-python" for p in source["parts"][:-1]]
    check(paths == want_paths, f"proofs paths {paths}, expected {want_paths}")
    return {"run": run, "calls": recorder.calls, "windows": windows, "later_lanes": later,
            "lanes_sent": sum(k for _, k in recorder.calls), "checks": checks,
            "checks_answered_by_the_cache": checks - sum(len(v) for v in later.values()),
            "proofs_paths": paths}


def bsync_window_arithmetic(n: int, heights: int) -> tuple:
    """The batches a sync of ``heights`` blocks of ``n`` validators sends,
    height by height as the reactor goes: the windows' lanes, then the
    light checks no window covered (2/3 of the set + 1 lanes) and the full
    checks of commits neither covered (the rest of the set, once)."""
    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor

    wb = min(BlocksyncReactor.PREFETCH_WINDOW, BlocksyncReactor.PREFETCH_MAX_SIGS // n)
    light_n = n * 2 // 3 + 1
    want_windows, covered, sent = [], set(), {}
    want_later = {"light": [], "full": []}
    prefetched_to = 0
    for h in range(1, heights):
        if h >= prefetched_to and heights - h + 1 >= 3:  # a window needs 3 blocks
            k = min(wb, heights - h + 1) - 1
            want_windows.append(k * n)
            covered.update(range(h, h + k))
            prefetched_to = h + k
        if h not in covered:  # the light check of commit h, second.LastCommit
            want_later["light"].append(light_n)
            sent[h] = light_n
        if h >= 2 and h - 1 not in covered and sent.get(h - 1, 0) < n:
            want_later["full"].append(n - sent.get(h - 1, 0))  # commit h - 1, once
            sent[h - 1] = n
    return want_windows, want_later


def bsync_stage_table(stages: BsyncStages) -> dict:
    """Per applied height: ms by stage (summed where a stage ran more than
    once a height, with its count), and the medians over the heights."""
    rows = [{k: sum(v) for k, v in h.items() if k != "proofs_path"} for h in stages.heights]
    counts = [{k: len(v) for k, v in h.items() if k != "proofs_path"} for h in stages.heights]
    keys = sorted({k for r in rows for k in r})
    med = {k: statistics.median(r.get(k, 0.0) for r in rows) for k in keys}
    return {"per_height_ms": rows, "counts": counts, "median_ms": med,
            "proofs_paths": [h.get("proofs_path") for h in stages.heights],
            "decode_ms": stages.decode, "decode_median_ms": statistics.median(stages.decode)}


def bsync_window_triples(source, heights):
    """(pubs, msgs, sigs) of the source's commits at the given heights, each
    as the next block's LastCommit carries it."""
    from cometbft_tpu_torch.state import make_genesis_state
    from cometbft_tpu_torch.types.block import Block

    vals = make_genesis_state(source["gen"]).validators.validators
    pubs, msgs, sigs = [], [], []
    for h in heights:
        commit = Block.decode(source["blocks"][h]).last_commit
        for v, cs, m in zip(vals, commit.signatures, commit.vote_sign_bytes_all(BSYNC_CHAIN_ID)):
            pubs.append(v.pub_key.bytes())
            msgs.append(bytes(m))
            sigs.append(cs.signature)
    return pubs, msgs, sigs


def bsync_batches(big, small) -> dict:
    """The batch shapes the blocksync path gives the verify kernels: the
    10,240-validator window (commits 1-2, 20,480 lanes in the 32,768
    bucket), one commit, the light check no window covers (2/3 of the set +
    1 lanes), the 150-validator window (commits 1-31, 4,650 lanes) and its
    light check. Each batch has four lanes corrupted (``corrupt_four``).
    Returns label -> (pubs, msgs, sigs, the corrupted lanes)."""

    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor as R

    def first_window(source):  # commits 1..k, as bsync_gates's arithmetic gives
        wb = min(R.PREFETCH_WINDOW, R.PREFETCH_MAX_SIGS // source["n_vals"])
        return bsync_window_triples(source, range(1, min(wb, len(source["blocks"]))))

    w10k, w150 = first_window(big), first_window(small)
    out = {}
    for src, n in ((w10k, len(w10k[0])), (w10k, big["n_vals"]),
                   (w10k, big["n_vals"] * 2 // 3 + 1), (w150, len(w150[0])),
                   (w150, small["n_vals"] * 2 // 3 + 1)):
        out[str(n)] = corrupt_four(*(x[:n] for x in src))
    return out


def corrupt_four(pubs, msgs, sigs):
    """Copies of a batch with four lanes corrupted: a flipped bit in R, in
    the message, in S and in A, at the first, a third, a half and the last
    lane. Returns (pubs, msgs, sigs, the corrupted lanes)."""

    def flip(b: bytes, at: int) -> bytes:
        return b[:at] + bytes([b[at] ^ 0x01]) + b[at + 1:]

    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    n = len(pubs)
    bad = (0, n // 3, n // 2, n - 1)
    sigs[bad[0]] = flip(sigs[bad[0]], 0)
    msgs[bad[1]] = flip(msgs[bad[1]], len(msgs[bad[1]]) - 1)
    sigs[bad[2]] = flip(sigs[bad[2]], 33)
    pubs[bad[3]] = flip(pubs[bad[3]], 0)
    return pubs, msgs, sigs, set(bad)


def bsync_compare_kernels(batches, dev) -> dict:
    """Each verify kernel against its plain version on the same device
    operands at each blocksync batch (``bsync_batches``, padded by
    ``pack_batch`` to its bucket): challenge_digits, decompress_words (the
    points through point_freeze, and ok) and verify_lanes (the verdicts and
    the accumulator). The kernels run batch by batch, as the path launches
    them; each plain version runs once over every batch's lanes joined (its
    lanes are independent, and its time is launch-bound, not lane-bound),
    and each batch's lanes of its answer are held to that batch's. Requires
    max_abs_err 0 for each, and the kernel's verdicts false at exactly the
    corrupted lanes. Returns label -> {bucket, lanes, corrupted, max_abs_err
    by kernel} and the device operands."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import sha512_kernel as s5

    operands, got, host_oks = {}, {}, {}
    for label, (pubs, msgs, sigs, bad) in batches.items():
        packed, host_ok = ek.pack_batch(pubs, msgs, sigs)
        a_w, r_w, s_w, msg_w, msg_nb = ek.operands_to_device(packed, dev)
        s_dig, k_dig = s5.challenge_digits(msg_w, msg_nb, s_w)
        pt, ok = ed.decompress_words(a_w, r_w)
        verdict, acc = ladder.verify_lanes(s_dig, k_dig, pt, ok, with_acc=True)
        operands[label] = (msg_w, msg_nb, s_w, a_w, r_w, s_dig, k_dig, pt, ok)
        got[label] = (s_dig, k_dig, pt, ok, verdict, acc)
        host_oks[label] = host_ok

    # The plain versions over the joined lanes: each batch's message words
    # padded with zero blocks to the widest (the block counts mask them);
    # A lanes then R lanes, as decompress_words and verify_lanes order them.
    ops = list(operands.values())
    widths = [o[3].shape[1] for o in ops]
    spans, at = [], 0
    for w in widths:
        spans.append((at, at + w))
        at += w
    words = max(o[0].shape[1] for o in ops)
    msg_all = torch.cat([torch.nn.functional.pad(o[0], (0, words - o[0].shape[1])) for o in ops])
    s_p, k_p = s5.challenge_digits_plain(msg_all, torch.cat([o[1] for o in ops]),
                                         torch.cat([o[2] for o in ops], dim=1))
    pt_p, ok_p = ed.decompress_words_plain(torch.cat([o[3] for o in ops], dim=1),
                                           torch.cat([o[4] for o in ops], dim=1))
    pt_p = torch.stack(ed.point_freeze(pt_p))
    s_dig_all = torch.cat([o[5] for o in ops], dim=1)
    k_dig_all = torch.cat([o[6] for o in ops], dim=1)
    pt_all = torch.cat([o[7][:, :, :w] for o, w in zip(ops, widths)]
                       + [o[7][:, :, w:] for o, w in zip(ops, widths)], dim=2)
    ok_all = torch.cat([o[8][:w] for o, w in zip(ops, widths)]
                       + [o[8][w:] for o, w in zip(ops, widths)])
    want_all, acc_p = ladder.verify_lanes_plain(s_dig_all, k_dig_all, pt_all, ok_all)
    acc_p = torch.stack(ed.point_freeze(acc_p))

    out = {}
    for (label, (pubs, msgs, sigs, bad)), (lo, hi) in zip(batches.items(), spans):
        n = len(pubs)
        s_dig, k_dig, pt, ok, verdict, acc = got[label]
        m = at  # the joined A lanes end where the R lanes start
        err_sha = max_abs_err(torch.stack([s_dig, k_dig]),
                              torch.stack([s_p[:, lo:hi], k_p[:, lo:hi]]))
        pt_k = torch.stack(ed.point_freeze(pt))
        w = hi - lo
        err_dec = max(max_abs_err(pt_k[:, :, :w], pt_p[:, :, lo:hi]),
                      max_abs_err(pt_k[:, :, w:], pt_p[:, :, m + lo : m + hi]),
                      max_abs_err(ok[:w], ok_p[lo:hi]), max_abs_err(ok[w:], ok_p[m + lo : m + hi]))
        err_lad = max(max_abs_err(verdict, want_all[lo:hi]),
                      max_abs_err(torch.stack(ed.point_freeze(acc)), acc_p[:, :, lo:hi]))
        errs = {"sha512": err_sha, "decompress": err_dec, "ladder": err_lad}
        check(all(e == 0 for e in errs.values()),
              f"blocksync batch of {n}: a kernel != plain (max abs err {errs})")
        verdicts = (verdict.cpu().numpy() & host_oks[label])[:n]
        rejected = set(np.nonzero(~verdicts)[0].tolist())
        check(rejected == bad, f"blocksync batch of {n}: rejected lanes {sorted(rejected)[:8]}, "
              f"corrupted {sorted(bad)}")
        out[label] = {"lanes": n, "bucket": w, "corrupted": sorted(bad), "max_abs_err": errs}
    return out, operands


def bsync_window_kernels(batches, dev) -> dict:
    """The verify kernels at the blocksync path's batches: each held against
    its plain version (``bsync_compare_kernels``), then timed by CUDA events
    (20 back-to-back launches each, the batches in turns, median of 3)."""
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import ladder
    from cometbft_tpu_torch.ops import sha512_kernel as s5

    out, operands = bsync_compare_kernels(batches, dev)
    fns = {}
    for label, (msg_w, msg_nb, s_w, a_w, r_w, s_dig, k_dig, pt, ok) in operands.items():
        fns[label] = {
            "sha512": lambda m=msg_w, b=msg_nb, sw=s_w: s5.challenge_digits(m, b, sw),
            "decompress": lambda a=a_w, r=r_w: ed.decompress_words(a, r),
            "ladder": lambda sd=s_dig, kd=k_dig, p=pt, o=ok: ladder.verify_lanes(sd, kd, p, o),
        }
        out[label]["ms"] = {k: [] for k in fns[label]}
    for _ in range(3):
        for label, fn in fns.items():
            for k, f in fn.items():
                out[label]["ms"][k].append(time_cuda(f, 20))
    for rec in out.values():
        rec["ms"] = {k: statistics.median(v) for k, v in rec["ms"].items()}
    return out


def bsync_sources(fixtures, torch_backend) -> dict:
    """The blocksync phase's two source chains (``bsync_source``), the
    10,240-validator one of BSYNC_HEIGHTS and the BSYNC_SMALL-validator one
    of BSYNC_SMALL_HEIGHTS, their validators signing in a pool of
    SIGN_PROCESSES processes; the light phase goes on with them."""
    from cometbft_tpu_torch.sidecar import backend as be

    _, seeds, pubs, *_ = fixtures
    t0 = time.perf_counter()
    be.set_backend(torch_backend)  # the source verifies each LastCommit it applies
    try:
        pool = sign_pool()
        big = bsync_source(seeds, pubs, BSYNC_HEIGHTS, BSYNC_TXS, pool)
        small = bsync_source(seeds[:BSYNC_SMALL], pubs[:BSYNC_SMALL], BSYNC_SMALL_HEIGHTS,
                             BSYNC_TXS, pool)
    finally:
        be.set_backend(None)
    fixtures_s = time.perf_counter() - t0
    print(f"blocksync fixtures: {len(pubs)} validators x {BSYNC_HEIGHTS} heights and "
          f"{BSYNC_SMALL} x {BSYNC_SMALL_HEIGHTS}, {BSYNC_TXS} transactions of {BSYNC_TX_BYTES} B a "
          f"block, blocks of {len(big['blocks'][-1])} / {len(small['blocks'][-1])} bytes in "
          f"{big['parts'][-1]} / {small['parts'][-1]} parts, built in {fixtures_s:.1f} s",
          flush=True)
    return {"10k": big, "150": small, "fixtures_s": fixtures_s}


def drive_blocksync_path(sources, torch_backend, dev, with_default: bool = False) -> dict:
    """The blocksync phase (module docstring, step 16) over the sources of
    ``bsync_sources``: returns its launches, gates, stage splits, timings
    (under the process default too ``with_default``, ``--blocksync``) and
    the window's kernel times."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    fallbacks = ed25519.scalar_fallbacks
    big, small, fixtures_s = sources["10k"], sources["150"], sources["fixtures_s"]

    # The counted runs: launch counts zeroed, pipeline off, the part sets'
    # proofs on the card (CMTPU_DEVICE_PROOFS=1: the sha256 levels entry).
    stamp("blocksync: the counted runs")
    ed25519._verified.clear()
    _build.reset_launches()
    gates = {}
    with environ(CMTPU_DEVICE_PROOFS="1"):
        for name, source in (("10k", big), ("150", small)):
            ed25519._verified.clear()
            stages = BsyncStages()
            gates[name] = bsync_gates(source, torch_backend, stages)
            gates[name]["stages"] = bsync_stage_table(stages)
    device_parts = sum(1 for p in big["parts"][:-1] if p >= 32) + sum(
        1 for p in small["parts"][:-1] if p >= 32)
    # One sha512 / decompress / ladder set a backend call, two sha256 launches
    # a part set of 32 parts or more.
    launches = expect_launches(sum(len(g["calls"]) for g in gates.values()), device_parts, 0)

    # The bad peer: p1 serves the 150-validator chain with one flipped
    # signature bit in the LastCommit of the block at BSYNC_BAD_HEIGHT; p2 the
    # honest chain.
    stamp("blocksync: the bad peer")
    ed25519._verified.clear()
    bad = bsync_run(small, torch_backend, pipeline=True,
                    corrupt={BSYNC_BAD_HEIGHT: bsync_flipped(small, BSYNC_BAD_HEIGHT)})
    bsync_same_chain(small, bad, BSYNC_SMALL_HEIGHTS - 1)
    check(bad["stops"] == ["p1"], f"stopped peers {bad['stops']}, expected p1 once")
    check((bad["prefetch_errors"], bad["sync_errors"]) == (0, 1),
          f"bad peer: prefetch_errors {bad['prefetch_errors']}, sync_errors {bad['sync_errors']}")
    check("wrong signature (#0)" in bad["last_sync_error"], f"bad peer: {bad['last_sync_error']}")

    # Timed: the default (pipeline on, the native proofs pass), BSYNC_REPS
    # rounds under TorchBackend() (and the process default, in turns, with
    # ``with_default``); the pipeline off is the counted runs' above (staged
    # and with the card's proofs: torch_pipeline_off_staged).
    stamp("blocksync: the timed runs")
    auto = None
    if with_default:
        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                     CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            auto = be._make_backend()
    runs = {name: {"torch": [], "auto": []} for name in ("10k", "150")}
    for name in runs:
        runs[name]["torch_pipeline_off_staged"] = [gates[name]["run"]["ms_per_block"]]
    overlap = {name: [] for name in runs}

    def timed(name, source, backend, pipeline):
        ed25519._verified.clear()
        r = bsync_run(source, backend, pipeline=pipeline)
        bsync_same_chain(source, r, len(source["blocks"]) - 1)
        check((r["prefetch_errors"], r["sync_errors"], r["stops"]) == (0, 0, []),
              f"{name}: errors {r['last_prefetch_error']} {r['last_sync_error']} {r['stops']}")
        return r

    try:
        for rep in range(BSYNC_REPS):
            tiers = [("torch", torch_backend)] + ([("auto", auto)] if auto else [])
            for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
                for name, source in (("10k", big), ("150", small)):
                    r = timed(name, source, backend, True)
                    runs[name][tier].append(r["ms_per_block"])
                    if tier == "torch":
                        overlap[name].append(r["pipeline_overlap_ms"])
    finally:
        if auto is not None:
            auto.close()
    check(ed25519.scalar_fallbacks == fallbacks, "a verification took the ChainExhausted fallback")

    # The verify kernels at the batches the path gave them (both windows,
    # one commit, both light checks), each held against its plain version
    # with corrupted lanes, then timed in turns.
    stamp("blocksync: the kernels at the path's batches")
    window_kernels = bsync_window_kernels(bsync_batches(big, small), dev)
    return {
        "fixtures_s": fixtures_s, "launches": launches,
        "blocks_bytes": {"10k": len(big["blocks"][-1]), "150": len(small["blocks"][-1])},
        "parts": {"10k": big["parts"], "150": small["parts"]},
        "gates": {name: {k: v for k, v in g.items() if k not in ("run", "stages")}
                  for name, g in gates.items()},
        "stages": {name: g["stages"] for name, g in gates.items()},
        "bad_peer": {k: v for k, v in bad.items() if k not in ("node", "state")},
        "ms_per_block_runs": runs,
        "ms_per_block": {name: {tier: statistics.median(v) for tier, v in r.items() if v}
                         for name, r in runs.items()},
        "pipeline_overlap_ms": overlap,
        "window_kernels": window_kernels,
    }


# -- the light path ---------------------------------------------------------------

LIGHT_CHAIN_ID = "chip-smoke-light"
LIGHT_T0 = 1_700_000_000
LIGHT_POWER = 10
# The 10,240-validator chain: height 1's set is the commit phase's keys; each
# next height drops the first LIGHT_ROTATE of the set's keys (20%) and takes
# as many fresh ones. A client trusting height 1 verifies height 9 with trust
# level 1/3: over 1/3 of a set survives two heights, not four, so the walk is
# 1 -> 9 and 1 -> 5 refused, 1 -> 3, 3 -> 5, 5 -> 9 refused, 5 -> 7, 7 -> 9
# (light_walk), and only heights 1, 3, 5, 7 and 9 need signed commits.
LIGHT_HEIGHTS = 9
LIGHT_ROTATE = 2_048
LIGHT_SIGNED = (1, 3, 5, 7, 9)
# The 150-validator chain (a typical set, as blocksync's): 15 keys (10%)
# rotate a height over LIGHT_SMALL_HEIGHTS heights, every height signed.
LIGHT_SMALL = COMMIT_SMALL
LIGHT_SMALL_HEIGHTS = 60  # 100 until the network phase came (the run near 1,000 s)
LIGHT_SMALL_ROTATE = 15
LIGHT_SEQ_TO = 20  # a sequential client verifies 1 -> 20
LIGHT_BACK = (50, 40)  # a client trusting height 50 verifies height 40 backwards
LIGHT_SWARM = 64  # clients at once through one gateway: the default CMTPU_LIGHTGW_SESSIONS
LIGHT_REPS = 1  # timed rounds (3 until the consensus phase came; one keeps the run near 750 s)
LIGHT_NOW_S = LIGHT_T0 + 3_600
LIGHT_DUP_HEIGHT = 10  # the duplicate votes' height on the 150-validator blocksync chain
LIGHT_SIGN_CHUNK = 512


class LightWire:
    """A provider of light blocks from their wire bytes, as a node's RPC
    hands them over: each fetch decodes a fresh LightBlock (timed as the
    stage ``fetch_decode`` when ``stages`` is given), and the fetched heights
    are kept. A height it does not hold raises ErrLightBlockNotFound. Its
    ``header_hash`` and ``base_height`` are a node's block store's, for a
    gateway over it."""

    def __init__(self, chain_id: str, encoded: dict, stages=None):
        self._chain_id = chain_id
        self.encoded = encoded
        self.stages = stages
        self.fetched: list[int] = []
        self.evidences: list = []

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int):
        from cometbft_tpu_torch.light.provider import ErrLightBlockNotFound
        from cometbft_tpu_torch.types import LightBlock

        h = height or max(self.encoded)
        self.fetched.append(h)
        raw = self.encoded.get(h)
        if raw is None:
            raise ErrLightBlockNotFound(f"no light block at height {h}")
        if self.stages is None:
            return LightBlock.decode(raw)
        with self.stages.stage("fetch_decode"):
            return LightBlock.decode(raw)

    def report_evidence(self, ev) -> None:
        self.evidences.append(ev)

    def base_height(self) -> int:
        return min(self.encoded)

    def header_hash(self, height: int) -> bytes | None:
        """The header's hash from its bytes alone, as a node's block store
        gives it (``BlockStoreProvider.header_hash``): the MMR's catch-up
        decodes no commit and no validator set."""
        from cometbft_tpu_torch.types import Header
        from cometbft_tpu_torch.wire import proto as wire

        raw = self.encoded.get(height)
        if raw is None:
            return None
        signed_header = wire.get_bytes(wire.decode_fields(raw), 1)
        return Header.decode(wire.get_bytes(wire.decode_fields(signed_header), 1)).hash()


@contextlib.contextmanager
def counting_launches():
    """While open, counts each kernel launch by (kernel, the launching
    thread's name) in the Counter it yields."""
    from cometbft_tpu_torch.ops import _build

    counts = collections.Counter()
    orig = _build.check_launch

    def check_launch(kernel, rc):
        counts[(kernel, threading.current_thread().name)] += 1
        return orig(kernel, rc)

    _build.check_launch = check_launch
    try:
        yield counts
    finally:
        _build.check_launch = orig


class LightRecorder:
    """A backend that records each call it is asked to verify: the caller's
    engine class (``light``: a descent's or the gateway's prewarm), its
    lanes and wall ms (ended by a synchronize); with ``keep``, its triples
    too (the kernel comparisons run on them). Everything else goes to the
    backend it wraps."""

    def __init__(self, inner, keep: bool = False):
        self.inner = inner
        self.keep = keep
        self.calls: list = []
        self.triples: list = []

    def batch_verify(self, pubs, msgs, sigs):
        from cometbft_tpu_torch.sidecar import engine

        klass = engine.CLASS_NAMES[engine.current_class()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.batch_verify(pubs, msgs, sigs)
        torch.cuda.synchronize()
        self.calls.append({"class": klass, "lanes": len(pubs),
                           "ms": (time.perf_counter() - t0) * 1e3})
        if self.keep:
            self.triples.append((list(pubs), list(msgs), list(sigs)))
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def lanes(self, klass=None) -> list:
        return [c["lanes"] for c in self.calls if klass is None or c["class"] == klass]


class StageTimer:
    """Lists the wall ms of named stages: ``stage(name)`` times a block,
    ``wrap(owner, attr, name)`` a method of a class or an object for one
    run (``with``; ``name`` may be a function of the call's positional
    arguments). A stage ends with a synchronize unless ``sync=False`` (it
    surrounds no device work); with ``count_bytes`` the lengths of its
    results are summed too. Stages nest as the calls do, each inclusive of
    the stages it calls."""

    def __init__(self):
        self.ms = collections.defaultdict(list)
        self.bytes = collections.Counter()
        self._saved = []

    @contextlib.contextmanager
    def stage(self, name, sync: bool = True):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                torch.cuda.synchronize()
            self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def wrap(self, owner, attr, name, sync: bool = True, count_bytes: bool = False):
        orig = getattr(owner, attr)
        stages = self

        def wrapper(*args, **kwargs):
            label = name(*args) if callable(name) else name
            with stages.stage(label, sync):
                out = orig(*args, **kwargs)
            if count_bytes:
                stages.bytes[label] += len(out)
            return out

        self._saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved.clear()

    def table(self) -> dict:
        return {k: {"ms": sum(v), "calls": len(v),
                    **({"bytes": self.bytes[k]} if k in self.bytes else {})}
                for k, v in sorted(self.ms.items())}


class LightStages(StageTimer):
    """Times a light sync's stages, each ended by a synchronize: the
    provider's fetch and decode (LightWire), ``LightBlock.validate_basic``,
    ``ValidatorSet.hash``, the descent's prewarm (``_speculate_descent``) and
    inside it ``speculative_verify_triples`` and the backend call
    (``BatchVerifier.verify`` of light class; ``bv.add`` is the rest), each
    hop's trusting and light checks on the cache (with ``BatchVerifier.verify``
    outside a prewarm: the cache filter), the store's save and the
    detector. Stages nest as the calls do. Installed on the port's classes
    for one run (``with``)."""

    def __enter__(self):
        from cometbft_tpu_torch.crypto import ed25519
        from cometbft_tpu_torch.light import client, detector
        from cometbft_tpu_torch.light.store import LightStore
        from cometbft_tpu_torch.sidecar import engine
        from cometbft_tpu_torch.types import LightBlock, ValidatorSet, validation

        self.wrap(LightBlock, "validate_basic", "validate_basic")
        self.wrap(ValidatorSet, "hash", "validator_set_hash")
        self.wrap(client.Client, "_speculate_descent", "prewarm")
        self.wrap(validation, "speculative_verify_triples", "prewarm_triples")
        self.wrap(ed25519.BatchVerifier, "verify", lambda bv: (
            "prewarm_backend" if engine.current_class() == engine.CLASS_LIGHT
            else "hop_cache_filter"))
        self.wrap(validation, "verify_commit_light_trusting", "hop_trusting_check")
        self.wrap(validation, "verify_commit_light", "hop_light_check")
        self.wrap(LightStore, "save_light_block", "store_save")
        self.wrap(detector, "detect_divergence", "detector")
        return self

    def table(self) -> dict:
        out = super().table()
        pre = out.get("prewarm", {}).get("ms", 0.0)
        out["prewarm_bv_add"] = {"ms": pre - out.get("prewarm_triples", {}).get("ms", 0.0)
                                 - out.get("prewarm_backend", {}).get("ms", 0.0),
                                 "calls": out.get("prewarm", {}).get("calls", 0)}
        return out


def light_keys(seeds, pubs, pool) -> dict:
    """Each light chain's keys by height, (seed, pub) pairs: height 1's are
    the first n of the commit phase's; each next height drops the first
    `rotate` and appends `rotate` fresh keys (seeds from fixed tags, public
    keys derived in the pool)."""
    plans = {"10k": (N_SIGS, LIGHT_ROTATE, LIGHT_HEIGHTS),
             "150": (LIGHT_SMALL, LIGHT_SMALL_ROTATE, LIGHT_SMALL_HEIGHTS)}
    fresh = {name: [hashlib.sha256(b"chip-smoke-light-%s-%d-%d" % (name.encode(), SEED, i)).digest()
                    for i in range(rot * (heights - 1))]
             for name, (_, rot, heights) in plans.items()}
    every = [s for name in plans for s in fresh[name]]
    chunks = [[("pub", s) for s in every[i : i + LIGHT_SIGN_CHUNK]]
              for i in range(0, len(every), LIGHT_SIGN_CHUNK)]
    derived = dict(zip(every, (p for c in pool.map(sign_jobs, chunks, chunksize=1) for p in c)))
    out = {}
    for name, (n, rot, heights) in plans.items():
        keys = [list(zip(seeds[:n], pubs[:n]))]
        for h in range(1, heights):
            new = fresh[name][(h - 1) * rot : h * rot]
            keys.append(keys[-1][rot:] + [(s, derived[s]) for s in new])
        out[name] = keys
    return out


def light_headers(key_lists):
    """A light chain's validator sets and headers: height h's set is
    key_lists[h - 1] at equal power; its header names the next height's
    set (the last height its own) and the previous header's BlockID."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.types import BlockID, Consensus, Header, PartSetHeader, Time, Validator
    from cometbft_tpu_torch.types import ValidatorSet

    sets = [ValidatorSet([Validator.new(ed25519.PubKey(p), LIGHT_POWER) for _, p in keys])
            for keys in key_lists]
    headers, last = [], BlockID()
    for h, vset in enumerate(sets, 1):
        nxt = sets[h] if h < len(sets) else vset
        header = Header(version=Consensus(11, 1), chain_id=LIGHT_CHAIN_ID, height=h,
                        time=Time(LIGHT_T0 + 6 * h, 0), last_block_id=last,
                        validators_hash=vset.hash(), next_validators_hash=nxt.hash(),
                        app_hash=hashlib.sha256(b"light-app-%d" % h).digest(),
                        proposer_address=vset.get_proposer().address)
        headers.append(header)
        last = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
    return sets, headers


def light_unsigned(header, vset, bid=None):
    """The commit of header (under ``bid``, by default one naming a single
    part) that every validator of vset signs (canonical precommits, seconds
    equal, nanos differing), signatures empty."""
    from cometbft_tpu_torch.types import (BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig,
                                          PartSetHeader, Time)

    if bid is None:
        bid = BlockID(header.hash(), PartSetHeader(1, hashlib.sha256(header.hash()).digest()))
    return Commit(height=header.height, round=0, block_id=bid, signatures=[
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, Time(header.time.seconds + 1, 1_000 + 977 * i),
                  b"") for i, v in enumerate(vset.validators)])


def sign_commits(plan, secret, pool) -> dict:
    """plan: (key, chain id, unsigned commit) entries; every commit's
    validators sign their canonical precommits in the pool. Returns key ->
    the signed Commit."""
    from cometbft_tpu_torch.types import Commit, CommitSig

    jobs, start = [], {}
    for key, chain_id, commit in plan:
        start[key] = len(jobs)
        jobs += [("ed25519", *secret[cs.validator_address], m)
                 for cs, m in zip(commit.signatures, commit.vote_sign_bytes_all(chain_id))]
    chunks = [jobs[i : i + LIGHT_SIGN_CHUNK] for i in range(0, len(jobs), LIGHT_SIGN_CHUNK)]
    sigs = [s for c in pool.map(sign_jobs, chunks, chunksize=1) for s in c]
    out = {}
    for key, _, commit in plan:
        k = start[key]
        out[key] = Commit(height=commit.height, round=commit.round, block_id=commit.block_id,
                          signatures=[CommitSig(cs.block_id_flag, cs.validator_address,
                                                cs.timestamp, sigs[k + i])
                                      for i, cs in enumerate(commit.signatures)])
    return out


def forged_tip(source, height: int):
    """The source's header at height with another app hash, and the commit
    its validators sign for it (unsigned): a light-client attack's
    conflicting block, before signing."""
    import dataclasses

    meta = source["node"]["block_store"].load_block_meta(height)
    vals = source["node"]["state_store"].load_validators(height)
    header = dataclasses.replace(meta.header, app_hash=b"\xee" * 32)
    return header, vals, light_unsigned(header, vals)


def light_fixtures(fixtures, sources, pool) -> dict:
    """The light phase's chains as wire bytes: the 10,240-validator chain's
    signed heights (LIGHT_SIGNED) and the 150-validator chain's 100, their
    validator sets; the conflicting tips of the two blocksync sources (the
    150-validator chain's last height for the attack, the 10,240-validator
    chain's for the evidence check) signed by the same validators."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.types import LightBlock, SignedHeader

    _, seeds, pubs, *_ = fixtures
    t0 = time.perf_counter()
    keys = light_keys(seeds, pubs, pool)
    keys_s = time.perf_counter() - t0
    secret = {ed25519.PubKey(p).address(): (s, p)
              for ks in keys.values() for hk in ks for s, p in hk}
    chains, plan = {}, []
    for name, signed in (("10k", LIGHT_SIGNED), ("150", range(1, LIGHT_SMALL_HEIGHTS + 1))):
        sets, headers = light_headers(keys[name])
        chains[name] = {"sets": sets, "headers": headers, "signed": tuple(signed)}
        plan += [((name, h), LIGHT_CHAIN_ID, light_unsigned(headers[h - 1], sets[h - 1]))
                 for h in signed]
    tips = {}
    for name, source in (("attack", sources["150"]), ("evidence", sources["10k"])):
        tip_h = len(source["blocks"])
        header, vals, unsigned = forged_tip(source, tip_h)
        tips[name] = (header, vals)
        plan.append(((name, tip_h), BSYNC_CHAIN_ID, unsigned))
    t1 = time.perf_counter()
    signed = sign_commits(plan, secret, pool)
    sign_s = time.perf_counter() - t1
    out = {"keys_s": keys_s, "sign_s": sign_s, "signatures": sum(
        len(c.signatures) for c in signed.values()), "secret": secret}
    for name, ch in chains.items():
        ch["encoded"] = {h: LightBlock(SignedHeader(ch["headers"][h - 1], signed[(name, h)]),
                                       ch["sets"][h - 1]).encode() for h in ch["signed"]}
        out[name] = ch
    for name, (header, vals) in tips.items():
        key = next(k for k in signed if k[0] == name)
        out[name] = LightBlock(SignedHeader(header, signed[key]), vals).encode()
    return out


def light_walk(sets, trusted: int, target: int) -> dict:
    """The skipping walk's arithmetic over equal-power sets (the client's
    _verify_skipping and _speculate_descent, by sets and counts): a
    non-adjacent hop is trusted when at least k_t = floor(total / 3) / power
    + 1 of the lower set signed the upper commit; its light check needs the
    first k = floor(2 total / 3) / power + 1 signatures in commit order and
    its trusting check the first k_t signers of the lower set; a refused hop
    fetches the midpoint and prewarms the optimistic chain's union, of which
    only what the cache lacks goes out. Returns the pivots fetched, the
    trace, the descents and the lanes of each backend call, in order, as
    (class, lanes)."""
    addr = [[v.address for v in s.validators] for s in sets]
    members = [set(a) for a in addr]

    def k_light(h):
        return (len(addr[h - 1]) * LIGHT_POWER * 2 // 3) // LIGHT_POWER + 1

    def k_trust(h):
        return (len(addr[h - 1]) * LIGHT_POWER // 3) // LIGHT_POWER + 1

    def signers_of(lower, upper):
        return [i for i, a in enumerate(addr[upper - 1]) if a in members[lower - 1]]

    def trusted_ok(lower, upper):
        return upper == lower + 1 or len(signers_of(lower, upper)) >= k_trust(lower)

    def light_part(upper):
        return {(upper, i) for i in range(k_light(upper))}

    def trust_part(lower, upper):
        return {(upper, i) for i in signers_of(lower, upper)[: k_trust(lower)]}

    def hop(lower, upper):
        if upper == lower + 1:
            return light_part(upper)
        return light_part(upper) | trust_part(lower, upper)

    cache, fetched, trace, calls, descents = set(), [], [], [], 0
    current, stack = trusted, [target]
    while stack:
        cand = stack[-1]
        if trusted_ok(current, cand):
            checks = [light_part(cand)] if cand == current + 1 else [
                trust_part(current, cand), light_part(cand)]
            for part in checks:
                if part - cache:
                    calls.append(("blocksync", len(part - cache)))
                cache |= part
            current = cand
            stack.pop()
            trace.append(cand)
            continue
        pivot = (current + cand) // 2
        check(pivot not in (current, cand), f"the walk cannot bisect {current} -> {cand}")
        fetched.append(pivot)
        stack.append(pivot)
        union, lower = set(), current
        for upper in reversed(stack):
            union |= hop(lower, upper)
            lower = upper
        if union:
            descents += 1
            if union - cache:
                calls.append(("light", len(union - cache)))
            cache |= union
    return {"fetched": fetched, "trace": trace, "descents": descents, "calls": calls}


def light_client(chain, provider, trust_height=1, witnesses=(), **kw):
    """The port's Client over ``provider``, trusting the chain's height
    ``trust_height``, a fresh MemDB store, the trusting period of the commit
    phase."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.types import LightBlock

    anchor = LightBlock.decode(chain["encoded"][trust_height])
    return Client(LIGHT_CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, trust_height, anchor.hash()),
                  provider, list(witnesses), LightStore(MemDB()), **kw)


def light_sync(chain, backend, target, trust_height=1, witness=False, stages=None, **kw):
    """One client's sync of ``chain`` to ``target`` under
    ``set_backend(backend)`` from an empty verified-triple cache, timed
    (the verify call alone, ended by a synchronize). Returns the client, its
    providers, the wall ms and the trace (stored heights and hashes)."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Time

    primary = LightWire(LIGHT_CHAIN_ID, chain["encoded"], stages)
    witnesses = [LightWire(LIGHT_CHAIN_ID, chain["encoded"], stages)] if witness else []
    be.set_backend(backend)
    try:
        client = light_client(chain, primary, trust_height, witnesses, **kw)
        ed25519._verified.clear()
        primary.fetched.clear()
        ctx = stages if stages is not None else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lb = client.verify_light_block_at_height(target, Time(LIGHT_NOW_S, 0))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    check(lb.height == target, f"synced to {lb.height}, not {target}")
    trace = [(h, client.store.light_block(h).hash().hex()) for h in client.store._heights()]
    return {"client": client, "primary": primary, "witnesses": witnesses, "ms": wall,
            "trace": trace}


def light_counts_clean(client, what: str) -> None:
    check(client.speculation["errors"] == 0 and client.detector_errors == 0,
          f"{what}: speculation errors {client.speculation['errors']} "
          f"({client.last_speculation_error!r}), detector errors {client.detector_errors} "
          f"({client.last_detector_error!r})")


def light_gates(lf, torch_backend) -> dict:
    """The counted clients under a LightRecorder around ``TorchBackend()``:
    the 10,240-validator sync with an honest witness, the 150-validator
    skipping, sequential and backwards clients. Each trace equals the host
    path's (the same client under ``CpuBackend()``, the native batch
    verifier) and the walk's arithmetic; each backend call is the
    arithmetic's, by class and lanes, so that every hop check after a
    prewarm sent no lane; no error counted."""
    from cometbft_tpu_torch.sidecar.backend import CpuBackend

    host = CpuBackend()
    out, recorders = {}, {}
    cases = {
        "10k": (lf["10k"], LIGHT_HEIGHTS, 1, True, {}),
        "150": (lf["150"], LIGHT_SMALL_HEIGHTS, 1, False, {}),
        "150_sequential": (lf["150"], LIGHT_SEQ_TO, 1, False, {"skip_verification": "sequential"}),
        "150_backwards": (lf["150"], LIGHT_BACK[1], LIGHT_BACK[0], False, {}),
    }
    for name, (chain, target, trust_h, witness, kw) in cases.items():
        rec = LightRecorder(torch_backend, keep=True)
        run = light_sync(chain, rec, target, trust_h, witness, **kw)
        on_host = light_sync(chain, host, target, trust_h, witness, **kw)
        check(run["trace"] == on_host["trace"], f"{name}: the card's trace differs from the host's")
        c = run["client"]
        light_counts_clean(c, name)
        got = [(k["class"], k["lanes"]) for k in rec.calls]
        if kw.get("skip_verification") == "sequential":
            want = {"fetched": [target] + list(range(trust_h + 1, target)),
                    "trace": list(range(trust_h + 1, target + 1)), "descents": 0,
                    "calls": [("blocksync", LIGHT_SMALL * 2 // 3 + 1)] * (target - trust_h)}
        elif target < trust_h:
            want = {"fetched": [target] + list(range(trust_h - 1, target, -1)),
                    "trace": [target], "descents": 0, "calls": []}
        else:
            want = light_walk(chain["sets"], trust_h, target)
            want["fetched"] = [target] + want["fetched"]
        stored = [h for h, _ in run["trace"]]
        check(stored == sorted({trust_h, *want["trace"]}),
              f"{name}: stored heights {stored}, the arithmetic gives {want['trace']}")
        check(run["primary"].fetched == want["fetched"],
              f"{name}: fetched {run['primary'].fetched}, the arithmetic gives {want['fetched']}")
        check(got == want["calls"], f"{name}: backend calls {got}, the arithmetic gives "
              f"{want['calls']}")
        check(c.speculation["descents"] == want["descents"],
              f"{name}: {c.speculation['descents']} descents, the arithmetic gives "
              f"{want['descents']}")
        first_prewarm = next((i for i, k in enumerate(got) if k[0] == "light"), len(got))
        check(all(k[0] == "light" for k in got[first_prewarm:]),
              f"{name}: a hop check sent lanes after the first prewarm: {got}")
        if witness:
            check(run["witnesses"][0].fetched == [target] and c.witnesses,
                  f"{name}: the witness was asked for {run['witnesses'][0].fetched}")
        recorders[name] = rec
        out[name] = {"trace_heights": stored, "fetched": run["primary"].fetched, "calls": got,
                     "speculation": dict(c.speculation), "ms": run["ms"], "host_ms": on_host["ms"]}
    check(lf["10k"]["signed"] == tuple(sorted({1, *out["10k"]["fetched"]})),
          f"the 10k client fetched {out['10k']['fetched']}, not exactly the signed heights")
    return out, recorders


def light_swarm(lf, torch_backend, proofs: bool) -> dict:
    """LIGHT_SWARM clients on threads cold-sync the 150-validator chain from
    height 1 to the tip at once through one LightGateway, each client over
    its own provider of the chain's wire bytes, under the port's
    CoalescingScheduler around a LightRecorder around ``TorchBackend()``,
    from an empty cache. Every kernel launch of the run is recorded with
    its thread. Returns the wall ms, the traces, the gateway's stats and
    the scheduler's counters."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.light.gateway import LightGateway
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar.scheduler import CoalescingScheduler
    from cometbft_tpu_torch.types import Time

    chain = lf["150"]
    rec = LightRecorder(torch_backend)
    sched = CoalescingScheduler(rec)
    gw = LightGateway(LIGHT_CHAIN_ID, LightWire(LIGHT_CHAIN_ID, chain["encoded"]))
    clients = [light_client(chain, LightWire(LIGHT_CHAIN_ID, chain["encoded"]), 1, [],
                            gateway=gw, gateway_proofs=proofs) for _ in range(LIGHT_SWARM)]
    results = [None] * LIGHT_SWARM
    barrier = threading.Barrier(LIGHT_SWARM + 1)
    threads_seen = collections.Counter()
    orig_check = _build.check_launch

    def check_launch(kernel, rc):
        threads_seen[threading.current_thread().name] += 1
        return orig_check(kernel, rc)

    def sync(i):
        try:
            barrier.wait(timeout=60)
            lb = clients[i].verify_light_block_at_height(LIGHT_SMALL_HEIGHTS, Time(LIGHT_NOW_S, 0))
            results[i] = ("ok", lb.hash().hex())
        except Exception as e:  # noqa: BLE001 - reported by the gate below
            results[i] = ("error", repr(e))

    ed25519._verified.clear()
    be.set_backend(sched)
    _build.check_launch = check_launch
    threads = [threading.Thread(target=sync, args=(i,), name=f"light-{i}")
               for i in range(LIGHT_SWARM)]
    try:
        for t in threads:
            t.start()
        barrier.wait(timeout=60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        _build.check_launch = orig_check
        be.set_backend(None)
        sched.close()
    check(all(r is not None and r[0] == "ok" for r in results),
          f"swarm: {[r for r in results if r is None or r[0] != 'ok'][:3]}")
    traces = {tuple((h, c.store.light_block(h).hash().hex()) for h in c.store._heights())
              for c in clients}
    for c in clients:
        light_counts_clean(c, "swarm")
    check(len(traces) == 1, f"swarm: {len(traces)} different traces")
    st = gw.stats()
    check(st["speculate_errors"] == 0 and gw.header_errors == 0,
          f"swarm: gateway prewarm errors {st['speculate_errors']} ({gw.last_speculate_error!r})")
    check(st["plan_misses"] == 1 and st["plan_hits"] + st["plan_waits"] == LIGHT_SWARM - 1,
          f"swarm: plans {st['plan_misses']} computed, {st['plan_hits']} hits, "
          f"{st['plan_waits']} waits")
    check(set(threads_seen) <= {"cmtpu-torch-dev"},
          f"swarm: kernels launched from {dict(threads_seen)}, not the one device-owner thread")
    stats = [dict(c.gateway_stats) for c in clients]
    want = ({"plan_syncs": 1, "proof_rejects": 1, "fallbacks": 0} if proofs
            else {"plan_syncs": 1, "proof_rejects": 0, "fallbacks": 0})
    check(all({k: s[k] for k in want} == want for s in stats),
          f"swarm: client stats {stats[0]}, expected {want}")
    return {"ms": wall, "trace": sorted(traces)[0], "gateway": st, "lanes": rec.lanes(),
            "lanes_total": sum(rec.lanes()), "scheduler": sched.counters(),
            "engine_classes": sched.engine.class_counters_, "client_stats": stats[0],
            "launch_threads": dict(threads_seen)}


def light_attack(sources, lf, torch_backend, signers) -> dict:
    """An attack, end to end, on the 150-validator blocksync source: a
    client trusting its height 1 through BlockStoreProvider (reporting to
    an EvidencePool over the source's stores) verifies the tip; a witness
    serves the source's chain but a conflicting tip signed by the same
    validators. Exactly one ErrLightClientAttack; the evidence is pending;
    the source's executor proposes the next height with it (its commit
    signed by the validators), saves and applies the block, and the pool
    marks the evidence committed; the stored block carries it."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.detector import ErrLightClientAttack
    from cometbft_tpu_torch.light.provider import BlockStoreProvider
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import BlockID, LightBlock
    from cometbft_tpu_torch.types.evidence import encode_evidence

    source = sources["150"]
    node, state = source["node"], source["state"]
    tip = len(source["blocks"])
    pool = EvidencePool(MemDB(), node["state_store"], node["block_store"])

    class Primary(BlockStoreProvider):
        def report_evidence(self, ev):
            pool.add_evidence(ev)

    primary = Primary(BSYNC_CHAIN_ID, node["block_store"], node["state_store"])
    forged = LightBlock.decode(lf["attack"])

    class Witness:
        def __init__(self):
            self.evidences = []

        def chain_id(self):
            return BSYNC_CHAIN_ID

        def light_block(self, height):
            return forged if height == tip else primary.light_block(height)

        def report_evidence(self, ev):
            self.evidences.append(ev)

    witness = Witness()
    rec = LightRecorder(torch_backend)
    ed25519._verified.clear()
    be.set_backend(rec)
    try:
        client = Client(BSYNC_CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, 1,
                                                     primary.light_block(1).hash()),
                        primary, [witness], LightStore(MemDB()))
        now = state.last_block_time.add_nanos(60 * 10**9)
        err = raises(ErrLightClientAttack, lambda: client.verify_light_block_at_height(tip, now))
        light_counts_clean(client, "attack")
        pending, _ = pool.pending_evidence(-1)
        check(len(pending) == 1
          and pending[0].conflicting_block.signed_header.header.hash() == forged.hash(),
              f"attack: {len(pending)} pending evidence")
        check(len(witness.evidences) == 1, "attack: the witness got no evidence of the primary")
        ev_bytes = encode_evidence(pending[0])
        ex = node["executor"]
        ex.evpool = pool
        last_commit = node["block_store"].load_seen_commit(tip)
        block = ex.create_proposal_block(tip + 1, state, last_commit,
                                         state.validators.get_proposer().address)
        check([encode_evidence(e) for e in block.evidence] == [ev_bytes],
              "attack: the proposal does not carry the evidence")
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        commit = sign_commits([("next", BSYNC_CHAIN_ID, light_unsigned(
            block.header, state.validators, bid))], lf["secret"], signers)["next"]
        node["block_store"].save_block(block, parts, commit)
        new_state, _ = ex.apply_block(state, bid, block)
    finally:
        be.set_backend(None)
    stored = node["block_store"].load_block(tip + 1)
    check([encode_evidence(e) for e in stored.evidence] == [ev_bytes],
          "attack: the stored block does not carry the evidence")
    check(pool._is_committed(pending[0]) and pool.pending_count() == 0,
          f"attack: the evidence is not committed ({pool.stats_snapshot()})")
    source["state"] = new_state
    return {"error": str(err), "evidence_bytes": len(ev_bytes), "block_height": tip + 1,
            "pool": pool.stats_snapshot(), "calls": [(k["class"], k["lanes"]) for k in rec.calls],
            "byzantine": len(pending[0].byzantine_validators)}


def light_evidence_10k(sources, lf, backend) -> dict:
    """The 10,240-validator blocksync source's tip, conflicting, signed by
    its validators, as LightClientAttackEvidence against height 1
    (``make_attack_evidence``: every signer byzantine): ``add_evidence`` of
    a fresh pool over the source's stores, from objects decoded anew and an
    empty cache, under ``set_backend(backend)``. Returns the wall ms, the
    backend's calls and the evidence's bytes."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.detector import make_attack_evidence
    from cometbft_tpu_torch.light.provider import BlockStoreProvider
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import LightBlock
    from cometbft_tpu_torch.types.evidence import decode_evidence, encode_evidence

    node = sources["10k"]["node"]
    common = BlockStoreProvider(BSYNC_CHAIN_ID, node["block_store"],
                                node["state_store"]).light_block(1)
    raw = encode_evidence(make_attack_evidence(LightBlock.decode(lf["evidence"]), common))
    rec = LightRecorder(backend, keep=True)
    ev = decode_evidence(raw)
    pool = EvidencePool(MemDB(), node["state_store"], node["block_store"])
    ed25519._verified.clear()
    be.set_backend(rec)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.add_evidence(ev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    check(pool.pending_count() == 1, "the 10,240-validator attack evidence was not accepted")
    return {"ms": wall, "calls": [(k["class"], k["lanes"]) for k in rec.calls],
            "bytes": len(raw), "byzantine": len(ev.byzantine_validators), "recorder": rec}


def light_duplicate_votes(sources, lf, fixtures, torch_backend, auto) -> dict:
    """Validator 0 of the 150-validator blocksync source precommits two
    blocks at LIGHT_DUP_HEIGHT; a fresh EvidencePool over the source's
    stores verifies the DuplicateVoteEvidence through a fresh sigbatch,
    under ``TorchBackend()`` (no engine: the private window, one backend
    call) and under the process default (its CoalescingScheduler's engine,
    consensus class); a copy with one flipped signature bit is refused with
    the reference's text. Returns the counters of each path."""
    import dataclasses

    from cometbft_tpu_torch.crypto import ed25519, sigbatch
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar import engine
    from cometbft_tpu_torch.types import PRECOMMIT_TYPE, BlockID, PartSetHeader, Vote
    from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence
    from cometbft_tpu_torch.types.vote import VoteError

    node = sources["150"]["node"]
    h = LIGHT_DUP_HEIGHT
    vals = node["state_store"].load_validators(h)
    t = node["block_store"].load_block_meta(h).header.time
    val = vals.validators[0]
    seed, pub = lf["secret"][val.address]
    votes = []
    for mark in (b"\xaa", b"\xbb"):
        v = Vote(type=PRECOMMIT_TYPE, height=h, round=0,
                 block_id=BlockID(mark * 32, PartSetHeader(1, mark * 32)), timestamp=t,
                 validator_address=val.address, validator_index=0)
        votes.append(v.with_signature(sign_known(pure, fixtures[0], seed, pub,
                                                 v.sign_bytes(BSYNC_CHAIN_ID))))
    ev = DuplicateVoteEvidence.new(votes[0], votes[1], t, vals)
    sig = bytearray(ev.vote_b.signature)
    sig[9] ^= 0x04
    bad = dataclasses.replace(ev, vote_b=dataclasses.replace(ev.vote_b, signature=bytes(sig)))
    out = {}
    for name, backend in (("torch", torch_backend), ("auto", auto)):
        old = sigbatch.set_batcher(None)
        ed25519._verified.clear()
        be.set_backend(backend)
        eng = engine.engine_of(backend)
        admitted = eng.class_counters_[engine.CLASS_CONSENSUS]["admitted"] if eng else 0
        launches = dict(_build.LAUNCHES)
        try:
            EvidencePool(MemDB(), node["state_store"], node["block_store"]).add_evidence(ev)
            err = raises(VoteError, lambda: EvidencePool(
                MemDB(), node["state_store"], node["block_store"]).add_evidence(bad))
            counters = sigbatch.counters()
        finally:
            be.set_backend(None)
            sigbatch.set_batcher(old)
        check(str(err) == "invalid signature", f"duplicate vote, {name}: {err!r}")
        check(counters["fallbacks"] == 0 and counters["dispatches"] == 2,
              f"duplicate vote, {name}: sigbatch {counters}")
        sets = {k: _build.LAUNCHES[k] - launches[k] for k in ("sha512", "decompress", "ladder")}
        rec = {"sigbatch": counters, "launch_sets": sets["ladder"],
               "engine": eng is not None}
        if name == "torch":
            check(eng is None and sets == {"sha512": 2, "decompress": 2, "ladder": 2},
                  f"duplicate vote under TorchBackend(): engine {eng}, launches {sets}")
        else:
            check(eng is not None and eng.class_counters_[engine.CLASS_CONSENSUS]["admitted"]
                  == admitted + 2, "duplicate vote under the default: not through its engine")
            hybrid = be._hybrid_tier(backend.inner)
            rec["hybrid_share_of_the_last"] = hybrid.last_share
        out[name] = rec
    return out


def light_kernel_batches(gates, ev10k) -> dict:
    """The batches the light path handed the verify kernels: the largest
    descent prewarm at 10,240 validators, the largest at 150, and the
    evidence check at 10,240; each with four lanes corrupted
    (``corrupt_four``). Returns label -> (pubs, msgs, sigs, corrupted)."""
    out = {}
    for label, rec in (("10k_prewarm", gates[1]["10k"]), ("150_prewarm", gates[1]["150"]),
                       ("10k_evidence", ev10k["recorder"])):
        pubs, msgs, sigs = max(rec.triples, key=lambda t: len(t[0]))
        out[f"{label}_{len(pubs)}"] = corrupt_four(pubs, msgs, sigs)
    return out


def light_metrics(lf, sources, torch_backend, auto, with_default: bool) -> dict:
    """Medians of LIGHT_REPS cold syncs (fresh client, empty cache) under
    ``TorchBackend()`` and, ``with_default`` (``--light``), the process
    default in turns: the 10,240-validator client to height 9 and the
    150-validator client to LIGHT_SMALL_HEIGHTS; the 10,240-validator
    evidence check; then the 10,240 sync's stage split (one staged run
    under ``TorchBackend()``)."""
    runs = {k: {"torch": [], "auto": []} for k in ("10k", "150", "evidence_10k")}
    for rep in range(LIGHT_REPS):
        tiers = [("torch", torch_backend)] + ([("auto", auto)] if with_default else [])
        for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
            runs["10k"][tier].append(light_sync(lf["10k"], backend, LIGHT_HEIGHTS, witness=True)["ms"])
            runs["150"][tier].append(light_sync(lf["150"], backend, LIGHT_SMALL_HEIGHTS)["ms"])
            runs["evidence_10k"][tier].append(light_evidence_10k(sources, lf, backend)["ms"])
    stages = LightStages()
    staged = light_sync(lf["10k"], LightRecorder(torch_backend), LIGHT_HEIGHTS, witness=True,
                        stages=stages)
    return {"runs_ms": runs,
            "medians_ms": {k: {t: statistics.median(v) for t, v in r.items() if v}
                           for k, r in runs.items()},
            "stages_10k": {"wall_ms": staged["ms"], "stages": stages.table()}}


def drive_light_path(fixtures, sources, torch_backend, dev, with_default: bool) -> dict:
    """The light phase (module docstring, step 17): returns its launches,
    gates, metrics (timed under the process default too ``with_default``)
    and the kernels at the path's own batches."""
    from cometbft_tpu_torch.crypto import ed25519, sigbatch
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    fallbacks = ed25519.scalar_fallbacks
    t0 = time.perf_counter()
    pool = sign_pool()
    lf = light_fixtures(fixtures, sources, pool)
    fixtures_s = time.perf_counter() - t0
    print(f"light fixtures: {N_SIGS} validators x {LIGHT_HEIGHTS} heights rotating "
          f"{LIGHT_ROTATE} a height (heights {LIGHT_SIGNED} signed), {LIGHT_SMALL} x "
          f"{LIGHT_SMALL_HEIGHTS} rotating {LIGHT_SMALL_ROTATE}, two conflicting tips: "
          f"{lf['signatures']} signatures, keys {lf['keys_s']:.1f} s, signing "
          f"{lf['sign_s']:.1f} s, built in {fixtures_s:.1f} s", flush=True)

    # The counted run: launch counts zeroed just before, read just after.
    with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                 CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
        auto = be._make_backend()
    try:
        stamp("light: the gates")
        _build.reset_launches()
        gates = light_gates(lf, torch_backend)
        stamp("light: the swarm")
        swarm = {mode: light_swarm(lf, torch_backend, mode == "mmr")
                 for mode in ("plan", "mmr")}
        stamp("light: the attack, the evidence, the duplicate votes")
        attack = light_attack(sources, lf, torch_backend, pool)
        ev10k = light_evidence_10k(sources, lf, torch_backend)
        dup = light_duplicate_votes(sources, lf, fixtures, torch_backend, auto)
        launches = dict(_build.LAUNCHES)
        calls = (sum(len(r.calls) for r in gates[1].values())
                 + sum(len(s["lanes"]) for s in swarm.values()) + len(attack["calls"])
                 + len(ev10k["calls"]) + dup["torch"]["launch_sets"]
                 + dup["auto"]["launch_sets"])
        check(launches == {"ladder": calls, "decompress": calls, "sha512": calls,
                           "sha256": 0, "bn254": 0},
              f"light path launches {launches}: expected one sha512 / decompress / ladder "
              f"set a card call ({calls})")
        check(ev10k["calls"] == [("blocksync", N_SIGS // 3 + 1)],
              f"the evidence check's calls {ev10k['calls']}")
        lone = sum(gates[1]["150"].lanes())
        for mode, s in swarm.items():
            check(s["lanes_total"] <= lone + s["gateway"]["prewarmed_sigs"],
                  f"swarm ({mode}): {s['lanes_total']} lanes, more than one lone client's "
                  f"{lone} plus the gateway's prewarm {s['gateway']['prewarmed_sigs']}")
        check(ed25519.scalar_fallbacks == fallbacks,
              "a light-path verification took the ChainExhausted fallback")
        stamp("light: the timed syncs")
        metrics = light_metrics(lf, sources, torch_backend, auto, with_default)
    finally:
        auto.close()
    check(ed25519.scalar_fallbacks == fallbacks,
          "a light-path verification took the ChainExhausted fallback")
    check(sigbatch.counters()["fallbacks"] == 0, "a sigbatch fallback on the light path")
    stamp("light: the kernels at the path's batches")
    kernels = bsync_window_kernels(light_kernel_batches(gates, ev10k), dev)
    ev10k.pop("recorder")
    return {
        "fixtures_s": fixtures_s, "signatures": lf["signatures"], "launches": launches,
        "gates": gates[0], "swarm": swarm, "attack": attack, "evidence_10k": ev10k,
        "duplicate_votes": dup, "metrics": metrics, "kernels": kernels,
        "lanes_by_caller": {
            **{name: r.calls for name, r in gates[1].items()},
            **{f"swarm_{m}": s["lanes"] for m, s in swarm.items()},
            "attack": attack["calls"], "evidence_10k": ev10k["calls"]},
    }


# -- the consensus path ----------------------------------------------------------

# Path (a): the port's simnet at a typical chain's set, the simnet's own WAN
# defaults (4 zones, default_spec's timeouts), vote buckets of 25 ms; 2
# blocks (5 take ~45 s under TorchBackend and ~90 s under the default on the
# card's host; 3 until the network phase came: the cut keeps the whole run
# near 1,000 s).
CONS_SIM = {"validators": COMMIT_SMALL, "blocks": 1, "seed": 7, "vote_window_ms": 25.0,
            "max_sim_s": 300.0}
# The flood run: the JAX package's flooder window (test_simnet_byzantine.py:
# node 1, 5-45 s, 20 Hz, fanout 8), each replay with one signature bit
# flipped and sent through the vote buckets, 8 a burst, so that a replay to
# a peer fills a bucket its drain prebatches.
CONS_FLOOD_BLOCKS = 2
CONS_FLOOD = {"role": "flooder", "node": 1, "from_s": 5.0, "until_s": 45.0, "rate_hz": 20.0,
              "burst": 8}
# Path (b): a node with no priv validator follows heights 1..CONS_HEIGHTS of
# the blocksync phase's 10,240-validator source chain through start() and
# send_peer_message; the counted run corrupts one prevote (height, index).
CONS_HEIGHTS = 2  # 4 until the RPC phase came, 3 until the node phase (the run near 1,100 s)
CONS_BAD = (2, 5)
CONS_TIMED = 1  # timed runs of path (b) under each backend, in turns
CONS_PEERS = 8  # the peer ids the follower's messages arrive from
CONS_SIGN_CHUNK = 512


class SimCaches:
    """One verified-triple cache a simnet node. The simnet runs its nodes in
    one process, where ``crypto/ed25519``'s cache is shared: a signer's own
    admission of its vote (``mark_self_signed``) answers every peer's check
    of it, and no vote reaches the card (a CPU run of 150 validators made no
    backend call). A network runs a process a node, each with its own
    cache: this context swaps ``ed25519._verified`` for the node's own dict
    around each of the state machine's entry points, so that every node
    checks each vote it receives, in its drains' prebatches (the card) or,
    in a bucket of fewer than 8, by the scalar check, as a node of a network
    does. The verdicts, and so the blocks, are the same either way."""

    ENTRY = ("_handle_msg", "_handle_timeout", "_prebatch_vote_signatures", "_stall_check",
             "_rearm_step_timeout")

    def __init__(self):
        self.caches: dict = {}
        self._saved: list = []

    def __enter__(self):
        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.crypto import ed25519

        caches = self.caches
        for name in self.ENTRY:
            orig = getattr(ConsensusState, name)

            def wrapper(cs, *args, _orig=orig, **kwargs):
                prev = ed25519._verified
                ed25519._verified = caches.setdefault(cs, {})
                try:
                    return _orig(cs, *args, **kwargs)
                finally:
                    ed25519._verified = prev

            self._saved.append((name, orig))
            setattr(ConsensusState, name, wrapper)
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.consensus.state import ConsensusState

        for name, orig in reversed(self._saved):
            setattr(ConsensusState, name, orig)
        self._saved.clear()


class ConsRecorder:
    """A backend that records each call: the height ``at()`` gives at the
    call, its lanes, the lanes its bitmap refused and its wall ms; it keeps
    the triples of its largest call and of its smallest of at least 8
    lanes (a prebatch's least) among the calls that refused no lane (the
    kernels are held at them with four lanes corrupted)."""

    def __init__(self, inner, at):
        self.inner = inner
        self.at = at
        self.calls: list = []
        self.largest = None
        self.smallest = None
        self._lock = threading.Lock()

    def batch_verify(self, pubs, msgs, sigs):
        t0 = time.perf_counter()
        ok, bits = self.inner.batch_verify(pubs, msgs, sigs)
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            n = len(pubs)
            self.calls.append((self.at(), n, sum(1 for b in bits if not b), ms))
            if all(bits):
                trip = (list(pubs), list(msgs), list(sigs))
                if self.largest is None or n > len(self.largest[0]):
                    self.largest = trip
                if n >= 8 and (self.smallest is None or n < len(self.smallest[0])):
                    self.smallest = trip
        return ok, bits

    def merkle_root(self, leaves):
        return self.inner.merkle_root(leaves)

    def by_height(self) -> dict:
        out: dict = {}
        for h, n, bad, ms in self.calls:
            rec = out.setdefault(h, {"calls": 0, "lanes": 0, "refused": 0, "ms": 0.0})
            rec["calls"] += 1
            rec["lanes"] += n
            rec["refused"] += bad
            rec["ms"] += ms
        return out


def flip_bit(b: bytes, at: int = 0) -> bytes:
    return b[:at] + bytes([b[at] ^ 0x01]) + b[at + 1:]


def bad_sig_flooder(base_cls):
    """The JAX package's flooder (``simnet/byzantine.Flooder``) whose
    replays each carry one flipped signature bit and go through the vote
    buckets (``Scenario._bucket_vote``) instead of straight to the peer, so
    that a drain's prebatch takes them; ``sent`` holds the bad signatures."""
    from dataclasses import replace

    from cometbft_tpu_torch.consensus.messages import VoteMessage

    class BadSigFlooder(base_cls):
        sent: set = set()

        def _tick(self) -> None:
            scen = self.scen
            if scen.clock.now() >= self.until_s:
                return
            i = self.node_index
            node = scen.nodes[i]
            if self.active() and node.online and self._ring:
                replay = [self._ring[self.rng.randrange(len(self._ring))]
                          for _ in range(self.burst)]
                peers = [j for j in range(scen.n) if j != i and scen._reachable(i, j)]
                if len(peers) > self.fanout:
                    peers = self.rng.sample(peers, self.fanout)
                for j in peers:
                    for m in replay:
                        bad = VoteMessage(replace(m.vote, signature=flip_bit(m.vote.signature)))
                        BadSigFlooder.sent.add(bad.vote.signature)
                        due = max(scen.clock.now() + scen._link_delay(i, j),
                                  scen._fifo.get((i, j), 0.0))
                        scen._bucket_vote(i, j, due, bad, f"sim{i}")
                        self._count("byz_flooded")
            scen.clock.timer(1.0 / self.rate_hz, self._tick)

    BadSigFlooder.sent = set()
    return BadSigFlooder


def cons_sim_run(backend, spec: dict, record: bool) -> dict:
    """One run of the port's simnet, ``Scenario(default_spec(**spec)).run()``
    (what ``run_scenario`` does), under ``set_backend(backend)`` with one
    verified-triple cache a node (SimCaches); with ``record`` the backend
    sits behind a ConsRecorder whose calls go to node 0's height. A
    ``flooder`` entry is the bad-signature flooder (bad_sig_flooder).
    Counts the scalar checks (``ed25519_pure.verify_zip215``) and keeps
    sigbatch's counters from before the run's closing reset."""
    from cometbft_tpu_torch.crypto import ed25519_pure, sigbatch
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.simnet import byzantine
    from cometbft_tpu_torch.simnet import scenario as sc

    scen = sc.Scenario(sc.default_spec(**spec))
    rec = ConsRecorder(backend, lambda: scen.nodes[0].cs.rs.height if scen.nodes else 0)
    flooder = bad_sig_flooder(byzantine.Flooder)
    orig_make, orig_verify, orig_reset = (byzantine.make_actor, ed25519_pure.verify_zip215,
                                          sigbatch.reset)
    scalar = [0]
    sig_counters: list = []

    def make_actor(scenario, entry):
        actor = orig_make(scenario, entry)
        if entry.get("role") == "flooder":
            actor.__class__ = flooder
        return actor

    def verify_zip215(*args):
        scalar[0] += 1
        return orig_verify(*args)

    def reset():
        sig_counters.append(sigbatch.counters())
        orig_reset()

    byzantine.make_actor, ed25519_pure.verify_zip215, sigbatch.reset = (
        make_actor, verify_zip215, reset)
    be.set_backend(rec if record else backend)
    try:
        with SimCaches() as caches:
            report = scen.run()
    finally:
        byzantine.make_actor, ed25519_pure.verify_zip215, sigbatch.reset = (
            orig_make, orig_verify, orig_reset)
        be.set_backend(None)
    nodes = [n.cs for n in scen.nodes]
    return {"report": report, "scenario": scen, "recorder": rec if record else None,
            "scalar_verifies": scalar[0], "sigbatch": sig_counters[-1],
            "prebatch_errors": sum(cs.prebatch_errors for cs in nodes),
            "consensus_failures": sum(cs.consensus_failures for cs in nodes),
            "stall_errors": sum(cs.stall_errors for cs in nodes),
            "last_prebatch_error": repr(next((cs.last_prebatch_error for cs in nodes
                                              if cs.last_prebatch_error), None)),
            "caches": len(caches.caches), "flood_sent": set(flooder.sent)}


def cons_sim_gates(run: dict, blocks: int, what: str) -> None:
    """A simnet run's gates: the chain reached its target, every node agrees
    and no two honest nodes differ, no straggler, every error counter 0."""
    rep = run["report"]
    check(rep["ok"] and rep["hash_agreement"] and rep["safety_ok"],
          f"simnet {what}: ok {rep['ok']}, agreement {rep['hash_agreement']}, safety "
          f"{rep['safety_ok']} (height {rep['height_node0']}, conflicting "
          f"{rep['conflicting_heights']})")
    check(rep["stragglers"] == [], f"simnet {what}: stragglers {rep['stragglers']}")
    check(len(rep["block_hashes"]) == blocks and all(rep["block_hashes"].values()),
          f"simnet {what}: committed {sorted(rep['block_hashes'])}")
    errs = sim_errors(run)
    check(all(v == 0 for v in errs.values()),
          f"simnet {what}: error counters {errs}; last prebatch error "
          f"{run['last_prebatch_error']}")


def sim_errors(run: dict) -> dict:
    return {"prebatch_errors": run["prebatch_errors"],
            "consensus_failures": run["consensus_failures"],
            "drain_failures": run["report"]["counters"]["drain_failures"],
            "stall_errors": run["stall_errors"], "sigbatch_fallbacks": run["sigbatch"]["fallbacks"]}


def cons_sim_summary(run: dict) -> dict:
    rep = run["report"]
    out = {"ms_per_height": rep["wall_time_s"] * 1e3 / len(rep["block_hashes"]),
           "errors": sim_errors(run),
           "wall_time_s": rep["wall_time_s"], "sim_time_s": rep["sim_time_s"],
           "accel": rep["accel"], "events": rep["events"],
           "vote_dispatches": rep["counters"]["vote_dispatches"],
           "deliveries": rep["counters"]["deliveries"], "scalar_verifies": run["scalar_verifies"],
           "sigbatch": run["sigbatch"], "node_caches": run["caches"]}
    if run["recorder"] is not None:
        per = run["recorder"].by_height()
        out["card_by_height"] = {int(h): v for h, v in sorted(per.items())}
        out["card_calls"] = len(run["recorder"].calls)
        out["card_lanes"] = sum(n for _, n, _, _ in run["recorder"].calls)
        out["card_ms"] = sum(ms for *_, ms in run["recorder"].calls)
    return out


def cons_simnet(torch_backend, auto) -> dict:
    """Path (a): the simnet at CONS_SIM under ``TorchBackend()`` (recorded)
    and, where ``auto`` is given (``--consensus``), the process default,
    then the flood run; the gates (module docstring, step 18). Returns the
    summaries, the launches of the recorded run and the recorders' largest
    batches."""
    from cometbft_tpu_torch.ops import _build

    _build.reset_launches()
    runs = {"torch": cons_sim_run(torch_backend, CONS_SIM, record=True)}
    launches = dict(_build.LAUNCHES)
    calls = len(runs["torch"]["recorder"].calls)
    check(launches == {"ladder": calls, "decompress": calls, "sha512": calls, "sha256": 0,
                       "bn254": 0},
          f"simnet launches {launches}: expected one sha512 / decompress / ladder set a card "
          f"call ({calls})")
    if auto is not None:
        runs["auto"] = cons_sim_run(auto, CONS_SIM, record=False)
    for tier, run in runs.items():
        cons_sim_gates(run, CONS_SIM["blocks"], tier)
    if auto is not None:
        a, b = runs["torch"]["report"], runs["auto"]["report"]
        for key in ("block_hashes", "commit_times", "sim_time_s", "events"):
            check(a[key] == b[key], f"simnet: {key} differs between TorchBackend and the default")
    per = runs["torch"]["recorder"].by_height()
    check(all(per.get(h, {}).get("lanes", 0) > 0 for h in range(1, CONS_SIM["blocks"] + 1)),
          f"simnet: a height without card lanes: {sorted(per.items())}")
    flood_spec = {**CONS_SIM, "blocks": CONS_FLOOD_BLOCKS, "byzantine": [CONS_FLOOD]}
    flood = cons_sim_run(torch_backend, flood_spec, record=True)
    cons_sim_gates(flood, CONS_FLOOD_BLOCKS, "flood")
    sent = flood["flood_sent"]
    scen = flood["scenario"]
    memo = sum(1 for n in scen.nodes for key in n.cs._failed_triples if key[32:96] in sent)
    refused = sum(bad for *_, bad, _ in flood["recorder"].calls)
    check(sent and memo > 0 and refused > 0,
          f"flood: {len(sent)} bad signatures sent, {memo} in the nodes' failed-triple memos, "
          f"{refused} lanes refused by the card")
    admitted = 0
    for n in scen.nodes:
        rs = n.cs.rs
        sets = [vs for rvs in rs.votes._round_vote_sets.values() for vs in rvs.values()]
        sets += [rs.last_commit] if rs.last_commit is not None else []
        admitted += sum(1 for vs in sets for v in vs.votes if v is not None and v.signature in sent)
        for h in range(1, n.cs.block_store.height() + 1):
            for c in (n.cs.block_store.load_seen_commit(h), n.cs.block_store.load_block(h).last_commit):
                admitted += sum(1 for s in (c.signatures if c else []) if s.signature in sent)
    check(admitted == 0, f"flood: {admitted} flood votes admitted")
    return {"summary": {tier: cons_sim_summary(run) for tier, run in runs.items()},
            "flood": {**cons_sim_summary(flood), "bad_signatures": len(sent),
                      "in_failed_memos": memo, "refused_lanes": refused,
                      "flooded": flood["report"]["counters"].get("byz_flooded", 0),
                      "admitted": admitted},
            "launches": launches, "largest": runs["torch"]["recorder"].largest,
            "flood_largest": flood["recorder"].largest}


def cons_follow_fixtures(source, fixtures) -> list:
    """Path (b)'s messages for heights 1..CONS_HEIGHTS of the source chain:
    each height's proposal (signed by the block's proposer), its block
    parts, 10,240 prevotes for the block (each signed by its validator in a
    pool of SIGN_PROCESSES processes, timestamps after the block's) and the
    source's seen commit turned back into 10,240 precommits; with the
    source's block and state bytes for the gates."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.types.block import PRECOMMIT_TYPE, PREVOTE_TYPE, Block, BlockID
    from cometbft_tpu_torch.types.proposal import Proposal
    from cometbft_tpu_torch.types.vote import Vote

    _, seeds, pubs, *_ = fixtures
    secret = {ed25519.PubKey(p).address(): (s, p) for s, p in zip(seeds, pubs)}
    store = source["node"]["block_store"]
    heights, jobs = [], []
    for h in range(1, CONS_HEIGHTS + 1):
        block = Block.decode(source["blocks"][h - 1])
        parts = block.make_part_set()
        bid = BlockID(block.hash(), parts.header())
        seen = store.load_seen_commit(h)
        proposal = Proposal(height=h, round=0, pol_round=-1, block_id=bid,
                            timestamp=block.header.time)
        jobs.append(("ed25519", *secret[block.header.proposer_address],
                     proposal.sign_bytes(BSYNC_CHAIN_ID)))
        prevotes = [Vote(type=PREVOTE_TYPE, height=h, round=0, block_id=bid,
                         timestamp=block.header.time.add_nanos(5 * 10**8 + 977 * i),
                         validator_address=cs.validator_address, validator_index=i)
                    for i, cs in enumerate(seen.signatures)]
        jobs += [("ed25519", *secret[v.validator_address], v.sign_bytes(BSYNC_CHAIN_ID))
                 for v in prevotes]
        precommits = [Vote(type=PRECOMMIT_TYPE, height=seen.height, round=seen.round,
                           block_id=cs.block_id(seen.block_id), timestamp=cs.timestamp,
                           validator_address=cs.validator_address, validator_index=i,
                           signature=cs.signature)
                      for i, cs in enumerate(seen.signatures) if not cs.is_absent()]
        heights.append({"height": h, "proposal": proposal, "prevotes": prevotes,
                        "precommits": precommits,
                        "parts": [parts.get_part(k) for k in range(parts.total)],
                        "block": source["blocks"][h - 1], "state": source["states"][h - 1],
                        "seen": seen})
    chunks = [jobs[i : i + CONS_SIGN_CHUNK] for i in range(0, len(jobs), CONS_SIGN_CHUNK)]
    pool = sign_pool()
    sigs = iter([s for chunk in pool.map(sign_jobs, chunks, chunksize=1) for s in chunk])
    from dataclasses import replace

    for hx in heights:
        hx["proposal"] = replace(hx["proposal"], signature=next(sigs))
        hx["prevotes"] = [replace(v, signature=next(sigs)) for v in hx["prevotes"]]
    return heights


class ConsStages:
    """Exclusive host time of the follower's stages (a stage's time less the
    stages it calls): the drains' prebatch (sign bytes, ``bv.add``, the
    cache filter, the merge) and the backend call apart, ``_try_add_vote``
    (the vote sets, the state transitions), the proposal check
    (``_set_proposal``: its scalar signature check), the block parts
    (``_add_proposal_block_part``: proofs, ``Block.decode``),
    ``validate_block``, ``_finalize_commit`` with ``save_block`` and
    ``apply_block`` apart, and the WAL's writes. Installed on the port's
    classes for one run (``with``); ``take()`` returns and clears the sums."""

    def __init__(self, recorder):
        self.recorder = recorder
        self.ms: dict = collections.defaultdict(float)
        self.n: collections.Counter = collections.Counter()
        self._local = threading.local()
        self._saved: list = []

    def _wrap(self, owner, name, stage):
        orig = getattr(owner, name)
        st = self

        def wrapper(*args, **kwargs):
            stack = st._local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                spent = (time.perf_counter() - t0) * 1e3
                inner = stack.pop()
                st.ms[stage] += spent - inner
                st.n[stage] += 1
                if stack:
                    stack[-1] += spent

        self._saved.append((owner, name, orig))
        setattr(owner, name, wrapper)

    def __enter__(self):
        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.consensus.wal import WAL
        from cometbft_tpu_torch.state import BlockExecutor
        from cometbft_tpu_torch.store import BlockStore

        self._wrap(self.recorder, "batch_verify", "backend_call")
        self._wrap(ConsensusState, "_prebatch_vote_signatures", "prebatch_host")
        self._wrap(ConsensusState, "_try_add_vote", "add_vote")
        self._wrap(ConsensusState, "_set_proposal", "proposal_check")
        self._wrap(ConsensusState, "_add_proposal_block_part", "block_parts")
        self._wrap(BlockExecutor, "validate_block", "validate_block")
        self._wrap(ConsensusState, "_finalize_commit", "finalize_commit")
        self._wrap(BlockStore, "save_block", "save_block")
        self._wrap(BlockExecutor, "apply_block", "apply_block")
        self._wrap(WAL, "write", "wal_write")
        self._wrap(WAL, "write_sync", "wal_write_sync")
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()

    def take(self) -> dict:
        out = {k: {"ms": self.ms[k], "calls": self.n[k]} for k in sorted(self.ms)}
        self.ms.clear()
        self.n.clear()
        return out


def cons_follow(fx, gen, backend, recorder=None, stages=None, corrupt=None, wire=None) -> dict:
    """Path (b) once: a fresh node from the source's genesis (the port's
    PersistentKVStoreApplication, CListMempool, stores and BlockExecutor,
    an ``EventBus``, a real ``WAL`` in a temporary directory, no priv
    validator; timeouts of 600 s and a long commit dwell with
    ``skip_timeout_commit``, so the node waits for every precommit and never
    prevotes nil) is started (``start()``) under ``set_backend(backend)``
    with an empty verified-triple cache; each height's proposal, parts,
    prevotes and precommits go in through ``send_peer_message``. The ms of a
    height run from the proposal's enqueue to the commit (the node at the
    next height); the next height is fed once every precommit is in (the
    node entered its next round). Gates at every height: the stored block,
    the state (app hash included) equal the source's; the seen commit is the
    source's at every signature it holds, over 2/3 of the power. With
    ``corrupt`` = (height, index), that prevote carries a flipped signature
    bit and must not enter the vote set. With ``wire`` (a ``WireFeed``: path
    (c)), the messages reach the node over TCP through its ConsensusReactor
    instead, and the ms of a height run from the relays' first send."""
    import tempfile
    from dataclasses import replace

    from cometbft_tpu_torch.config import ConsensusConfig
    from cometbft_tpu_torch.consensus.cstypes import STEP_PROPOSE
    from cometbft_tpu_torch.consensus.messages import (BlockPartMessage, ProposalMessage,
                                                       VoteMessage)
    from cometbft_tpu_torch.consensus.state import ConsensusState
    from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage, read_messages
    from cometbft_tpu_torch.crypto import ed25519, sigbatch
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.state import store as state_store
    from cometbft_tpu_torch.types.events import EventBus

    ed25519._verified.clear()
    sigbatch.reset()
    node = bsync_node(gen)
    bus = EventBus()
    bus.start()
    node["executor"].event_bus = bus
    # Over the wire the last precommit can land before the block's last part
    # (a relay's parts and votes interleave on its connection), and then no
    # vote is left to start round 0 of the next height once the block
    # commits (skip_timeout_commit is checked only as a vote is added): the
    # commit dwell is then NET_COMMIT_DWELL_S.
    cfg = ConsensusConfig(timeout_propose=600.0, timeout_prevote=600.0, timeout_precommit=600.0,
                          timeout_commit=600.0 if wire is None else NET_COMMIT_DWELL_S,
                          skip_timeout_commit=True)
    out = {"ms": [], "full_ms": [], "prebatched": collections.Counter(), "stages": [],
           "corrupt": None}
    with tempfile.TemporaryDirectory() as wal_dir:
        wal = WAL(os.path.join(wal_dir, "cs.wal", "wal"))
        cs = ConsensusState(cfg, node["state"], node["executor"], node["block_store"],
                            node["mempool"], event_bus=bus, wal=wal, name="follower")
        if recorder is not None:
            recorder.at = lambda: cs.rs.height
        orig_prebatch = cs._prebatch_vote_signatures

        def prebatch(items):  # counts the votes each drain prebatches, by height
            out["prebatched"][cs.rs.height] += sum(
                1 for k, p, _ in items if k == "peer" and isinstance(p, VoteMessage))
            return orig_prebatch(items)

        cs._prebatch_vote_signatures = prebatch
        be.set_backend(backend)
        try:
            cs.start()
            if wire is not None:
                wire.start(cs)
            for hx in fx:
                h = hx["height"]
                prevotes = hx["prevotes"]
                if corrupt is not None and corrupt[0] == h:
                    v = prevotes[corrupt[1]]
                    prevotes = list(prevotes)
                    prevotes[corrupt[1]] = replace(v, signature=flip_bit(v.signature))
                check(cs.rs.height == h, f"follower at height {cs.rs.height}, feeding {h}")
                hvs = cs.rs.votes
                t0 = time.perf_counter()
                if wire is not None:
                    wire.feed(h)
                else:
                    cs.send_peer_message(ProposalMessage(hx["proposal"]), "peer0")
                    for part in hx["parts"]:
                        cs.send_peer_message(BlockPartMessage(h, 0, part), "peer0")
                    for i, v in enumerate(prevotes):
                        cs.send_peer_message(VoteMessage(v), f"peer{i % CONS_PEERS}")
                    for i, v in enumerate(hx["precommits"]):
                        cs.send_peer_message(VoteMessage(v), f"peer{i % CONS_PEERS}")
                check(cs.wait_for_height(h + 1, timeout=600),
                      f"follower did not commit height {h}: {cs.rs.height}/{cs.rs.round}/"
                      f"{cs.rs.step}; consensus failures {cs.consensus_failures} "
                      f"({cs.last_consensus_failure!r})")
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                deadline = time.monotonic() + 600
                while not (cs.rs.height == h + 1 and cs.rs.step >= STEP_PROPOSE):
                    check(time.monotonic() < deadline, f"height {h}: precommits not all in")
                    time.sleep(0.002)
                out["full_ms"].append((time.perf_counter() - t0) * 1e3)
                if stages is not None:
                    out["stages"].append(stages.take())
                if wire is not None:
                    wire.height_done()
                bs = node["block_store"]
                check(bs.load_block(h).encode() == hx["block"], f"follower's block {h} differs")
                check(state_store._encode_state(cs.state) == hx["state"],
                      f"follower's state after height {h} differs from the source's")
                seen, src = bs.load_seen_commit(h), hx["seen"]
                held = [i for i, s in enumerate(seen.signatures) if not s.is_absent()]
                check(seen.block_id == src.block_id and seen.height == h
                      and all(seen.signatures[i] == src.signatures[i] for i in held)
                      and 3 * len(held) > 2 * len(src.signatures),
                      f"follower's seen commit {h}: {len(held)} signatures, not the source's")
                if corrupt is not None and corrupt[0] == h:
                    bad = prevotes[corrupt[1]]
                    pv = hvs.prevotes(0)
                    bad_key = None
                    for k in cs._failed_triples:
                        if k[32:96] == bad.signature:
                            bad_key = k
                    # Over the wire a relay's late prevotes can reach the node
                    # after it committed on 2/3 of the precommits, and are
                    # then for a past height: the set holds at most the rest.
                    held = len(pv.list_votes())
                    check(pv.get_by_index(corrupt[1]) is None and bad_key is not None
                          and (held == len(prevotes) - 1 if wire is None
                               else held <= len(prevotes) - 1),
                          f"the corrupted prevote: in the vote set "
                          f"{pv.get_by_index(corrupt[1]) is not None}, in the failed memo "
                          f"{bad_key is not None}, {len(pv.list_votes())} prevotes held")
                    out["corrupt"] = {"height": h, "index": corrupt[1], "in_vote_set": False,
                                      "in_failed_memo": True, "prevotes_held": held}
            if wire is not None:
                out["wire"] = wire.finish()
        finally:
            if wire is not None:
                wire.close()
            cs.stop()
            bus.stop()
            be.set_backend(None)
        errs = {"prebatch_errors": cs.prebatch_errors, "consensus_failures": cs.consensus_failures,
                "wal_catchup_errors": cs.wal_catchup_errors,
                "sigbatch_fallbacks": sigbatch.counters()["fallbacks"]}
        check(all(v == 0 for v in errs.values()),
              f"follower error counters {errs}; last prebatch error {cs.last_prebatch_error!r}, "
              f"last failure {cs.last_consensus_failure!r}")
        out["errors"] = errs
        if stages is not None:
            ends = [tm.msg.height for tm in read_messages(wal.path)
                    if isinstance(tm.msg, EndHeightMessage)]
            check(ends == list(range(CONS_HEIGHTS + 1)), f"the WAL's end heights {ends}")
            out["wal_end_heights"] = ends
    out["app_hash"] = cs.state.app_hash.hex()
    return out


def cons_follow_path(sources, fixtures, torch_backend, auto, timed: int = CONS_TIMED) -> dict:
    """Path (b): the fixtures, the counted run (TorchBackend behind a
    ConsRecorder, the stages timed, one prevote corrupted), then ``timed``
    unstaged runs under ``TorchBackend()`` and the process default in turns;
    ``consensus_10k_ms_per_height`` is the median of heights 2..CONS_HEIGHTS
    (None without timed runs: the full run's is the counted run's,
    ``consensus_phase``)."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import _build

    source = sources["10k"]
    t0 = time.perf_counter()
    fx = cons_follow_fixtures(source, fixtures)
    fixtures_s = time.perf_counter() - t0
    print(f"consensus fixtures: {CONS_HEIGHTS} heights of the {source['n_vals']}-validator "
          f"source, {sum(len(hx['prevotes']) for hx in fx)} prevotes and {CONS_HEIGHTS} "
          f"proposals signed, {sum(len(hx['parts']) for hx in fx)} parts, built in "
          f"{fixtures_s:.1f} s", flush=True)
    fallbacks = ed25519.scalar_fallbacks
    rec = ConsRecorder(torch_backend, lambda: 0)
    before = dict(_build.LAUNCHES)
    with ConsStages(rec) as stages:
        counted = cons_follow(fx, source["gen"], rec, rec, stages, corrupt=CONS_BAD)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    calls = len(rec.calls)
    check(launched == {"ladder": calls, "decompress": calls, "sha512": calls, "sha256": 0,
                       "bn254": 0},
          f"follower launches {launched}: expected one sha512 / decompress / ladder set a card "
          f"call ({calls})")
    per = rec.by_height()
    for h, n in counted["prebatched"].items():
        check(per.get(h, {}).get("lanes", 0) >= n,
              f"height {h}: {per.get(h)} card lanes for {n} prebatched votes")
    check(sum(bad for *_, bad, _ in rec.calls) >= 1, "the corrupted prevote was not refused")
    runs = {"torch": [], "auto": []}
    for rep in range(timed):
        tiers = [("torch", torch_backend), ("auto", auto)]
        for tier, backend in tiers if rep % 2 == 0 else tiers[::-1]:
            runs[tier].append(cons_follow(fx, source["gen"], backend)["ms"])
    check(ed25519.scalar_fallbacks == fallbacks, "a follower check took the ChainExhausted fallback")
    med = {tier: statistics.median(ms for r in rs for ms in r[1:]) if rs else None
           for tier, rs in runs.items()}
    return {"fixtures_s": fixtures_s, "ms_per_height": med, "runs_ms": runs,
            "counted_ms": counted["ms"], "counted_full_ms": counted["full_ms"],
            "stages_by_height": counted["stages"],
            "card_by_height": {int(h): v for h, v in sorted(per.items())},
            "prebatched_by_height": dict(counted["prebatched"]), "corrupt": counted["corrupt"],
            "errors": counted["errors"], "wal_end_heights": counted["wal_end_heights"],
            "launches": launched, "largest": rec.largest, "smallest": rec.smallest,
            "app_hash": counted["app_hash"], "fx": fx}


def drive_consensus_path(fixtures, sources, torch_backend, dev, timed: int = CONS_TIMED) -> dict:
    """The consensus phase (module docstring, step 18): paths (a) and (b)
    (under the process default too with ``timed``), the launch counts of
    the whole drive, the kernels at the path's batches."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    auto = None  # the process default, timed under --consensus only
    if timed:
        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                     CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            auto = be._make_backend()
    try:
        _build.reset_launches()
        sim = cons_simnet(torch_backend, auto)
        stamp("consensus: path (b)")
        follow = cons_follow_path(sources, fixtures, torch_backend, auto, timed)
        launches = dict(_build.LAUNCHES)
    finally:
        if auto is not None:
            auto.close()
    check(all(launches[k] > 0 for k in ("sha512", "decompress", "ladder")),
          f"consensus path launches {launches}")
    batches = {}
    for label, trip in (("follow_largest", follow.pop("largest")),
                        ("follow_smallest", follow.pop("smallest")),
                        ("simnet_largest", sim.pop("largest")),
                        ("flood_largest", sim.pop("flood_largest"))):
        batches[f"{label}_{len(trip[0])}"] = corrupt_four(*trip)
    kernels = bsync_window_kernels(batches, dev)
    return {"launches": launches, "simnet": sim, "follow": follow, "kernels": kernels}


def consensus_phase(fixtures, sources, backend, dev, card, records, timed: int = CONS_TIMED):
    """Runs the consensus path (step 18), prints its metrics and gates,
    merges its kernel comparisons into ``records``; returns its launches and
    path (b)'s fixtures. With ``timed`` 0 (the full run)
    ``consensus_10k_ms_per_height`` is the counted run's (a recording
    backend, each stage ended by a synchronize)."""
    start = time.perf_counter()
    out = drive_consensus_path(fixtures, sources, backend, dev, timed)
    fx = out["follow"].pop("fx")
    for k in ("sha512", "decompress", "ladder"):  # held at the path's own batches too
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    sim, fol = out["simnet"], out["follow"]
    print(f"consensus path ok (the {CONS_SIM['validators']}-validator simnet committed "
          f"{CONS_SIM['blocks']} blocks under TorchBackend"
          + (" and the default, the same blocks" if timed else "")
          + f", card lanes at every height; the flood refused on the card, none admitted; the "
          f"follower committed the {N_SIGS}-validator source's heights 1-{CONS_HEIGHTS}, its "
          f"corrupted prevote refused); launches {out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    print(json.dumps({"metric": "simnet_150_ms_per_height",
                      "value": sim["summary"]["torch"]["ms_per_height"],
                      "validators": CONS_SIM["validators"], "blocks": CONS_SIM["blocks"],
                      "by_backend": {t: s["ms_per_height"] for t, s in sim["summary"].items()},
                      "runs": sim["summary"], "flood": sim["flood"], **common}), flush=True)
    counted = statistics.median(fol["counted_ms"][1:])
    print(json.dumps({"metric": "consensus_10k_ms_per_height",
                      "value": fol["ms_per_height"]["torch"] if timed else counted,
                      "from": "timed runs" if timed else "the counted run (each stage synchronized)",
                      "validators": N_SIGS, "heights": CONS_HEIGHTS,
                      "by_backend": fol["ms_per_height"] if timed else {"torch": counted},
                      "runs_ms": fol["runs_ms"], "counted_ms": fol["counted_ms"], **common}),
          flush=True)
    print(json.dumps({"consensus_stages_10k": fol["stages_by_height"],
                      "card_by_height": fol["card_by_height"],
                      "prebatched_by_height": fol["prebatched_by_height"], **common}), flush=True)
    print(json.dumps({"consensus": {"follow": {k: v for k, v in fol.items() if k not in (
        "stages_by_height", "runs_ms")}, "kernels": out["kernels"], "launches": out["launches"]},
        "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"], fx


def bsync_10k_source(fixtures, backend) -> dict:
    """The blocksync phase's 10,240-validator source chain alone (what the
    consensus and network phases follow), built under ``backend``."""
    from cometbft_tpu_torch.sidecar import backend as be

    _, seeds, pubs, *_ = fixtures
    t0 = time.perf_counter()
    be.set_backend(backend)
    try:
        pool = sign_pool()
        big = bsync_source(seeds, pubs, BSYNC_HEIGHTS, BSYNC_TXS, pool)
    finally:
        be.set_backend(None)
    print(f"blocksync source: {N_SIGS} validators x {BSYNC_HEIGHTS} heights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return big


def consensus_only(card, dev) -> int:
    """``--consensus``: the fixtures, the 10,240-validator blocksync source
    and the consensus phase alone (a quick check of that phase on the card;
    no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    big = bsync_10k_source(fixtures, backend)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    launches, _ = consensus_phase(fixtures, {"10k": big}, backend, dev, card, records)
    print(json.dumps({"consensus_launches": launches, "max_abs_err": records}), flush=True)
    return 0


# -- the network path ------------------------------------------------------------

# Path (c): path (b)'s follower with a ConsensusReactor on a Switch listening
# on 127.0.0.1:0, fed by NET_PEERS relays over TCP (each a Switch with its own
# NodeKey, MultiplexTransport and SecretConnection, and a feeder reactor), in
# turns with path (b) under each backend, NET_TIMED times.
NET_PEERS = CONS_PEERS
NET_TIMED = 1
NET_SETTLE_S = 30.0  # the wait for every connection's bytes to be delivered
NET_COMMIT_DWELL_S = 3.0  # the follower's timeout_commit on the wire (cons_follow)
# Paths (d) and (e): NET_MESH validators of their own chain, each a
# ConsensusState with a ConsensusReactor and a MempoolReactor on a Switch in a
# full mesh: (d) over TCP to height NET_MESH_HEIGHTS with NET_MESH_TXS kvstore
# transactions entered at node 0; (e) over SimTransport (the simnet's WAN link
# defaults from NET_SIM_SEED), cut 2|2 when node 0 reaches NET_SIM_CUT_AT and
# held NET_SIM_HOLD_S, healed, then to height NET_SIM_HEIGHTS.
NET_CHAIN_ID = "chip-smoke-mesh"
NET_MESH = 4
NET_MESH_HEIGHTS = 5
NET_MESH_TXS = 20
NET_SIM_SEED = 17
NET_SIM_JITTER_S = 0.010  # simnet/scenario.default_spec's jitter_ms
NET_SIM_CUT_AT = 3
NET_SIM_HOLD_S = 3.0
NET_SIM_HEAL_ONLY_S = 5.0  # heal() alone, before the cut's connections are redialed
NET_SIM_HEIGHTS = 6
NET_WAIT_S = 120.0


def net_key(tag: bytes):
    """A node key from a fixed seed (the same ID every run)."""
    from cometbft_tpu_torch import convert

    return convert.node_key_from_seed(hashlib.sha256(b"chip-smoke-node-" + tag).digest())


def net_switch(key, network: str, moniker: str, reactors, transport_of=None):
    """A Switch over ``MultiplexTransport`` (or ``transport_of(info, key)``)
    with the given (name, reactor) pairs."""
    from cometbft_tpu_torch.p2p.node_info import NodeInfo
    from cometbft_tpu_torch.p2p.switch import Switch
    from cometbft_tpu_torch.p2p.transport import MultiplexTransport

    info = NodeInfo(node_id=key.id, network=network, moniker=moniker)
    sw = Switch(info, (transport_of or MultiplexTransport)(info, key))
    for name, reactor in reactors:
        sw.add_reactor(name, reactor)
    return sw


def feeder_reactor():
    """A relay's reactor: the consensus reactor's four channels; it keeps
    the follower's peer once dialed and counts what it receives, by type."""
    from cometbft_tpu_torch.consensus import messages as cmsg
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.p2p.reactor import Reactor

    class Feeder(Reactor):
        def __init__(self):
            super().__init__("FEEDER")
            self.peer = None
            self.received = collections.Counter()

        def get_channels(self):
            return ConsensusReactor.get_channels(self)

        def add_peer(self, peer):
            self.peer = peer

        def receive(self, chan_id, peer, msg_bytes):
            self.received[type(cmsg.decode_consensus_message(msg_bytes)).__name__] += 1

    return Feeder()


def wire_plans(fx, corrupt=None) -> dict:
    """Each height's messages, encoded, split over the NET_PEERS relays:
    relay k sends its NewRoundStep, then the proposal, the parts and the
    prevotes and precommits whose index is k mod NET_PEERS, in path (b)'s
    order. Its NewRoundStep is the height after the next: a peer that has
    committed the height it feeds and the one after (the source chain has
    BSYNC_HEIGHTS), so that the follower sees every relay ahead both before
    and after it commits the height and gossips nothing back, as the
    reference's reactor does to a peer ahead (a relay announcing only the
    next height is level with the follower once it commits, and would be
    sent the last commit's precommits it lacks). ``corrupt`` flips the
    prevote that path (b) flips."""
    from dataclasses import replace

    from cometbft_tpu_torch.consensus import messages as cmsg
    from cometbft_tpu_torch.consensus.cstypes import STEP_NEW_HEIGHT
    from cometbft_tpu_torch.p2p.reactor import (CONSENSUS_DATA_CHANNEL,
                                                CONSENSUS_STATE_CHANNEL, CONSENSUS_VOTE_CHANNEL)

    def step(height):
        return (CONSENSUS_STATE_CHANNEL, cmsg.encode_consensus_message(cmsg.NewRoundStepMessage(
            height=height, round=0, step=STEP_NEW_HEIGHT, seconds_since_start_time=0,
            last_commit_round=0)))

    plans = {}
    for hx in fx:
        h = hx["height"]
        prevotes = list(hx["prevotes"])
        if corrupt is not None and corrupt[0] == h:
            v = prevotes[corrupt[1]]
            prevotes[corrupt[1]] = replace(v, signature=flip_bit(v.signature))
        prop = (CONSENSUS_DATA_CHANNEL,
                cmsg.encode_consensus_message(cmsg.ProposalMessage(hx["proposal"])))
        per = [[step(h + 2), prop] for _ in range(NET_PEERS)]
        for part in hx["parts"]:
            per[part.index % NET_PEERS].append((CONSENSUS_DATA_CHANNEL, cmsg.encode_consensus_message(
                cmsg.BlockPartMessage(h, 0, part))))
        for v in prevotes + hx["precommits"]:
            per[v.validator_index % NET_PEERS].append(
                (CONSENSUS_VOTE_CHANNEL, cmsg.encode_consensus_message(cmsg.VoteMessage(v))))
        plans[h] = per
    return plans


def relay_counts(relays) -> list:
    """A relay process's counters, a connection each: bytes and frames
    sent to the follower, bytes received from it."""
    return [{"relay_sent": f.peer.mconn.send_monitor.bytes_total,
             "relay_frames": f.peer.mconn._conn.frames_sent,
             "relay_recv_bytes": f.peer.mconn.recv_monitor.bytes_total} for _, f in relays]


def relay_main(conn, addr: str, follower_id: str, plans: dict) -> None:
    """The NET_PEERS relays of path (c), in a process of their own (so that
    their sends do not share the follower's interpreter lock, as a real
    node's peers do not): each a Switch with its own NodeKey and a feeder
    reactor, dialing the follower at ``addr``. It answers the commands
    ``WireFeed`` sends through ``conn``: ("feed", height) sends that
    height's plan from every relay at once (a thread a relay,
    ``Peer.send``); ("counts", None) the counters; ("finish", None) the
    counters, the errors counted and what each relay received; ("close",
    None) stops the relays."""
    relays = []
    try:
        for k in range(NET_PEERS):
            feeder = feeder_reactor()
            sw = net_switch(net_key(b"relay-%d" % k), BSYNC_CHAIN_ID, f"relay{k}",
                            [("CONSENSUS", feeder)])
            sw.start("")
            relays.append((sw, feeder))
        for sw, feeder in relays:
            if sw.dial_peer(f"{follower_id}@{addr}") is None or feeder.peer is None:
                raise RuntimeError("a relay's dial of the follower failed")
        conn.send({"ids": [sw.node_info.node_id for sw, _ in relays],
                   "handshake_ms": [f.peer.mconn._conn.handshake_ms for _, f in relays]})
        while True:
            cmd, arg = conn.recv()
            if cmd == "feed":
                failed = []

                def send(k, h=arg):
                    peer = relays[k][1].peer
                    for chan, data in plans[h][k]:
                        if not peer.send(chan, data):
                            failed.append((k, chan))
                            return

                threads = [threading.Thread(target=send, args=(k,)) for k in range(NET_PEERS)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(NET_WAIT_S)
                conn.send(failed + [("hung", k) for k, t in enumerate(threads) if t.is_alive()])
            elif cmd == "counts":
                conn.send(relay_counts(relays))
            elif cmd == "finish":
                conn.send({"counts": relay_counts(relays),
                           "errors": [sw.errors() for sw, _ in relays],
                           "close_errors": sum(f.peer.mconn.close_errors
                                               + f.peer.mconn._conn.close_errors
                                               for _, f in relays),
                           "received": [dict(f.received) for _, f in relays]})
            elif cmd == "close":
                break
    except Exception as e:  # reported to the parent, which fails the run
        conn.send({"error": repr(e)})
    finally:
        for sw, _ in relays:
            sw.stop()
        conn.close()


class WireFeed:
    """Path (c)'s network around one follower (``cons_follow(wire=...)``):
    ``start(cs)`` puts the follower's ConsensusReactor on a Switch on
    127.0.0.1:0 and starts the relay process (``relay_main``), whose
    NET_PEERS relays dial it (the SecretConnection handshake, the NodeInfo
    swap); ``feed`` has every relay send a height's plan; ``height_done``
    keeps each connection's bytes and frames of the height; ``finish``
    stops the follower's reactor, waits for every connection's bytes sent
    to equal its bytes received (the flowrate monitors, both ways) and
    checks that the demux shed nothing of the consensus class, that no error
    was counted (the Switches, the reactor, every MConnection and
    SecretConnection) and that the relays received only NewRoundSteps."""

    def __init__(self, plans: dict):
        self.plans = plans
        self.sw = None
        self.proc = None
        self.by_height: list = []

    def _ask(self, cmd, arg=None):
        self.conn.send((cmd, arg))
        check(self.conn.poll(NET_WAIT_S), f"the relay process did not answer {cmd!r}")
        out = self.conn.recv()
        check(not (isinstance(out, dict) and "error" in out),
              f"the relay process failed: {out.get('error') if isinstance(out, dict) else ''}")
        return out

    def start(self, cs) -> None:
        import multiprocessing

        from cometbft_tpu_torch.consensus.reactor import ConsensusReactor

        self.reactor = ConsensusReactor(cs)
        key = net_key(b"follower")
        self.sw = net_switch(key, BSYNC_CHAIN_ID, "follower", [("CONSENSUS", self.reactor)])
        addr = self.sw.start("127.0.0.1:0")
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=relay_main, args=(child, addr, key.id, self.plans),
                                daemon=True)
        self.proc.start()
        child.close()
        check(self.conn.poll(NET_WAIT_S), "the relay process did not start")
        hello = self.conn.recv()
        check("error" not in hello, f"the relay process failed: {hello.get('error')}")
        deadline = time.monotonic() + NET_WAIT_S
        while self.sw.num_peers() < NET_PEERS:
            check(time.monotonic() < deadline, f"the follower has {self.sw.num_peers()} peers")
            time.sleep(0.01)
        self.peers = [self.sw.get_peer(i) for i in hello["ids"]]
        check(all(p is not None for p in self.peers), "a relay is not the follower's peer")
        self.handshake_ms = [{"relay": r, "follower": p.mconn._conn.handshake_ms}
                             for r, p in zip(hello["handshake_ms"], self.peers)]
        self._last = self._counts()

    def _counts(self, relay=None) -> list:
        relay = relay or self._ask("counts")
        return [{**r, "follower_received": p.mconn.recv_monitor.bytes_total,
                 "follower_sent": p.mconn.send_monitor.bytes_total,
                 "follower_frames": p.mconn._conn.frames_recv}
                for r, p in zip(relay, self.peers)]

    def feed(self, h: int) -> None:
        failed = self._ask("feed", h)
        check(not failed, f"height {h}: a relay's send failed or hung: {failed}")

    def height_done(self) -> None:
        now = self._counts()
        self.by_height.append([{k: b[k] - a[k] for k in b} for a, b in zip(self._last, now)])
        self._last = now

    def finish(self) -> dict:
        self.reactor.stop()
        deadline = time.monotonic() + NET_SETTLE_S
        while True:
            counts = self._counts()
            settled = all(c["relay_sent"] == c["follower_received"]
                          and c["follower_sent"] == c["relay_recv_bytes"] for c in counts)
            if settled or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        check(settled, f"bytes sent and received differ on a connection: {counts}")
        recvq = self.sw.recvq_stats()
        check(recvq["consensus_shed"] == 0, f"the follower's demux shed consensus messages: {recvq}")
        relay = self._ask("finish")
        errors = {"follower": self.sw.errors(), "relays": relay["errors"],
                  "gossip_errors": self.reactor.gossip_errors,
                  "maj23_conflicts": self.reactor.maj23_conflicts,
                  "close_errors": relay["close_errors"] + sum(
                      p.mconn.close_errors + p.mconn._conn.close_errors for p in self.peers),
                  "transport_close_errors": self.sw.transport.close_errors}
        flat = [v for d in [errors["follower"], *errors["relays"]] for v in d.values()]
        flat += [errors[k] for k in ("gossip_errors", "maj23_conflicts", "close_errors",
                                     "transport_close_errors")]
        check(not any(flat), f"the network counted errors: {errors}")
        received = relay["received"]
        check(all(set(r) <= {"NewRoundStepMessage"} for r in received),
              f"the follower gossiped to a relay ahead of it: {received}")
        from cometbft_tpu_torch.crypto import compat

        return {"aead_provider": compat.AEAD_PROVIDER, "handshake_ms": self.handshake_ms,
                "bytes": [{"relay_to_follower": c["relay_sent"],
                           "follower_to_relay": c["follower_sent"]} for c in counts],
                "by_height": self.by_height, "recvq": recvq, "errors": errors,
                "relay_received": received}

    def close(self) -> None:
        if self.proc is not None:
            try:
                self.conn.send(("close", None))
            except OSError:
                pass
            self.proc.join(NET_WAIT_S)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()
        if self.sw is not None:
            self.sw.stop()


def net_wire_path(fx, gen, torch_backend, auto, timed: int = NET_TIMED) -> dict:
    """Path (c) in turns with path (b): the counted run of (c) (a recording
    ``TorchBackend()``, the corrupted prevote, every gate of path (b) and
    the wire's); then ``timed`` rounds of (c) and (b) under
    ``TorchBackend()`` and the process default (``auto``), each unrecorded
    and uncorrupted as (b)'s are; the medians of heights 2..CONS_HEIGHTS.
    With ``timed`` 0 (the full run) (c)'s median is the counted run's, and
    (b)'s and the default's are None."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import _build

    plans, bad_plans = wire_plans(fx), wire_plans(fx, CONS_BAD)
    fallbacks = ed25519.scalar_fallbacks
    rec = ConsRecorder(torch_backend, lambda: 0)
    before = dict(_build.LAUNCHES)
    counted = cons_follow(fx, gen, rec, rec, None, corrupt=CONS_BAD, wire=WireFeed(bad_plans))
    launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
    calls = len(rec.calls)
    check(launched == {"ladder": calls, "decompress": calls, "sha512": calls, "sha256": 0,
                       "bn254": 0},
          f"wire follower launches {launched}: expected one sha512 / decompress / ladder set a "
          f"card call ({calls})")
    per = rec.by_height()
    for h, n in counted["prebatched"].items():
        check(per.get(h, {}).get("lanes", 0) >= n,
              f"wire height {h}: {per.get(h)} card lanes for {n} prebatched votes")
    check(sum(bad for *_, bad, _ in rec.calls) >= 1, "the corrupted prevote was not refused")
    runs = {(p, t): [] for p in ("b", "c") for t in ("torch", "auto")}
    wires = []
    # Heights whose next round waited out the commit dwell (cons_follow).
    dwells = [sum(1 for a, b in zip(counted["ms"], counted["full_ms"])
                  if b - a >= 0.9e3 * NET_COMMIT_DWELL_S)]
    order = [("c", "torch"), ("b", "torch"), ("b", "auto"), ("c", "auto")]
    for rep in range(timed):
        for path, tier in order if rep % 2 == 0 else order[::-1]:
            backend = torch_backend if tier == "torch" else auto
            out = cons_follow(fx, gen, backend, wire=WireFeed(plans) if path == "c" else None)
            runs[(path, tier)].append(out["ms"])
            if path == "c":
                wires.append(out["wire"])
                dwells.append(sum(1 for a, b in zip(out["ms"], out["full_ms"])
                                  if b - a >= 0.9e3 * NET_COMMIT_DWELL_S))
    check(ed25519.scalar_fallbacks == fallbacks, "a wire check took the ChainExhausted fallback")
    if not timed:
        runs[("c", "torch")].append(counted["ms"])
    med = {f"{p}_{t}": statistics.median(ms for r in rs for ms in r[1:]) if rs else None
           for (p, t), rs in runs.items()}
    return {"ms_per_height": med, "runs_ms": {f"{p}_{t}": rs for (p, t), rs in runs.items()},
            "counted_ms": counted["ms"], "counted_full_ms": counted["full_ms"],
            "card_by_height": {int(h): v for h, v in sorted(per.items())},
            "prebatched_by_height": dict(counted["prebatched"]), "corrupt": counted["corrupt"],
            "errors": counted["errors"], "wire": counted["wire"],
            "timed_wire_bytes": [w["bytes"] for w in wires], "dwell_hits": dwells,
            "launches": launched,
            "largest": rec.largest, "smallest": rec.smallest}


def net_mesh_nodes(fixtures, timeout_propose: float, transport_of=None) -> list:
    """NET_MESH validators of NET_CHAIN_ID (step 3's first keys, power 10),
    each the port's ConsensusState (``test_config()``'s timeouts, the
    propose timeout given) over the kvstore, a CListMempool and MemDB stores,
    with a ConsensusReactor and a MempoolReactor on a Switch."""
    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.consensus.state import ConsensusState
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.mempool.reactor import MempoolReactor
    from cometbft_tpu_torch.proxy import AppConns, local_client_creator
    from cometbft_tpu_torch.state import BlockExecutor, StateStore, make_genesis_state
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types import Time
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.priv_validator import MockPV

    _, seeds, pubs, *_ = fixtures
    pvs = [MockPV(ed25519.PrivKey(seeds[i] + pubs[i])) for i in range(NET_MESH)]
    gen = GenesisDoc(chain_id=NET_CHAIN_ID, genesis_time=Time(1_700_000_000, 0), validators=[
        GenesisValidator(pv.address(), pv.get_pub_key(), 10, f"v{i}") for i, pv in enumerate(pvs)])
    gen.validate_and_complete()
    nodes = []
    for i, pv in enumerate(pvs):
        state = make_genesis_state(gen)
        conns = AppConns(local_client_creator(KVStoreApplication()))
        conns.start()
        cfg = test_config()
        cfg.consensus.timeout_propose = timeout_propose
        mempool = CListMempool(cfg.mempool, conns.mempool)
        ss, bs = StateStore(MemDB()), BlockStore(MemDB())
        ss.save(state)
        cs = ConsensusState(cfg.consensus, state, BlockExecutor(ss, conns.consensus, mempool, None,
                                                                bs),
                            bs, mempool, name=f"mesh{i}")
        cs.set_priv_validator(pv)
        reactor = ConsensusReactor(cs, gossip_sleep=0.02)  # as tests/test_consensus_tcp.py
        mreactor = MempoolReactor(cfg.mempool, mempool)
        key = net_key(b"mesh-%d" % i)
        sw = net_switch(key, NET_CHAIN_ID, f"mesh{i}",
                        [("CONSENSUS", reactor), ("MEMPOOL", mreactor)], transport_of)
        nodes.append({"cs": cs, "reactor": reactor, "mreactor": mreactor, "sw": sw, "key": key,
                      "mempool": mempool})
    return nodes


def net_mesh_connect(nodes, addrs) -> None:
    for i, n in enumerate(nodes):
        for j in range(i + 1, len(nodes)):
            check(n["sw"].dial_peer(f"{nodes[j]['key'].id}@{addrs[j]}") is not None,
                  f"mesh{i} could not dial mesh{j}")
    deadline = time.monotonic() + NET_WAIT_S
    while any(n["sw"].num_peers() < len(nodes) - 1 for n in nodes):
        check(time.monotonic() < deadline, f"mesh peers {[n['sw'].num_peers() for n in nodes]}")
        time.sleep(0.01)


def net_mesh_errors(nodes) -> dict:
    return {n["cs"].name: {**n["sw"].errors(), "gossip_errors": n["reactor"].gossip_errors,
                           "maj23_conflicts": n["reactor"].maj23_conflicts,
                           "consensus_failures": n["cs"].consensus_failures,
                           "prebatch_errors": n["cs"].prebatch_errors,
                           "check_tx_errors": dict(n["mreactor"].check_tx_errors)}
            for n in nodes}


def net_same_chain(nodes, upto: int, what: str) -> list:
    hashes = []
    for h in range(1, upto + 1):
        got = {n["cs"].block_store.load_block(h).hash() for n in nodes}
        check(len(got) == 1, f"{what}: the nodes' blocks at height {h} differ")
        hashes.append(got.pop().hex())
    return hashes


def net_tcp_mesh(fixtures, backend) -> dict:
    """Path (d): the mesh over TCP (127.0.0.1), NET_MESH_TXS kvstore
    transactions entered at node 0 before the start, to height
    NET_MESH_HEIGHTS under ``set_backend(backend)`` (a recorder: the card
    calls, if any; buckets under 8 take the scalar check). Gates: the same
    block at every height on every node, every transaction committed on
    every node, no error counted (a gossiped duplicate is the mempool's
    ``ErrTxInCache``, expected)."""
    from cometbft_tpu_torch.sidecar import backend as be

    nodes = net_mesh_nodes(fixtures, 0.4)
    txs = [b"chip-mesh-%d=v%d" % (i, i) for i in range(NET_MESH_TXS)]
    be.set_backend(backend)
    try:
        addrs = [n["sw"].start("127.0.0.1:0") for n in nodes]
        net_mesh_connect(nodes, addrs)
        for tx in txs:
            nodes[0]["mempool"].check_tx(tx)
        t0 = time.perf_counter()
        for n in nodes:
            n["cs"].start()
        for n in nodes:
            check(n["cs"].wait_for_height(NET_MESH_HEIGHTS + 1, timeout=NET_WAIT_S),
                  f"tcp mesh: {n['cs'].name} at height {n['cs'].rs.height}")
        ms = (time.perf_counter() - t0) * 1e3 / NET_MESH_HEIGHTS
        deadline = time.monotonic() + NET_WAIT_S

        def committed(n):
            bs = n["cs"].block_store
            return {tx for h in range(1, bs.height() + 1) for tx in bs.load_block(h).data.txs}

        while not all(set(txs) <= committed(n) for n in nodes):
            check(time.monotonic() < deadline, "tcp mesh: a transaction was not committed on "
                  "every node")
            time.sleep(0.05)
        hashes = net_same_chain(nodes, NET_MESH_HEIGHTS, "tcp mesh")
        errors = net_mesh_errors(nodes)
        for name, e in errors.items():
            check(not any(v for k, v in e.items() if k != "check_tx_errors")
                  and set(e["check_tx_errors"]) <= {"ErrTxInCache"},
                  f"tcp mesh: {name} counted errors {e}")
        recvq = [n["sw"].recvq_stats() for n in nodes]
        return {"ms_per_height": ms, "hashes": hashes, "errors": errors, "txs": len(txs),
                "recvq_delivered": [r["delivered_total"] for r in recvq],
                "recvq_shed": [r["shed_total"] for r in recvq]}
    finally:
        for n in nodes:
            n["cs"].stop()
            n["sw"].stop()
        be.set_backend(None)


def net_sim_mesh(fixtures, backend) -> dict:
    """Path (e): the mesh on ``SimTransport`` over one ``SimNetwork`` (wall
    clock; seed NET_SIM_SEED; the simnet's WAN link defaults: a zone-pair
    latency matrix synthesized from the seed, a validator a zone, 10 ms of
    jitter; propose timeout 1 s). Cut 2|2 when node 0 reaches
    NET_SIM_CUT_AT: once what was in flight has landed, no height may
    commit for NET_SIM_HOLD_S. Then ``heal()`` alone for up to
    NET_SIM_HEAL_ONLY_S: whether the chain reached NET_SIM_HEIGHTS, and
    each node's height, round and step, are reported. A partition leaves
    the connections open but silent, and the reactor's PeerState marks
    count the votes lost in the cut as delivered (the reference's fault,
    ROADMAP §3), so where it did not, the cut's connections are dropped and
    dialed again, as a real network's dead TCP sessions are; the chain
    must reach NET_SIM_HEIGHTS with the same blocks on every node."""
    import random

    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.simnet.clock import MonotonicClock
    from cometbft_tpu_torch.simnet.scenario import _synth_zone_latency
    from cometbft_tpu_torch.simnet.transport import SimNetwork, SimTransport

    net = SimNetwork(MonotonicClock(), seed=NET_SIM_SEED, jitter_s=NET_SIM_JITTER_S)
    zl = _synth_zone_latency(random.Random(NET_SIM_SEED), NET_MESH)
    nodes = net_mesh_nodes(fixtures, 1.0, lambda info, key: SimTransport(info, key, net))
    for i in range(NET_MESH):
        for j in range(i + 1, NET_MESH):
            net.set_link(nodes[i]["key"].id, nodes[j]["key"].id, latency_s=zl[i][j] / 1000.0)
    half = NET_MESH // 2
    ids = [n["key"].id for n in nodes]
    be.set_backend(backend)
    try:
        addrs = [n["sw"].start(f"10.0.0.{i + 1}:26656") for i, n in enumerate(nodes)]
        net_mesh_connect(nodes, addrs)
        t0 = time.perf_counter()
        for n in nodes:
            n["cs"].start()
        check(nodes[0]["cs"].wait_for_height(NET_SIM_CUT_AT, timeout=NET_WAIT_S),
              "sim mesh: no progress to the cut")
        before_ms = (time.perf_counter() - t0) * 1e3
        net.partition([ids[:half], ids[half:]])
        time.sleep(0.5)
        held = [n["cs"].block_store.height() for n in nodes]
        time.sleep(NET_SIM_HOLD_S)
        after = [n["cs"].block_store.height() for n in nodes]
        check(after == held, f"sim mesh: heights {held} -> {after} committed during the partition")
        net.heal()
        t1 = time.perf_counter()
        # heal() alone first: the reference's reactor, and so the port's,
        # keeps the votes sent into the cut marked as delivered (ROADMAP §3),
        # so the chain may stay where the cut left it. Reported, not gated.
        heal_only = all(n["cs"].wait_for_height(NET_SIM_HEIGHTS + 1, timeout=max(
            0.0, NET_SIM_HEAL_ONLY_S - (time.perf_counter() - t1))) for n in nodes)
        heal_only_state = [[n["cs"].rs.height, n["cs"].rs.round, int(n["cs"].rs.step)]
                           for n in nodes]
        heal_only_ms = (time.perf_counter() - t1) * 1e3
        t2 = time.perf_counter()  # the redial, where heal() alone fell short
        if not heal_only:
            for i in range(half):  # the cut's connections, dropped from one side
                for j in range(half, NET_MESH):
                    peer = nodes[i]["sw"].get_peer(ids[j])
                    if peer is not None:
                        nodes[i]["sw"].stop_peer_for_error(peer, "partition healed: reconnect")
            deadline = time.monotonic() + NET_WAIT_S
            while any(n["sw"].num_peers() > half - 1 for n in nodes):
                check(time.monotonic() < deadline, "sim mesh: the cut's connections did not close")
                time.sleep(0.01)
            for i in range(half):
                for j in range(half, NET_MESH):
                    check(nodes[i]["sw"].dial_peer(f"{ids[j]}@{addrs[j]}") is not None,
                          f"sim mesh: mesh{i} could not dial mesh{j} again")
        for n in nodes:
            check(n["cs"].wait_for_height(NET_SIM_HEIGHTS + 1, timeout=NET_WAIT_S),
                  f"sim mesh: {n['cs'].name} at height {n['cs'].rs.height} after the heal")
        heal_ms = heal_only_ms if heal_only else (time.perf_counter() - t2) * 1e3
        hashes = net_same_chain(nodes, NET_SIM_HEIGHTS, "sim mesh")
        return {"to_cut_ms": before_ms, "held_heights": held, "hold_s": NET_SIM_HOLD_S,
                "heal_to_height_ms": heal_ms, "heal_only_recovered": heal_only,
                "heal_only_ms": heal_only_ms, "heal_only_state": heal_only_state,
                "hashes": hashes, "stats": dict(net.stats),
                "errors": net_mesh_errors(nodes),
                "peer_errors_from_the_reconnect": sum(n["sw"].peer_errors for n in nodes)}
    finally:
        for n in nodes:
            n["cs"].stop()
            n["sw"].stop()
        be.set_backend(None)


def drive_network_path(fixtures, sources, torch_backend, dev, fx=None,
                       timed: int = NET_TIMED) -> dict:
    """The network phase (module docstring, step 19): paths (c) (with
    ``timed`` rounds of (b) and (c) under each backend), (d) and (e), the
    launch counts of the whole drive, the verify kernels at (c)'s
    batches."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    source = sources["10k"]
    if fx is None:
        t0 = time.perf_counter()
        fx = cons_follow_fixtures(source, fixtures)
        print(f"network fixtures: path (b)'s {CONS_HEIGHTS} heights in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    auto = None
    if timed:
        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                     CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            auto = be._make_backend()
    try:
        _build.reset_launches()
        wire = net_wire_path(fx, source["gen"], torch_backend, auto, timed)
        stamp("network: the TCP mesh")
        mesh_rec = ConsRecorder(torch_backend, lambda: 0)
        mesh = net_tcp_mesh(fixtures, mesh_rec)
        mesh["card_calls"] = len(mesh_rec.calls)
        stamp("network: the SimTransport mesh")
        sim_rec = ConsRecorder(torch_backend, lambda: 0)
        sim = net_sim_mesh(fixtures, sim_rec)
        sim["card_calls"] = len(sim_rec.calls)
        launches = dict(_build.LAUNCHES)
    finally:
        if auto is not None:
            auto.close()
    check(all(launches[k] > 0 for k in ("sha512", "decompress", "ladder")),
          f"network path launches {launches}")
    batches = {}
    for label, trip in (("wire_largest", wire.pop("largest")),
                        ("wire_smallest", wire.pop("smallest"))):
        batches[f"{label}_{len(trip[0])}"] = corrupt_four(*trip)
    kernels = bsync_window_kernels(batches, dev)
    return {"launches": launches, "wire": wire, "tcp_mesh": mesh, "sim_mesh": sim,
            "kernels": kernels}


def network_phase(fixtures, sources, backend, dev, card, records, fx=None,
                  timed: int = NET_TIMED) -> dict:
    """Runs the network path (step 19), prints its metrics and gates, merges
    its kernel comparisons into ``records``; returns its launches. With
    ``timed`` 0 (the full run) ``consensus_10k_wire_ms_per_height`` is the
    counted run's and ``consensus_10k_ms_per_height`` the consensus
    phase's; ``--network`` times NET_TIMED rounds under each backend."""
    start = time.perf_counter()
    out = drive_network_path(fixtures, sources, backend, dev, fx, timed)
    for k in ("sha512", "decompress", "ladder"):
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    wire, mesh, sim = out["wire"], out["tcp_mesh"], out["sim_mesh"]
    w = wire["wire"]
    print(f"network path ok (the follower committed the {N_SIGS}-validator source's heights "
          f"1-{CONS_HEIGHTS} from {NET_PEERS} relays over TCP, its corrupted prevote refused, "
          f"bytes sent equal bytes received on every connection; AEAD {w['aead_provider']}; the "
          f"{NET_MESH}-validator mesh to height {NET_MESH_HEIGHTS} over TCP with every "
          f"transaction committed, and on SimTransport halted in the 2|2 cut, then "
          + (f"healed by heal() alone to height {NET_SIM_HEIGHTS}" if sim["heal_only_recovered"]
             else f"left by heal() alone at {sim['heal_only_state']} for "
                  f"{NET_SIM_HEAL_ONLY_S:.0f} s, redialed to height {NET_SIM_HEIGHTS}")
          + f"); launches {out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    med = wire["ms_per_height"]
    if timed:
        print(json.dumps({"metric": "consensus_10k_ms_per_height", "value": med["b_torch"],
                          "validators": N_SIGS, "heights": CONS_HEIGHTS,
                          "by_backend": {"torch": med["b_torch"], "auto": med["b_auto"]},
                          "runs_ms": {"torch": wire["runs_ms"]["b_torch"],
                                      "auto": wire["runs_ms"]["b_auto"]},
                          "timed_in": "the network phase, in turns with path (c)", **common}),
              flush=True)
    print(json.dumps({"metric": "consensus_10k_wire_ms_per_height", "value": med["c_torch"],
                      "from": "timed runs" if timed else "the counted run (a recording backend)",
                      "validators": N_SIGS, "heights": CONS_HEIGHTS, "peers": NET_PEERS,
                      "by_backend": {"torch": med["c_torch"], "auto": med["c_auto"]},
                      "path_b_ms_per_height": {"torch": med["b_torch"], "auto": med["b_auto"]},
                      "wire_minus_b_ms": {t: med[f"c_{t}"] - med[f"b_{t}"]
                                          for t in ("torch", "auto")
                                          if None not in (med[f"c_{t}"], med[f"b_{t}"])},
                      "runs_ms": wire["runs_ms"], "counted_ms": wire["counted_ms"],
                      "dwell_hits": wire["dwell_hits"], "aead_provider": w["aead_provider"], "handshake_ms": w["handshake_ms"],
                      **common}), flush=True)
    print(json.dumps({"wire_by_height": w["by_height"], "wire_bytes": w["bytes"],
                      "recvq_stats": w["recvq"], "relay_received": w["relay_received"],
                      "card_by_height": wire["card_by_height"],
                      "prebatched_by_height": wire["prebatched_by_height"], **common}), flush=True)
    print(json.dumps({"metric": "tcp_mesh_4_ms_per_height", "value": mesh["ms_per_height"],
                      **mesh, **common}), flush=True)
    print(json.dumps({"metric": "sim_mesh_4_heal_ms", "value": sim["heal_to_height_ms"], **sim,
                      **common}), flush=True)
    print(json.dumps({"network": {"wire": {k: v for k, v in wire.items() if k not in (
        "wire", "runs_ms", "card_by_height", "prebatched_by_height")},
        "kernels": out["kernels"], "launches": out["launches"]},
        "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"]


def network_only(card, dev) -> int:
    """``--network``: the keys, the 10,240-validator blocksync source, path
    (b)'s fixtures and the network phase alone (a quick check of that phase
    on the card; no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    big = bsync_10k_source(fixtures, backend)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    launches = network_phase(fixtures, {"10k": big}, backend, dev, card, records)
    print(json.dumps({"network_launches": launches, "max_abs_err": records}), flush=True)
    return 0


# -- the RPC path ----------------------------------------------------------------

# (f) The Handshaker over the 10,240-validator blocksync source; (g) a light
# client over HTTP against the port's JSONRPCServer in a process of its own;
# (h) a one-validator chain served over RPC, in this process.
RPC_PER_PAGE = 100  # HTTPProvider's page: 103 /validators calls a light block at 10,240
RPC_NOW_S = BSYNC_T0 + 3_600
RPC_WAIT_S = 300.0
RPC_CHAIN_ID = "chip-smoke-rpc"
RPC_TXS = BSYNC_TXS  # (h)'s first block: the source chain's transactions a block
RPC_COMMIT_TXS = 3  # then a block each through broadcast_tx_commit
RPC_PROOF_STRIDE = 64  # every 64th tx?prove=true answer of the first block over HTTP (~63 ms each)
RPC_NATIVE_STRIDE = 64  # ... and every 64th again by the native pass, which must agree
RPC_QUERY_KEYS = 16  # proven abci_query answers, each on the card and natively
APP_HASH_TEXT = ("app hash {got} does not match state app hash {want} after replay. "
                 "Did you reset CometBFT without resetting the application?")


def rpc_tx(i: int) -> bytes:
    """(h)'s kvstore transactions: ``key=value``, 48 bytes."""
    head = b"rpc%05d=" % i
    return head + hashlib.sha256(head).hexdigest().encode()[: 48 - len(head)]


def rpc_db(items):
    """A MemDB under a BlockStore and a StateStore holding ``items``."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.state import StateStore
    from cometbft_tpu_torch.store import BlockStore

    db = MemDB()
    for k, v in items:
        db.set(k, v)
    return db, BlockStore(db), StateStore(db)


def rpc_reindex(bs, ss, tx_ix, blk_ix) -> int:
    """The reference's ``reindex-event`` (``cmd/__main__.py``): both indexes
    rebuilt from the block store and the stored ABCI responses (replay
    through the app publishes no event). Returns the transactions indexed."""
    from cometbft_tpu_torch.state.execution import decode_responses
    from cometbft_tpu_torch.types.events import _abci_events_to_attrs

    n = 0
    for h in range(max(bs.base(), 1), bs.height() + 1):
        block, resp = bs.load_block(h), decode_responses(ss.load_abci_responses(h))
        blk_ix.index(h, _abci_events_to_attrs(list(resp["begin_block"].events)
                                              + list(resp["end_block"].events)))
        for i, tx in enumerate(block.data.txs):
            res = resp["deliver_txs"][i]
            tx_ix.index(h, i, tx, res, _abci_events_to_attrs(res.events))
            n += 1
    return n


def rpc_restart(source, torch_backend) -> dict:
    """(f): the Handshaker over copies of the source's stores, with a fresh
    PersistentKVStoreApplication, a fresh event bus and fresh KV indexers.
    Each case runs twice on fresh copies: bare (its ``ms``, the metric: no
    stage wrapper, only a recorder around the backend) and then
    instrumented (its ``stages``: StageTimer wrappers, a synchronize only
    around stages that reach the card). (i) The app wiped (app 0, state =
    store = 6): every block replayed through the app, no backend call; the
    source's app hash and state; the indexes rebuilt (``rpc_reindex``) hold
    every transaction; the same app with a doctored app hash raises
    AppHashMismatchError with the reference's text. (ii) The crash after
    ``save_block`` and before the state save (store 6, state 5, the app
    brought to 5 by replaying blocks 1-5 through it): the last block through
    ``apply_block``, whose ``validate_block`` verifies its 10,240-signature
    LastCommit on the card in one call; the source's app hash and state; the
    IndexerService indexes its 4,096 transactions from the bus; ``stop()``
    leaves no pump behind."""
    from cometbft_tpu_torch import convert
    from cometbft_tpu_torch.abci.example.kvstore import PersistentKVStoreApplication
    from cometbft_tpu_torch.consensus import replay
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.proxy import AppConns, local_client_creator
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.state import store as state_store
    from cometbft_tpu_torch.state.txindex import IndexerService, KVBlockIndexer, KVTxIndexer
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.events import EventBus
    from cometbft_tpu_torch.types.tx import tx_hash

    gen, items = source["gen"], list(source["node"]["db"].iterator())
    want_state, want_hash = source["states"][-1], source["state"].app_hash
    check(source["node"]["block_store"].height() == len(source["states"]) == BSYNC_HEIGHTS,
          f"restart: the source is at {source['node']['block_store'].height()}")
    out = {}

    def app_conns():
        conns = AppConns(local_client_creator(PersistentKVStoreApplication()))
        conns.start()
        return conns

    def handshake(hs, conns, stages) -> tuple:
        with stages if stages is not None else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = hs.handshake(conns)
            torch.cuda.synchronize()
            return st, (time.perf_counter() - t0) * 1e3

    def case_i(instrument: bool):
        """(i) on fresh copies: the state, the app, the stores and the ms."""
        _, bs, ss = rpc_db(items)
        conns = app_conns()
        rec = LightRecorder(torch_backend)
        stages = StageTimer().wrap(bs, "load_block", "load_block", sync=False).wrap(
            ss, "load_validators", "load_validators", sync=False).wrap(
            replay, "build_last_commit_info", "build_last_commit_info", sync=False).wrap(
            conns.consensus, "deliver_tx", "deliver_tx", sync=False).wrap(
            conns.consensus, "commit", "app_commit", sync=False) if instrument else None
        be.set_backend(rec)
        ed25519._verified.clear()
        try:
            hs = replay.Handshaker(ss, ss.load(), bs, gen, event_bus=EventBus())
            st, ms = handshake(hs, conns, stages)
        finally:
            be.set_backend(None)
        app = conns.query._app
        check(state_store._encode_state(st) == want_state and app.app_hash == want_hash
              and hs.n_blocks == BSYNC_HEIGHTS and app.height == BSYNC_HEIGHTS
              and state_store._encode_state(ss.load()) == want_state,
              f"restart (i): state at {st.last_block_height}, app at {app.height} "
              f"({app.app_hash.hex()} vs {want_hash.hex()}), {hs.n_blocks} blocks replayed")
        check(rec.calls == [], f"restart (i): replay through the app called the backend "
                               f"{rec.calls}")
        return {"ms": ms, "replayed": hs.n_blocks, "stages": stages}, bs, ss, conns

    # (i) the app wiped: the bare run, then the instrumented one.
    bare, bs, ss, conns = case_i(False)
    split = case_i(True)[0]
    tx_ix, blk_ix = KVTxIndexer(MemDB()), KVBlockIndexer(MemDB())
    t0 = time.perf_counter()
    n_indexed = rpc_reindex(bs, ss, tx_ix, blk_ix)
    reindex_ms = (time.perf_counter() - t0) * 1e3
    hashes = [tx_hash(tx) for h in range(1, BSYNC_HEIGHTS + 1) for tx in bs.load_block(h).data.txs]
    check(n_indexed == len(hashes) == BSYNC_HEIGHTS * BSYNC_TXS
          and all(tx_ix._db.get(b"tx:" + h) is not None for h in hashes)
          and blk_ix.search("block.height>=1") == list(range(1, BSYNC_HEIGHTS + 1)),
          f"restart (i): {n_indexed} of {BSYNC_HEIGHTS * BSYNC_TXS} transactions indexed")
    app = conns.query._app
    bad = b"\x00" * len(want_hash)
    app.app_hash = bad
    try:
        replay.Handshaker(ss, ss.load(), bs, gen).handshake(conns)
        check(False, "restart: a wrong app hash was accepted")
    except replay.AppHashMismatchError as e:
        want_text = APP_HASH_TEXT.format(got=bad.hex(), want=want_hash.hex())
        check(str(e) == want_text, f"restart: the mismatch reads {str(e)!r}, not {want_text!r}")
        mismatch = {"type": type(e).__name__, "text": str(e)}
    out["i"] = {"ms": bare["ms"], "replayed": bare["replayed"],
                "instrumented_ms": split["ms"], "stages": split["stages"].table(),
                "indexed": n_indexed, "reindex_ms": reindex_ms, "mismatch": mismatch}

    def case_ii(instrument: bool):
        """(ii) on fresh copies, with the IndexerService on the bus."""
        _, bs2, ss2 = rpc_db(items)
        state5 = convert.state_from_store_bytes(source["states"][-2])
        ss2.save(state5)
        conns2 = app_conns()
        warm = replay.Handshaker(ss2, state5, bs2, gen)
        warm._init_chain(state5, conns2)
        warm._replay_blocks_through_app(state5, conns2, 0, BSYNC_HEIGHTS - 1)
        app2 = conns2.query._app
        check(app2.height == BSYNC_HEIGHTS - 1, f"restart (ii): the app at {app2.height}")
        bus = EventBus()
        bus.start()
        tx_ix2, blk_ix2 = KVTxIndexer(MemDB()), KVBlockIndexer(MemDB())
        indexer = IndexerService(tx_ix2, blk_ix2, bus)
        indexer.start()
        rec2 = LightRecorder(torch_backend, keep=instrument)
        stages = StageTimer().wrap(BlockStore, "load_block", "load_block", sync=False).wrap(
            replay.BlockExecutor, "apply_block", "apply_block").wrap(
            replay.BlockExecutor, "validate_block", "validate_block").wrap(
            rec2, "batch_verify", "backend_call") if instrument else None
        be.set_backend(rec2)
        ed25519._verified.clear()
        try:
            hs2 = replay.Handshaker(ss2, ss2.load(), bs2, gen, event_bus=bus)
            st2, ms = handshake(hs2, conns2, stages)
        finally:
            be.set_backend(None)
        check(state_store._encode_state(st2) == want_state and app2.app_hash == want_hash
              and hs2.n_blocks == 1 and state_store._encode_state(ss2.load()) == want_state,
              f"restart (ii): state at {st2.last_block_height}, app {app2.app_hash.hex()}, "
              f"{hs2.n_blocks} blocks replayed")
        check([c["lanes"] for c in rec2.calls] == [N_SIGS],
              f"restart (ii): backend calls {[c['lanes'] for c in rec2.calls]}, expected one "
              f"of {N_SIGS} lanes (the LastCommit)")
        last = [tx_hash(tx) for tx in bs2.load_block(BSYNC_HEIGHTS).data.txs]
        deadline = time.monotonic() + RPC_WAIT_S
        while not (all(tx_ix2._db.get(b"tx:" + h) is not None for h in last[-1:])
                   and blk_ix2.search("block.height>=1") == [BSYNC_HEIGHTS]):
            check(time.monotonic() < deadline, "restart (ii): the indexer did not catch up")
            time.sleep(0.05)
        pumps = list(indexer._threads)
        check(len(pumps) == 2, f"restart (ii): the IndexerService runs {len(pumps)} pumps")
        indexer.stop()
        check(not any(t.is_alive() for t in pumps) and bus.num_clients() == 0,
              "restart (ii): an indexer pump outlived stop()")
        check(all(tx_ix2._db.get(b"tx:" + h) is not None for h in last)
              and len([k for k, _ in tx_ix2._db.iterator(b"tx:", b"tx;")]) == BSYNC_TXS,
              "restart (ii): the IndexerService missed transactions of the final block")
        bus.stop()
        return {"ms": ms, "replayed": hs2.n_blocks, "stages": stages,
                "card_calls": [c["lanes"] for c in rec2.calls],
                "backend_ms": [c["ms"] for c in rec2.calls], "indexed": len(last)}, rec2

    # (ii) the crash after save_block, before the state save: bare, then instrumented.
    bare2, _ = case_ii(False)
    split2, rec2 = case_ii(True)
    out["ii"] = {**bare2, "instrumented_ms": split2["ms"], "stages": split2["stages"].table(),
                 "instrumented_backend_ms": split2["backend_ms"]}
    out["index_items"] = list(tx_ix._db.iterator()) + list(blk_ix._db.iterator())
    out["final_block"] = rec2.triples[0]
    return out


def rpc_doctored_commit(honest, bs, doctored_height: int = 0):
    """A /commit route whose commit at ``doctored_height`` (the tip where 0)
    carries its first signature with one bit flipped."""

    def commit(height=None):
        out = honest(height=height)
        if int(out["signed_header"]["header"]["height"]) == (doctored_height or bs.height()):
            sig = out["signed_header"]["commit"]["signatures"][0]
            raw = base64.b64decode(sig["signature"])
            sig["signature"] = base64.b64encode(bytes([raw[0] ^ 0x01]) + raw[1:]).decode()
        return out

    return commit


def rpc_serve_main(conn, doctored_height: int = 0) -> None:
    """(g)'s node, in a process of its own (so that its server threads do
    not hold the client's interpreter lock), started before (f) and sent
    (f)'s indexes when (f) is done: the port's JSONRPCServer on 127.0.0.1:0
    serving ``routes(Environment(...))`` over the source's stores and
    indexes (their items, the genesis, from the pipe), and a second one
    whose /commit is doctored at ``doctored_height`` (the tip where 0;
    ``rpc_doctored_commit``). Sends the two ports, then serves until
    ``close``."""
    servers = []
    try:
        items, index_items, gen_json = conn.recv()
        from cometbft_tpu_torch import convert
        from cometbft_tpu_torch.config import test_config
        from cometbft_tpu_torch.rpc.core import Environment, routes
        from cometbft_tpu_torch.rpc.jsonrpc.server import JSONRPCServer
        from cometbft_tpu_torch.types.genesis import GenesisDoc

        _, bs, ss = rpc_db(items)
        tx_ix, blk_ix = convert.indexers_from_items(index_items)
        gen = GenesisDoc.from_json(gen_json)
        honest = routes(Environment(config=test_config(), state_store=ss, block_store=bs,
                                    genesis_doc=gen, tx_indexer=tx_ix, block_indexer=blk_ix,
                                    node_info={"moniker": "chip-smoke-rpc",
                                               "network": gen.chain_id}))
        doctored = dict(honest, commit=rpc_doctored_commit(honest["commit"], bs, doctored_height))
        for table in (honest, doctored):
            srv = JSONRPCServer(table, host="127.0.0.1", port=0)
            srv.start()
            servers.append(srv)
        conn.send({"ports": [s.port for s in servers]})
        while conn.recv() != "close":
            pass
    except Exception as e:  # reported to the parent, which fails the run
        conn.send({"error": repr(e)})
    finally:
        for srv in servers:
            srv.stop()
        conn.close()


def rpc_route_split(stages: StageTimer) -> dict:
    """A light sync's stage table with each route's JSON decode: its
    ``HTTPClient.call`` (``{route}_call``) less its HTTP exchange
    (``{route}_http``, ``HTTPClient._post``)."""
    table = stages.table()
    for key in [k for k in table if k.endswith("_call")]:
        route = key[: -len("_call")]
        table[f"{route}_json_decode"] = {
            "ms": table[key]["ms"] - table.get(f"{route}_http", {}).get("ms", 0.0),
            "calls": table[key]["calls"]}
    return table


def rpc_light_sync(url: str, anchor, backend, witness: bool = True):
    """The port's light client over ``HTTPProvider(chain_id, HTTPClient(url))``
    as primary and witness, trusting height 1 (the light block ``anchor``,
    already in its store, as after a first start: the anchor's own fetch, a
    third light block of 103 pages, is left out), from a cold cache, synced
    to the tip under ``set_backend(backend)``: its construction and
    ``verify_light_block_at_height``, timed together. The port's
    ``HTTPClient`` is timed by route for the run (StageTimer, no
    synchronize: ``call``, and inside it ``_post``, the HTTP exchange with
    its bytes), as is ``HTTPProvider.light_block``. Returns the wall ms,
    the trace (height, signed header bytes, validator set hash), the client
    and its stages."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import HTTPProvider
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Time

    def provider():
        return HTTPProvider(BSYNC_CHAIN_ID, HTTPClient(url, timeout=RPC_WAIT_S))

    store = LightStore(MemDB())
    store.save_light_block(anchor)
    stages = StageTimer().wrap(
        HTTPProvider, "light_block", "provider_light_block", sync=False).wrap(
        HTTPClient, "call", lambda _c, method: f"{method}_call", sync=False).wrap(
        HTTPClient, "_post", lambda _c, method, _p: f"{method}_http", sync=False,
        count_bytes=True)
    be.set_backend(backend)
    ed25519._verified.clear()
    try:
        with stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            client = Client(BSYNC_CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, 1, anchor.hash()),
                            provider(), [provider()] if witness else [], store)
            lb = client.verify_light_block_at_height(BSYNC_HEIGHTS, Time(RPC_NOW_S, 0))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        be.set_backend(None)
    check(lb.height == BSYNC_HEIGHTS, f"the HTTP light client synced to {lb.height}")
    trace = [(h, client.store.light_block(h).signed_header.encode(),
              client.store.light_block(h).validator_set.hash()) for h in client.store._heights()]
    return {"ms": wall, "trace": trace, "client": client, "stages": stages}


def rpc_server_start(doctored_height: int = 0) -> tuple:
    """(g)'s server process (``rpc_serve_main``), started: (the process,
    the pipe). It imports while (f) runs."""
    return spawn(rpc_serve_main, doctored_height)


def rpc_light_path(source, index_items, torch_backend, sync_reps: int, started) -> dict:
    """(g): the node in its own process (``rpc_server_start``'s
    ``started``, sent the stores' and indexes' items here); the counted
    sync under a recording ``TorchBackend()`` (every verify launch from the
    device-owner thread, three a card call), its trace equal to a
    BlockStoreProvider client's over the same stores, the doctored tip
    refused with the reference's error (one fetch), then ``sync_reps``
    rounds of the default's sync (built only then), in turns with
    TorchBackend()'s after the first (the counted run is its first), each
    with its stage split."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import BlockStoreProvider
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Time

    node = source["node"]
    items = list(node["db"].iterator())
    anchor = BlockStoreProvider(BSYNC_CHAIN_ID, node["block_store"], node["state_store"]) \
        .light_block(1)
    proc, conn = started
    out = {}
    try:
        t0 = time.perf_counter()  # the server's start from its stores' items
        conn.send((items, index_items, source["gen"].to_json()))
        check(conn.poll(RPC_WAIT_S), "the RPC server process did not start")
        hello = conn.recv()
        check("error" not in hello, f"the RPC server process failed: {hello.get('error')}")
        out["server_start_s"] = time.perf_counter() - t0
        honest, doctored = (f"http://127.0.0.1:{p}" for p in hello["ports"])

        # The counted sync, and the BlockStoreProvider sync it must equal.
        rec = LightRecorder(torch_backend, keep=True)
        threads_seen = collections.Counter()
        orig_check = _build.check_launch

        def check_launch(kernel, rc):
            threads_seen[(kernel, threading.current_thread().name)] += 1
            return orig_check(kernel, rc)

        before = dict(_build.LAUNCHES)
        _build.check_launch = check_launch
        try:
            counted = rpc_light_sync(honest, anchor, rec)
        finally:
            _build.check_launch = orig_check
        launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
        calls = len(rec.calls)
        check(calls > 0 and launched == {"sha512": calls, "decompress": calls, "ladder": calls,
                                         "sha256": 0, "bn254": 0},
              f"HTTP light sync: launches {launched} for {calls} card calls")
        check({t for (_, t) in threads_seen} <= {"cmtpu-torch-dev"},
              f"HTTP light sync: kernels launched from {dict(threads_seen)}")
        c = counted["client"]
        check(c.speculation["errors"] == 0 and c.detector_errors == 0,
              f"HTTP light sync: speculation errors {c.speculation['errors']}, detector errors "
              f"{c.detector_errors}")
        be.set_backend(torch_backend)
        try:
            store_client = Client(BSYNC_CHAIN_ID, TrustOptions(TRUSTING_PERIOD_NS, 1, anchor.hash()),
                                  BlockStoreProvider(BSYNC_CHAIN_ID, node["block_store"],
                                                     node["state_store"]),
                                  [], LightStore(MemDB()))
            store_client.verify_light_block_at_height(BSYNC_HEIGHTS, Time(RPC_NOW_S, 0))
        finally:
            be.set_backend(None)
        store_trace = [(h, store_client.store.light_block(h).signed_header.encode(),
                        store_client.store.light_block(h).validator_set.hash())
                       for h in store_client.store._heights()]
        check(counted["trace"] == store_trace and len(store_trace) >= 2,
              f"HTTP light sync: trace {[t[0] for t in counted['trace']]} differs from the "
              f"BlockStoreProvider client's {[t[0] for t in store_trace]}")
        pages = len(counted["stages"].ms["validators_http"])
        check(pages % -(-N_SIGS // RPC_PER_PAGE) == 0,
              f"HTTP light sync: {pages} /validators pages, not a multiple of "
              f"{-(-N_SIGS // RPC_PER_PAGE)}")
        out["counted"] = {"ms": counted["ms"], "stages": rpc_route_split(counted["stages"]),
                          "card_calls": [x["lanes"] for x in rec.calls],
                          "backend_ms": [x["ms"] for x in rec.calls], "launches": launched,
                          "launch_threads": {f"{k}@{t}": n for (k, t), n in threads_seen.items()},
                          "heights": [t[0] for t in counted["trace"]],
                          "validators_pages": pages}
        triples = sorted(rec.triples, key=lambda t: len(t[0]))
        out["largest"], out["smallest"] = triples[-1], triples[0]

        # The doctored tip: one flipped signature bit, refused.
        tip_sig = node["block_store"].load_seen_commit(BSYNC_HEIGHTS).signatures[0].signature
        flipped = bytes([tip_sig[0] ^ 0x01]) + tip_sig[1:]
        try:
            rpc_light_sync(doctored, anchor, torch_backend, witness=False)
            check(False, "HTTP light sync: the doctored tip commit was accepted")
        except Exception as e:  # noqa: BLE001 - the refusal is checked below
            # A set that never changes: the trusting check meets the bad lane
            # first (tests/test_torch_rpc.py: the reference's error too).
            want = ("ValueError", f"wrong signature (#0): {flipped.hex().upper()}")
            check((type(e).__name__, str(e)) == want,
                  f"HTTP light sync: the doctored tip raised {type(e).__name__}: {e}")
            out["doctored"] = {"type": type(e).__name__, "text": str(e)}

        # The timed syncs, in turns: the counted run is TorchBackend()'s first
        # (its recorder adds a synchronize a backend call).
        runs = {"torch": [counted["ms"]], "auto": []}
        splits = {"torch": rpc_route_split(counted["stages"])}
        if sync_reps:
            with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                         CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
                auto = be._make_backend()
            try:
                for rnd in range(sync_reps):
                    order = [("torch", torch_backend)] if rnd else []
                    for label, bk in order + [("auto", auto)]:
                        r = rpc_light_sync(honest, anchor, bk)
                        check(r["trace"] == store_trace,
                              f"HTTP light sync ({label}): trace differs")
                        runs[label].append(r["ms"])
                        splits[label] = rpc_route_split(r["stages"])
            finally:
                auto.close()
        out["runs_ms"] = runs
        out["ms"] = {k: statistics.median(v) for k, v in runs.items() if v}
        out["stages"] = splits
        conn.send("close")
    finally:
        proc.join(RPC_WAIT_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
        conn.close()
    check(proc.exitcode == 0, f"the RPC server process exited {proc.exitcode}")
    return out


def rpc_verify_tx_answer(ans: dict, data_hash: bytes, tx: bytes) -> None:
    """A ``tx?prove=true`` answer's proof, decoded from its JSON, against the
    block's data hash (``TxProof.validate``)."""
    from cometbft_tpu_torch.rpc.json_codec import tx_proof_from_json

    tp = tx_proof_from_json(ans["proof"])
    check(tp.data == tx, "tx?prove=true: the proof is of another transaction")
    tp.validate(data_hash)


def rpc_node_path(torch_backend, tmpdir: str) -> dict:
    """(h): a one-validator chain, a port ``Node`` (``node/node.py``) built
    by ``default_new_node`` from a home under ``tmpdir`` written by the
    port's own functions (``node_home``: config.toml from ``test_config()``
    with RPC on 127.0.0.1:0 and no p2p listener, the genesis, a FilePV, a
    node key), with a provable kvstore: the WAL, the event bus, the KV
    indexers behind IndexerService, the ingress (legacy transactions pass
    it to CListMempool) and JSONRPCServer. RPC_TXS transactions through
    ``broadcast_tx_async`` over HTTP before the first height (consensus is
    held back while ``start()`` brings the rest up, so that it carries them
    all), a websocket subscribed to NewBlock, then RPC_COMMIT_TXS through
    ``broadcast_tx_commit``. Under
    ``CMTPU_DEVICE_PROOFS=1`` the card's proof set of the first block (the
    one its tx route computes) holds every proof, each verified against the
    header's data hash, and every RPC_PROOF_STRIDE-th ``tx?prove=true``
    answer over HTTP (~63 ms each) comes from the card and verifies, every
    RPC_NATIVE_STRIDE-th equal to the native pass's answer; proven
    ``abci_query`` answers verify through ``default_proof_runtime()`` against
    the next header's app hash, each equal to the native pass's. Two sha256
    launches a proof set on the card, none else."""
    from cometbft_tpu_torch.abci.example.kvstore import KVStoreApplication
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.crypto.merkle.proof_op import ProofOp, ProofOps, default_proof_runtime
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from cometbft_tpu_torch.rpc.jsonrpc.ws_client import WSClient
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Time
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.tx import tx_hash

    home = os.path.join(tmpdir, "rpc-node")
    cfg = node_config(p2p__laddr="")
    pv = node_home(home, cfg, b"chip-smoke-rpc-validator")
    gen = GenesisDoc(chain_id=RPC_CHAIN_ID, genesis_time=Time(BSYNC_T0, 0), validators=[
        GenesisValidator(pv.address(), pv.get_pub_key(), 10, "validator")])
    gen.validate_and_complete()
    node_genesis(cfg, gen.to_json())
    node = node_load(home, app=KVStoreApplication(provable=True))
    cs, bs, tx_ix = node.consensus_state, node.block_store, node.tx_indexer
    hold_start, cs.start = cs.start, lambda: None  # consensus waits for the txs below
    before = set(threading.enumerate())
    try:
        node.start()
    finally:
        cs.start = hold_start
    rpc = HTTPClient(f"http://127.0.0.1:{node.rpc_port}", timeout=RPC_WAIT_S)
    ws = WSClient(node.rpc_port, timeout=RPC_WAIT_S)
    app = node.proxy_app.query._app
    rec = LightRecorder(torch_backend)
    device_sets = []
    proof_threads = collections.Counter()  # the caller's thread of each card proof set
    launch_threads = collections.Counter()  # (kernel, launching thread) of each launch
    orig_device, orig_check = mk.proofs_from_byte_slices_device, _build.check_launch

    def counted_device(items, device=None):
        device_sets.append(len(items))
        proof_threads[threading.current_thread().name] += 1
        return orig_device(items, device)

    def check_launch(kernel, rc):
        launch_threads[(kernel, threading.current_thread().name)] += 1
        return orig_check(kernel, rc)

    seen, ws_error = [], []

    def ws_reader():
        try:
            while True:
                msg = ws.recv()
                h = int(msg["result"]["data"]["value"]["block"]["header"]["height"])
                seen.append((h, time.perf_counter()))
        except (ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001 - reported by the gate below
            ws_error.append(repr(e))

    out = {}
    be.set_backend(rec)
    mk.proofs_from_byte_slices_device = counted_device
    _build.check_launch = check_launch
    reader = None
    try:
        ws.send({"jsonrpc": "2.0", "id": 0, "method": "subscribe",
                 "params": {"query": "tm.event='NewBlock'"}})
        check(ws.recv().get("result") == {}, "websocket: the subscription failed")
        reader = threading.Thread(target=ws_reader, name="rpc-ws", daemon=True)
        reader.start()
        txs = [rpc_tx(i) for i in range(RPC_TXS)]
        t0 = time.perf_counter()
        for tx in txs:
            check(rpc.broadcast_tx_async(tx)["code"] == 0, "broadcast_tx_async refused a tx")
        out["broadcast_async_ms_per_tx"] = (time.perf_counter() - t0) * 1e3 / len(txs)
        check(node.ingress.flush_queue(RPC_WAIT_S), "the ingress did not drain its lanes")
        deadline = time.monotonic() + RPC_WAIT_S
        while node.mempool.size() < RPC_TXS:  # the ingress hands them on from its dispatcher
            check(time.monotonic() < deadline,
                  f"the mempool holds {node.mempool.size()} of {RPC_TXS}")
            time.sleep(0.005)
        out["ingress_admitted_ms"] = (time.perf_counter() - t0) * 1e3
        start = time.perf_counter()
        with node.threads.scope():  # consensus's threads join the node's, as in start()
            cs.start()
        deadline = time.monotonic() + RPC_WAIT_S
        while bs.height() < 1:  # the first height reaps the mempool whole
            check(time.monotonic() < deadline, "the one-validator chain made no block")
            time.sleep(0.005)
        commits = []
        for i in range(RPC_COMMIT_TXS):
            tx = b"rpc-commit-%d=done" % i
            t1 = time.perf_counter()
            res = rpc.broadcast_tx_commit(tx)
            commits.append({"ms": (time.perf_counter() - t1) * 1e3, "height": int(res["height"]),
                            "check": res["check_tx"]["code"], "deliver": res["deliver_tx"]["code"]})
            txs.append(tx)
            not_found = 0
            while True:  # the indexer runs behind the Tx event broadcast_tx_commit waits on
                try:
                    rpc.tx(tx_hash(tx))
                    break
                except RPCClientError as e:
                    check("not found" in str(e), f"tx: {e}")
                    not_found += 1
                    time.sleep(0.002)
            commits[-1]["tx_not_yet_indexed"] = not_found
        check(all(c["check"] == 0 and c["deliver"] == 0 for c in commits),
              f"broadcast_tx_commit: {commits}")
        first = bs.load_block(1)
        check(len(first.data.txs) == RPC_TXS, f"height 1 carries {len(first.data.txs)} txs")
        deadline = time.monotonic() + RPC_WAIT_S
        while not all(tx_ix._db.get(b"tx:" + tx_hash(tx)) is not None for tx in txs):
            check(time.monotonic() < deadline, "the indexer did not index every transaction")
            time.sleep(0.05)
        data_hash = bytes.fromhex(rpc.header(1)["header"]["data_hash"])
        launches0 = dict(_build.LAUNCHES)
        with environ(CMTPU_DEVICE_PROOFS="1"):  # the set the tx route computes, whole
            root, proofs = merkle.proofs_from_byte_slices(txs[:RPC_TXS])
        check(root == data_hash, "the card's root of the first block != its data hash")
        for i, tx in enumerate(txs[:RPC_TXS]):
            proofs[i].verify(data_hash, tx)

        # Proven tx answers: the card, then every RPC_NATIVE_STRIDE-th by the native pass.
        tx_ms, answers = [], {}
        with environ(CMTPU_DEVICE_PROOFS="1"):
            for i in range(0, RPC_TXS, RPC_PROOF_STRIDE):
                t1 = time.perf_counter()
                ans = rpc.tx(tx_hash(txs[i]), prove=True)
                tx_ms.append((time.perf_counter() - t1) * 1e3)
                rpc_verify_tx_answer(ans, data_hash, txs[i])
                if i % RPC_NATIVE_STRIDE == 0:
                    answers[i] = ans
        native_ms = []
        with environ(CMTPU_DEVICE_PROOFS="0"):
            for i, ans in answers.items():
                t1 = time.perf_counter()
                check(rpc.tx(tx_hash(txs[i]), prove=True) == ans,
                      f"tx?prove=true: the card's answer for tx {i} != the native pass's")
                native_ms.append((time.perf_counter() - t1) * 1e3)
        n_tx_proofs = len(tx_ms)

        # Proven abci_query answers against the next header's app hash.
        keys = [txs[i].split(b"=")[0] for i in range(0, RPC_TXS, RPC_TXS // RPC_QUERY_KEYS)]
        query_ms, query_native_ms, queried = [], [], []
        for key in keys:
            with environ(CMTPU_DEVICE_PROOFS="1"):
                t1 = time.perf_counter()
                q = rpc.abci_query("", key, prove=True)["response"]
                query_ms.append((time.perf_counter() - t1) * 1e3)
            with environ(CMTPU_DEVICE_PROOFS="0"):
                t1 = time.perf_counter()
                qn = rpc.abci_query("", key, prove=True)["response"]
                query_native_ms.append((time.perf_counter() - t1) * 1e3)
            check({k: v for k, v in qn.items() if k != "height"}
                  == {k: v for k, v in q.items() if k != "height"},
                  f"abci_query: the card's proof for {key!r} != the native pass's")
            queried.append((key, q))
        for key, q in queried:
            qh = int(q["height"])
            deadline = time.monotonic() + RPC_WAIT_S
            while bs.height() < qh + 1:
                check(time.monotonic() < deadline, f"no height {qh + 1} to check a proof at")
                time.sleep(0.01)
            app_hash = bytes.fromhex(rpc.header(qh + 1)["header"]["app_hash"])
            ops = ProofOps(ops=[ProofOp(o["type"], base64.b64decode(o["key"]),
                                        base64.b64decode(o["data"]))
                                for o in q["proofOps"]["ops"]])
            default_proof_runtime().verify_value(ops, app_hash, "/x:" + key.hex(),
                                                 base64.b64decode(q["value"]))
        launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}
        n_sets = len(device_sets)
        check(n_sets == 1 + n_tx_proofs + len(keys)
              and launched["sha256"] == 2 * n_sets and launched["bn254"] == 0,
              f"proofs on the card: {n_sets} proof sets (the block's, {n_tx_proofs} tx, "
              f"{len(keys)} query), launches {launched}")
        # The proofs path launches on its caller's thread (crypto/merkle's
        # proofs_from_byte_slices returns host bytes to its caller): the
        # block's set on this thread, each proven answer's on the server's
        # request thread that computes it. A verify launch would come from
        # the device-owner thread.
        me = threading.current_thread().name
        check({k: n for k, n in launch_threads.items() if k[0] == "sha256"}
              == {("sha256", t): 2 * n for t, n in proof_threads.items()}
              and proof_threads[me] == 1
              and all("process_request_thread" in t for t in proof_threads if t != me)
              and {t for k, t in launch_threads if k != "sha256"} <= {"cmtpu-torch-dev"},
              f"proofs on the card: launches by thread {dict(launch_threads)}, proof sets "
              f"by caller {dict(proof_threads)}")
        height = bs.height()
        check(cs.prebatch_errors == 0 and cs.consensus_failures == 0,
              f"the node counted errors: prebatch {cs.prebatch_errors}, consensus "
              f"{cs.consensus_failures}")
        ingress = node.ingress.stats()
        check(ingress["legacy_passthrough"] == ingress["admitted"] == RPC_TXS + RPC_COMMIT_TXS
              and all(ingress[k] == 0 for k in NODE_INGRESS_ERRORS),
              f"the ingress: {ingress}")
        out["ingress"] = {k: ingress[k] for k in ("submitted", "admitted", "legacy_passthrough")}
    finally:
        ws.close()
        if reader is not None:
            reader.join(RPC_WAIT_S)
        # Every thread started since the node was built, held before stop(),
        # but the process's own: the backend's device-owner thread and the
        # vote batcher's window (``crypto/sigbatch``), which outlive nodes.
        held = [t for t in threading.enumerate() if t not in before and t is not reader
                and t.name not in ("cmtpu-torch-dev", "sigbatch")]
        node.stop()  # before its backend goes: no thread of it can call get_backend() after
        mk.proofs_from_byte_slices_device = orig_device
        _build.check_launch = orig_check
        be.set_backend(None)
    alive = [t.name for t in held if t.is_alive()]
    check(cs._thread in held and not alive and node.threads_left_at_stop == 0,
          f"threads of the node outlived stop(): {alive} ({node.threads_left_at_stop} of its "
          f"group); consensus's receive routine held: {cs._thread in held}")
    check(not ws_error, f"websocket: {ws_error}")
    heights = [h for h, _ in seen]
    check(heights == list(range(1, len(heights) + 1)) and heights[-1] >= height - 1,
          f"websocket: NewBlock heights {heights[:5]}...{heights[-5:]}, the store at {height}")
    times = [t for _, t in seen]
    gaps = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    out.update({
        "first_height_ms": (times[0] - start) * 1e3, "heights": height,
        "ms_per_height": statistics.median(gaps), "gaps_ms_max": max(gaps),
        "commits": commits, "card_calls": [c["lanes"] for c in rec.calls],
        "proven_tx": {"answers": n_tx_proofs, "ms_median": statistics.median(tx_ms),
                      "ms_max": max(tx_ms), "native_answers": len(native_ms),
                      "native_ms_median": statistics.median(native_ms),
                      "leaves": RPC_TXS},
        "proven_query": {"answers": len(query_ms), "ms_median": statistics.median(query_ms),
                         "native_ms_median": statistics.median(query_native_ms),
                         "leaves": device_sets[-1]},
        "device_proof_sets": n_sets, "launches": launched,
        "proof_set_callers": {"main": proof_threads[me], "request_threads": sum(
            n for t, n in proof_threads.items() if t != me), "distinct_request_threads": len(
            [t for t in proof_threads if t != me])},
        "tx_leaves": txs[:RPC_TXS], "kv_leaves": app._kv_leaves()[1],
    })
    return out


def rpc_compare_levels(sets: dict, dev, sms, clock_hz) -> dict:
    """The sha256 levels entry against its plain version, every word, at
    the RPC path's proof sets (a block's transactions, the kv leaves), timed
    beside its bound."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk

    out = {}
    for name, items in sets.items():
        flat, offsets = mk.pack_leaves(items, dev)
        got = mk.tree_levels_raw(flat, offsets)
        want = mk.tree_levels_raw_plain(flat, offsets)
        err = max_abs_err(got.cpu(), want.cpu())
        check(err == 0, f"sha256 levels entry at {name} ({len(items)} leaves) != plain")
        t_b = levels_bound(mk, flat, offsets, sms, clock_hz)
        out[name] = {"leaves": len(items), "max_abs_err": err,
                     "ms": time_cuda(lambda f=flat, o=offsets: mk.tree_levels_raw(f, o), 20),
                     "plain_ms": time_host(lambda f=flat, o=offsets: (
                         mk.tree_levels_raw_plain(f, o), torch.cuda.synchronize())),
                     "bound_ms": t_b[0], "bound_by": t_b[1]}
    return out


def drive_rpc_path(sources, torch_backend, dev, sms, clock_hz, sync_reps: int) -> dict:
    """The RPC phase (module docstring, step 20): (f), (g) with ``sync_reps``
    rounds of the default's sync, (h), the launch counts of the whole drive,
    the kernels at the path's batches."""
    import tempfile

    from cometbft_tpu_torch.ops import _build

    source = sources["10k"]
    started = rpc_server_start()  # ended by rpc_light_path, or here if (f) fails
    try:
        _build.reset_launches()
        restart = rpc_restart(source, torch_backend)
        restart_launches = dict(_build.LAUNCHES)
        check(restart_launches == {"sha512": 2, "decompress": 2, "ladder": 2, "sha256": 0,
                                   "bn254": 0},
              f"restart: launches {restart_launches}, expected one verify set (the LastCommit) "
              f"in each of (ii)'s two runs")
    except BaseException:
        started[0].kill()
        started[0].join()
        started[1].close()
        raise
    stamp("RPC: (g)")
    light = rpc_light_path(source, restart.pop("index_items"), torch_backend, sync_reps, started)
    stamp("RPC: (h)")
    with tempfile.TemporaryDirectory() as tmp:
        node = rpc_node_path(torch_backend, tmp)
    stamp("RPC: the kernels at the path's batches")
    launches = dict(_build.LAUNCHES)
    batches = {}
    for label, trip in (("final_block", restart.pop("final_block")),
                        ("light_largest", light.pop("largest")),
                        ("light_smallest", light.pop("smallest"))):
        batches[f"{label}_{len(trip[0])}"] = corrupt_four(*trip)
    kernels = bsync_window_kernels(batches, dev)
    levels = rpc_compare_levels({"block_txs": node.pop("tx_leaves"),
                                 "kv_leaves": node.pop("kv_leaves")}, dev, sms, clock_hz)
    return {"launches": launches, "restart": restart, "light": light, "node": node,
            "kernels": kernels, "levels": levels}


def rpc_phase(sources, backend, dev, card, records, sms, clock_hz, sync_reps: int = 0) -> tuple:
    """Runs the RPC path (step 20), prints its metrics and gates, merges its
    kernel comparisons into ``records``; returns its launches. ``sync_reps``
    rounds of the default's HTTP sync: 0 in the full run, which keeps near
    1,000 s; 1 under ``--rpc``."""
    start = time.perf_counter()
    out = drive_rpc_path(sources, backend, dev, sms, clock_hz, sync_reps)
    for k in ("sha512", "decompress", "ladder"):
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    records["sha256"]["max_abs_err"] = max([records["sha256"]["max_abs_err"]] + [
        v["max_abs_err"] for v in out["levels"].values()])
    r, g, h = out["restart"], out["light"], out["node"]
    print(f"RPC path ok (restart: the app wiped, {r['i']['replayed']} blocks replayed to the "
          f"source's app hash and state, {r['i']['indexed']} transactions indexed; the crash "
          f"after save_block, the final block through apply_block, its {N_SIGS}-signature "
          f"LastCommit on the card; a wrong app hash refused; a light client synced the "
          f"{N_SIGS}-validator chain over HTTP as over the block store, the doctored tip "
          f"refused ({g['doctored']['type']}); a one-validator chain served {h['heights']} "
          f"heights over RPC, {h['proven_tx']['answers']} tx and "
          f"{h['proven_query']['answers']} query proofs from the card verified); launches "
          f"{out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    print(json.dumps({"metric": "handshake_replay_10k_ms", "value": r["i"]["ms"],
                      "validators": N_SIGS, "heights": BSYNC_HEIGHTS, "txs_a_block": BSYNC_TXS,
                      "by_case": {"app_wiped": r["i"]["ms"], "crash_after_save_block": r["ii"]["ms"]},
                      "restart": r, **common}), flush=True)
    print(json.dumps({"metric": "rpc_light_sync_10k_ms", "value": g["ms"]["torch"],
                      "validators": N_SIGS, "heights": BSYNC_HEIGHTS, "by_backend": g["ms"],
                      "runs_ms": g["runs_ms"], "stages": g["stages"], "counted": g["counted"],
                      "doctored": g["doctored"], "server_start_s": g["server_start_s"],
                      "server": "a process of its own", **common}), flush=True)
    print(json.dumps({"metric": "rpc_chain_ms_per_height", "value": h["ms_per_height"],
                      "proven_tx_ms": h["proven_tx"]["ms_median"],
                      "proven_query_ms": h["proven_query"]["ms_median"],
                      **{k: v for k, v in h.items() if k != "ms_per_height"}, **common}),
          flush=True)
    print(json.dumps({"rpc": {"kernels": out["kernels"], "levels": out["levels"],
                              "launches": out["launches"]},
                      "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"], out["levels"]


def rpc_only(card, dev, sms, clock_hz) -> int:
    """``--rpc``: the keys, the 10,240-validator blocksync source and the RPC
    phase alone (a quick check of that phase on the card; no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    big = bsync_10k_source(fixtures, backend)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder", "sha256")}
    launches, _ = rpc_phase({"10k": big}, backend, dev, card, records, sms, clock_hz,
                            sync_reps=1)
    print(json.dumps({"rpc_launches": launches, "max_abs_err": records}), flush=True)
    return 0


# -- the node path ---------------------------------------------------------------

# (j) A one-validator port Node under its defaults (the QoS ingress, PEX,
# blocksync) admits signed envelopes sent over HTTP; (k) a fresh port Node
# catches up with the 10,240-validator source over TCP from a port Node in a
# process of its own. Every node is built by ``default_new_node`` from a home
# on disk that the port's own functions wrote.
NODE_CHAIN_ID = "chip-smoke-node"
NODE_SENDERS = 64
NODE_PER_SENDER = 64  # 4,096 envelopes in all, one of each sender's corrupted
NODE_CLIENTS = 8  # HTTP client threads; each sender's envelopes in order from one
NODE_PAYLOAD_BYTES = 48
NODE_WAIT_S = 300.0
NODE_LAST_WAIT_S = 4.0  # the consensus catch-up of the source's last block, after blocksync
NODE_DEEP_WAIT_S = 150.0  # ... under --node, long enough to see it commit
INGRESS_RUNS = 3  # --ingress: timed runs of (j) after its warm-up
NODE_INGRESS_ERRORS = ("preverify_fallbacks", "dispatcher_errors", "callback_errors",
                       "rejected_other", "rejected_mempool_full", "rejected_queue_full",
                       "rejected_rate_limited", "shed_total")


def node_config(**fields):
    """``test_config()`` with p2p and RPC on 127.0.0.1:0, a loopback address
    book (strict refuses loopback, as the reference's own PEX test says) and
    only errors logged; every other field at the reference's default (the
    ingress, PEX and blocksync on). ``fields`` are ``section__field=value``."""
    from cometbft_tpu_torch.config import test_config

    cfg = test_config()
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.addr_book_strict = False
    cfg.base.log_level = "error"
    for k, v in fields.items():
        section, _, field = k.partition("__")
        setattr(getattr(cfg, section), field, v)
    return cfg


def node_home(home: str, cfg, pv_secret: bytes | None = None, items=()):
    """A node's home written by the port's own functions: config.toml
    (``config/toml.write_config_file``), the FilePV (the key of
    ``pv_secret``, else a fresh one), the node key and, for a sqlite home,
    the block and state stores holding ``items``. Returns the FilePV (the
    genesis comes with ``node_genesis``)."""
    from cometbft_tpu_torch.config.toml import write_config_file
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file import FilePV

    cfg.set_root(home)
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(cfg.base.db_path(), exist_ok=True)
    write_config_file(os.path.join(home, "config", "config.toml"), cfg)
    if pv_secret is not None:
        FilePV(ed25519.gen_priv_key_from_secret(pv_secret), cfg.base.priv_validator_key_path(),
               cfg.base.priv_validator_state_path()).save()
    pv = FilePV.load_or_generate(cfg.base.priv_validator_key_path(),
                                 cfg.base.priv_validator_state_path())
    NodeKey.load_or_gen(cfg.base.node_key_path())
    for name in ("blockstore", "state") if items else ():
        db = new_db(name, cfg.base.db_backend, cfg.base.db_path())
        for k, v in items:
            db.set(k, v)
        db.close()
    return pv


def node_genesis(cfg, gen_json: str) -> None:
    with open(cfg.base.genesis_path(), "w") as f:
        f.write(gen_json)


def node_load(home: str, app=None):
    """``default_new_node`` over the home's config.toml, as a CLI would."""
    from cometbft_tpu_torch.config.toml import load_toml
    from cometbft_tpu_torch.node import default_new_node

    cfg = load_toml(os.path.join(home, "config", "config.toml"))
    cfg.set_root(home)
    return default_new_node(cfg, app=app)


def node_errors(node) -> dict:
    """Every error a node counts (ROADMAP §3, counted exceptions), by name."""
    out = {"prebatch_errors": node.consensus_state.prebatch_errors,
           "consensus_failures": node.consensus_state.consensus_failures,
           "wal_catchup_errors": node.consensus_state.wal_catchup_errors}
    if node.ingress is not None:
        st = node.ingress.stats()
        out.update({f"ingress_{k}": st[k] for k in NODE_INGRESS_ERRORS})
    if node.switch is not None:
        out.update(node.switch.errors())
        out["gossip_errors"] = node.consensus_reactor.gossip_errors
        out["check_tx_errors"] = sum(node.mempool_reactor.check_tx_errors.values())
        out["evidence_receive_errors"] = node.evidence_reactor.receive_errors
        out["blocksync_prefetch_errors"] = node.blocksync_reactor.prefetch_errors
        out["blocksync_sync_errors"] = node.blocksync_reactor.sync_errors
        out["pex_dial_errors"] = node.pex_reactor.dial_errors
        out["addrbook_load_errors"] = node.addr_book.load_errors
    return out


def node_envelopes() -> dict:
    """(j)'s traffic: NODE_SENDERS senders (ed25519 keys from fixed seeds),
    NODE_PER_SENDER envelopes each (a NODE_PAYLOAD_BYTES-byte ``k...=v...``
    payload, priorities cycling 0-3, nonces in order; the one at nonce i mod
    NODE_PER_SENDER of sender i with R's first byte flipped), signed here
    with the fixed-base table; then the four ``broadcast_tx_sync`` probes:
    a valid envelope, a corrupted one, a malformed one (truncated) and a
    duplicate of one already admitted."""
    from cometbft_tpu_torch.crypto import ed25519, ed25519_pure as pure
    from cometbft_tpu_torch.mempool import ingress as ing

    fb = FixedBase(pure)
    seeds = [hashlib.sha256(b"chip-smoke-node-sender-%d" % i).digest()
             for i in range(NODE_SENDERS)]
    pubs = [pure.point_compress(fb.mult(pure.secret_expand(s)[0])) for s in seeds]

    def envelope(i: int, j: int, corrupt: bool = False) -> bytes:
        payload = (b"node-%02d-%02d=" % (i, j)).ljust(NODE_PAYLOAD_BYTES, b"v")
        env = ing.SignedTxEnvelope(pubs[i], j % 4, j, payload, b"")
        sig = sign_known(pure, fb, seeds[i], pubs[i], env.sign_bytes())
        if corrupt:
            sig = bytes([sig[0] ^ 0x01]) + sig[1:]
        return (bytes([ing.ENVELOPE_MAGIC, ing.ENVELOPE_VERSION]) + pubs[i]
                + bytes([j % 4]) + env.nonce.to_bytes(8, "big") + payload + sig)

    check(envelope(3, 5) == ing.encode_envelope(ed25519._from_seed(seeds[3]),
                                                (b"node-03-05=").ljust(NODE_PAYLOAD_BYTES, b"v"),
                                                priority=1, nonce=5),
          "the envelopes signed here differ from ingress.encode_envelope's")
    streams = [[envelope(i, j, corrupt=(j == i % NODE_PER_SENDER))
                for j in range(NODE_PER_SENDER)] for i in range(NODE_SENDERS)]
    corrupted = {s[i % NODE_PER_SENDER] for i, s in enumerate(streams)}
    valid = [tx for s in streams for tx in s if tx not in corrupted]
    probes = {"valid": envelope(0, NODE_PER_SENDER), "corrupted": envelope(
        1, NODE_PER_SENDER, corrupt=True), "malformed": envelope(2, NODE_PER_SENDER)[:60],
              "duplicate": streams[2][0]}
    return {"streams": streams, "valid": valid, "corrupted": corrupted, "probes": probes}


def node_ingress_run(env: dict, backend, label: str, tmpdir: str, keep: bool = False) -> dict:
    """(j) once: a one-validator node (its own FilePV, the kvstore) under
    ``set_backend(recorder(backend))``; NODE_CLIENTS threads send the
    streams through the port's ``HTTPClient.broadcast_tx_async``; then the
    probes through ``broadcast_tx_sync``. Times from the first send to the
    store of the height holding the last valid envelope, with the split
    (HTTP submit, lane wait, the preverify backend calls, CheckTx, the
    heights); gates the commits, the rejections, the counters, the lanes
    against the verified-triple cache, the launches and their thread, the
    ingress_stats route and the reap order."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import Time
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    home = os.path.join(tmpdir, f"ingress-{label}")
    cfg = node_config()
    pv = node_home(home, cfg, b"chip-smoke-node-validator")
    gen = GenesisDoc(chain_id=NODE_CHAIN_ID, genesis_time=Time(BSYNC_T0, 0), validators=[
        GenesisValidator(pv.address(), pv.get_pub_key(), 10, "validator")])
    gen.validate_and_complete()
    node_genesis(cfg, gen.to_json())
    node = node_load(home)
    ing, mp, lanes = node.ingress, node.mempool, node.ingress.lanes
    app = node.proxy_app.mempool._app
    rec = LightRecorder(backend, keep=keep)

    # Instruments, on this node's objects (and the launch and verify hooks,
    # restored after): lane wait, CheckTx, the app's CheckTx txs, the
    # verified-triple cache hits of the ingress's batches, launch threads.
    pushed, waits, check_ms, app_seen, hits = {}, [], [], set(), [0]
    launch_threads = collections.Counter()
    orig_push, orig_drain, orig_mp_check = lanes.push, lanes.drain, mp.check_tx
    orig_app_check, orig_launch = app.check_tx, _build.check_launch
    orig_verify = ed25519.BatchVerifier.verify

    def push(item):
        pushed[id(item)] = time.perf_counter()
        try:
            orig_push(item)
        except Exception:
            pushed.pop(id(item), None)
            raise

    def drain(budget):
        out = orig_drain(budget)
        now = time.perf_counter()
        waits.extend((now - pushed.pop(id(it))) * 1e3 for it in out)
        return out

    def mp_check(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig_mp_check(*a, **kw)
        finally:
            check_ms.append((time.perf_counter() - t0) * 1e3)

    def app_check(req):
        app_seen.add(bytes(req.tx))
        return orig_app_check(req)

    def verify(self):
        if threading.current_thread().name == "tx-ingress":
            hits[0] += sum(1 for k in zip(self._pubs, self._sigs, self._msgs)
                           if k in ed25519._verified)
        return orig_verify(self)

    def check_launch(kernel, rc):
        launch_threads[(kernel, threading.current_thread().name)] += 1
        return orig_launch(kernel, rc)

    lanes.push, lanes.drain, mp.check_tx, app.check_tx = push, drain, mp_check, app_check
    ed25519.BatchVerifier.verify, _build.check_launch = verify, check_launch
    ed25519._verified.clear()  # a cold cache, as in a fresh node's process
    be.set_backend(rec)
    blocks, out = {}, {}
    try:
        node.start()
        rpc = HTTPClient(f"http://127.0.0.1:{node.rpc_port}", timeout=NODE_WAIT_S)
        deadline = time.monotonic() + NODE_WAIT_S
        while node.block_store.height() < 1:
            check(time.monotonic() < deadline, f"(j) {label}: the node made no block")
            time.sleep(0.01)
        launches0 = dict(_build.LAUNCHES)
        send_ms = [[] for _ in range(NODE_CLIENTS)]
        answers = [[] for _ in range(NODE_CLIENTS)]

        def client(t: int) -> None:
            c = HTTPClient(f"http://127.0.0.1:{node.rpc_port}", timeout=NODE_WAIT_S)
            mine = [s for i, s in enumerate(env["streams"]) if i % NODE_CLIENTS == t]
            for j in range(NODE_PER_SENDER):
                for s in mine:
                    t1 = time.perf_counter()
                    answers[t].append(c.broadcast_tx_async(s[j])["code"])
                    send_ms[t].append((time.perf_counter() - t1) * 1e3)

        # The store time of each height, from a watcher polling the block store.
        seen_at, watching = {}, threading.Event()

        def watcher() -> None:
            h_seen = node.block_store.height()
            while not watching.is_set():
                h = node.block_store.height()
                now = time.perf_counter()
                for hh in range(h_seen + 1, h + 1):
                    seen_at[hh] = now
                h_seen = h
                time.sleep(0.002)

        threads = [threading.Thread(target=client, args=(t,), name=f"node-client-{t}")
                   for t in range(NODE_CLIENTS)]
        watch = threading.Thread(target=watcher, name="node-watcher")
        watch.start()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(NODE_WAIT_S)
        t_sent = time.perf_counter()
        check(all(a == 0 for ans in answers for a in ans)
              and sum(map(len, answers)) == NODE_SENDERS * NODE_PER_SENDER,
              f"(j) {label}: broadcast_tx_async answered {collections.Counter(sum(answers, []))}")

        # The heights as they are stored, until every valid envelope is in one.
        want, committed, scanned = set(env["valid"]), set(), set()
        t_last = None
        deadline = time.monotonic() + NODE_WAIT_S
        try:
            while not want <= committed:
                check(time.monotonic() < deadline,
                      f"(j) {label}: {len(want - committed)} valid envelopes never committed; "
                      f"the mempool holds {mp.size()}, the ingress {ing.stats()}")
                for hh in sorted(set(seen_at) - scanned):
                    txs = {bytes(tx) for tx in node.block_store.load_block(hh).data.txs}
                    committed.update(txs)
                    scanned.add(hh)
                    if want & txs:
                        t_last = max(t_last or 0.0, seen_at[hh])
                time.sleep(0.005)
        finally:
            watching.set()
            watch.join()
        seen_h = max(seen_at)
        out["ms"] = (t_last - t0) * 1e3
        sent_ms = sorted(x for s in send_ms for x in s)
        lane_waits = sorted(waits)
        ingress_calls = [c for c in rec.calls if c["class"] == "ingress"]
        lanes_of = sorted(c["lanes"] for c in ingress_calls)
        heights = [hh for hh in sorted(seen_at) if hh >= 2]
        per_height = [len(node.block_store.load_block(hh).data.txs) for hh in heights]
        out["split"] = {
            "http_submit": {"wall_ms": (t_sent - t0) * 1e3, "calls": len(sent_ms),
                            "ms_median": statistics.median(sent_ms), "ms_max": sent_ms[-1]},
            "lane_wait": {"items": len(lane_waits), "ms_median": statistics.median(lane_waits),
                          "ms_p95": lane_waits[int(0.95 * (len(lane_waits) - 1))],
                          "ms_max": lane_waits[-1]},
            "preverify": {"calls": len(ingress_calls), "lanes_min": lanes_of[0],
                          "lanes_median": statistics.median(lanes_of), "lanes_max": lanes_of[-1],
                          "lanes": sum(lanes_of),
                          "backend_ms_median": statistics.median(c["ms"] for c in ingress_calls),
                          "backend_ms_sum": sum(c["ms"] for c in ingress_calls)},
            "check_tx": {"calls": len(check_ms), "ms_sum": sum(check_ms),
                         "ms_median": statistics.median(check_ms)},
            "heights": {"to_commit": len([hh for hh in heights if seen_at[hh] <= t_last]),
                        "txs_min": min(per_height), "txs_median": statistics.median(per_height),
                        "txs_max": max(per_height)},
        }

        # The sync probes: their codes and codespaces, then the valid one committed.
        probes = {k: rpc.broadcast_tx_sync(tx) for k, tx in env["probes"].items()}
        got = {k: (r["code"], r["codespace"]) for k, r in probes.items()}
        check(got == {"valid": (0, ""), "corrupted": (102, "ingress"), "malformed": (101, "ingress"),
                      "duplicate": (105, "ingress")}, f"(j) {label}: broadcast_tx_sync {got}")
        out["probes"] = {k: {"code": r["code"], "codespace": r["codespace"], "log": r["log"]}
                         for k, r in probes.items()}
        want.add(env["probes"]["valid"])
        deadline = time.monotonic() + NODE_WAIT_S
        while env["probes"]["valid"] not in committed:
            check(time.monotonic() < deadline, f"(j) {label}: the valid probe never committed")
            h = node.block_store.height()
            for hh in range(seen_h + 1, h + 1):
                committed.update(bytes(tx) for tx in node.block_store.load_block(hh).data.txs)
            seen_h = h
            time.sleep(0.01)
        check(ing.flush_queue(NODE_WAIT_S), f"(j) {label}: the ingress lanes did not drain")
        launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}

        # Gates.
        count = collections.Counter()
        order_ok = True
        for hh in range(1, node.block_store.height() + 1):
            txs = [bytes(tx) for tx in node.block_store.load_block(hh).data.txs]
            count.update(txs)
            prios = [tx[34] for tx in txs if tx[:1] == b"\xce"]
            order_ok &= prios == sorted(prios, reverse=True)
        check(all(count[tx] == 1 for tx in want),
              f"(j) {label}: valid envelopes not in exactly one block: "
              f"{collections.Counter(count[tx] for tx in want)}")
        bad = env["corrupted"] | {env["probes"]["corrupted"], env["probes"]["malformed"]}
        check(not (bad & app_seen) and not (bad & set(count)),
              f"(j) {label}: {len(bad & app_seen)} corrupted or malformed envelopes reached "
              f"CheckTx")
        check(order_ok, f"(j) {label}: a block's envelopes are not in descending lanes")
        st = ing.stats()
        n_valid = len(env["valid"]) + 1
        check(st["submitted"] == NODE_SENDERS * NODE_PER_SENDER + 4 and st["admitted"] == n_valid
              and st["rejected_invalid_sig"] == len(env["corrupted"]) + 1
              and st["rejected_bad_envelope"] == 1 and st["rejected_duplicate"] == 1
              and st["legacy_passthrough"] == 0, f"(j) {label}: ingress counters {st}")
        all_lanes = sum(c["lanes"] for c in rec.calls if c["class"] == "ingress")
        check(all_lanes == st["preverify_sigs"] - hits[0],
              f"(j) {label}: preverify lanes {all_lanes}, preverify_sigs "
              f"{st['preverify_sigs']}, cache hits {hits[0]}")
        errors = node_errors(node)
        check(all(v == 0 for v in errors.values()), f"(j) {label}: errors {errors}")
        route = rpc.call("ingress_stats")
        check(route.pop("enabled") is True and route == ing.stats(),
              f"(j) {label}: the ingress_stats route {route} != stats() {ing.stats()}")
        calls = len(rec.calls)
        if label == "torch":
            check(launched == {"sha512": calls, "decompress": calls, "ladder": calls,
                               "sha256": 0, "bn254": 0},
                  f"(j) torch: launches {launched} for {calls} card calls")
            check({t for (_, t) in launch_threads} <= {"cmtpu-torch-dev"},
                  f"(j) torch: kernels launched from {dict(launch_threads)}")
        out.update({"launches": launched, "card_calls": calls, "cache_hits": hits[0],
                    "counters": st, "heights": node.block_store.height(),
                    "launch_threads": {f"{k}@{t}": n for (k, t), n in launch_threads.items()}})
        if keep:
            out["batches"] = sorted((c for c in rec.triples), key=lambda t: len(t[0]))
    finally:
        node.stop()  # before its backend goes: no thread of it can call get_backend() after
        lanes.push, lanes.drain, mp.check_tx, app.check_tx = (
            orig_push, orig_drain, orig_mp_check, orig_app_check)
        ed25519.BatchVerifier.verify, _build.check_launch = orig_verify, orig_launch
        be.set_backend(None)
    check(node.threads_left_at_stop == 0,
          f"(j) {label}: {node.threads_left_at_stop} threads outlived stop(): "
          f"{thread_stacks(node.threads.threads())}")
    return out


def node_serve_main(conn, items, gen_json: str, home: str,
                    proxy_app: str = "persistent_kvstore") -> None:
    """(k)'s server, in a process of its own (its threads off the
    follower's interpreter lock): a port Node built by
    ``default_new_node`` from a sqlite home whose stores hold the source's
    items, a fresh FilePV (no validator), the persistent kvstore (in
    process, or behind the socket address ``proxy_app``: (l)'s snapshot
    peer), PEX on and RPC off, ``TorchBackend()`` its process backend (its
    consensus checks the seen commit it rebuilds as LastCommit); its
    Handshaker replays the app at build. Sends its p2p address (with the
    seconds from its entry to then), then answers "stats" until "close"."""
    entered = time.perf_counter()
    node = None
    try:
        from cometbft_tpu_torch.sidecar import backend as be

        # The card, where there is one (a CPU rehearsal asks for the CPU).
        be.set_backend(be.TorchBackend(device=None if torch.cuda.is_available() else "cpu"))
        # No stall watchdog: the source's validators run nowhere, so the
        # server's consensus waits at the next height by design.
        cfg = node_config(base__db_backend="sqlite", base__proxy_app=proxy_app,
                          rpc__laddr="", consensus__stall_watchdog_factor=0.0)
        node_home(home, cfg, items=items)
        node_genesis(cfg, gen_json)
        # The WAL a node that committed the stores' last height leaves: its
        # end height, so that consensus starts past it with nothing to replay.
        from cometbft_tpu_torch.consensus.wal import WAL, EndHeightMessage
        from cometbft_tpu_torch.state import StateStore

        wal = WAL(cfg.consensus.wal_path())
        wal.start()
        from cometbft_tpu_torch.libs.db import new_db

        sdb = new_db("state", "sqlite", cfg.base.db_path())
        wal.write_sync(EndHeightMessage(StateStore(sdb).load().last_block_height))
        sdb.close()
        wal.stop()
        t0 = time.perf_counter()
        node = node_load(home)
        build_s = time.perf_counter() - t0
        pex_in = collections.Counter()
        orig_receive = node.pex_reactor.receive

        def receive(chan_id, peer, msg_bytes):
            from cometbft_tpu_torch.p2p.pex.reactor import decode_pex_message

            pex_in[decode_pex_message(msg_bytes)[0]] += 1
            return orig_receive(chan_id, peer, msg_bytes)

        node.pex_reactor.receive = receive
        node.start()
        state = node.consensus_state.state
        conn.send({"addr": f"{node.node_key.id}@{node.p2p_laddr}", "build_s": build_s,
                   "ready_s": time.perf_counter() - entered,
                   "height": state.last_block_height, "app_hash": state.app_hash.hex()})
        while True:
            msg = conn.recv()
            if msg == "close":
                break
            conn.send({"pex_in": dict(pex_in), "book": sorted(node.addr_book._addrs),
                       "errors": node_errors(node), "peers": [p.id for p in node.switch.peers()]})
    except Exception as e:  # reported to the parent, which fails the run
        conn.send({"error": repr(e)})
    finally:
        if node is not None:
            node.stop()
        conn.close()


def node_catchup_run(source, backend, server: dict, tmpdir: str, label: str,
                     counted: bool, conn=None, last_wait_s: float = NODE_LAST_WAIT_S) -> dict:
    """(k) once: a fresh port Node from a home holding only the source's
    genesis, the server its persistent peer. ``counted``: the blocksync
    pipeline off and every stage timed (``BsyncStages``), the backend calls
    tagged by check. Returns the wall ms from ``start()`` to the source's
    last height but one (blocksync's last), the heights' store times, the
    handoff to consensus, whether consensus then committed the last
    height within ``last_wait_s``, and the node's end state, read after
    ``stop()`` (its last backend calls included), and when ``counted`` the
    triples of each backend call; with ``conn``, the server's stats taken
    while the follower is still connected."""
    from cometbft_tpu_torch.consensus import messages as cmsg
    from cometbft_tpu_torch.crypto import ed25519, sigbatch
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    last = len(source["blocks"])
    home = os.path.join(tmpdir, f"follower-{label}-{'counted' if counted else 'timed'}")
    cfg = node_config(base__proxy_app="persistent_kvstore", rpc__laddr="",
                      p2p__persistent_peers=server["addr"])
    node_home(home, cfg)
    node_genesis(cfg, source["gen"].to_json())
    with environ(CMTPU_BLOCKSYNC_PIPELINE="0" if counted else None):
        node = node_load(home)
    stages = BsyncStages() if counted else None
    rec = BsyncRecorder(backend, stages, keep=True) if counted else LightRecorder(backend)
    wire = {"parts": [], "votes": []}
    orig_send = node.consensus_state.send_peer_message
    orig_caught_up = node.blocksync_reactor.on_caught_up
    pex_in = collections.Counter()
    orig_pex = node.pex_reactor.receive
    handoff = {}

    def send_peer_message(msg, peer_id="peer"):
        if getattr(msg, "height", None) == last or getattr(
                getattr(msg, "vote", None), "height", None) == last:
            kind = "parts" if isinstance(msg, cmsg.BlockPartMessage) else "votes"
            wire[kind].append(time.perf_counter())
        return orig_send(msg, peer_id)

    def on_caught_up(state):
        handoff["t"] = time.perf_counter()
        handoff["calls"] = len(rec.calls)
        handoff["height"] = state.last_block_height
        orig_caught_up(state)
        handoff["t_started"] = time.perf_counter()

    def pex_receive(chan_id, peer, msg_bytes):
        from cometbft_tpu_torch.p2p.pex.reactor import decode_pex_message

        pex_in[decode_pex_message(msg_bytes)[0]] += 1
        return orig_pex(chan_id, peer, msg_bytes)

    node.consensus_state.send_peer_message = send_peer_message
    node.blocksync_reactor.on_caught_up = on_caught_up
    node.pex_reactor.receive = pex_receive
    ed25519._verified.clear()  # a cold cache, as in a fresh node's process
    fallbacks0 = sigbatch.counters()["fallbacks"]
    be.set_backend(rec)
    stored, out = {}, {}
    stopped = False
    try:
        with counting_launches() as launch_threads, (
                stages if counted else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            node.start()
            deadline = time.monotonic() + NODE_WAIT_S
            seen_h = 0
            while (node.consensus_state.state.last_block_height < last - 1
                   or "t_started" not in handoff):
                check(time.monotonic() < deadline,
                      f"(k) {label}: the follower stopped at {node.block_store.height()}")
                h = node.block_store.height()
                for hh in range(seen_h + 1, h + 1):
                    stored[hh] = (time.perf_counter() - t0) * 1e3
                seen_h = h
                time.sleep(0.005)
            t_sync = time.perf_counter()
            deadline = time.monotonic() + last_wait_s
            while node.consensus_state.state.last_block_height < last:
                if time.monotonic() > deadline:
                    break
                time.sleep(0.005)
            t_end = time.perf_counter()
            torch.cuda.synchronize()
            if conn is not None:
                conn.send("stats")
                out["server_stats"] = conn.recv()
            bytes_io = {p.id[:8]: {"sent": p.mconn.send_monitor.status()["bytes"],
                                   "received": p.mconn.recv_monitor.status()["bytes"]}
                        for p in node.switch.peers()}
            t_stop = time.perf_counter()
            node.stop()  # before the calls are read: its last ones are counted
            stopped = True
            stop_s = time.perf_counter() - t_stop
        reached = node.consensus_state.state.last_block_height
        out.update({
            "ms_to_blocksync_end": (t_sync - t0) * 1e3,
            "ms_per_block": (t_sync - t0) * 1e3 / (last - 1),
            "stored_ms": stored, "reached": reached, "last_reached": reached == last,
            "handoff_ms": (handoff["t_started"] - handoff["t"]) * 1e3,
            "handoff_at_ms": (handoff["t"] - t0) * 1e3, "handoff_height": handoff["height"],
            "last_height_ms": (t_end - handoff["t"]) * 1e3 if reached == last else None,
            "wire_last_height": {k: {"messages": len(v), "first_ms": (v[0] - handoff["t"]) * 1e3,
                                     "span_ms": (v[-1] - v[0]) * 1e3} if v else {"messages": 0}
                                 for k, v in wire.items()},
            "calls": list(rec.calls) if counted else [c["lanes"] for c in rec.calls],
            "calls_before_handoff": handoff["calls"],
            "launch_threads": {f"{k}@{t}": n for (k, t), n in launch_threads.items()},
            "pex_in": dict(pex_in), "book": sorted(node.addr_book._addrs),
            "errors": {**node_errors(node),
                       "sigbatch_fallbacks": sigbatch.counters()["fallbacks"] - fallbacks0},
            "node_id": node.node_key.id, "stop_s": stop_s, "bytes": bytes_io,
        })
        if not counted:
            out["backend_ms"] = [c["ms"] for c in rec.calls]
        # Blocks and state: the source's, to the height reached.
        from cometbft_tpu_torch.state import store as state_store

        for hh in range(1, reached + 1):
            check(node.block_store.load_block(hh).encode() == source["blocks"][hh - 1],
                  f"(k) {label}: stored block {hh} differs from the source's")
        check(state_store._encode_state(node.consensus_state.state) == source["states"][reached - 1],
              f"(k) {label}: the state at {reached} differs from the source's")
        if counted:
            out["stages"] = bsync_stage_table(stages)
            out["triples"] = rec.triples
    finally:
        if not stopped:
            node.stop()  # before its backend goes: no thread of it calls get_backend() after
        node.consensus_state.send_peer_message = orig_send
        node.blocksync_reactor.on_caught_up = orig_caught_up
        be.set_backend(None)
    check(node.threads_left_at_stop == 0,
          f"(k) {label}: {node.threads_left_at_stop} threads outlived stop(): "
          f"{thread_stacks(node.threads.threads())}")
    return out


def thread_stacks(threads) -> dict:
    """Each thread's name and the last frames of its stack."""
    import traceback

    frames = sys._current_frames()
    return {t.name: "".join(traceback.format_stack(frames[t.ident])[-3:])
            for t in threads if t.ident in frames}


def node_window_arithmetic(calls, n: int, heights: int) -> bool:
    """Blocksync's batches over the wire, against the window arithmetic
    (``bsync_window_arithmetic``) made for blocks that arrive as they may:
    each window covers from 2 to its size less one commits (n lanes each),
    each light check sends 2/3 of the set + 1 lanes and each full check the
    rest; every commit of heights 1 to ``heights`` - 1 is covered by a
    window or a light check, once, and every light-checked commit but the
    last is fully checked once (the last one's block is not applied).
    Over TCP the blocks may arrive one at a time, so no window is required:
    a run without one is held to the light and full checks' counts alone."""
    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor as R

    wb = min(R.PREFETCH_WINDOW, R.PREFETCH_MAX_SIGS // n)
    light_n = n * 2 // 3 + 1
    windows = [k for who, k in calls if who == "window"]
    light = [k for who, k in calls if who == "light"]
    full = [k for who, k in calls if who == "full"]
    return (len(calls) == len(windows) + len(light) + len(full)
            and all(k % n == 0 and 2 <= k // n <= wb - 1 for k in windows)
            and all(k == light_n for k in light) and all(k == n - light_n for k in full)
            and sum(windows) // n + len(light) == heights - 1
            and len(light) - 1 <= len(full) <= len(light))


def node_catchup_batches(calls, triples) -> dict:
    """Batches that (k)'s counted catch-up sent to the card, as sent: the
    first of each window size, the first light check, the first full check
    and the first batch of consensus's catch-up after the handoff (a check
    of no sync stage). Requires a light check, a full check and a
    consensus batch. Returns label -> (pubs, msgs, sigs)."""
    picks = {}
    for (who, n), t in zip(calls, triples):
        kind = who or "consensus"
        if kind == "window" or not any(k.startswith(f"catchup_{kind}_") for k in picks):
            picks.setdefault(f"catchup_{kind}_{n}", t)
    kinds = {k.split("_")[1] for k in picks}
    check({"light", "full", "consensus"} <= kinds,
          f"(k): the counted catch-up sent no batch of {sorted({'light', 'full', 'consensus'} - kinds)}")
    return picks


def node_server_start(source, tmpdir: str) -> tuple:
    """(k)'s server (``node_serve_main``) started in a process of its own,
    fed the source's items over a pipe: (the process, the pipe, its start
    time). The node phase starts it first, so that it builds its home and
    replays its app while (j) runs."""
    t0 = time.perf_counter()
    proc, conn = spawn(node_serve_main, list(source["node"]["db"].iterator()),
                       source["gen"].to_json(), os.path.join(tmpdir, "server"))
    return proc, conn, t0


def node_server_ready(source, started) -> dict:
    """(k)'s server's first message, once it is up: its p2p address, build
    and ready seconds, and the height and app hash its Handshaker left it
    at (gated: the source's)."""
    _, conn, _ = started
    check(conn.poll(NODE_WAIT_S), "(k): the server process did not start")
    server = conn.recv()
    check("error" not in server, f"(k): the server process failed: {server.get('error')}")
    check(server["height"] == len(source["blocks"])
          and server["app_hash"] == source["state"].app_hash.hex(),
          f"(k): the server's Handshaker left it at {server['height']}, app hash "
          f"{server['app_hash']}")
    return server


def node_server_end(started) -> int:
    """Asks (k)'s server to close (again, where the catch-up did; at once,
    where a step before it failed), waits for it to end (killed after
    NODE_WAIT_S), closes its pipe; returns its exit code."""
    return spawned_end(started[:2])


def node_catchup_path(source, torch_backend, auto, tmpdir: str, started,
                      deep: bool = False) -> dict:
    """(k): the server (``node_server_start``'s, ``started``); when it is
    up, the counted catch-up under a BsyncRecorder around
    ``TorchBackend()`` (gates: the last height but one reached with
    the source's blocks and state, the window batches of the window
    arithmetic, each book holding the other node, PEX bytes both ways, no
    error counted, every verify launch from the device-owner thread, three
    a card call); then the timed catch-ups, ``TorchBackend()`` and, with
    ``auto``, the process default in turns. ``deep`` (``--node``): the
    counted run waits NODE_DEEP_WAIT_S for consensus to commit the last
    height, and the timed runs are made; else the counted run is the timed
    one too (its stage wrappers add a synchronize a stage). Ends by asking
    the server to close."""
    from cometbft_tpu_torch.ops import _build

    _, conn, t0 = started
    out = {}
    t_wait = time.perf_counter()
    server = node_server_ready(source, started)
    out["server"] = {"ready_s": server["ready_s"], "build_s": server["build_s"],
                     "since_start_s": time.perf_counter() - t0,
                     "wait_s": time.perf_counter() - t_wait, "addr": server["addr"]}
    launches0 = dict(_build.LAUNCHES)
    counted = node_catchup_run(
        source, torch_backend, server, tmpdir, "torch", counted=True, conn=conn,
        last_wait_s=NODE_DEEP_WAIT_S if deep else NODE_LAST_WAIT_S)
    launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}
    sstats = counted.pop("server_stats")
    out["batches"] = node_catchup_batches(counted["calls"], counted.pop("triples"))
    print(f"node (k) counted: height {counted['reached']} (blocksync to "
          f"{counted['handoff_height']} in {counted['ms_to_blocksync_end']:.0f} ms, the last "
          f"height {'in ' + format(counted['last_height_ms'], '.0f') + ' ms' if counted['last_reached'] else 'not committed'}); "
          f"{len(counted['calls'])} backend calls; server ready {out['server']['ready_s']:.1f} s "
          f"after its entry (waited for {out['server']['wait_s']:.1f} s after (j)); stored at ms "
          f"{counted['stored_ms']}; stage "
          f"medians {json.dumps(counted['stages']['median_ms'])}, decode "
          f"{counted['stages']['decode_median_ms']:.1f} ms; bytes {counted['bytes']}; stop "
          f"{counted['stop_s']:.1f} s", flush=True)
    before = counted["calls"][:counted["calls_before_handoff"]]
    check(node_window_arithmetic(before, source["n_vals"], len(source["blocks"])),
          f"(k): blocksync's batches {before} do not add up to its window arithmetic")
    calls = len(counted["calls"])
    check(launched == {"sha512": calls, "decompress": calls, "ladder": calls, "sha256": 0,
                       "bn254": 0},
          f"(k): launches {launched} for {calls} card calls; launches by thread "
          f"{counted['launch_threads']}; calls "
          f"by check {collections.Counter(w for w, _ in counted['calls'])}, lanes "
          f"{collections.Counter(k for _, k in counted['calls']).most_common(12)}")
    check({k.split("@", 1)[1] for k in counted["launch_threads"]} <= {"cmtpu-torch-dev"},
          f"(k): kernels launched from {counted['launch_threads']}")
    server_id = server["addr"].split("@", 1)[0]
    check(server_id in counted["book"] and counted["node_id"] in sstats["book"],
          f"(k): the books: the follower's {counted['book']}, the server's {sstats['book']}")
    check(counted["pex_in"].get("addrs", 0) >= 1 and sstats["pex_in"].get("request", 0) >= 1,
          f"(k): PEX in at the follower {counted['pex_in']}, at the server "
          f"{sstats['pex_in']}")
    errors = {**counted["errors"], **{f"server_{k}": v for k, v in sstats["errors"].items()}}
    check(all(v == 0 for v in errors.values()), f"(k): errors {errors}")
    out["counted"] = {k: v for k, v in counted.items() if k not in ("book", "stored_ms")}
    out["counted"]["calls"] = [[who, k] for who, k in counted["calls"]]
    out["counted"]["server_pex_in"] = sstats["pex_in"]
    out["launches"] = launched
    runs = {"torch": [] if deep else [counted["ms_per_block"]], "auto": []}
    timed = {}
    for label, bk in ([("torch", torch_backend)] + ([("auto", auto)] if auto else [])
                      if deep else []):
        r = node_catchup_run(source, bk, server, tmpdir, label, counted=False,
                             last_wait_s=0.0)
        # The server's book holds the followers before this one, gone: PEX
        # dials them and fails (reported, not gated).
        check(all(v == 0 for k, v in r["errors"].items() if k != "pex_dial_errors"),
              f"(k) {label}: errors {r['errors']}")
        runs[label].append(r["ms_per_block"])
        timed[label] = {k: v for k, v in r.items() if k not in ("book",)}
    out["runs_ms_per_block"] = runs
    out["ms_per_block"] = {k: statistics.median(v) for k, v in runs.items() if v}
    out["timed"] = timed
    out["metric_from"] = "bare runs" if deep else "the counted run (a synchronize a stage)"
    return out  # the server stays up for (n); node_server_end closes it


def corrupt_valid(pubs, msgs, sigs):
    """A batch of the ingress (which holds corrupted envelopes) for the
    kernel comparison: ``corrupt_four``'s four flips (R, the message, S, A)
    on its first, a third, a half and the last of its valid lanes, or one R
    flip on its middle valid lane where it has fewer than 8 lanes. Returns
    (pubs, msgs, sigs, the lanes that must be rejected: the corrupted and
    the invalid ones, by the pure ZIP-215 check)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure

    pubs, msgs, sigs = list(pubs), list(msgs), list(sigs)
    invalid = {i for i, t in enumerate(zip(pubs, msgs, sigs)) if not pure.verify_zip215(*t)}
    ok = [i for i in range(len(pubs)) if i not in invalid]

    def flip(b: bytes, at: int) -> bytes:
        return b[:at] + bytes([b[at] ^ 0x01]) + b[at + 1:]

    if len(pubs) < 8:
        lane = ok[len(ok) // 2]
        sigs[lane] = flip(sigs[lane], 0)
        return pubs, msgs, sigs, invalid | {lane}
    lanes = (ok[0], ok[len(ok) // 3], ok[len(ok) // 2], ok[-1])
    sigs[lanes[0]] = flip(sigs[lanes[0]], 0)
    msgs[lanes[1]] = flip(msgs[lanes[1]], len(msgs[lanes[1]]) - 1)
    sigs[lanes[2]] = flip(sigs[lanes[2]], 33)
    pubs[lanes[3]] = flip(pubs[lanes[3]], 0)
    return pubs, msgs, sigs, invalid | set(lanes)


def drive_node_path(sources, torch_backend, dev, with_default: bool, after_timed=None,
                    during_server=None) -> dict:
    """The node phase (module docstring, step 21): (j) and (k) under
    ``TorchBackend()`` (and the process default with ``with_default``),
    (m) under ``TorchBackend()``, the launch counts of the whole drive,
    ``during_server(server_addr, tmpdir)`` if given (while (k)'s server is
    still up: phase (n)), ``after_timed()`` if given, then the verify
    kernels at the path's batches."""
    import tempfile

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    source = sources["10k"]
    auto = None
    procs: list = []  # (m)'s signer processes
    with tempfile.TemporaryDirectory() as tmp:
        started = node_server_start(source, tmp)
        try:
            t0 = time.perf_counter()
            env = node_envelopes()
            env_s = time.perf_counter() - t0
            if with_default:
                with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                             CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
                    auto = be._make_backend()
            _build.reset_launches()
            ingress = {"torch": node_ingress_run(env, torch_backend, "torch", tmp, keep=True)}
            if auto is not None:
                ingress["auto"] = node_ingress_run(env, auto, "auto", tmp)
            for b, r in ingress.items():
                print(f"node (j) {b}: {r['ms']:.1f} ms, {r['card_calls']} backend calls, "
                      f"launches {r['launches']}; split {json.dumps(r['split'])}", flush=True)
            stamp("node: (k)")
            catchup = node_catchup_path(source, torch_backend, auto, tmp, started,
                                        deep=with_default)
            stamp("node: (m)")
            operator = operator_path(torch_backend, tmp, procs)
            launches = dict(_build.LAUNCHES)
            if during_server is not None:
                stamp("the ops path")
                during_server(catchup["server"]["addr"], tmp)
            if after_timed is not None:
                after_timed()
        finally:
            if auto is not None:
                auto.close()
            exitcode = node_server_end(started)
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    check(exitcode == 0, f"(k): the server process exited {exitcode}")
    check(all(launches[k] > 0 for k in ("sha512", "decompress", "ladder")),
          f"node path launches {launches}")
    from cometbft_tpu_torch.crypto import ed25519_pure as pure

    batches = ingress["torch"].pop("batches")

    def with_valid(order):  # the first batch in that order with a lane to corrupt
        return next(batches[i] for i in order if any(pure.verify_zip215(*t)
                                                     for t in zip(*batches[i])))

    n_b = len(batches)
    picks = {"smallest": with_valid(range(n_b)),
             "median": with_valid(list(range(n_b // 2, n_b)) + list(range(n_b // 2))),
             "largest": with_valid(range(n_b - 1, -1, -1))}
    kb = {f"preverify_{k}_{len(t[0])}": corrupt_valid(*t) for k, t in picks.items()}
    # The catch-up's batches hold only valid signatures; a consensus batch
    # may have fewer than 8 lanes.
    for label, t in catchup.pop("batches").items():
        kb[label] =(corrupt_valid if label.startswith("catchup_consensus") else corrupt_four)(*t)
    stamp("node: the kernels at the path's batches")
    kernels = bsync_window_kernels(kb, dev)
    return {"launches": launches, "ingress": ingress, "catchup": catchup, "kernels": kernels,
            "envelopes_s": env_s, "operator": operator}


def node_phase(sources, backend, dev, card, records, with_default: bool = False,
               after_timed=None, during_server=None) -> dict:
    """Runs the node path (step 21), prints its metrics and gates, merges its
    kernel comparisons into ``records``; returns its launches.
    ``after_timed``, ``during_server``: see ``drive_node_path``."""
    start = time.perf_counter()
    out = drive_node_path(sources, backend, dev, with_default, after_timed, during_server)
    for k in ("sha512", "decompress", "ladder"):
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    j, k, m = out["ingress"], out["catchup"], out["operator"]
    c = k["counted"]
    print(f"node path ok ((j) a default node committed every one of "
          f"{j['torch']['counters']['admitted']} valid envelopes "
          f"once and refused the {j['torch']['counters']['rejected_invalid_sig']} corrupted "
          f"without CheckTx, preverify_fallbacks 0; (k) a fresh node caught up over TCP to height "
          f"{c['reached']} of {BSYNC_HEIGHTS} (blocksync to {c['handoff_height']}, the last "
          f"height {'committed' if c['last_reached'] else 'not committed'} by consensus), PEX "
          f"both ways; (m) a validator with its key in a signer process and its kvstore behind "
          f"a socket committed {OP_TXS} transactions sent through a LightProxy, answered "
          f"{OP_QUERIES} proven queries through it, refused a tampered and a stripped answer, and "
          f"went on {m['signer_restart']['heights_after']} heights past its signer's restart); "
          f"launches {out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    print(json.dumps({"metric": "node_ingress_4096_ms", "value": j["torch"]["ms"],
                      "by_backend": {b: r["ms"] for b, r in j.items()},
                      "envelopes": NODE_SENDERS * NODE_PER_SENDER, "senders": NODE_SENDERS,
                      "clients": NODE_CLIENTS, "split": {b: r["split"] for b, r in j.items()},
                      "runs": {b: {x: v for x, v in r.items() if x not in ("split", "ms")}
                               for b, r in j.items()}, **common}), flush=True)
    print(json.dumps({"metric": "node_catchup_10k_ms_per_block",
                      "value": k["ms_per_block"]["torch"], "validators": N_SIGS,
                      "heights": BSYNC_HEIGHTS, "txs_a_block": BSYNC_TXS,
                      "by_backend": k["ms_per_block"], "runs": k["runs_ms_per_block"],
                      "from": k["metric_from"], "counted": c, "timed": k["timed"],
                      "server": k["server"], **common}),
          flush=True)
    print(json.dumps({"metric": "operator_ms_per_height", "value": m["ms_per_height"],
                      "proxy_query_ms": m["proxy_query_ms"], "txs": OP_TXS,
                      "queries": OP_QUERIES, **{x: v for x, v in m.items()
                                                if x not in ("ms_per_height", "proxy_query_ms")},
                      **common}), flush=True)
    print(json.dumps({"metric": "proxy_query_ms", "value": m["proxy_query_ms"],
                      "runs_ms": m["proxy_query_runs_ms"], **common}), flush=True)
    print(json.dumps({"node": {"kernels": out["kernels"], "launches": out["launches"],
                               "envelopes_s": out["envelopes_s"]},
                      "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"]


def ingress_only(card) -> int:
    """``--ingress``: (j) alone under ``TorchBackend()``, INGRESS_RUNS
    times in one process after a warm-up run, each run's ms and split
    printed (to time two checkouts of the mempool or the ingress against
    each other in one call; no result line)."""
    import tempfile

    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    backend = TorchBackend()
    env = node_envelopes()
    for i in range(INGRESS_RUNS + 1):
        with tempfile.TemporaryDirectory() as tmp:
            r = node_ingress_run(env, backend, f"ingress-{i}", tmp)
        sp = r["split"]
        print(json.dumps({"run": "warm-up" if i == 0 else i, "node_ingress_4096_ms": r["ms"],
                          "http_submit_ms_median": sp["http_submit"]["ms_median"],
                          "preverify_calls": sp["preverify"]["calls"],
                          "preverify_ms_median": sp["preverify"]["backend_ms_median"],
                          "check_tx_ms_median": sp["check_tx"]["ms_median"],
                          "heights": sp["heights"]["to_commit"], "card": card}), flush=True)
    return 0


def node_only(card, dev) -> int:
    """``--node``: the keys, the 10,240-validator blocksync source and the node
    phase alone, (j) and (k) under the process default too (a quick check of
    that phase on the card; no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    big = bsync_10k_source(fixtures, backend)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    launches = node_phase({"10k": big}, backend, dev, card, records, with_default=True)
    print(json.dumps({"node_launches": launches, "max_abs_err": records}), flush=True)
    return 0


# -- the ops path -------------------------------------------------------------------

# (n) The operator's tier through the port's CLI (``cometbft_tpu_torch/cmd``):
# (n1) ``rollback`` then ``replay`` on a sqlite copy of the 10,240-validator
# source's home in this process, ``inspect`` and ``reindex-event`` on it; (n2) a
# follower started by ``python -m cometbft_tpu_torch.cmd start`` in a process of
# its own, (k)'s server its persistent peer, with Prometheus, the psql sink,
# pprof, the watchdog and the WAL's group commit on, under the process default;
# (n3) ``loadtime --signed`` (4 validators, one connection) in this process.
OPS_WAIT_S = 300.0
OPS_WATCHDOG_S = 120  # CMTPU_WATCHDOG: longer than the follower runs unmoved
OPS_WAL_GROUP_MS = 2  # CMTPU_WAL_GROUP_MS
OPS_TRACE_S = 10.0  # the /debug/torch/trace window from the follower's start
OPS_SCRAPE_S = 0.25  # /metrics polled this often while the follower catches up
OPS_LOAD_RATE = 100  # loadtime's tx/s (the reference's default is 200)
# The reference's default is 100 blocks. 20 hold some hundreds of txs at
# OPS_LOAD_RATE; a window of 3 sat in the ramp after the load starts (the
# ingress and the gossip fill the first blocks slowly) and held a handful.
OPS_LOAD_BLOCKS = 20
# The share of OPS_LOAD_RATE x the window's duration that must commit in the
# window: the generator, four nodes and their ingress share one interpreter,
# and on a loaded host the generator itself offers less than it is asked.
OPS_LOAD_MIN_SHARE = 0.5
OPS_REPS = 3  # --ops: timed (n1) runs under each backend, in turns
OPS_KERNELS = ("digits_kernel", "decompress_kernel", "ladder_verify_kernel")
OPS_FOLLOWER_ENV: dict = {}  # added to (n2)'s environment (a CPU rehearsal asks for the CPU)


def ops_cli(*args) -> tuple:
    """``cometbft_tpu_torch.cmd.__main__.main(args)`` in this process, as the
    reference's ``tests/test_cmd_ops.py`` calls its own: (exit code, what it
    printed, what it printed to stderr, wall ms)."""
    import io

    from cometbft_tpu_torch.cmd.__main__ import main as cli

    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli(list(args))
    return rc, buf.getvalue(), err.getvalue(), (time.perf_counter() - t0) * 1e3


def ops_source_home(source, home: str) -> None:
    """(k)'s server's home: the source's stores in sqlite, its genesis, the
    persistent kvstore, RPC off."""
    cfg = node_config(base__db_backend="sqlite", base__proxy_app="persistent_kvstore",
                      rpc__laddr="")
    node_home(home, cfg, items=list(source["node"]["db"].iterator()))
    node_genesis(cfg, source["gen"].to_json())


def ops_state(home: str) -> bytes:
    """The home's stored state, encoded."""
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.state import StateStore
    from cometbft_tpu_torch.state import store as state_store

    db = new_db("state", "sqlite", os.path.join(home, "data"))
    try:
        return state_store._encode_state(StateStore(db).load())
    finally:
        db.close()


def ops_db_items(home: str, name: str) -> list:
    from cometbft_tpu_torch.libs.db import new_db

    db = new_db(name, "sqlite", os.path.join(home, "data"))
    try:
        return list(db.iterator())
    finally:
        db.close()


def ops_inspect(home: str) -> dict:
    """``inspect``'s server over the home: status, block, commit and
    validators at the home's tip, and the refusal of a write route."""
    from cometbft_tpu_torch.config.toml import load_toml
    from cometbft_tpu_torch.inspect import Inspector
    from cometbft_tpu_torch.rpc.client import HTTPClient, RPCClientError

    cfg = load_toml(os.path.join(home, "config", "config.toml")).set_root(home)
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    ins = Inspector(cfg)
    ins.start()
    try:
        c = HTTPClient(f"http://127.0.0.1:{ins.port}")
        tip = BSYNC_HEIGHTS
        out = {"status": c.call("status"), "block": c.call("block", height=tip),
               "commit": c.call("commit", height=tip),
               "validators": c.call("validators", height=tip, page=1, per_page=100)}
        refused = raises(RPCClientError, lambda: c.call("broadcast_tx_sync", tx="00"))
    finally:
        ins.stop()
    check(refused, "(n1): inspect served a write route")
    return out


def ops_rollback_replay(source, backend, tmpdir: str, label: str, src_home: str,
                        stages: bool = False) -> dict:
    """(n1) once on a fresh copy of ``src_home``: ``rollback`` then
    ``replay`` through the CLI under a recording ``backend`` (a cold
    verified-triple cache), the Handshaker's stages timed when ``stages``.
    Gates: rollback's line and state (the source's at the height below),
    the replayed state the source's, two card calls of N_SIGS lanes (the
    Handshaker's final block checks its LastCommit, then the node's
    consensus checks the seen commit it rebuilds as LastCommit), three
    launches a call from the device-owner thread."""
    import shutil

    from cometbft_tpu_torch.consensus.replay import Handshaker
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    home = os.path.join(tmpdir, f"n1-{label}")
    shutil.copytree(src_home, home)
    last = len(source["blocks"])
    rec = LightRecorder(backend, keep=True)
    split = StageTimer()
    ed25519._verified.clear()
    be.set_backend(rec)
    try:
        launches0 = dict(_build.LAUNCHES)
        with counting_launches() as threads_:
            if stages:
                split.wrap(Handshaker, "_replay_blocks_through_app", "replay_through_app")
                split.wrap(Handshaker, "_replay_final_block", "replay_final_block")
            with split:
                torch.cuda.synchronize()
                rc1, out1, _, rollback_ms = ops_cli("--home", home, "rollback")
                rolled = ops_state(home)
                rc2, out2, _, replay_ms = ops_cli("--home", home, "replay")
                torch.cuda.synchronize()
        launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}
    finally:
        be.set_backend(None)
    from cometbft_tpu_torch.state import store as state_store

    want_rolled = state_store._decode_state(source["states"][last - 2])
    check(rc1 == 0 and out1 == f"Rolled back state to height {last - 1} and hash "
          f"{want_rolled.app_hash.hex().upper()}\n", f"(n1) {label}: rollback said {out1!r}")
    check(rolled == source["states"][last - 2],
          f"(n1) {label}: the rolled-back state is not the source's at {last - 1}")
    check(rc2 == 0 and f"replay done; store height {last}" in out2,
          f"(n1) {label}: replay said {out2!r}")
    check(ops_state(home) == source["states"][last - 1],
          f"(n1) {label}: the replayed state is not the source's at {last}")
    lanes = rec.lanes()
    check(lanes == [N_SIGS, N_SIGS],
          f"(n1) {label}: the replay's card calls {lanes}, not two of {N_SIGS}")
    if label == "torch":
        check(launched == {"sha512": 2, "decompress": 2, "ladder": 2, "sha256": 0, "bn254": 0},
              f"(n1): launches {launched}")
        check({t for _, t in threads_} <= {"cmtpu-torch-dev"},
              f"(n1): kernels launched from {dict(threads_)}")
    return {"home": home, "ms": rollback_ms + replay_ms, "rollback_ms": rollback_ms,
            "replay_ms": replay_ms, "card_call_ms": [c["ms"] for c in rec.calls],
            "stages": split.table() if stages else None, "launches": launched,
            "triples": rec.triples}


def ops_inspect_reindex(source, src_home: str, home: str, start: int = 1) -> dict:
    """(n1)'s offline tools on the replayed home: ``inspect`` serves what
    it serves over the source's home; ``reindex-event`` rebuilds the tx and
    block indexes from height ``start`` (every record the node indexed live
    kept as it was, every tx of those heights found by hash and by
    ``tx.height``)."""
    from cometbft_tpu_torch.libs.db import new_db
    from cometbft_tpu_torch.state.txindex import KVTxIndexer
    from cometbft_tpu_torch.types.block import Block
    from cometbft_tpu_torch.types.tx import tx_hash

    t0 = time.perf_counter()
    replayed, original = ops_inspect(home), ops_inspect(src_home)
    inspect_ms = (time.perf_counter() - t0) * 1e3
    diff = [k for k in replayed if replayed[k] != original[k]]
    check(not diff, f"(n1): inspect answers differ from the source home's on {diff}")
    check(int(replayed["status"]["sync_info"]["latest_block_height"]) == BSYNC_HEIGHTS
          and int(replayed["validators"]["total"]) == N_SIGS,
          f"(n1): inspect's status {replayed['status']['sync_info']}")
    live = ops_db_items(home, "tx_index")
    for name in ("tx_index", "block_index"):
        for suffix in ("", "-wal", "-shm"):
            path = os.path.join(home, "data", f"{name}.sqlite{suffix}")
            if os.path.exists(path):
                os.unlink(path)
    last = len(source["blocks"])
    rc, out, _, reindex_ms = ops_cli("--home", home, "reindex-event", "--start-height", str(start))
    check(rc == 0 and out == f"reindexed {last - start + 1} blocks ({start}..{last})\n",
          f"(n1): reindex-event said {out!r}")
    rebuilt = dict(ops_db_items(home, "tx_index"))
    lost = [k for k, v in live if rebuilt.get(k) != v]
    check(not lost, f"(n1): reindex-event lost or changed {len(lost)} records the node "
          f"indexed live, e.g. {lost[:2]}")
    idx = KVTxIndexer(new_db("tx_index", "sqlite", os.path.join(home, "data")))
    for h in range(start, last + 1):
        txs = Block.decode(source["blocks"][h - 1]).data.txs
        for i in (0, len(txs) // 2, len(txs) - 1):
            rec = idx.get(tx_hash(txs[i]))
            check(rec is not None and rec["height"] == str(h) and rec["index"] == i,
                  f"(n1): tx {i} of height {h} not in the rebuilt index")
    by_height = len(idx.search(f"tx.height = {last}"))
    check(by_height == BSYNC_TXS, f"(n1): tx.height = {last} finds {by_height} txs")
    n_tx = sum(1 for k in rebuilt if k.startswith(b"tx:"))
    check(n_tx == (last - start + 1) * BSYNC_TXS, f"(n1): {n_tx} tx records rebuilt")
    return {"inspect_ms": inspect_ms, "reindex_ms": reindex_ms, "reindexed_from": start,
            "live_records": len(live),
            "rebuilt_records": len(rebuilt), "tx_records": n_tx}


def ops_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ops_metrics(port: int) -> tuple:
    """One /metrics GET: (the samples by name, the wall ms)."""
    t0 = time.perf_counter()
    body = http_get(port, "/metrics")
    ms = (time.perf_counter() - t0) * 1e3
    vals = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, _, v = line.rpartition(" ")
            vals[name] = float(v)
    return vals, ms


def ops_trace(port: int, trace_dir: str, out: dict) -> None:
    """The follower's /debug/torch/trace over OPS_TRACE_S (a thread's
    target): the kernels' records by name, from the Chrome trace it wrote."""
    try:
        text = http_get(port, f"/debug/torch/trace?seconds={OPS_TRACE_S}&dir={trace_dir}")
        path = text.split("trace written to ", 1)[1].split(": ", 1)[0]
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = collections.Counter(e.get("name", "") for e in events
                                    if e.get("cat") == "kernel")
        out["text"] = text
        out["kernels"] = {k: sum(n for name, n in names.items() if k in name)
                          for k in OPS_KERNELS}
    except Exception as e:  # reported; the gate fails on it
        out["error"] = repr(e)


def ops_follower_start(source, server_addr: str, tmpdir: str) -> dict:
    """(n2) begun: ``init`` of the port's CLI in a process of its own, the
    home's genesis and config.toml written, then ``start`` in a process of
    its own, and a thread that waits for its "Node started" line, takes the
    /debug/torch/trace window from there and polls /metrics until the
    store reaches the source's last height but one. Returns the handle
    ``ops_follower_end`` takes."""
    from cometbft_tpu_torch.config.toml import load_toml, write_config_file

    here = os.path.dirname(os.path.abspath(__file__))
    home = os.path.join(tmpdir, "n2-follower")
    env = {k: v for k, v in os.environ.items() if not k.startswith("CMTPU_")}
    t0 = time.perf_counter()
    init = subprocess.run([sys.executable, "-m", "cometbft_tpu_torch.cmd", "--home", home,
                           "init", "--chain-id", BSYNC_CHAIN_ID], cwd=here, env=env,
                          capture_output=True, text=True, timeout=OPS_WAIT_S)
    check(init.returncode == 0 and f"Initialized node in {home}" in init.stdout,
          f"(n2): init exited {init.returncode}: {init.stdout} {init.stderr}")
    init_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(home, "config", "genesis.json"), "w") as f:
        f.write(source["gen"].to_json())
    path = os.path.join(home, "config", "config.toml")
    cfg = load_toml(path)
    mport, pport = ops_free_port(), ops_free_port()
    cfg.base.proxy_app = "persistent_kvstore"
    cfg.base.log_level = "error"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.persistent_peers = server_addr
    cfg.p2p.addr_book_strict = False
    cfg.rpc.laddr = ""
    cfg.rpc.pprof_laddr = f"127.0.0.1:{pport}"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{mport}"
    cfg.tx_index.indexer = "psql"
    write_config_file(path, cfg)
    log_path = os.path.join(tmpdir, "n2-follower.log")
    env.update(CMTPU_WATCHDOG=str(OPS_WATCHDOG_S), CMTPU_WAL_GROUP_MS=str(OPS_WAL_GROUP_MS),
               **OPS_FOLLOWER_ENV)
    fol = {"home": home, "log_path": log_path, "mport": mport, "init_ms": init_ms,
           "scrapes": [], "trace": {}, "height": 0, "t_started": None, "t_height": None,
           "done": threading.Event(), "stop": threading.Event()}
    with open(log_path, "w") as log:
        fol["t_spawn"] = time.perf_counter()
        fol["proc"] = subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.cmd", "--home",
                                        home, "start"], cwd=here, env=env, stdout=log,
                                       stderr=subprocess.STDOUT, text=True)
    _OPS_PROCS.append(fol["proc"])
    target = len(source["blocks"]) - 1

    def monitor():
        proc, deadline = fol["proc"], time.monotonic() + OPS_WAIT_S
        try:
            while "Node started" not in ops_printed(fol):
                if proc.poll() is not None or time.monotonic() > deadline or fol["stop"].is_set():
                    return
                time.sleep(0.01)
            fol["t_started"] = time.perf_counter()
            tracer = threading.Thread(target=ops_trace, daemon=True, args=(
                pport, os.path.join(tmpdir, "n2-trace"), fol["trace"]))
            tracer.start()
            fol["tracer"] = tracer
            while fol["height"] < target:
                if proc.poll() is not None or time.monotonic() > deadline or fol["stop"].is_set():
                    return
                try:
                    vals, ms = ops_metrics(mport)
                    fol["scrapes"].append(ms)
                    fol["height"] = int(vals["cometbft_blockstore_height"])
                except OSError:
                    pass
                time.sleep(OPS_SCRAPE_S)
            fol["t_height"] = time.perf_counter()
        finally:
            fol["done"].set()

    fol["monitor"] = threading.Thread(target=monitor, daemon=True, name="ops-follower")
    fol["monitor"].start()
    return fol


def ops_printed(fol) -> str:
    with open(fol["log_path"]) as f:
        return f.read()


def ops_sink_rows(path: str, below: int) -> list:
    """(tx hash, height) of every tx row of the sink under height ``below``,
    by plain SQL, read as an external consumer would (waiting out the
    node's write transaction)."""
    import sqlite3

    db = sqlite3.connect(path, timeout=60.0)
    try:
        return db.execute("SELECT t.tx_hash, b.height FROM tx_results t JOIN blocks b "
                          "ON t.block_id = b.rowid WHERE b.height < ?", (below,)).fetchall()
    finally:
        db.close()


def ops_follower_end(source, fol: dict) -> dict:
    """(n2) ended: waits for the monitor to see the store at the source's
    last height but one, and for the psql sink to hold every tx of the
    heights below it; a last scrape; SIGINT. Gates: that height on
    ``/metrics``, the backend gauges clean and the engine's blocksync
    lanes the window arithmetic's; the trace window holds the three
    verify kernels; every tx of those heights once in the sink; SIGINT
    ends the process with exit code 0, no thread left, no sampler error,
    no watchdog report; ``replay`` on its home gives its height."""
    import signal

    from cometbft_tpu_torch.types.block import Block
    from cometbft_tpu_torch.types.tx import tx_hash

    proc, last = fol["proc"], len(source["blocks"])
    rows = []
    try:
        fol["done"].wait(OPS_WAIT_S)
        check(fol["t_height"] is not None,
              f"(n2): the follower stopped at {fol['height']}: {ops_printed(fol)[-2000:]}")
        want = {}
        for h in range(1, last):
            for tx in Block.decode(source["blocks"][h - 1]).data.txs:
                want[tx_hash(tx).hex().upper()] = h
        sink_path = os.path.join(fol["home"], "data", "event_sink.sqlite")
        deadline = time.monotonic() + OPS_WAIT_S
        while len(rows) < len(want):
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"(n2): the sink holds {len(rows)} of {len(want)} txs")
            time.sleep(0.25)
            rows = ops_sink_rows(sink_path, last)
        t_sink = time.perf_counter()
        fol["tracer"].join(OPS_TRACE_S + 120)
        final, ms = ops_metrics(fol["mport"])
        fol["scrapes"].append(ms)
        t_sigint = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(OPS_WAIT_S)
        t_end = time.perf_counter()
    finally:
        fol["stop"].set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log_text = ops_printed(fol)
    trace = fol["trace"]
    check(rc == 0, f"(n2): SIGINT: exit code {rc}: {log_text[-3000:]}")
    check("Node stopped; threads left 0; metrics sampler errors 0; watchdog stalls 0" in log_text
          and "watchdog: no progress" not in log_text and "Traceback" not in log_text,
          f"(n2): the follower's output: {log_text[-3000:]}")
    check(sorted(rows) == sorted(want.items()),
          f"(n2): the sink's txs of heights 1-{last - 1} are not the source's, once each")
    check("error" not in trace and all(trace["kernels"][k] > 0 for k in OPS_KERNELS),
          f"(n2): the trace window: {trace}")
    n, light_n = source["n_vals"], source["n_vals"] * 2 // 3 + 1
    heights = last - 1
    arith = {heights * n, heights * n - (n - light_n)}
    got_sigs = final["cometbft_engine_blocksync_dispatched_sigs"]
    check(got_sigs in arith, f"(n2): the engine's blocksync lanes {got_sigs}, not the window "
          f"arithmetic's {sorted(arith)}")
    backend_gauges = {k: final[f"cometbft_backend_{k}"]
                      for k in ("trips", "retries", "deadline_exceeded", "active_tier")}
    check(all(v == 0 for v in backend_gauges.values()), f"(n2): backend gauges {backend_gauges}")
    reached = int(final["cometbft_blockstore_height"])
    check(reached >= last - 1, f"(n2): final scrape {final}")
    rc2, out2, _, _ = ops_cli("--home", fol["home"], "replay")
    check(rc2 == 0 and f"replay done; store height {reached}" in out2,
          f"(n2): replay on the follower's home said {out2!r} (reached {reached})")
    scrapes = fol["scrapes"]
    return {
        "init_ms": fol["init_ms"],
        "ms_to_height": (fol["t_height"] - fol["t_started"]) * 1e3,
        "ms_per_block": (fol["t_height"] - fol["t_started"]) * 1e3 / heights,
        "spawn_to_started_ms": (fol["t_started"] - fol["t_spawn"]) * 1e3,
        "sink_drain_after_ms": (t_sink - fol["t_height"]) * 1e3,
        "sigint_to_exit_ms": (t_end - t_sigint) * 1e3,
        "scrape_ms": scrapes, "scrape_ms_median": statistics.median(scrapes),
        "reached": reached, "engine": {k[len("cometbft_engine_"):]: v for k, v in final.items()
                                       if k.startswith("cometbft_engine_blocksync")
                                       or k.startswith("cometbft_engine_consensus")},
        "backend": backend_gauges, "trace": trace.get("kernels"),
        "wal_group_commits": final.get("cometbft_wal_group_commits_total"),
        "sink_txs": len(rows), "stop_line": [line for line in log_text.splitlines()
                                              if line.startswith("Node stopped")],
    }


def ops_loadtime(backend) -> dict:
    """(n3): ``loadtime --signed`` (4 validators, one connection,
    OPS_LOAD_RATE tx/s, OPS_LOAD_BLOCKS blocks) in this process under a
    recording ``backend``. Gates: the report covers exactly the blocks
    asked, with at least OPS_LOAD_MIN_SHARE of the asked rate times the
    window's duration committed in it, and no submission or stop that
    raised; ingress-class calls of the preverify's
    batches among the card calls; three launches a call from the
    device-owner thread."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    rec = LightRecorder(backend, keep=True)
    be.set_backend(rec)
    try:
        launches0 = dict(_build.LAUNCHES)
        with counting_launches() as threads_:
            rc, text, err, ms = ops_cli("loadtime", "--signed", "--rate", str(OPS_LOAD_RATE),
                                        "--blocks", str(OPS_LOAD_BLOCKS), "--validators", "4",
                                        "--connections", "1")
        launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}
    finally:
        be.set_backend(None)
    rep = json.loads(text.strip().splitlines()[-1])
    tail = err.strip().splitlines()[-1] if err.strip() else ""
    m = re.fullmatch(r"loadtime: submitted (\d+); submit errors (\d+); stop errors (\d+)", tail)
    check(m is not None and m.group(2) == "0" and m.group(3) == "0",
          f"(n3): loadtime's errors: {err[-2000:]}")
    submitted = int(m.group(1))
    check(rc == 0 and rep["blocks"] == OPS_LOAD_BLOCKS
          and rep["end_height"] - rep["start_height"] == OPS_LOAD_BLOCKS - 1,
          f"(n3): loadtime's report {rep}")
    want = OPS_LOAD_MIN_SHARE * OPS_LOAD_RATE * rep["duration_s"]
    check(rep["txs_committed"] >= want,
          f"(n3): {rep['txs_committed']} txs committed in the window, under {want:.0f} "
          f"({OPS_LOAD_MIN_SHARE} x {OPS_LOAD_RATE} tx/s x {rep['duration_s']:.3f} s; "
          f"{submitted} submitted): {rep}")
    ingress = rec.lanes("ingress")
    calls = len(rec.calls)
    check(ingress and min(ingress) >= 1, f"(n3): ingress calls {ingress}")
    check(launched == {"sha512": calls, "decompress": calls, "ladder": calls, "sha256": 0,
                       "bn254": 0}, f"(n3): launches {launched} for {calls} card calls")
    check({t for _, t in threads_} <= {"cmtpu-torch-dev"},
          f"(n3): kernels launched from {dict(threads_)}")
    ing_triples = [t for c, t in zip(rec.calls, rec.triples) if c["class"] == "ingress"]
    return {"report": rep, "ms": ms, "launches": launched, "calls": calls, "submitted": submitted,
            "ingress_lanes": ingress, "lanes_by_class": {
                k: rec.lanes(k) for k in sorted({c["class"] for c in rec.calls})},
            "ingress_triples": ing_triples}


def ops_kernel_batches(source, replay_triples, ingress_triples) -> dict:
    """(n)'s batches for the kernel comparison: the replay's 10,240-lane
    call, (k)'s window of two commits, its light and full checks (from the
    source's commits), and the smallest and largest ingress batches of
    (n3), four lanes of each corrupted (one under 8 lanes)."""
    n = source["n_vals"]
    light_n = n * 2 // 3 + 1
    w = bsync_window_triples(source, (1, 2))
    c3 = bsync_window_triples(source, (3,))
    out = {f"replay_{N_SIGS}": corrupt_four(*replay_triples),
           f"window_{2 * n}": corrupt_four(*w),
           f"light_{light_n}": corrupt_four(*(x[:light_n] for x in c3)),
           f"full_{n - light_n}": corrupt_four(*(x[light_n:] for x in c3))}
    by_size = sorted(ingress_triples, key=lambda t: len(t[0]))
    for tag, t in (("smallest", by_size[0]), ("largest", by_size[-1])):
        out[f"ingress_{tag}_{len(t[0])}"] = corrupt_valid(*t)
    return out


def drive_ops_path(source, server_addr: str, torch_backend, dev, tmpdir: str,
                   timed: int = 0, auto=None) -> dict:
    """Phase (n): (n1) counted and staged under ``TorchBackend()`` (and, with
    ``timed``, that many bare runs under it and under ``auto`` in turns),
    inspect and reindex; (n2); (n3); launch counts zeroed before and read
    after; then the verify kernels at (n)'s batches. Without ``timed`` (the
    full run) (n2)'s follower starts first and (n1) and (n3) run while it
    warms up and catches up (its process beside this one: its numbers are
    then not alone on the host); with ``timed`` (``--ops``) each runs
    alone."""
    from cometbft_tpu_torch.ops import _build

    _build.reset_launches()
    try:
        return _drive_ops_path(source, server_addr, torch_backend, dev, tmpdir, timed, auto)
    finally:
        # A failed step leaves no follower running (its end stops it).
        for proc in _OPS_PROCS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        _OPS_PROCS.clear()


_OPS_PROCS: list = []  # (n2)'s follower process while it runs


def _drive_ops_path(source, server_addr, torch_backend, dev, tmpdir, timed, auto) -> dict:
    from cometbft_tpu_torch.ops import _build

    fol = None
    if not timed:
        stamp("ops: (n2) a follower from the CLI, started")
        fol = ops_follower_start(source, server_addr, tmpdir)
    src_home = os.path.join(tmpdir, "n1-source")
    t0 = time.perf_counter()
    ops_source_home(source, src_home)
    home_s = time.perf_counter() - t0
    stamp("ops: (n1) rollback and replay")
    n1 = ops_rollback_replay(source, torch_backend, tmpdir, "torch", src_home, stages=True)
    runs = {"torch": [n1["ms"]], "auto": []}
    for i in range(timed):
        for label, bk in [("torch", torch_backend)] + ([("auto", auto)] if auto else []):
            r = ops_rollback_replay(source, bk, tmpdir, f"{label}-{i}", src_home)
            runs[label].append(r["ms"])
    # The full run rebuilds the tip's index alone (~5 s; all six heights
    # take ~30 s, under --ops).
    tools = ops_inspect_reindex(source, src_home, n1["home"],
                                start=1 if timed else len(source["blocks"]))
    if fol is None:
        stamp("ops: (n2) a follower from the CLI")
        n2 = ops_follower_end(source, ops_follower_start(source, server_addr, tmpdir))
    stamp("ops: (n3) loadtime")
    n3 = ops_loadtime(torch_backend)
    if fol is not None:
        stamp("ops: (n2) the follower's end")
        n2 = ops_follower_end(source, fol)
    n2["alone"] = fol is None
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in ("sha512", "decompress", "ladder")),
          f"ops path launches {launches}")
    stamp("ops: the kernels at the path's batches")
    kernels = bsync_window_kernels(
        ops_kernel_batches(source, n1.pop("triples")[0], n3.pop("ingress_triples")), dev)
    return {"launches": launches, "n1": n1, "runs_ms": runs, "tools": tools, "n2": n2,
            "n3": n3, "kernels": kernels, "home_s": home_s}


def ops_phase(source, server_addr: str, backend, dev, card, records, tmpdir: str,
              timed: int = 0, auto=None) -> dict:
    """Runs the ops path, prints its metrics and gates, merges its kernel
    comparisons into ``records``; returns its launches."""
    start = time.perf_counter()
    out = drive_ops_path(source, server_addr, backend, dev, tmpdir, timed, auto)
    for k in ("sha512", "decompress", "ladder"):
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    n1, n2, n3 = out["n1"], out["n2"], out["n3"]
    rep = n3["report"]
    print(f"ops path ok ((n1) rollback to {BSYNC_HEIGHTS - 1} and replay to {BSYNC_HEIGHTS} "
          f"through the CLI gave the source's states, two card calls of {N_SIGS} lanes, inspect "
          f"served the source's answers, reindex-event rebuilt "
          f"{out['tools']['tx_records']} tx records; (n2) a follower started from the CLI "
          f"blocksynced to {n2['reached']}, its /metrics, trace ({n2['trace']}), psql sink "
          f"({n2['sink_txs']} txs) and watchdog as gated, SIGINT exit 0 with no thread left; "
          f"(n3) loadtime --signed committed {rep['txs_committed']} txs over {rep['blocks']} "
          f"blocks, ingress batches {sorted(set(n3['ingress_lanes']))}); launches "
          f"{out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    runs = {k: v for k, v in out["runs_ms"].items() if v}
    print(json.dumps({"metric": "cli_replay_10k_ms", "value": n1["ms"],
                      "by_backend": {k: statistics.median(v) for k, v in runs.items()},
                      "runs_ms": runs, "rollback_ms": n1["rollback_ms"],
                      "replay_ms": n1["replay_ms"], "card_call_ms": n1["card_call_ms"],
                      "stages": n1["stages"], "tools": out["tools"],
                      "source_home_s": out["home_s"], **common}), flush=True)
    print(json.dumps({"metric": "cli_catchup_10k_ms_per_block", "value": n2["ms_per_block"],
                      **{k: v for k, v in n2.items() if k not in ("ms_per_block", "scrape_ms")},
                      **common}), flush=True)
    print(json.dumps({"metric": "metrics_scrape_ms", "value": n2["scrape_ms_median"],
                      "runs_ms": n2["scrape_ms"], **common}), flush=True)
    print(json.dumps({"metric": "loadtime_tx_latency_p50_ms",
                      "value": rep["tx_latency_p50_s"] * 1e3,
                      "loadtime_block_interval_mean_ms": rep["block_interval_mean_s"] * 1e3,
                      "report": rep, "wall_ms": n3["ms"], "calls": n3["calls"],
                      "submitted": n3["submitted"],
                      "committed_share": rep["txs_committed"] / (OPS_LOAD_RATE * rep["duration_s"]),
                      "lanes_by_class": {k: collections.Counter(v).most_common(16)
                                         for k, v in n3["lanes_by_class"].items()},
                      **common}), flush=True)
    print(json.dumps({"metric": "loadtime_block_interval_mean_ms",
                      "value": rep["block_interval_mean_s"] * 1e3, **common}), flush=True)
    print(json.dumps({"ops": {"kernels": out["kernels"], "launches": out["launches"]},
                      "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"]


def ops_only(card, dev) -> int:
    """``--ops``: the keys, the 10,240-validator blocksync source, (k)'s
    server, then the ops path with OPS_REPS timed (n1) runs under
    ``TorchBackend()`` and the process default in turns (no result line)."""
    import tempfile

    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    big = bsync_10k_source(fixtures, backend)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    with tempfile.TemporaryDirectory() as tmp:
        started = node_server_start(big, tmp)
        auto = None
        try:
            server = node_server_ready(big, started)
            with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                         CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
                auto = be._make_backend()
            launches = ops_phase(big, server["addr"], backend, dev, card, records, tmp,
                                 timed=OPS_REPS, auto=auto)
        finally:
            if auto is not None:
                auto.close()
            exitcode = node_server_end(started)
    check(exitcode == 0, f"(k): the server process exited {exitcode}")
    print(json.dumps({"ops_launches": launches, "max_abs_err": records}), flush=True)
    return 0


# -- the statesync path -------------------------------------------------------------

# (l) A fresh port Node joins the 10,240-validator source by statesync: a
# snapshot peer (a port Node over a sqlite copy of the source's stores, its
# kvstore a process behind a socket) serves the app's snapshot at height 4, the
# joiner's light client verifies it over HTTP against (g)'s server, restores its
# own out-of-process kvstore over the socket, bootstraps and blocksyncs to the
# source's last height but one.
SS_SNAPSHOT_INTERVAL = 4  # a snapshot at 4 only: one at the tip (6) needs headers 7 and 8
SS_HEIGHT = SS_SNAPSHOT_INTERVAL
SS_DISCOVERY_S = 2.0  # statesync.discovery_time, 15 s by default
SS_REFUSAL_TIMEOUT_S = 20.0  # the refused join's statesync deadline (600 s by default)
SS_WAIT_S = 300.0


def abci_app_main(conn, app: str, snapshot_interval: int, provable: bool) -> None:
    """A kvstore (``app``: kvstore or persistent_kvstore) behind the port's
    ``ABCIServer`` on 127.0.0.1:0, in a process of its own, counting the
    requests it serves by type. Sends its address, then answers "stats"
    with the counts and the app's height until "close"."""
    srv = None
    try:
        from cometbft_tpu_torch.abci.example import kvstore
        from cometbft_tpu_torch.abci.server import ABCIServer, dispatch_request

        counts = collections.Counter()

        class Counting(ABCIServer):
            def _dispatch(self, req):
                with self._mtx:
                    counts[type(req).__name__] += 1
                    return dispatch_request(self.app, req)

        cls = (kvstore.PersistentKVStoreApplication if app == "persistent_kvstore"
               else kvstore.KVStoreApplication)
        kv = cls(snapshot_interval=snapshot_interval, provable=provable)
        srv = Counting(kv, "tcp://127.0.0.1:0")
        conn.send({"addr": srv.start()})
        while conn.recv() != "close":
            conn.send({"requests": dict(counts), "height": kv.height})
    except Exception as e:  # reported to the parent, which fails the run
        conn.send({"error": repr(e)})
    finally:
        if srv is not None:
            srv.stop()
        conn.close()


def spawn(target, *args) -> tuple:
    """``target(child_pipe, *args)`` in a spawned process: (process, pipe)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=target, args=(child, *args), daemon=True)
    proc.start()
    child.close()
    return proc, conn


def spawned_hello(started, what: str, wait_s: float = SS_WAIT_S) -> dict:
    """The first message of a spawned process; fails the run on its error."""
    _, conn = started
    check(conn.poll(wait_s), f"{what}: the process did not start")
    hello = conn.recv()
    check("error" not in hello, f"{what}: the process failed: {hello.get('error')}")
    return hello


def spawned_end(started, wait_s: float = NODE_WAIT_S) -> int:
    """Asks a spawned process to close, waits for it (killed after
    ``wait_s``), closes its pipe; returns its exit code."""
    proc, conn = started
    with contextlib.suppress(OSError):
        conn.send("close")
    proc.join(wait_s)
    if proc.is_alive():
        proc.kill()
        proc.join()
    conn.close()
    return proc.exitcode


def ss_app_cli(extra=()) -> tuple:
    """``python -m cometbft_tpu_torch.abci.server persistent_kvstore`` on
    127.0.0.1:0: (the process, its address)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.abci.server", "persistent_kvstore",
         "--addr", "tcp://127.0.0.1:0", *extra],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    m = re.search(r"listening on (tcp://[\d.]+:\d+)", line)
    if not m:
        proc.kill()
        proc.wait()
    check(m is not None, f"the ABCI server printed {line!r}")
    return proc, m.group(1)


def ss_servers_start(source, tmpdir: str, procs: list) -> dict:
    """(l)'s servers, started once the node phase's timed parts are done, so
    that they build while its kernels are compared and no node metric
    carries their load: (g)'s RPC server (``rpc_serve_main``, its doctored /commit at
    SS_HEIGHT + 1, the first header the joiner verifies) fed the source's
    items; the snapshot peer's kvstore, ``python -m
    cometbft_tpu_torch.abci.server persistent_kvstore --snapshot-interval
    4`` (in ``procs``); the snapshot peer, ``node_serve_main`` over a
    sqlite copy of the source's stores with that socket as its proxy_app
    (its Handshaker replays blocks 1-6 through it, so the app holds a
    snapshot at 4)."""
    items = list(source["node"]["db"].iterator())
    t0 = time.perf_counter()
    rpc = rpc_server_start(SS_HEIGHT + 1)
    rpc[1].send((items, [], source["gen"].to_json()))
    app_proc, app_addr = ss_app_cli(("--snapshot-interval", str(SS_SNAPSHOT_INTERVAL)))
    procs.append(app_proc)
    peer = spawn(node_serve_main, items, source["gen"].to_json(),
                 os.path.join(tmpdir, "snapshot-peer"), app_addr)
    return {"rpc": rpc, "peer": peer, "app": app_proc, "app_addr": app_addr, "t0": t0}


def ss_servers_ready(servers, source) -> dict:
    """Waits for (l)'s servers: the RPC server's two URLs and the snapshot
    peer's address, its Handshaker at the source's height and app hash."""
    if "peer_hello" not in servers:
        ports = spawned_hello(servers["rpc"], "(l)'s RPC server")["ports"]
        servers["honest"], servers["doctored"] = (f"http://127.0.0.1:{p}" for p in ports)
        hello = spawned_hello(servers["peer"], "(l)'s snapshot peer")
        check(hello["height"] == len(source["blocks"])
              and hello["app_hash"] == source["state"].app_hash.hex(),
              f"(l): the snapshot peer's Handshaker left it at {hello['height']}, app hash "
              f"{hello['app_hash']}")
        servers["peer_hello"] = hello
        servers["ready_s"] = time.perf_counter() - servers["t0"]
    return servers


def ss_servers_end(servers) -> dict:
    """Ends (l)'s servers: their exit codes (the CLI kvstore killed)."""
    servers["ended"] = True
    codes = {"rpc": spawned_end(servers["rpc"], RPC_WAIT_S), "peer": spawned_end(servers["peer"])}
    servers["app"].kill()
    servers["app"].wait()
    servers["app"].stdout.close()
    return codes


def ss_state_fields(state) -> dict:
    """A State's fields but ``last_height_validators_changed``, which the
    state provider sets to H + 1 (stateprovider.go State) where the source
    kept its genesis height; the validator sets by hash."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "last_height_validators_changed":
            continue
        out[f.name] = v.hash() if hasattr(v, "hash") and hasattr(v, "validators") else (
            v.encode() if hasattr(v, "encode") else v)
    return out


def ss_syncer_state(syncer) -> dict | None:
    """What a stalled join's syncer holds: its candidates and retries."""
    if syncer is None:
        return None
    return {"candidates": [(k[0], sorted(c.peers), c.rejected)
                           for k, c in syncer._candidates.items()],
            "chunks": len(syncer._chunks), "retry_errors": syncer.retry_errors,
            "last_retry_error": repr(syncer.last_retry_error)}


def ss_expected_lanes(n: int) -> list:
    """The card calls of a join at n equal-power validators, by the light
    walk's arithmetic over the verified-triple cache: the provider's hop
    1 -> SS_HEIGHT + 1 (the trusting check's first k_t signers, then the
    light check's k lanes less those), its hop 1 -> SS_HEIGHT (the client
    verifies a height below its latest from the trusted height under it:
    the same two checks on that commit), the adjacent hop to SS_HEIGHT + 2
    (k lanes); then blocksync of SS_HEIGHT + 1, whose light check the cache
    holds and whose full check sends the other n - k."""
    total = n * BSYNC_POWER
    k = (total * 2 // 3) // BSYNC_POWER + 1
    k_t = (total // 3) // BSYNC_POWER + 1
    return [k_t, k - k_t, k_t, k - k_t, k, n - k]


def ss_join(source, servers, backend, tmpdir: str, label: str, counted: bool,
            rpc_url: str, timeout_s: float | None = None, last_wait_s: float = NODE_LAST_WAIT_S):
    """(l) once: a joiner app (``abci_app_main``, persistent kvstore, in a
    process of its own) and a fresh port Node built by ``default_new_node``
    with statesync on (``rpc_url`` its RPC server, trusting height 1 by its
    hash; the snapshot peer its persistent peer; discovery SS_DISCOVERY_S),
    under ``set_backend(backend)`` behind a LightRecorder; from ``start()``
    to blocksync's handoff at the source's last height but one, then up to
    ``last_wait_s`` for consensus to commit the last. ``counted``: the
    syncer, the provider, the HTTP client by route and the socket's apply
    timed in place, and the launches' threads kept. Returns the wall ms, the
    split, the calls, the restored and the final states, the node's
    counters and the app's requests."""
    from cometbft_tpu_torch.abci.client import SocketClient
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.light.provider import BlockStoreProvider, HTTPProvider
    from cometbft_tpu_torch.node import node as node_mod
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.statesync import LightClientStateProvider, Syncer

    last = len(source["blocks"])
    node_src = source["node"]
    anchor = BlockStoreProvider(BSYNC_CHAIN_ID, node_src["block_store"],
                                node_src["state_store"]).light_block(1)
    app = spawn(abci_app_main, "persistent_kvstore", 0, False)
    out, node, stopped = {"label": label}, None, False
    timeout0 = node_mod.STATESYNC_TIMEOUT_S
    try:
        app_addr = spawned_hello(app, f"(l) {label}: the joiner's app")["addr"]
        home = os.path.join(tmpdir, f"joiner-{label}")
        cfg = node_config(base__proxy_app=app_addr, rpc__laddr="",
                          p2p__persistent_peers=servers["peer_hello"]["addr"],
                          statesync__enable=True, statesync__rpc_servers=(rpc_url,),
                          statesync__trust_height=1, statesync__trust_hash=anchor.hash().hex(),
                          # The source's blocks carry BSYNC_T0's time; the node
                          # checks them against the wall clock.
                          statesync__trust_period=time.time() - BSYNC_T0 + 86_400.0,
                          statesync__discovery_time=SS_DISCOVERY_S)
        node_home(home, cfg)
        node_genesis(cfg, source["gen"].to_json())
        node = node_load(home)
        check(node._state_sync and type(node.proxy_app.snapshot) is SocketClient,
              f"(l) {label}: the joiner is not armed for statesync over a socket")
        if timeout_s is not None:
            node_mod.STATESYNC_TIMEOUT_S = timeout_s
        marks, applied = {}, []
        boot = node.state_store.bootstrap
        caught_up = node.blocksync_reactor.on_caught_up
        apply_chunk = node.proxy_app.snapshot.apply_snapshot_chunk

        def bootstrap(state):
            marks.setdefault("t_boot_start", time.perf_counter())
            boot(state)
            marks["restored"] = state
            marks["t_boot"] = time.perf_counter()

        def on_caught_up(state):
            marks["t_handoff"] = time.perf_counter()
            marks["handoff_height"] = state.last_block_height
            marks["calls_before_handoff"] = len(rec.calls)
            caught_up(state)

        def apply_snapshot_chunk(req):
            t = time.perf_counter()
            res = apply_chunk(req)
            applied.append(((time.perf_counter() - t) * 1e3, len(req.chunk)))
            return res

        node.state_store.bootstrap = bootstrap
        node.blocksync_reactor.on_caught_up = on_caught_up
        node.proxy_app.snapshot.apply_snapshot_chunk = apply_snapshot_chunk
        rec = LightRecorder(backend, keep=counted)
        stages = StageTimer()
        if counted:
            stages.wrap(Syncer, "sync_any", "sync_any", sync=False).wrap(
                Syncer, "_sync_one", "sync_one", sync=False).wrap(
                Syncer, "_fetch_and_apply", "fetch_and_apply", sync=False).wrap(
                LightClientStateProvider, "app_hash", "provider_app_hash", sync=False).wrap(
                LightClientStateProvider, "state", "provider_state", sync=False).wrap(
                LightClientStateProvider, "commit", "provider_commit", sync=False).wrap(
                HTTPProvider, "light_block", "provider_light_block", sync=False).wrap(
                HTTPClient, "call", lambda _c, method: f"{method}_call", sync=False).wrap(
                HTTPClient, "_post", lambda _c, method, _p: f"{method}_http", sync=False,
                count_bytes=True)
        ed25519._verified.clear()  # a cold cache, as in a fresh node's process
        be.set_backend(rec)
        launches0 = dict(_build.LAUNCHES)
        try:
            with counting_launches() as launch_threads, stages:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                node.start()
                deadline = time.monotonic() + SS_WAIT_S + (timeout_s or 0.0)
                while "t_handoff" not in marks or \
                        node.consensus_state.state.last_block_height < last - 1:
                    check(time.monotonic() < deadline,
                          f"(l) {label}: the joiner stopped at height "
                          f"{node.consensus_state.state.last_block_height}; statesync errors "
                          f"{node.statesync_errors} ({node.last_statesync_error!r}); syncer "
                          f"{ss_syncer_state(node.syncer)}")
                    time.sleep(0.005)
                t_sync = time.perf_counter()
                deadline = time.monotonic() + last_wait_s
                while node.consensus_state.state.last_block_height < last and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
                t_end = time.perf_counter()
                torch.cuda.synchronize()
                node.stop()  # before the calls are read: its last ones are counted
                stopped = True
        finally:
            be.set_backend(None)
        launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}
        syncer = node.syncer
        restored = marks.get("restored")
        reached = node.consensus_state.state.last_block_height
        out.update({
            "ms_to_bootstrap": (marks["t_boot"] - t0) * 1e3 if restored else None,
            "ms_to_blocksync_end": (t_sync - t0) * 1e3,
            "handoff_height": marks["handoff_height"], "reached": reached,
            "last_reached": reached == last,
            "last_height_ms": (t_end - marks["t_handoff"]) * 1e3 if reached == last else None,
            "bootstrap_ms": (marks["t_boot"] - marks["t_boot_start"]) * 1e3 if restored else None,
            "blocksync_ms": (t_sync - marks["t_boot"]) * 1e3 if restored else None,
            "restored_height": restored.last_block_height if restored else None,
            "calls": [c["lanes"] for c in rec.calls],
            "call_classes": [c["class"] for c in rec.calls],
            "calls_before_handoff": marks["calls_before_handoff"],
            "backend_ms": [c["ms"] for c in rec.calls], "launches": launched,
            "launch_threads": {f"{k}@{t}": n for (k, t), n in launch_threads.items()},
            "chunks": len(applied), "chunk_bytes": sum(b for _, b in applied),
            "apply_ms": sum(ms for ms, _ in applied),
            "statesync_errors": node.statesync_errors,
            "last_statesync_error": repr(node.last_statesync_error)
            if node.last_statesync_error else None,
            "retry_errors": syncer.retry_errors if syncer else None,
            "last_retry_error": str(syncer.last_retry_error)
            if syncer and syncer.last_retry_error else None,
            "errors": node_errors(node), "threads_left": node.threads_left_at_stop,
            "restored_state": restored, "final_state": node.consensus_state.state,
        })
        if counted:
            table = rpc_route_split(stages)
            sync_any = table.get("sync_any", {}).get("ms", 0.0)
            sync_one = table.get("sync_one", {}).get("ms", 0.0)
            fetch = table.get("fetch_and_apply", {}).get("ms", 0.0)
            out["split"] = {
                "discovery_ms": sync_any - sync_one, "chunk_fetch_ms": fetch - out["apply_ms"],
                "apply_over_socket_ms": out["apply_ms"],
                "provider_ms": {k[len("provider_"):]: v for k, v in table.items()
                                if k.startswith("provider_")},
                "http_by_route": {k: v for k, v in table.items()
                                  if k.endswith(("_call", "_http", "_json_decode"))},
                "card_calls": [[c["lanes"], c["ms"]] for c in rec.calls],
                "bootstrap_ms": out["bootstrap_ms"], "blocksync_ms": out["blocksync_ms"]}
            out["triples"] = rec.triples
        app_conn = app[1]
        app_conn.send("stats")
        out["app"] = app_conn.recv()
    finally:
        if node is not None and not stopped:
            node.stop()
        node_mod.STATESYNC_TIMEOUT_S = timeout0
        out["app_exit"] = spawned_end(app)
    return out


def ss_gates(source, run: dict, label: str, first: bool = True) -> None:
    """(l)'s gates on one join (see ``statesync_phase``). ``first``: the
    counted join under ``TorchBackend()``, which sends every call to the
    card (the process default's hybrid takes small batches on the host), so
    each call is three launches from the device-owner thread, and whose
    peer's address book holds no joiner gone since (a later joiner's PEX
    dials those and fails: reported, not gated, as for (k)'s timed runs)."""
    from cometbft_tpu_torch.state import store as state_store

    last, n = len(source["blocks"]), source["n_vals"]
    want = {h: state_store._decode_state(source["states"][h - 1]) for h in (SS_HEIGHT, last - 1)}
    check(run["statesync_errors"] == 0 and run["restored_height"] == SS_HEIGHT,
          f"(l) {label}: statesync errors {run['statesync_errors']} "
          f"({run['last_statesync_error']}), restored {run['restored_height']}")
    check(ss_state_fields(run["restored_state"]) == ss_state_fields(want[SS_HEIGHT]),
          f"(l) {label}: the restored state differs from the source's at {SS_HEIGHT}")
    check(run["handoff_height"] == last - 1 and run["reached"] >= last - 1,
          f"(l) {label}: blocksync handed off at {run['handoff_height']}")
    final = run["final_state"]
    check(final.app_hash == state_store._decode_state(
        source["states"][final.last_block_height - 1]).app_hash
          and (final.last_block_height > last - 1
               or ss_state_fields(final) == ss_state_fields(want[last - 1])),
          f"(l) {label}: the state at {final.last_block_height} differs from the source's")
    reqs = run["app"]["requests"]
    check(reqs.get("RequestOfferSnapshot") == 1
          and reqs.get("RequestApplySnapshotChunk") == run["chunks"] > 1
          and reqs.get("RequestInfo", 0) >= 1,
          f"(l) {label}: the joiner's app saw {reqs} for {run['chunks']} chunks")
    before = run["calls"][:run["calls_before_handoff"]]
    check(before == ss_expected_lanes(n),
          f"(l) {label}: card calls {before}, the light walk's arithmetic gives "
          f"{ss_expected_lanes(n)}")
    calls = len(run["calls"])
    if first:
        check(run["launches"] == {"sha512": calls, "decompress": calls, "ladder": calls,
                                  "sha256": 0, "bn254": 0},
              f"(l) {label}: launches {run['launches']} for {calls} card calls")
        check({k.split("@", 1)[1] for k in run["launch_threads"]} <= {"cmtpu-torch-dev"},
              f"(l) {label}: kernels launched from {run['launch_threads']}")
    check(all(v == 0 for k, v in run["errors"].items() if first or k != "pex_dial_errors"),
          f"(l) {label}: errors {run['errors']}")
    check(run["threads_left"] == 0 and run["app_exit"] == 0,
          f"(l) {label}: {run['threads_left']} threads outlived stop(); the app exited "
          f"{run['app_exit']}")


def ss_refusal(source, servers, torch_backend, tmpdir: str) -> dict:
    """Under ``--statesync``: the join with the doctored server as its RPC
    server (block SS_HEIGHT + 1's commit with one bit flipped), its
    statesync deadline cut to SS_REFUSAL_TIMEOUT_S: the light client refuses
    the header with the reference's error, the syncer keeps the snapshot and
    retries it (the reference's behaviour) until its deadline, the node
    counts one statesync error and falls back to blocksync from genesis,
    which reaches the last height but one with the source's blocks."""
    tip_sig = source["node"]["block_store"].load_seen_commit(SS_HEIGHT + 1).signatures[0].signature
    flipped = bytes([tip_sig[0] ^ 0x01]) + tip_sig[1:]
    run = ss_join(source, servers, torch_backend, tmpdir, "refused", counted=False,
                  rpc_url=servers["doctored"], timeout_s=SS_REFUSAL_TIMEOUT_S, last_wait_s=0.0)
    want = f"wrong signature (#0): {flipped.hex().upper()}"
    check(run["statesync_errors"] == 1 and "ErrNoSnapshots" in (run["last_statesync_error"] or "")
          and run["retry_errors"] >= 1 and run["last_retry_error"] == want
          and run["restored_height"] is None and run["handoff_height"] == len(source["blocks"]) - 1,
          f"(l) refused: statesync errors {run['statesync_errors']} "
          f"({run['last_statesync_error']}), retries {run['retry_errors']} "
          f"({run['last_retry_error']!r}, want {want!r}), restored {run['restored_height']}, "
          f"handoff at {run['handoff_height']}")
    check(run["app"]["requests"].get("RequestOfferSnapshot", 0) == 0,
          f"(l) refused: the app was offered a snapshot: {run['app']['requests']}")
    check(all(v == 0 for k, v in run["errors"].items() if k != "pex_dial_errors"),
          f"(l) refused: errors {run['errors']}")
    check(run["threads_left"] == 0 and run["app_exit"] == 0,
          f"(l) refused: {run['threads_left']} threads outlived stop()")
    return {k: run[k] for k in ("statesync_errors", "last_statesync_error", "retry_errors",
                                "last_retry_error", "ms_to_blocksync_end", "handoff_height",
                                "calls", "errors")}


def drive_statesync_path(sources, torch_backend, dev, servers, tmpdir: str,
                         with_default: bool) -> dict:
    """The statesync phase (module docstring, step 22): (l)'s counted join
    under ``TorchBackend()``, under ``--statesync`` a join under the process
    default and the refusal; the launch counts of the whole drive; then the
    verify kernels at (l)'s batches."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.sidecar import backend as be

    source = sources["10k"]
    t_wait = time.perf_counter()
    ss_servers_ready(servers, source)
    wait_s = time.perf_counter() - t_wait
    _build.reset_launches()
    stamp("statesync: (l) under TorchBackend()")
    counted = ss_join(source, servers, torch_backend, tmpdir, "torch", counted=True,
                      rpc_url=servers["honest"])
    ss_gates(source, counted, "torch")
    print(f"statesync (l) counted: restored {counted['restored_height']} from "
          f"{counted['chunks']} chunks of {counted['chunk_bytes']} bytes in "
          f"{counted['ms_to_bootstrap']:.0f} ms, blocksync to {counted['handoff_height']} at "
          f"{counted['ms_to_blocksync_end']:.0f} ms, the last height "
          f"{'in ' + format(counted['last_height_ms'], '.0f') + ' ms' if counted['last_reached'] else 'not committed'}; "
          f"card calls {counted['calls']}; split {json.dumps(counted['split'])}", flush=True)
    runs = {"torch": [counted["ms_to_blocksync_end"]], "auto": []}
    out = {"counted": counted, "servers_ready_s": servers["ready_s"], "servers_wait_s": wait_s}
    if with_default:
        with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                     CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
            auto = be._make_backend()
        try:
            stamp("statesync: (l) under the process default")
            r = ss_join(source, servers, auto, tmpdir, "auto", counted=False,
                        rpc_url=servers["honest"])
            ss_gates(source, r, "auto", first=False)
            runs["auto"].append(r["ms_to_blocksync_end"])
            out["auto"] = {k: v for k, v in r.items()
                           if k not in ("restored_state", "final_state")}
        finally:
            auto.close()
        stamp("statesync: (l) refused by a doctored server")
        out["refused"] = ss_refusal(source, servers, torch_backend, tmpdir)
    out["launches"] = dict(_build.LAUNCHES)
    out["runs_ms"] = runs
    stamp("statesync: the kernels at the path's batches")
    # The light walk's batches (each lane count once) and the smallest of the
    # consensus catch-up after the handoff; four lanes corrupted, one under 8.
    triples = counted.pop("triples")
    picks = {len(t[0]): t for t in triples[:counted["calls_before_handoff"]]}
    after = triples[counted["calls_before_handoff"]:]
    if after:
        smallest = min(after, key=lambda t: len(t[0]))
        picks.setdefault(len(smallest[0]), smallest)
    batches = {f"statesync_{n}": (corrupt_valid if n < 8 else corrupt_four)(*t)
               for n, t in sorted(picks.items())}
    out["kernels"] = bsync_window_kernels(batches, dev)
    for k in ("restored_state", "final_state"):
        counted.pop(k)
    return out


def statesync_phase(sources, backend, dev, card, records, servers, tmpdir: str,
                    with_default: bool = False) -> dict:
    """Runs the statesync path (step 22), prints its metric and gates, merges
    its kernel comparisons into ``records``; returns its launches. Ends
    (l)'s servers."""
    start = time.perf_counter()
    try:
        out = drive_statesync_path(sources, backend, dev, servers, tmpdir, with_default)
    finally:
        codes = ss_servers_end(servers)
    check(codes == {"rpc": 0, "peer": 0}, f"(l): the servers exited {codes}")
    for k in ("sha512", "decompress", "ladder"):
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    c = out["counted"]
    print(f"statesync path ok ((l) a fresh node restored height {c['restored_height']} of the "
          f"{N_SIGS}-validator source from a snapshot peer over TCP, the snapshot verified by "
          f"its light client over HTTP, its kvstore restored over the ABCI socket "
          f"({c['app']['requests']}), bootstrapped and blocksynced to {c['handoff_height']}, "
          f"the last height {'committed' if c['last_reached'] else 'not committed'} by "
          f"consensus; statesync_errors 0"
          + (f"; refused with the doctored server: {out['refused']['last_retry_error']}, "
             f"fell back to blocksync" if "refused" in out else "")
          + f"); launches {out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    print(json.dumps({"metric": "statesync_join_10k_ms", "value": c["ms_to_blocksync_end"],
                      "to_bootstrap_ms": c["ms_to_bootstrap"], "validators": N_SIGS,
                      "snapshot_height": SS_HEIGHT, "heights": BSYNC_HEIGHTS,
                      "txs_a_block": BSYNC_TXS, "chunks": c["chunks"],
                      "chunk_bytes": c["chunk_bytes"], "split": c["split"],
                      "runs_ms": out["runs_ms"],
                      "by_backend": {k: statistics.median(v) for k, v in out["runs_ms"].items() if v},
                      "cuts": {"discovery_s": SS_DISCOVERY_S,
                               "refused_statesync_deadline_s": SS_REFUSAL_TIMEOUT_S},
                      "counted": {k: v for k, v in c.items() if k != "split"},
                      "auto": out.get("auto"), "refused": out.get("refused"),
                      "servers_ready_s": out["servers_ready_s"],
                      "servers_wait_s": out["servers_wait_s"], **common}), flush=True)
    print(json.dumps({"statesync": {"kernels": out["kernels"], "launches": out["launches"]},
                      "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"]


def statesync_only(card, dev) -> int:
    """``--statesync``: the keys, the 10,240-validator blocksync source, (l)'s
    servers and the statesync phase alone, with the process default's join
    and the refusal (a quick check of that phase on the card; no result
    line)."""
    import tempfile

    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    big = bsync_10k_source(fixtures, backend)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    procs: list = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            servers = ss_servers_start(big, tmp, procs)
            launches = statesync_phase({"10k": big}, backend, dev, card, records, servers, tmp,
                                       with_default=True)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(json.dumps({"statesync_launches": launches, "max_abs_err": records}), flush=True)
    return 0


# (m) An operator's validator: a one-validator port Node by ``default_new_node``
# whose key is in a signer process (``priv_validator_laddr``) and whose kvstore
# is a process behind the socket, with a LightProxy in front of its RPC.
OP_CHAIN_ID = "chip-smoke-operator"
OP_SECRET = b"chip-smoke-operator-key"
OP_TXS = 64
OP_QUERIES = 16
OP_AFTER_RESTART = 3  # heights committed after the signer's restart


class ProxyTamperer:
    """An RPC client for a LightProxy that corrupts abci_query values or
    strips their proofs (tests/test_light_proxy.py's _Tamperer)."""

    def __init__(self, inner, corrupt: bool = False, strip_proofs: bool = False):
        self.inner, self.corrupt, self.strip_proofs = inner, corrupt, strip_proofs

    def call(self, method, **params):
        res = self.inner.call(method, **params)
        if method == "abci_query":
            if self.strip_proofs:
                res["response"].pop("proofOps", None)
            if self.corrupt:
                res["response"]["value"] = base64.b64encode(b"evil").decode()
        return res


def op_signer(laddr: str, key_file: str, state_file: str) -> subprocess.Popen:
    """``python -m cometbft_tpu_torch.privval.signer`` dialing ``laddr``."""
    return subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.privval.signer", "--addr", laddr,
         "--chain-id", OP_CHAIN_ID, "--key-file", key_file, "--state-file", state_file],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def op_proxy(node_url: str, wrap=None):
    """A LightProxy on 127.0.0.1:0 over the port's light client (trusting
    the node's height 1, over HTTPProvider) and the node's RPC: (proxy, its
    HTTPClient)."""
    from cometbft_tpu_torch.libs.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import HTTPProvider
    from cometbft_tpu_torch.light.proxy import LightProxy
    from cometbft_tpu_torch.light.store import LightStore
    from cometbft_tpu_torch.rpc.client import HTTPClient

    provider = HTTPProvider(OP_CHAIN_ID, HTTPClient(node_url, timeout=RPC_WAIT_S))
    client = Client(OP_CHAIN_ID, TrustOptions(3_600 * 10**9, 1, provider.light_block(1).hash()),
                    provider, [], LightStore(MemDB()))
    rpc = HTTPClient(node_url, timeout=RPC_WAIT_S)
    proxy = LightProxy(client, wrap(rpc) if wrap else rpc, port=0)
    proxy.start()
    return proxy, HTTPClient(f"http://127.0.0.1:{proxy.port}", timeout=RPC_WAIT_S)


def operator_path(torch_backend, tmpdir: str, procs: list) -> dict:
    """(m): the signer process (``python -m cometbft_tpu_torch.privval.signer``
    over a FilePV) and the app process (``abci_app_main``, the provable
    kvstore) first; the node by ``default_new_node`` (``priv_validator_laddr``
    a unix socket, ``proxy_app`` the app's ``tcp://`` address, RPC on) under a
    recording ``TorchBackend()``; a LightProxy in front of its RPC, trusting
    height 1. OP_TXS transactions through the proxy's ``broadcast_tx_sync``,
    then the heights that hold them; OP_QUERIES proven ``abci_query``s
    through the proxy (each value the one sent; the proxy checks each proof
    against its light client's verified app hash); a tampered value and an
    answer stripped of its proofs refused with the reference's errors; the
    signer killed and started again: the node commits OP_AFTER_RESTART
    heights more, each height's one precommit the signer's over the block
    the chain holds, the signer's state at the last. Every card call is the
    proxy's header check, one lane, three launches from the device-owner
    thread; no error counted; no thread of the node left."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.privval.file import FilePV
    from cometbft_tpu_torch.rpc.client import RPCClientError
    from cometbft_tpu_torch.sidecar import backend as be
    from cometbft_tpu_torch.types import cmttime
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    key_file, state_file = (os.path.join(tmpdir, f"operator-{n}.json") for n in ("key", "state"))
    pv = FilePV(ed25519.gen_priv_key_from_secret(OP_SECRET), key_file, state_file)
    pv.save()
    pub = pv.get_pub_key()
    gen = GenesisDoc(chain_id=OP_CHAIN_ID, genesis_time=cmttime.now(),
                     validators=[GenesisValidator(pub.address(), pub, 10, "operator")])
    gen.validate_and_complete()
    laddr = f"unix://{tmpdir}/operator-pv.sock"
    signer = op_signer(laddr, key_file, state_file)
    procs.append(signer)
    app = spawn(abci_app_main, "kvstore", 0, True)
    out, node, proxies, stopped = {}, None, [], False
    rec = LightRecorder(torch_backend)
    with counting_launches() as launch_threads:
        try:
            app_addr = spawned_hello(app, "(m): the app")["addr"]
            home = os.path.join(tmpdir, "operator")
            cfg = node_config(base__proxy_app=app_addr, base__priv_validator_laddr=laddr)
            node_home(home, cfg)
            node_genesis(cfg, gen.to_json())
            be.set_backend(rec)
            launches0 = dict(_build.LAUNCHES)
            node = node_load(home)  # asks the signer for the key
            check(type(node.priv_validator).__name__ == "RetrySignerClient"
                  and type(node.proxy_app.consensus).__name__ == "SocketClient",
                  "(m): the node did not take the signer or the socket")
            node.start()
            wait_until(lambda: node.block_store.height() >= 2, "(m): the chain never started")
            url = f"http://127.0.0.1:{node.rpc_port}"
            proxy, cli = op_proxy(url)
            proxies.append(proxy)
            h0 = node.block_store.height()
            t0 = time.perf_counter()
            for i in range(OP_TXS):
                res = cli.broadcast_tx_sync(b"op-%03d=value-%d" % (i, i))
                check(res["code"] == 0, f"(m): broadcast_tx_sync answered {res}")
            stored = {}  # height -> the transactions of (m) it holds

            def all_stored() -> bool:
                for h in range(max(stored, default=h0) + 1, node.block_store.height() + 1):
                    stored[h] = [tx for tx in node.block_store.load_block(h).data.txs
                                 if tx.startswith(b"op-")]
                return sum(len(v) for v in stored.values()) >= OP_TXS

            wait_until(all_stored, "(m): the transactions never committed")
            t_txs = time.perf_counter()
            h_txs = max(stored)
            holding = sorted(h for h, v in stored.items() if v)
            check(sorted(tx for v in stored.values() for tx in v)
                  == [b"op-%03d=value-%d" % (i, i) for i in range(OP_TXS)],
                  f"(m): heights {holding} do not hold the {OP_TXS} transactions once")
            # The app writes a block's transactions before its Commit: query once
            # the block after the last one holding them is stored.
            wait_until(lambda: node.consensus_state.state.last_block_height >= h_txs + 1,
                       "(m): the chain stopped after the transactions")
            query_ms = []
            for i in range(OP_QUERIES):
                t = time.perf_counter()
                res = cli.abci_query("/store", b"op-%03d" % i, prove=True)
                query_ms.append((time.perf_counter() - t) * 1e3)
                check(base64.b64decode(res["response"]["value"]) == b"value-%d" % i
                      and res["response"]["proofOps"]["ops"],
                      f"(m): the proven query of op-{i:03d} answered {res['response']}")
            refused = {}
            for name, wrap, want in (
                    ("tampered", lambda r: ProxyTamperer(r, corrupt=True), "proof verification failed: "),
                    ("stripped", lambda r: ProxyTamperer(r, strip_proofs=True),
                     "no proof ops (value-op apps cannot prove absence; query an existing key or use "
                     "an app with range proofs)")):
                bad, bad_cli = op_proxy(url, wrap)
                proxies.append(bad)
                try:
                    bad_cli.abci_query("/store", b"op-000", prove=True)
                    check(False, f"(m): the {name} answer was accepted")
                except RPCClientError as e:
                    check(str(e).find(want) >= 0, f"(m): the {name} answer raised {e}")
                    refused[name] = str(e)
            # The signer killed and started again while the node runs.
            h_kill = node.block_store.height()
            t_kill = time.perf_counter()
            signer.kill()
            signer.wait()
            signer = op_signer(laddr, key_file, state_file)
            procs.append(signer)
            wait_until(lambda: node.block_store.height() >= h_kill + OP_AFTER_RESTART,
                       f"(m): the node stopped at {node.block_store.height()} after the signer's "
                       f"restart at {h_kill}")
            restart_ms = (time.perf_counter() - t_kill) * 1e3
            final = node.block_store.height()
            node_errs = node_errors(node)
            node.stop()
            stopped = True
            torch.cuda.synchronize()
        finally:
            be.set_backend(None)
            for p in proxies:
                p.stop()
            if node is not None and not stopped:
                node.stop()
            app_exit = spawned_end(app)
            signer.kill()
            signer.wait()
    launched = {k: _build.LAUNCHES[k] - launches0[k] for k in launches0}
    # Each height's one precommit is the signer's, over the block the chain
    # holds; the signer's state is at the last height it signed.
    for h in range(1, final):
        commit = node.block_store.load_block(h + 1).last_commit
        check(len(commit.signatures) == 1 and commit.block_id.hash ==
              node.block_store.load_block(h).hash()
              and pure.verify_zip215(pub.bytes(), commit.vote_sign_bytes(OP_CHAIN_ID, 0),
                                     commit.signatures[0].signature),
              f"(m): height {h}'s precommit is not the signer's over the stored block")
    signed = json.load(open(state_file))
    check(int(signed["height"]) >= final, f"(m): the signer's state is at {signed}, the chain "
          f"at {final}")
    calls = len(rec.calls)
    check(calls > 0 and all(c["lanes"] == 1 for c in rec.calls)
          and launched == {"sha512": calls, "decompress": calls, "ladder": calls, "sha256": 0,
                           "bn254": 0},
          f"(m): launches {launched} for card calls of {rec.lanes()} lanes")
    check({t for (_, t) in launch_threads} <= {"cmtpu-torch-dev"},
          f"(m): kernels launched from {dict(launch_threads)}")
    check(all(v == 0 for v in node_errs.values()), f"(m): errors {node_errs}")
    check(node.threads_left_at_stop == 0 and app_exit == 0,
          f"(m): {node.threads_left_at_stop} threads outlived stop(); the app exited {app_exit}")
    out.update({
        "ms_per_height": (t_txs - t0) * 1e3 / max(1, h_txs - h0), "heights_of_txs": holding,
        "tx_window_heights": h_txs - h0, "tx_window_ms": (t_txs - t0) * 1e3,
        "proxy_query_ms": statistics.median(query_ms), "proxy_query_runs_ms": query_ms,
        "refused": refused, "signer_restart": {"at_height": h_kill, "heights_after": final - h_kill,
                                               "ms_to_3_heights": restart_ms},
        "final_height": final, "card_calls": calls, "launches": launched,
        "backend_ms_median": statistics.median(c["ms"] for c in rec.calls)})
    return out


def wait_until(cond, what: str, timeout: float = NODE_WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, what)
        time.sleep(0.01)


N_SHARDS = 2


def compare_digests(leaves, merkle_oracle, dev, sms, clock_hz):
    """The sha256 kernel's digests entry (counterpart of merkle_kernel.
    merkle_root_pow2) against digest_tree_root_plain on every word at the
    block's 65,536 leaf digests and at 10,000, 3 and 1 of them, and
    merkle_root_pow2 against the host tree; times at 65,536. Returns the
    record and the leaf digests (int32[8, n] on the card)."""
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import sha256_kernel as sha

    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in leaves])
    digests = mk.leaf_core(torch.from_numpy(blocks.view(np.int32)).to(dev),
                           torch.from_numpy(nblocks).to(dev))
    err = 0
    for m in (len(leaves), N_RAGGED_LEAVES, 3, 1):
        part = digests[:, :m]
        got = mk.digest_tree_root(part)
        err = max(err, max_abs_err(got, mk.digest_tree_root_plain(part)))
        check(mk._root_bytes(got) == merkle_oracle(leaves[:m]),
              f"sha256 digests entry: {m}-digest root != hash_from_byte_slices")
    check(err == 0, f"sha256 digests entry != plain (max abs err {err})")
    check(mk.merkle_root_pow2(digests) == merkle_oracle(leaves),
          "merkle_root_pow2 != hash_from_byte_slices at 65,536 digests")
    n = digests.shape[1]
    t_b = bound_ms(2 * (n - 1) * SHA256_BLOCK_OPS, 32 * n + 32, sms, clock_hz)
    rec = {
        "shape": f"{n} leaf digests, 2 launches ({-(-n // mk.CHUNK)} chunks of {mk.CHUNK})",
        "ms": time_cuda(lambda: mk.digest_tree_root(digests), 50),
        # the profiler has dropped records of this pair of launches: up to
        # three traces, the first that holds every launch
        "kernel_ms": next((t for t in (kernel_ms(lambda: mk.digest_tree_root(digests), launches=2)
                                       for _ in range(3)) if t is not None), None),
        "queued_ms": time_queued(lambda: mk.digest_tree_root(digests), 50),
        "plain_ms": time_cuda(lambda: mk.digest_tree_root_plain(digests), 1, warmup=0),
        "bound_ms": t_b[0], "bound_by": t_b[1], "chain_floor_ms": chain_floor_ms(0, n, clock_hz),
        "max_abs_err": err, "replaces": "cometbft_tpu/ops/merkle_kernel.py:214",
    }
    print(f"sha256 digests entry, {n} digests: {rec['kernel_ms']} ms CUPTI, {rec['queued_ms']} "
          f"queued, {rec['ms']} by events; bound {rec['bound_ms']}, chain floor "
          f"{rec['chain_floor_ms']}", flush=True)
    return rec, digests


@contextlib.contextmanager
def virtual_width(dev, width: int):
    """Route as a host with ``width`` cards would, on ``width`` virtual
    shards of ``dev``: ed25519_kernel's mesh_width and local_devices, which
    merkle_kernel and bn254_kernel read too, replaced inside the block."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    saved = ek.mesh_width, ek.local_devices
    ek.mesh_width = lambda device=None: width
    ek.local_devices = lambda dev_type, w: [dev] * w
    try:
        yield
    finally:
        ek.mesh_width, ek.local_devices = saved


def drive_mesh_path(fixtures, bn_fix, pure, merkle_oracle, dev, digests) -> dict:
    """The lane-split programs on N_SHARDS virtual shards of ``dev``, each
    step's launches checked exactly: TorchBackend routed over the mesh (K1
    for the commit, K2 for the root) and Bn254DeviceBackend (K7, the
    aggregate and the one with a share left out); K1 sharded and
    replicated, K3, K2 and K4 called directly; K5 on a one-rank group
    (``nccl`` on the card) over one shard and over N_SHARDS, and
    MultihostShardBackend. Bitmaps equal TorchBackend's on one device, roots
    the host's. Returns the launches and the mesh and bn254 counters'
    steps."""
    import torch.distributed as dist

    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import bn254_kernel as bk
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import merkle_kernel as mk
    from cometbft_tpu_torch.ops import multihost, sharded
    from cometbft_tpu_torch.ops import sha256_kernel as sha
    from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    n = len(pubs)
    bad_msgs, bad_sigs, want_bad = corrupted_commit(pure, msgs, sigs)
    one_ok, one_bits = TorchBackend(device=dev).batch_verify(pubs, bad_msgs, bad_sigs)
    check(not one_ok and [i for i, b in enumerate(one_bits) if not b] == want_bad,
          "mesh phase: the one-device bitmap of the corrupted commit is wrong")
    root = merkle_oracle(leaves)
    good_ops, good_mask = ek.pack_batch(pubs, msgs, sigs, 1)
    bad_ops, bad_mask = ek.pack_batch(pubs, bad_msgs, bad_sigs, 1)
    blocks, nblocks = sha.pack_messages([b"\x00" + t for t in leaves])
    mesh = sharded.make_mesh([dev] * N_SHARDS)

    def bits_of(mask, dev_ok):
        return [bool(m and d) for m, d in zip(mask[:n], np.asarray(dev_ok)[:n])]

    def step(name, fn, verifies=0, **want):
        before = dict(_build.LAUNCHES)
        out = fn()
        got = {k: _build.LAUNCHES[k] - before[k] for k in before}
        full = {k: want.get(k, 0) for k in before}
        for k in ("sha512", "decompress", "ladder"):
            full[k] = verifies
        check(got == full, f"mesh path, {name}: launches {got}, expected {full}")
        return out

    mc0, bc0 = ek.mesh_counters(), bk.counters()
    _build.reset_launches()
    with virtual_width(dev, N_SHARDS):
        backend = TorchBackend(device=dev)
        check(backend.mesh_width() == N_SHARDS, "mesh phase: TorchBackend's routing width")
        ok, bits = step("TorchBackend, commit", lambda: backend.batch_verify(pubs, msgs, sigs),
                        N_SHARDS)
        check(ok and all(bits) and len(bits) == n, "mesh phase: the commit did not verify")
        ok, bits = step("TorchBackend, corrupted commit",
                        lambda: backend.batch_verify(pubs, bad_msgs, bad_sigs), N_SHARDS)
        check(bits == one_bits, "mesh phase: K1 bitmap != TorchBackend's on one device")
        check(step("TorchBackend, root (K2)", lambda: backend.merkle_root(leaves),
                   sha256=3 * N_SHARDS + 2) == root, "mesh phase: K2 root != the host's")
        agg = Bn254DeviceBackend(device=dev)
        check(step("K7 aggregate", lambda: agg.aggregate_verify(bn_fix["pubs"], bn_fix["msgs"],
                                                                bn_fix["agg"]), bn254=2 * N_SHARDS)
              is True, "mesh phase: the aggregate did not verify over the lane mesh")
        check(step("K7 aggregate, a share left out",
                   lambda: agg.aggregate_verify(bn_fix["pubs"], bn_fix["msgs"], bn_fix["poisoned"]),
                   bn254=2 * N_SHARDS) is False,
              "mesh phase: the aggregate with a share left out verified over the lane mesh")
    mc, bc = ek.mesh_counters(), bk.counters()
    counters = {k: mc[k] - mc0[k] for k in ("sharded_dispatches", "padded_lanes",
                                            "merkle_sharded_dispatches")}
    counters["bn254_sharded_dispatches"] = bc["sharded_dispatches"] - bc0["sharded_dispatches"]
    pad = 2 * (ek.bucket_for(n, N_SHARDS) - n)
    check(counters == {"sharded_dispatches": 2, "padded_lanes": pad, "merkle_sharded_dispatches": 1,
                       "bn254_sharded_dispatches": 4}, f"mesh phase: counters stepped {counters}")

    dev_ok = step("K1", lambda: sharded.sharded_verify_fn(mesh)(*bad_ops).cpu().numpy(), N_SHARDS)
    rep_ok = step("K1 replicated",
                  lambda: sharded.sharded_verify_replicated_fn(mesh)(*bad_ops).cpu().numpy(),
                  N_SHARDS)
    check((dev_ok == rep_ok).all() and bits_of(bad_mask, dev_ok) == one_bits,
          "mesh phase: K1 sharded and replicated bitmaps differ or != TorchBackend's")
    check(mk._root_bytes(step("K3", lambda: sharded.sharded_merkle_fn(mesh)(digests),
                              sha256=2 * N_SHARDS + 2)) == root, "mesh phase: K3 root")
    check(mk._root_bytes(step("K2", lambda: sharded.sharded_leaves_to_root_fn(mesh)(blocks, nblocks),
                              sha256=3 * N_SHARDS + 2)) == root, "mesh phase: K2 root")
    commit_step = sharded.sharded_commit_step_fn(mesh)
    for ops, mask, valid, want in ((good_ops, good_mask, True, [True] * n),
                                   (bad_ops, bad_mask, False, one_bits)):
        ok_t, all_valid, r = step("K4", lambda: commit_step(*ops, digests), N_SHARDS,
                                  sha256=2 * N_SHARDS + 2)
        check(bool(all_valid) is valid and mk._root_bytes(r) == root
              and bits_of(mask, ok_t.cpu().numpy()) == want,
              f"mesh phase: K4 step (all_valid {bool(all_valid)}, expected {valid})")

    kind = "nccl" if dev.type == "cuda" else "gloo"
    one_rank = multihost.distributed_init(dist.HashStore(), 1, 0,
                                          local_devices=None if dev.type == "cuda" else 1)
    try:
        check(dist.get_backend() == kind and one_rank.width == 1, "mesh phase: the one-rank group")
        wide = sharded.make_mesh([dev] * N_SHARDS, group=dist.group.WORLD)
        for m in (one_rank, wide):
            k = m.local_width
            ok_np, all_valid, r = step(f"K5 commit step, {k} shards",
                                       lambda: multihost.multihost_commit_step(m, bad_ops, digests),
                                       k, sha256=2 * k + 2)
            check(all_valid is False and sha.digest_words_to_bytes(r)[0] == root
                  and bits_of(bad_mask, ok_np) == one_bits, "mesh phase: K5 commit step")
            _, bits = step(f"K5 verify, {k} shards",
                           lambda: multihost.multihost_verify(m, pubs, bad_msgs, bad_sigs), k)
            check(bits == one_bits, "mesh phase: K5 verify bitmap != TorchBackend's")
        shard = multihost.MultihostShardBackend(wide, [])
        _, bits = step("MultihostShardBackend", lambda: shard.batch_verify(pubs, bad_msgs, bad_sigs),
                       N_SHARDS)
        check(bits == one_bits and shard.mesh_width() == N_SHARDS,
              "mesh phase: MultihostShardBackend")
    finally:
        dist.destroy_process_group()
    launches = dict(_build.LAUNCHES)
    check(all(launches.values()), f"mesh phase: a kernel of the path was not launched: {launches}")
    return {"launches": launches, "counters": counters, "good_ops": good_ops,
            "commit_step": commit_step}


def mesh_metrics(mesh_out, digests) -> dict:
    """mesh_commit_step_10k_64k_ms: one K4 step over N_SHARDS virtual shards,
    the commit's packed host operands in, the bitmap, all-valid bit and root
    back on the host; median of 5, and one traced step (the device's busy
    time and each kernel's and copy's)."""
    step, ops = mesh_out["commit_step"], mesh_out["good_ops"]

    def run():
        ok, all_valid, root = step(*ops, digests)
        return ok.cpu(), bool(all_valid), root.cpu()

    runs = [time_host(run) for _ in range(5)]
    trace = trace_call(run)
    trace["kernels_ms"] = dict(collections.Counter(trace["kernels_ms"]).most_common(8))
    return {"metric": "mesh_commit_step_10k_64k_ms", "value": statistics.median(runs),
            "runs_ms": runs, "shards": N_SHARDS,
            "label": "two virtual shards on one card, not a multi-GPU figure",
            "traced_step": trace}


def time_bn254_lanes() -> int:
    """``--bn254-lanes``: only the bn254 kernel's time by events at each of
    BN254_LANE_COUNTS, for the cometbft_tpu_torch beside this file (a copy
    of it in an older checkout times that checkout's kernel, in the same
    call as this one's). Prints {"bn254_ms_by_lanes": {lanes: ms}}."""
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.ops import bn254_kernel as bk

    lanes = bn254_lanes(bn, max(BN254_LANE_COUNTS))
    out = {}
    for n in BN254_LANE_COUNTS:
        ops = bk.operands_to_device(bk._pack(lanes[:n], n), torch.device("cuda"))
        out[n] = time_cuda(lambda: bk.miller_values(*ops), 5)
    print(json.dumps({"bn254_ms_by_lanes": out}), flush=True)
    return 0


def blocksync_phase(fixtures, backend, dev, card, records, with_default: bool = False):
    """Builds the blocksync sources and runs the blocksync path (step 16),
    prints its metrics and gates, merges its kernel comparisons into
    ``records``; returns its launches and the sources (the later phases
    go on with them). The syncs are timed under the process default too
    only ``with_default`` (``--blocksync``)."""
    bsync_start = time.perf_counter()
    sources = bsync_sources(fixtures, backend)
    bs_out = drive_blocksync_path(sources, backend, dev, with_default)
    launches = bs_out.pop("launches")
    for k in ("sha512", "decompress", "ladder"):  # held at the path's own batches too
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in bs_out["window_kernels"].values()])
    print(f"blocksync path ok (a fresh node synced the {N_SIGS}-validator chain's "
          f"{BSYNC_HEIGHTS - 1} heights and the {BSYNC_SMALL}-validator chain's "
          f"{BSYNC_SMALL_HEIGHTS - 1} from two peer doubles, state and blocks equal to the "
          f"source's; window batches {bs_out['gates']['10k']['windows']} and "
          f"{bs_out['gates']['150']['windows']}, later checks "
          f"{bs_out['gates']['10k']['later_lanes']} and {bs_out['gates']['150']['later_lanes']}; "
          f"the bad peer stopped once); launches {launches}", flush=True)
    for name, n in (("10k", N_SIGS), ("150", BSYNC_SMALL)):
        print(json.dumps({
            "metric": f"blocksync_{name}_ms_per_block",
            "value": bs_out["ms_per_block"][name]["torch"],
            "validators": n, "by_backend": bs_out["ms_per_block"][name],
            "runs_ms": bs_out["ms_per_block_runs"][name],
            "pipeline_overlap_ms": bs_out["pipeline_overlap_ms"][name],
            "gates": bs_out["gates"][name],
            "stages_pipeline_off": bs_out["stages"][name],
            "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    print(json.dumps({"blocksync": {k: v for k, v in bs_out.items()
                                    if k not in ("gates", "stages", "ms_per_block_runs")},
                      "phase_s": time.perf_counter() - bsync_start,
                      "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    return launches, sources


def blocksync_only(card, dev) -> int:
    """``--blocksync``: the keys, the blocksync sources and the blocksync
    phase alone, timed under the process default too (a quick check of
    that phase on the card; no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    launches, _ = blocksync_phase(fixtures, TorchBackend(), dev, card, records, with_default=True)
    print(json.dumps({"blocksync_launches": launches, "max_abs_err": records}), flush=True)
    return 0


def light_phase(fixtures, sources, backend, dev, card, records,
                with_default: bool = False) -> dict:
    """Runs the light path (step 17), prints its metrics and gates, merges
    its kernel comparisons into ``records``; returns its launches. The
    syncs are timed under the process default too only ``with_default``
    (``--light``)."""
    start = time.perf_counter()
    out = drive_light_path(fixtures, sources, backend, dev, with_default)
    for k in ("sha512", "decompress", "ladder"):  # held at the path's own batches too
        records[k]["max_abs_err"] = max([records[k]["max_abs_err"]] + [
            b["max_abs_err"][k] for b in out["kernels"].values()])
    g, sw, med = out["gates"], out["swarm"], out["metrics"]["medians_ms"]
    print(f"light path ok (the {N_SIGS}-validator client fetched {g['10k']['fetched']}, backend "
          f"calls {g['10k']['calls']}; the {LIGHT_SMALL}-validator skipping, sequential and "
          f"backwards clients as the arithmetic gives; {LIGHT_SWARM} clients through one gateway "
          f"share one plan in each mode; the attack detected, its evidence committed at height "
          f"{out['attack']['block_height']}; duplicate votes accepted and the flipped copy "
          f"refused on both paths); launches {out['launches']}", flush=True)
    common = {"device": torch.cuda.get_device_name(0), "card": card}
    for name, key, n in (("light_sync_10k_ms", "10k", N_SIGS),
                         ("light_sync_150_ms", "150", LIGHT_SMALL),
                         ("evidence_verify_10k_ms", "evidence_10k", N_SIGS)):
        print(json.dumps({"metric": name, "value": med[key]["torch"], "validators": n,
                          "by_backend": med[key], "runs_ms": out["metrics"]["runs_ms"][key],
                          **common}), flush=True)
    print(json.dumps({"metric": "light_gateway_64_ms", "value": sw["plan"]["ms"],
                      "clients": LIGHT_SWARM, "by_mode": {m: s["ms"] for m, s in sw.items()},
                      "swarm": {m: {k: v for k, v in s.items() if k != "trace"}
                                for m, s in sw.items()}, **common}), flush=True)
    print(json.dumps({"light_stages_10k": out["metrics"]["stages_10k"], **common}), flush=True)
    print(json.dumps({"light": {k: v for k, v in out.items() if k not in ("swarm", "metrics")},
                      "phase_s": time.perf_counter() - start, **common}), flush=True)
    return out["launches"]


def light_only(card, dev) -> int:
    """``--light``: the fixtures, the blocksync sources and the light phase
    alone (a quick check of that phase on the card; no result line)."""
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, 1)
    print(f"fixtures: {N_SIGS} keys in {time.perf_counter() - t0:.1f} s", flush=True)
    backend = TorchBackend()
    records = {k: {"max_abs_err": 0} for k in ("sha512", "decompress", "ladder")}
    launches = light_phase(fixtures, bsync_sources(fixtures, backend), backend, dev, card,
                           records, with_default=True)
    print(json.dumps({"light_launches": launches, "max_abs_err": records}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--bn254-lanes"]:
        return time_bn254_lanes()
    from cometbft_tpu_torch.ops import _build  # noqa: F401 - alone, the run stops here

    card = card_line()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    clock_hz = max_sm_clock_hz()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}; "
          f"{props.multi_processor_count} SMs, max SM clock {clock_hz / 1e6:.0f} MHz; card: {card}",
          flush=True)

    sign_pool()  # its workers start while the kernels build
    try:
        return run_modes(card, dev, props, clock_hz)
    finally:
        close_sign_pool()


def run_modes(card, dev, props, clock_hz) -> int:
    """The build, then the mode the arguments ask for (the module
    docstring's usage), by default every phase."""
    from cometbft_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        entry = re.search(r"entry function '_Z\w*?\d+(\w+_kernel)(I((?:L[ib]\d+E)+)E)?", line)
        if entry:
            args = re.findall(r"L[ib](\d+)E", entry.group(3) or "")
            name = re.search(r"[a-z_]+_kernel$", entry.group(1)).group(0)
            print(f"  {name}" + (f"<{', '.join(args)}>" if args else ""))
        elif line.startswith("==") or "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    if sys.argv[1:] == ["--blocksync"]:
        return blocksync_only(card, dev)
    if sys.argv[1:] == ["--light"]:
        return light_only(card, dev)
    if sys.argv[1:] == ["--consensus"]:
        return consensus_only(card, dev)
    if sys.argv[1:] == ["--network"]:
        return network_only(card, dev)
    if sys.argv[1:] == ["--rpc"]:
        return rpc_only(card, dev, props.multi_processor_count, clock_hz)
    if sys.argv[1:] == ["--node"]:
        return node_only(card, dev)
    if sys.argv[1:] == ["--ingress"]:
        return ingress_only(card)
    if sys.argv[1:] == ["--statesync"]:
        return statesync_only(card, dev)
    if sys.argv[1:] == ["--ops"]:
        return ops_only(card, dev)
    procs: list = []  # every process the phases start, ended here
    try:
        return run_phases(card, dev, props, clock_hz, so, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(card, dev, props, clock_hz, so, procs: list) -> int:
    """Phases 4-24 (module docstring); the processes it starts go to ``procs``."""
    from cometbft_tpu_torch.crypto import bn254_pure as bn
    from cometbft_tpu_torch.crypto import ed25519_pure as pure
    from cometbft_tpu_torch.crypto import merkle as host
    from cometbft_tpu_torch.crypto.merkle import hash_from_byte_slices
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops.bn254_kernel import Bn254DeviceBackend
    from cometbft_tpu_torch.sidecar.backend import TorchBackend

    mixes = sass_mix(so)
    for g, mix in mixes.items():
        print(f"ladder SASS at {g} threads a lane (static instruction counts): {mix}", flush=True)
    from cometbft_tpu_torch.probe import issue_rates

    stamp("the issue rates")
    rates = issue_rates.measure(props.multi_processor_count, clock_hz)
    print(f"issue rates (thread-instructions a clock per SM, measured): {json.dumps(rates)}",
          flush=True)

    # Processes of their own on the card, started now that the kernel library
    # is built (they load it) and the issue rates are measured: the fleet's
    # remote sidecar (warming up while the fixtures are made) and the
    # device probe.
    sidecar_proc = start_sidecar_process()
    procs.append(sidecar_proc)
    probe_proc = subprocess.Popen([sys.executable, "-m", "cometbft_tpu_torch.probe.device"],
                                  cwd=os.path.dirname(os.path.abspath(__file__)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs.append(probe_proc)

    stamp("the fixtures")
    t0 = time.perf_counter()
    fixtures = make_fixtures(pure, N_SIGS, N_LEAVES)
    print(f"fixtures: {N_SIGS} signatures, {N_LEAVES} leaves, {N_PARTS} parts of {PART_BYTES} "
          f"bytes in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bn_fix = bn254_fixtures(bn)
    print(f"fixtures: {N_VALIDATORS}-validator BN254 aggregate and {N_VOTES} votes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Both processes done with their first use of the card before anything
    # is timed here.
    remote = sidecar_process_addr(sidecar_proc)
    probe_out, _ = probe_proc.communicate(timeout=300)
    print(f"sidecar process serving on {remote}; device probe exit {probe_proc.returncode}",
          flush=True)

    stamp("the kernels against their plain versions")
    t0 = time.perf_counter()
    records = compare_kernels(fixtures, hash_from_byte_slices, dev, props.multi_processor_count,
                              clock_hz, rates)
    stamp("kernels: bn254")
    records["bn254"] = compare_bn254(bn, dev, props.multi_processor_count, clock_hz, rates)
    print(f"kernels equal their plain versions (compare + timing {time.perf_counter() - t0:.1f} s)",
          flush=True)
    for g, mix in mixes.items():
        est = ladder_issue_estimate(mix, rates, g, N_SIGS, props.multi_processor_count, clock_hz)
        print(f"ladder issue estimate at {g} threads a lane (ms, static mix over measured "
              f"rates): {est}; measured {records['ladder']['ms_by_group'][g]}", flush=True)

    stamp("the Ed25519 / Merkle path")
    backend = TorchBackend()
    _build.reset_launches()
    drive_main_path(fixtures, pure, hash_from_byte_slices, backend)
    launches = dict(_build.LAUNCHES)
    check(launches == {"ladder": 4, "decompress": 4, "sha512": 4, "sha256": 4, "bn254": 0},
          f"expected one sha512, decompress and ladder launch a batch (4 batches) and two "
          f"sha256 launches a root (2 roots): {launches}")
    print(f"Ed25519 / Merkle path ok; launches {launches}", flush=True)
    by_path = {"verify_root": launches}

    _, _, pubs, msgs, sigs, leaves, _ = fixtures
    totals = []
    for _ in range(5):
        totals.append(time_host(lambda: (backend.batch_verify(pubs, msgs, sigs),
                                         backend.merkle_root(leaves))))
    splits = [stage_split(fixtures, dev) for _ in range(3)]
    stages = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    trace = trace_call(lambda: (backend.batch_verify(pubs, msgs, sigs),
                                backend.merkle_root(leaves)))
    print(json.dumps({
        "metric": "verify_10k_commit_plus_64k_merkle_ms",
        "value": statistics.median(totals), "runs_ms": totals,
        "stages_ms": stages, "device": torch.cuda.get_device_name(0), "card": card,
    }), flush=True)
    trace["kernels_ms"] = dict(collections.Counter(trace["kernels_ms"]).most_common(12))
    # A busy share only from a trace that saw every kernel of the call: the
    # verify's launch from the device-owner thread, the tree's from this one.
    seen = " ".join(trace["kernels_ms"])
    complete = all(k in seen for k in ("digits_kernel", "decompress_kernel", "ladder_verify_kernel",
                                       "tree_chunks_kernel", "tree_roots_kernel"))
    print(json.dumps({"traced_call": trace, "trace_saw_every_kernel": complete,
                      "device_busy_share_of_untraced_median":
                          trace["device_ms"] / statistics.median(totals) if complete else None}),
          flush=True)

    stamp("the proofs path")
    _build.reset_launches()
    drive_proofs(fixtures, host)
    by_path["proofs"] = dict(_build.LAUNCHES)
    check(by_path["proofs"] == {"ladder": 0, "decompress": 0, "sha512": 0, "sha256": 6, "bn254": 0},
          f"expected two sha256 launches a proof set (3 sets): {by_path['proofs']}")
    print(f"proofs path ok (65,536, 10,000 and {N_PARTS} x {PART_BYTES}-byte leaves equal the "
          f"host's proofs); launches {by_path['proofs']}", flush=True)
    print(json.dumps({**proofs_metrics(fixtures, host, dev), "device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)

    stamp("the sidecar path")
    sc = drive_sidecar(fixtures, pure, hash_from_byte_slices)
    by_path["sidecar"] = sc["launches"]
    print(f"sidecar path ok through the socket ({sc['dispatches']} verify dispatches); launches "
          f"{sc['launches']}; client {sc['client']}", flush=True)
    print(json.dumps({
        "metric": "sidecar_verify_10k_commit_plus_64k_merkle_ms",
        "value": statistics.median(sc["totals"]), "runs_ms": sc["totals"],
        "in_process_ms": statistics.median(totals), "warmup_s": sc["warmup_s"],
        "scheduler": sc["scheduler"], "device": torch.cuda.get_device_name(0), "card": card,
    }), flush=True)

    stamp("the BN254 path")
    bn_backend = Bn254DeviceBackend()
    _build.reset_launches()
    bn_times = drive_bn254_path(bn_fix, bn_backend)
    bn_launches = dict(_build.LAUNCHES)
    check(bn_launches == {"ladder": 0, "decompress": 0, "sha512": 0, "sha256": 0, "bn254": 5},
          f"expected two bn254 launches an aggregate (2 aggregates) and one for the vote "
          f"batch: {bn_launches}")
    by_path["bn254"] = bn_launches
    cut = ("every validator signs one shared message: distinct per-validator sign bytes would "
           "cost 10,240 runs of the host's pure-Python hash-to-G2; the device work a lane is "
           "the same either way")
    print(f"BN254 path ok; launches {bn_launches}; cut: {cut}", flush=True)
    bn_splits = [bn254_stage_split(bn_fix, bn, dev)]
    print(json.dumps({
        "metric": "aggregate_verify_10k_ms", "value": bn_times["aggregate_accept"],
        "runs_ms": bn_times, "stages_ms": bn_splits, "validators": N_VALIDATORS,
        "lanes": N_VALIDATORS + 1, "cut": cut, "device": torch.cuda.get_device_name(0),
        "card": card,
    }), flush=True)

    stamp("the hybrid path")
    hybrid, root, plan, by_path["hybrid"] = drive_hybrid_path(fixtures, pure, backend)
    print(f"hybrid path ok (shares 0, {HYBRID_SPLIT} and {N_SIGS}: bitmaps equal TorchBackend's; "
          f"verify_and_root's root too); launches {by_path['hybrid']}; planner {json.dumps(plan)}",
          flush=True)
    hm = hybrid_metrics(fixtures, hybrid, backend)
    print(json.dumps({"metric": "hybrid_verify_10k_commit_ms", "value": hm["verify_ms"]["hybrid"],
                      **hm, "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    stamp("the chain path")
    by_path["chain"], chain_rec = drive_chain_path(fixtures, pure, bn_fix, root)
    print(f"chain path ok (hybrid serves, an injected error degrades to cpu with the same bitmaps; "
          f"the BN254 chain serves from bn254-device, then bn254-host); launches {by_path['chain']}; "
          f"{json.dumps(chain_rec)}", flush=True)

    stamp("the auto path")
    auto = drive_auto_path(fixtures, pure, backend)
    by_path["auto"] = auto.pop("launches")
    print(f"auto path ok (CMTPU_BACKEND=auto: the coalesced chain, its hybrid warmed in "
          f"{auto['setup_s']:.1f} s, served every batch with TorchBackend's bitmaps); launches "
          f"{by_path['auto']}", flush=True)
    print(json.dumps({"metric": "auto_verify_ms", **auto, "device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)
    stamp("the fanout path")
    fan = drive_fanout_path(fixtures, pure, backend, sidecar_proc, remote, root)
    by_path["fanout"] = fan.pop("launches")
    print(f"fanout path ok (fanout -> hybrid -> cpu; two sidecars, one in another process, and "
          f"the local hybrid on one card; a killed shard redistributed once, the root failed "
          f"over); launches {by_path['fanout']}", flush=True)
    print(json.dumps({"metric": "fanout_verify_10k_commit_ms",
                      "value": statistics.median(fan["times_ms"]["fanout_commit"]),
                      "torch_ms": statistics.median(fan["times_ms"]["torch_commit"]),
                      "note": "three shards on ONE card, not a multi-host figure", **fan,
                      "device": torch.cuda.get_device_name(0), "card": card}), flush=True)
    stamp("the proofs paths")
    pp = drive_proofs_paths(fixtures, host)
    by_path["proofs_paths"] = pp.pop("launches")
    print(f"proofs paths ok (the card and the native host pass equal the pure pass; default "
          f"{pp['default']}); launches {by_path['proofs_paths']}", flush=True)
    print(json.dumps({"metric": "proofs_paths_ms", **pp, "device": torch.cuda.get_device_name(0),
                      "card": card}), flush=True)
    stamp("the tooling")
    tools = drive_tooling(fixtures, backend, probe_proc.returncode, probe_out)
    by_path["tooling"] = tools.pop("launches")
    print(f"tooling ok (pprof endpoints, dryrun_multichip(2), entry(), the device probe); "
          f"launches {by_path['tooling']}; {json.dumps(tools)}", flush=True)

    stamp("the commit path")
    commit_start = time.perf_counter()
    cf = commit_fixtures(fixtures)
    print(f"commit fixtures: a {N_SIGS}-validator ed25519 set and its commits at heights "
          f"{COMMIT_HEIGHT}, +1 and +5 ({3 * N_SIGS} canonical precommits), a hop of "
          f"{CANT_TRUST_SIGNERS} signers, a {COMMIT_SMALL}-validator commit and a "
          f"{N_BN254_COMMIT}-validator BN254 aggregate commit, signed in {SIGN_PROCESSES} "
          f"processes, built in {time.perf_counter() - commit_start:.1f} s", flush=True)
    stamp("commit: the counted checks")
    cp = drive_commit_path(cf, backend)
    by_path["commit"] = cp.pop("launches")
    print(f"commit path ok (verify_commit, verify_commit_light and both hops of the "
          f"{N_SIGS}-validator set; the corrupted commit, the short commit and the hop that "
          f"cannot be trusted raise as they should; the BN254 aggregate through "
          f"get_bn254_backend()); launches {by_path['commit']}; {json.dumps(cp)}", flush=True)
    from cometbft_tpu_torch.sidecar import backend as be

    with environ(CMTPU_BACKEND="auto", CMTPU_COALESCE=None, CMTPU_FANOUT_PEERS=None,
                 CMTPU_SIDECAR_ADDR=None, CMTPU_FAULTS=None):
        auto = be._make_backend()
    try:
        cm = commit_metrics(cf, backend, auto, dev)
    finally:
        auto.close()
    print(json.dumps({"metric": "verify_commit_10k_ms",
                      "value": cm["medians_ms"]["verify_commit_10k"]["torch"], **cm,
                      "phase_s": time.perf_counter() - commit_start,
                      "device": torch.cuda.get_device_name(0), "card": card}), flush=True)

    stamp("the blocksync path")
    by_path["blocksync"], sources = blocksync_phase(fixtures, backend, dev, card, records)

    stamp("the light path")
    by_path["light"] = light_phase(fixtures, sources, backend, dev, card, records)
    stamp("the consensus path")
    by_path["consensus"], cons_fx = consensus_phase(fixtures, sources, backend, dev, card,
                                                    records, timed=0)
    stamp("the network path")
    by_path["network"] = network_phase(fixtures, sources, backend, dev, card, records, cons_fx,
                                       timed=0)
    stamp("the RPC path")
    by_path["rpc"], records["sha256"]["rpc_levels"] = rpc_phase(
        sources, backend, dev, card, records, props.multi_processor_count, clock_hz)
    stamp("the node path")
    import tempfile

    ss_tmp, ss_servers = tempfile.TemporaryDirectory(), {}
    try:
        # (n) runs while (k)'s server is up; (l)'s servers build while the
        # node path's kernels are compared.
        def ops(server_addr, tmp):
            by_path["ops"] = ops_phase(sources["10k"], server_addr, backend, dev, card,
                                       records, tmp)

        by_path["node"] = node_phase(
            sources, backend, dev, card, records,
            after_timed=lambda: ss_servers.update(
                ss_servers_start(sources["10k"], ss_tmp.name, procs)),
            during_server=ops)
        stamp("the statesync path")
        by_path["statesync"] = statesync_phase(sources, backend, dev, card, records, ss_servers,
                                               ss_tmp.name)
    finally:
        if ss_servers and not ss_servers.get("ended"):
            ss_servers_end(ss_servers)
        ss_tmp.cleanup()
    stamp("the mesh path")

    mesh_start = time.perf_counter()
    records["sha256"]["digests"], digests = compare_digests(
        fixtures[5], hash_from_byte_slices, dev, props.multi_processor_count, clock_hz)
    records["sha256"]["max_abs_err"] = max(records["sha256"]["max_abs_err"],
                                           records["sha256"]["digests"]["max_abs_err"])
    mesh_out = drive_mesh_path(fixtures, bn_fix, pure, hash_from_byte_slices, dev, digests)
    by_path["mesh"] = mesh_out["launches"]
    print(f"mesh path ok on {N_SHARDS} virtual shards of one card (K1-K7); launches "
          f"{mesh_out['launches']}; counters {mesh_out['counters']}", flush=True)
    print(json.dumps({**mesh_metrics(mesh_out, digests), "device": torch.cuda.get_device_name(0),
                      "card": card, "phase_s": time.perf_counter() - mesh_start}), flush=True)

    sources = {
        "ladder": ("cometbft_tpu_torch/ops/csrc/ladder.cu", "cometbft_tpu/ops/pallas_ladder.py:218",
                   "pallas_ladder._ladder_kernel + the epilogue of ed25519_kernel._verify_from_words"),
        "decompress": ("cometbft_tpu_torch/ops/csrc/decompress.cu",
                       "cometbft_tpu/ops/edwards.py:141, cometbft_tpu/ops/unpack.py:66",
                       "edwards.decompress + unpack.words_to_limbs255"),
        "sha512": ("cometbft_tpu_torch/ops/csrc/sha512.cu",
                   "cometbft_tpu/ops/sha512_kernel.py:188, cometbft_tpu/ops/unpack.py:188,182",
                   "sha512_kernel.hash_blocks_core + unpack.digest_words_to_digits "
                   "+ unpack.scalar_words_to_digits"),
        "sha256": ("cometbft_tpu_torch/ops/csrc/sha256.cu",
                   "cometbft_tpu/ops/sha256_kernel.py:48, cometbft_tpu/ops/merkle_kernel.py:235, "
                   "cometbft_tpu/ops/merkle_kernel.py:214",
                   "sha256_kernel.compress (merkle_kernel._leaf_core/_inner_core/leaves_to_root_core)"
                   " + merkle_kernel._leaves_to_levels_core (the levels entry)"
                   " + merkle_kernel.merkle_root_pow2 (the digests entry)"),
        "bn254": ("cometbft_tpu_torch/ops/csrc/bn254.cu", "cometbft_tpu/ops/bn254_kernel.py:352",
                  "bn254_kernel._build_program.run over _fp_mul :215, _f2_mul_many :239, "
                  "_f12_sqr :277, _f12_sparse :295, _dbl_and_line :320, _add_and_line :335"),
    }
    kernels = []
    for name in _build.KERNELS:
        src, replaces, fn = sources[name]
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "replaces_function": fn, "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {k: p[name] for k, p in by_path.items()},
            "max_abs_err": rec["max_abs_err"], "match": rec["max_abs_err"] == 0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "shape": rec["shape"],
            "kernel_ms": rec["kernel_ms"],
            **{k: v for k, v in rec.items()
               if k in ("threads_per_lane", "ms_by_group", "bound_ms_at_imad_wide_rate", "digests",
                        "chain_floor_ms", "rpc_levels",
                        "ms_by_lanes", "plain_ms_by_lanes", "bound_ms_by_lanes", "fp_muls_a_lane",
                        "queued_ms")
               or k.startswith("levels")},
        })
    stamp("the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
