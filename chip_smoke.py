#!/usr/bin/env python3
"""Drive lighthouse_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py                  # the full configuration (below)
    python3 chip_smoke.py --validators 4096 --sets 8 --keys 16 --batches 1

Phases (any failure exits non-zero; nothing is caught and carried on from):
  1. build the fused field-multiply kernels (csrc/fused_mul.cu: the plan
     kernel and the chain kernel; nvcc, sm_90a);
  2. build the fixtures with the port's pure-Python oracle: a registry of
     consecutive secret keys (pk_i = pk_{i-1} + G in Jacobian coordinates,
     one batched normalisation), cached as .npz under .fixture_cache/;
     per-set aggregate signatures; one block's signature sets as ``bls``
     objects; a gossip pool of single-key attestations (sig_{i+1} = sig_i +
     H(m) for consecutive keys, one batched normalisation per committee);
  3. one warm-up run of every path below, recording the shapes each path
     gives the kernels;
  4. the plan kernel (K1, every K3 plan signature) and the chain kernel
     (Fermat inversion, the Fq2 square-root chain, the |x| cyclotomic power)
     held bit-exact against their plain PyTorch versions at every row count
     any path gave them; each timed at its most-launched row count on the
     main, block and gossip paths beside its bound (chains also beside their
     own step loop of plan-kernel launches); cluster sizes 1/2/4/8 at rows 1;
  5. the main path (``verify_indexed_sets_device``): counts set to 0, timed
     valid batches (each must verify True) and one batch with a poisoned
     signature (must give False), counts read; K1, K3 and the chain kernel
     must have launched (K2 only inside chains), every timed schedule and
     chain too, the plain version never;
  6. the h2c stage's message points held against the oracle's
     hash_to_curve on the first messages;
  7. one more valid batch under torch.profiler: device busy time, idle
     share, aten ops dispatched, device time by kernel;
  8. the ``bls`` API at block width (``bls.verify_signature_sets``): the
     valid block True, one poisoned signature False, 4 small sets the same
     verdict as ``verify_signature_sets_oracle``, ``warmup()`` True; the
     host half (points -> limbs, hash_to_field) and the device half timed
     apart over repeats (median, min, max), the device half once more
     under the profiler (device busy time, idle share);
  9. the gossip firehose (``FirehoseEngine`` over
     ``verify_indexed_sets_device``, supervised, no CPU fallback) paced at
     50,000 att/s for 3 s and drained: verified att/s, drops, queue latency
     against the SLOs, beside the standalone rate of the same batches; no
     rejected, errored or faulted batch, a clean supervisor;
 10. one synchronous drain of 64 gossip items with 2 poisoned: exactly
     those False, as many verify calls as the reference's bisection makes;
 11. epoch boundaries on the device: an electra mainnet-preset state over
     the whole registry (bench.py's _build_epoch_state shape, the
     registry's pubkeys) through one warm-up, EPOCH_TIMED timed and one profiled
     boundary, each through ``process_slots`` with the epoch backend
     "device": every one handled by the device engine, a clean
     ``epoch_device`` supervisor; at 2^18 validators one device boundary
     held against the numpy ``per_epoch`` twin, field for field and by
     tree_root;
 12. a signed electra block one slot after phase 11's last boundary
     (8 attestations over every committee of one slot each, a full sync
     aggregate, proposer and randao) through
     ``per_block_processing(VERIFY_BULK)`` with the state root checked:
     exactly one ``bls.verify_signature_sets`` batch, on the card; the
     block with a poisoned attestation signature raises;
 13. the port's ``BeaconChain`` anchored on phase 11's post-boundary state
     (justification set one epoch behind, finality two, as on a healthy
     chain), its pubkey cache seeded from the registry's affine points and
     checked against the state's compressed keys, a ``HotColdDB`` over
     ``MemoryStore``, the bls and epoch backends "device": phase 12's block
     through ``process_block`` (head, stored post-state root, one bls
     batch) and its poisoned twin (``BlockError``; head, store and fork
     choice unchanged); a second block at the first slot of the next epoch,
     attesting to the first, whose import runs the boundary on the device
     engine (block 1's fork-choice votes equal its attesters' balances);
     64 unaggregated attestations of one head committee (one poisoned) and
     4 aggregates (one with another aggregator's selection proof) through
     ``BeaconProcessor`` batches into the chain (exact verdicts, the
     reference bisection's call count); the valid attestations through
     ``chain.create_firehose()`` (all verified, no drop, no oracle rung).
     Each import runs with the supervisors' default configuration and is
     split into its parts; the second one's last slot, boundary and block
     processing are then replayed on a copy under the profiler.
 14. a sampling node's slot of blob data on phase 13's chain (PeerDAS at
     mainnet geometry: the port's trusted setup, 128 cells of 64 field
     elements, MAX_BLOBS_PER_BLOCK = 6 blobs of 4096 random field elements,
     custody 4 and 8 samples per slot; the commitments and the required
     columns' cell proofs built by the port's device MSM in phases 2 and
     14): a signed block one slot after the head carrying the commitments
     raises BlockPendingAvailability with head and store unchanged; a
     required column with another blob's cell swapped in is rejected by
     ``verify_data_column_sidecar`` and never marked verified; each honest
     required column is verified on the card, put into the chain and
     recorded by the sampler, the block available only after the last;
     ``notify_columns`` releases it and the chain imports it (head, stored
     post-state root); every required cell in one ``verify_cell_proof_batch``
     (n_pad 64 or 128, as the slot's samples fall) True, one column's cells
     True through the host ``CellContext`` loop too; the blobs' batch proof
     True on the host and False with one proof swapped; one pairing check
     with two pairs per batch (``PROBE``); a clean ``kzg_device`` supervisor. Timed: column
     verifies (5), the batch (3, its kernel rows timed at its own n_pad),
     the table builds, each proof MSM; one column verify, the batch and its
     Fr stage under the profiler.
 15. a second node over the network on phase 13-14's chain: node A a
     ``BeaconNodeService`` over that chain, node B booted from a copy of
     phase 13's post-import-2 state (its own seeded pubkey cache and device
     tensor, ``HotColdDB(MemoryStore)``, PeerDAS custody from its node id),
     both on one ``LoopbackTransport``, B's slot clock at A's head. A builds
     and imports NET_BLOCKS more blocks; B range-syncs them with phase 14's
     blob block as one segment (one ``process_chain_segment`` bls batch on
     the card; the blob block parks on availability, its custody and sample
     columns are fetched by root from A and verified on the card): B's head
     and stored blocks and post-states equal A's, no peer demoted. B
     backfills below its anchor: a corrupt peer's segment (block 1 with
     block 2's proposer signature) rejected and that peer demoted, A's
     accepted, one indexed batch each. A publishes a blob block (pending on
     B, no launch), a column with a swapped cell (dropped) and B's required
     columns (the head moves with the last), 64 attestations of one head
     committee with one poisoned (exactly it rejected, the reference
     bisection's call count), 4 aggregates with one bad, 64 sync-committee
     messages of subnet 0 with one poisoned and a contribution, through
     ``Router`` and ``BeaconProcessor``; the processor's drops and expiries
     printed. Then two gossipsub ``SocketTransport`` endpoints on 127.0.0.1
     met through a ``BootNode`` carry 64 more attestations (the same
     verdicts), a BlocksByRange of the segment and a
     DataColumnSidecarsByRoot (decoded roots == the sent ones); a mainnet
     block's and a column's encode and decode timed. Timed: the sync split
     (download, the segment's bls halves, column fetch and verifies), the
     backfill batches, gossip att/s beside phase 13's; the segment batch
     under the profiler; host peak RSS and peak device bytes.
 16. a light client of node A and the mass-service batch: node A's
     ``LightClientServerCache`` (live since phase 13; its time inside every
     import of phases 13 and 15 reported) holds a latest optimistic update,
     a finality update where the attested state's finalized block is held,
     and a period in its update store; node B requests the four
     light-client methods from A over the loopback (each message through
     the codec) and a gossipsub socket pair: decoded roots equal A's, the
     bootstrap verifies (with one branch node flipped it does not), the
     updates verify through ``verify_update_batch`` on the card (path
     ``lc_serve``); then 16 optimistic-update sessions over the state's
     current and next sync committees (512 keys, ~75% bitfields, distinct
     slots, oracle-signed) in one dispatch (path ``lc_batch``): True over
     LC_REPS timed batches, one pairing check of 17 pairs each
     (``PROBE``), False with a tampered signature; a mixed subset (a
     tampered signature, a tampered header, a malformed encoding) session
     for session equal to the host loop on the oracle; with both device
     rungs of ``lc_device`` faulted every session False and no host rung;
     one batch under the profiler.
 17. the slasher (``lighthouse_tpu_torch.slasher``; its span sweep is
     PyTorch on the card, no hand kernel): (a) the reference bench's cell
     (``bench.py:1893``): a span store of 2^20 validators x 64 epochs, one
     warm-up and 16 timed ticks of 16,384 honest (cur-1, cur) votes, 4
     ticks an epoch, then 4 injected surrounds and 4 double votes: 4 of 4
     each flagged, no flag on the honest stream, the store on the card with
     no demotion; checks/s, ms per tick, the byte bound, busy and idle share
     over one profiled epoch, plane and peak bytes; (b) the same at
     Lighthouse's default window of 4096 epochs (32 GiB of planes at the
     reference's 8 bytes a cell), 4 timed ticks; (c) at 2^15 x 64, 8 ticks of
     random pairs (window rolls, out-of-window, invalid and padding pairs,
     tag conflicts): the card's planes and per-pair outputs equal the numpy
     twin's and the CPU sweep's, bit for bit; (d) the fault drill: corruption
     injected into ``slasher.sweep`` demotes the store, the checkpoint and
     journal replay give the twin's planes, probation puts them back on the
     card; (e) a ``SlasherService`` (window 64) on node A's chain observers:
     64 attestations of one committee through the gossip batch path, one
     member voting twice for one target: exactly one ``AttesterSlashing`` in
     its pool, naming that member, its signatures verified on the card.
 18. node C restarts from disk: a ``BeaconChain`` over ``HotColdDB`` with
     ``LevelStore`` hot and cold stores in a temporary directory, on phase
     13's anchor and pubkey cache, imports phase 12's block (fork choice
     persisted at the import barrier), takes phase 13's gossip attestations
     and phase 17's slashing into its op pool and persists it; phase 17's
     slasher checkpoints into C's hot store. Every object is dropped and the
     stores reopened; a pubkey cache seeded from the registry's affine points,
     ``recover_node_state`` and ``make_slasher(store.hot)``: head, fork-choice
     nodes and weights, checkpoints and pool equal C's before the crash, 64
     gossip attestations (one poisoned) verify on the card through the
     recovered chain, and a double vote after the restart against a vote
     from before it is convicted by the restored slasher, its sweep on the
     card. Reports the import's store write, the WAL bytes, the recovery's
     parts and the slasher checkpoint's bytes and ms.
 19. the client surface: (a) a ``BeaconApiServer`` over node A (its chain,
     op pool, network service and load monitor), a ``MetricsServer`` and a
     ``ValidatorMonitor`` on committee 0 of the head slot; through the
     port's ``BeaconNodeHttpClient`` (or ``urllib``), each timed and checked
     against the chain: genesis, fork, finality checkpoints, the head
     header, the head block by root, 16 validators by index and 16 by
     pubkey, their balances, every committee of the head epoch (each
     active validator once), the epoch's proposer duties, 64 validators'
     attester duties, syncing, health and the spec; then 64 single-key
     attestations of committee 0 at the head (one signed by another member)
     posted to ``/eth/v1/beacon/pool/attestations``: 400 naming exactly
     that one, as many verify calls as the reference bisection makes, on
     the card, the other 63 in A's op pool, the aggregate served for their
     data the naive pool's, ``validator_monitor_attestations_total`` 63;
     (b) ``cli.run_bn`` in process on a minimal-preset electra interop
     genesis of 64 keys two slots old (HTTP and metrics on ephemeral ports,
     a datadir): the joined warm-up healthy; a block for the current slot
     produced over ``/eth/v2/validator/blocks``, signed by the proposer's
     interop key (oracle) and published as SSZ: 200, the head its root, one
     bls batch on the card; a second ``bn`` checkpoint-synced from the first
     (its anchor the first's finalized state); the first stopped and booted
     again on its datadir to the same head slot, root and fork choice.
  20. the spec vectors on the card: (a) ``conformance.run_all(device=cuda)``
     over tests/vectors (99 cases, nothing pruned): every case passes and
     every file is consumed; the state families' bulk verifies and the bls
     batches on the card, every epoch boundary on the device engine
     (counted per fork, phase0 to electra, each above 0), the KZG families'
     MSMs and cell batches on the card; bls_device, epoch_device and
     kzg_device clean; each family timed with its launches; (b) phase 8's
     block and its poisoned twin through ``bls.set_backend("native")`` (the
     C++ backend, built with g++ beside phase 1): True and False, as on the
     card, timed beside phase 8's device half; (c) ``python -m
     lighthouse_tpu_torch boot-node --enr`` in a subprocess and two ``bn``
     nodes in process (64 interop keys, on the card) given only its record
     (``--boot-enrs``): each finds the other through discovery and peers
     with it, and a block published to node 1 reaches node 2's head over
     gossip (one bls batch on the card on each node).
 21. the validator client (run beside phase 19, on its nodes): (a) a
     ``ProductionValidatorClient`` of VC_KEYS = 1,024 keys of node A's
     registry (a contiguous range and 16 sync-committee members, none seen
     attesting in the head epoch) against a ``BeaconApiServer`` on A, its
     API client given 600 s where ``vc`` gives 10 s (at 2^20 the
     epoch-after duty routes take longer than 10 s): ``run_slot`` for 2
     slots after A's head (duties poll, attestations, selection proofs and
     aggregates, sync messages), every publish 200, an attestation carrying
     another's signature 400, A's verdicts on the card equal to the
     oracle's, the attestations in A's op pool, bls_device and epoch_device
     clean; the second slot under
     the profiler; a second ``ValidatorStore`` on the same slashing
     database refused a double vote with no request; one doppelganger
     liveness check timed, live exactly where A saw attestations; (b) on
     phase 19 (b)'s ``bn`` before its restart: ``account-manager`` and
     ``validator-manager create`` keystores (scrypt), a ``vc`` from
     ``cli.build_parser()``/``cli.run_vc`` with
     interop keys 0-55, the first keystores and keys 56-63 from a
     ``MockWeb3Signer``, its keymanager reached by ``validator-manager
     import``/``list``; ``run_slot`` for the current slot: the VC's block in
     one bls batch on the card and the head, its attestations, aggregate and
     sync messages verified on the card; watch records the slot and serves
     the head's root; a second proposal refused before any request.
 22. the local network on the card: (a) the port's ``LocalNetwork`` of 4
     nodes over 64 interop validators (minimal, altair from genesis; a
     slasher on each node's observers, sync-committee duties, per-node WAL
     stores in a datadir, 2% seeded gossip loss; each duty phase's gossip
     verified in batches), the bls, epoch and slasher backends on the card,
     run until every node finalizes at >= 2: one node killed at the 9th WAL
     frame barrier after slot 10 (``resilience.inject`` ``mode=kill``) and
     restarted from disk two slots later (its recovery report at its
     pre-crash head with fork-choice nodes, back at the network's head);
     then an attestation carrying another's signature and a block signed by
     the wrong key, refused by every other node; no slashing anywhere; no
     fault domain moved; ms per slot, verify calls and launches per slot
     per node, one slot under the profiler, peak bytes. (b) 16 light-client
     sessions from ``testing.fabricate_lc_sessions`` on the network's
     harness through the LC engine on the card: all True, a tampered one
     False, as the host loop (native) and the oracle judge them. (c) one
     main-path batch (``batches[1]``) with the Karabina switch off and on
     (``bls.set_backend(..., karabina=)``): equal verdicts, the poisoned
     batch False under both, the canonical |x| powers and final
     exponentiations of its Miller product equal; each arm's |x| power,
     final exponentiation and batch timed; KARABINA_SQR bit-exact against
     its plain version at rows 1. Every shape the phase launched is then
     held exact, and its new kernel rows timed.
 23. the serving mesh on the card: MESH_SHARDS = 4 logical shards on the
     one card (``[cuda:0] * 4``; the machine has one card, so no cross-card
     copy is measured), each part run where its fixture lives. (a) after
     phase 10: phase 5's batches through ``bls.sharded.
     verify_indexed_sets_sharded`` (the poisoned batch False as the
     warm-up, 3 timed True) and ``verify_staged_pershard`` (a valid batch
     all True, its dispatch profiled, the device alone; the poisoned set
     rotated into shard 2: exactly shard 2 False), the bls API's mesh arm
     (2 shards) on phase 8's small sets as the oracle judges them; (b) the
     firehose with a ``MeshVerifier`` planner at phase 9's rate for 1 s
     (intake 32) with phase 10's two poisoned items leading: every
     verdict as the oracle's; then ``mesh.shard1`` injected twice:
     ``bls_shard1`` quarantined, the ticks served by the mesh of 2 with the
     poisoned group False, then back on all 4 after probation; (c) after
     phase 13: the chain's planner with the mesh on (no oracle rung on a
     card) and its batch route, valid and poisoned gossip as with the mesh
     off; (d) is not run: the light-client and KZG engines keep one check a
     batch (their split would run every shard on the same device); (e) in
     phase 11: the 2^18 parity boundary over 4 row blocks, its tree root
     equal to the unsharded device boundary's (every field, by their
     roots); after phase 17: the 2^20 x 64 slasher cell's traffic on 4
     validator row blocks, per-pair outputs and the device planes equal to
     the unsharded store's, 4/4 surrounds and doubles, no false positive;
     (f) after phase 22: every
     shape the mesh ran held exact and its new rows timed. Its seconds are
     paid for by the timed repeats cut in earlier phases (REPEAT_CUTS); the
     run prints both.
  24. the analysis passes on the card (``lighthouse_tpu_torch.analysis``):
     (a) ``__main__.main(["--json", "--device", "cuda", ...])`` in process,
     every pass, the certificates in a temporary directory: exit 0; every
     ``cuda_smem_bytes`` obligation's limit the card's
     ``shared_memory_per_block_optin``; the ``h100_80gb`` tier's HBM the
     card's ``total_memory``, its name and power limit nvidia-smi's; every
     (schedule or chain, rows) checked exact since phase 4 covered by the
     shared-memory walk at the cluster those rows pick. (b) the residency
     models against the card's allocator, each structure's bytes equal to
     its model and the allocator's change within its rounding: the 2^20
     epoch mirror bound in phase 11, the slasher planes of phase 17's cells
     (2^20 x 64 and 2^20 x 4096), the 2^18 mirror's 4 row blocks bound in
     phase 23 (e); a firehose batch of 64 gossip items staged, a second
     KZG engine's tables, and a light-client cache of phase 16's
     committees, each built here; then the meta walk's peak against
     ``max_memory_allocated`` for fq.mont_mul, tower.fq12_mul,
     pairing.miller_loop_product, pairing.final_exponentiation and
     kzg.fr_dot at batch 32 (the walk's no lower; the ratio printed) and
     ``max_safe_shape`` of the pairing graph on h100_80gb. (c) the build
     sentinel around phase 5's timed batches, phase 11's timed boundary,
     phase 9's firehose and phase 17's timed ticks: nothing built. (d) the
     supervisor probe: ``batches[1]`` through the bls supervisor's ladder,
     its verdict equal to the bare call's, no build, the call on the
     operands' current device. (e) lockdep in a process of its own
     (``--lockdep-child``, started before (a) and joined after (d)), its
     lock factories installed before the package is imported: phase 23
     (b)'s firehose over the MeshVerifier, its checks included, at
     LD_VALIDATORS keys; the observed lock-order graph non-empty, its locks
     the port's, acyclic alone and merged into (a)'s static graph. The main
     process's locks stay plain, so no phase is timed under lockdep.
Phases 8-10, 12-16 and 17-23 each set the counts to 0 before and read them after,
as phase 5 does, and hold any shape they launched that phase 4 did not see
(phase 14's column and batch shapes, phase 15's and phase 16's must all be
among the shapes checked before them: phase 3's warm-up runs one column
verify and a batch at each n_pad a slot's required cells can give, 64 and
128, a segment's single-key sets (two a block) through the bls API, one
indexed item (a backfilled block, a sync-committee message), a
contribution's three items, and light-client batches of 16 and 4 sessions
over two 512-key committees; phase 19's API batch runs the gossip path's
shapes, and its CLI node's new shapes are checked exact after it; phase
20's and 21's new shapes, the vectors', the discovery nodes' and the
validator client's, likewise; 21's are timed beside the others).

Full configuration: 2^20 validator pubkeys resident as the [N, 3, 25]
cache (mainnet); main path batches of 64 aggregate signature sets, 512 keys
per set, 4 timed batches; a block of 131 sets (proposer, randao, 128
attestation aggregates and one sync aggregate of --keys = 512 keys); a gossip pool
of 64 committees x 32 attesters; the state transition over all 2^20
validators (the parity boundary at 2^18), its block carrying 262,658 keys in
11 sets; the chain over the same 2^20 registry; PeerDAS at mainnet geometry
(nothing cut); the network over the same chain and a second 2^20-validator
node (depth cut: NET_BLOCKS new blocks synced); the light client at the
mainnet sync-committee size (512) and the reference bench's 16 sessions;
the slasher at 2^20 validators, windows of 64 (the reference bench's) and
4096 epochs (Lighthouse's default); a restarted 2^20-validator node; the
Beacon API over the 2^20 node (the CLI's own node at interop size: an
interop genesis derives every key with the oracle); a validator client of
1,024 keys over it, and the CLI's over the interop node.
The last line of stdout is the result object; the line before it the
kernel table; before that the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, ".fixture_cache")
H100_BYTES_PER_S = 3.35e12
STREAM_S = 3.0  # firehose stream length (bench.py's BENCH_FIREHOSE_SECONDS default)
FIREHOSE_RATE = 50_000.0  # att/s offered (BASELINE config #5)
COMMITTEES = 64  # gossip pool: one slot's committees, 32 attesters each
BLOCK_ATTESTATIONS = 128  # attestation aggregates in the block (BASELINE config #3)
BLOCK_REPS = 2  # timed repeats of each half of the block verify (5 until phase 23)
EPOCH_TIMED = 1  # timed epoch boundaries, between one warm-up and one profiled (3 until phase 23)
PARITY_VALIDATORS = 1 << 18  # the largest registry bench.py holds against its numpy twin
STATE_EPOCH = 101  # bench.py's epoch: no eth1, sync-committee or history boundary follows soon
ATT_SLOTS = 8  # attestations in the state-transition block (one per slot, all committees)
KZG_COLUMN_REPS = 2  # timed column verifies (phase 14; 5 until phase 23)
KZG_BATCH_REPS = 1  # timed batches of every required cell (phase 14; 3 until phase 23)
NET_BLOCKS = 1  # blocks node A builds for node B's range sync, after phase 14's blob block (phase 15; cut from 2 to keep phase 22 inside the time limit)
NET_CODEC_REPS = 2  # timed encodes and decodes of a block and a column (phase 15; 5 until phase 23)
LC_SESSIONS = 16  # the mass-service batch (bench.py:2162 _inner_light_clients; phase 16)
LC_REPS = 2  # timed batches of it (5 until phase 23)
FIREHOSE_ALONE = 1  # standalone gossip batches timed beside the firehose (phase 9; 8 until phase 23)
PLAIN_REPS = 1  # timed calls, after a warm-up, of a plan schedule's plain version (phase 4 rows; 10 until phase 23)
TIMING_REPS = 20  # launches of a plan row timed in a CUDA graph, and from Python (100 until phase 23)
LC_MIXED = 4  # sessions of the mixed batch held against the host loop (its time bounds it)
# int32 multiply-add rate outside the tensor cores: an H100 SM has half as
# many INT32 lanes as FP32 lanes, so half the 67 TFLOP/s fp32 peak
H100_INT32_OPS_PER_S = 33.5e12


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------------------
# Fixture (pure-Python oracle; signatures never come from the port's own code)
# --------------------------------------------------------------------------------------


REGISTRY_CHUNKS = 8  # independent walks of the registry, one per fixture worker


def _fixture_map(pool, fn, jobs: list) -> list:
    return pool.map(fn, jobs) if pool is not None else [fn(j) for j in jobs]


def _registry_walk(job):
    """Affine pubkeys of secret keys sk .. sk+m-1 as raw [m, 96] bytes: one
    mixed Jacobian + affine G addition per key, then one batched
    normalisation (Montgomery's trick)."""
    import numpy as np

    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import P

    sk, n = job
    gx, gy = oc.g1_generator()
    x1, y1 = oc.g1_mul((gx, gy), sk)
    X, Y, Z = [x1], [y1], [1]
    for _ in range(n - 1):
        # mixed Jacobian + affine G addition (add-2007-bl madd, a = 0)
        x, y, z = X[-1], Y[-1], Z[-1]
        zz = z * z % P
        u2 = gx * zz % P
        s2 = gy * z % P * zz % P
        h = (u2 - x) % P
        if h == 0:
            raise ValueError("registry walk hit the generator")
        hh = h * h % P
        i4 = 4 * hh % P
        j = h * i4 % P
        r = 2 * (s2 - y) % P
        v = x * i4 % P
        x3 = (r * r - j - 2 * v) % P
        y3 = (r * (v - x3) - 2 * y * j) % P
        z3 = ((z + h) * (z + h) - zz - hh) % P
        X.append(x3)
        Y.append(y3)
        Z.append(z3)
    pref = [0] * n
    acc = 1
    for i in range(n):
        acc = acc * Z[i] % P
        pref[i] = acc
    inv = pow(acc, P - 2, P)
    xs = bytearray()
    ys = bytearray()
    out_x = [0] * n
    out_y = [0] * n
    for i in range(n - 1, -1, -1):
        zi = inv * pref[i - 1] % P if i else inv
        inv = inv * Z[i] % P
        zi2 = zi * zi % P
        out_x[i] = X[i] * zi2 % P
        out_y[i] = Y[i] * zi2 % P * zi % P
    for i in range(n):
        xs += out_x[i].to_bytes(48, "big")
        ys += out_y[i].to_bytes(48, "big")
    return np.concatenate(
        [np.frombuffer(bytes(xs), np.uint8).reshape(n, 48),
         np.frombuffer(bytes(ys), np.uint8).reshape(n, 48)],
        axis=1,
    )


def _registry(n: int, sk0: int, pool=None):
    """Affine pubkeys of secret keys sk0 .. sk0+n-1 as raw [n, 96] bytes,
    walked in REGISTRY_CHUNKS consecutive ranges (over ``pool``'s workers
    when given)."""
    import numpy as np

    path = os.path.join(FIXTURE_DIR, f"registry_{n}_{sk0:x}.npz")
    if os.path.exists(path):
        return np.load(path)["raw"]
    step = -(-n // REGISTRY_CHUNKS)
    jobs = [(sk0 + i, min(step, n - i)) for i in range(0, n, step)]
    raw = np.concatenate(_fixture_map(pool, _registry_walk, jobs), axis=0)
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    np.savez(path, raw=raw)
    return raw


def _sign_compressed(job) -> bytes:
    """The oracle's compressed signature of ``msg`` under secret key ``sk``."""
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc

    sk, msg = job
    return oc.g2_compress(cs.sign(sk, msg))


def _batch(rng, n_val: int, sk0: int, n_sets: int, k: int, poison: bool = False, pool=None):
    """n_sets (indices, message, signature bytes) triples signed by the oracle
    with each set's aggregate secret key (over ``pool``'s workers when
    given); ``poison`` swaps in a signature of another message for set 0."""
    from lighthouse_tpu_torch.oracle.fields import R

    drawn, jobs = [], []
    for s in range(n_sets):
        idx = rng.choice(n_val, size=k, replace=False)
        msg = rng.bytes(32)
        agg_sk = (k * sk0 + int(idx.sum())) % R
        msg_signed = rng.bytes(32) if (poison and s == 0) else msg
        drawn.append(([int(i) for i in idx], msg))
        jobs.append((agg_sk, msg_signed))
    sigs = _fixture_map(pool, _sign_compressed, jobs)
    return [(idx, msg, sig) for (idx, msg), sig in zip(drawn, sigs)]


def _pubkeys(raw, idx):
    """``bls.PublicKey`` objects straight from the registry's affine points
    (no decompression, no subgroup check: the registry is valid by
    construction)."""
    from lighthouse_tpu_torch import bls

    return [
        bls.PublicKey((int.from_bytes(raw[v, :48].tobytes(), "big"),
                       int.from_bytes(raw[v, 48:].tobytes(), "big")))
        for v in idx
    ]


def _sign_point(job):
    """The oracle's signature of ``msg`` under secret key ``sk`` (a G2 point)."""
    from lighthouse_tpu_torch.oracle import ciphersuite as cs

    sk, msg = job
    return cs.sign(sk, msg)


def _block(rng, raw, sk0: int, n_att: int, k: int, pool=None):
    """One block's signature sets over ``bls`` objects: the proposer and
    randao sets (one key each, through ``PublicKey.from_bytes``), ``n_att``
    attestation aggregates and one sync aggregate of ``k`` keys each, all
    signed by the oracle (over ``pool``'s workers when given). Returns
    (sets, the secret key of each set)."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    n_val = raw.shape[0]
    singles, multis, sks, msgs = [], [], [], []
    for _ in range(2):
        v = int(rng.integers(n_val))
        singles.append(bls.PublicKey.from_bytes(oc.g1_compress(_pubkeys(raw, [v])[0].point)))
        msgs.append(rng.bytes(32))
        sks.append(sk0 + v)
    for _ in range(n_att + 1):
        idx = rng.choice(n_val, size=k, replace=False)
        msgs.append(rng.bytes(32))
        sks.append((k * sk0 + int(idx.sum())) % R)
        multis.append(_pubkeys(raw, idx))
    sigs = _fixture_map(pool, _sign_point, list(zip(sks, msgs)))
    sets = [bls.SignatureSet.single_pubkey(bls.Signature(sig), pk, msg)
            for pk, sig, msg in zip(singles, sigs, msgs)]
    sets += [bls.SignatureSet.multiple_pubkeys(bls.AggregateSignature(sig), pks, msg)
             for pks, sig, msg in zip(multis, sigs[2:], msgs[2:])]
    return sets, sks


def _poison(sets, sks, j: int):
    """``sets`` with set j's signature made over another message."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.oracle import ciphersuite as cs

    out = list(sets)
    out[j] = bls.SignatureSet.multiple_pubkeys(
        bls.AggregateSignature(cs.sign(sks[j], b"\x5a" * 32)), sets[j].signing_keys, sets[j].message)
    return out


def _g2_walk(p0, h, n: int):
    """[p0, p0 + h, ..., p0 + (n-1) h] (affine G2): one Jacobian add per
    point, then one batched normalisation (Montgomery's trick)."""
    from lighthouse_tpu_torch.oracle import curves as oc

    ops = oc.OPS_FQ2
    hj = oc._to_jac(h, ops)
    jac = [oc._to_jac(p0, ops)]
    for _ in range(n - 1):
        jac.append(oc._jac_add(jac[-1], hj, ops))
    pref, acc = [], ops.one
    for _, _, z in jac:
        acc = acc * z
        pref.append(acc)
    inv = acc.inv()
    out = [None] * n
    for i in range(n - 1, -1, -1):
        x, y, z = jac[i]
        zi = inv * pref[i - 1] if i else inv
        inv = inv * z
        zi2 = zi.square()
        out[i] = (x * zi2, y * zi2 * zi)
    return out


def _gossip_pool(rng, n_val: int, sk0: int, committees: int, size: int):
    """committees x size single-key attestations (one signing root per
    committee, as in one slot) from consecutive validators: with consecutive
    secret keys, sig_{i+1} = sig_i + H(m). Seeded order, committees mixed."""
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    pool = []
    for _ in range(committees):
        msg = rng.bytes(32)
        base = int(rng.integers(n_val - size))
        h = cs.hash_to_g2(msg)
        sigs = _g2_walk(oc.g2_mul(h, (sk0 + base) % R), h, size)
        pool += [([base + i], msg, oc.g2_compress(sg)) for i, sg in enumerate(sigs)]
    return [pool[i] for i in rng.permutation(len(pool))]


# --------------------------------------------------------------------------------------
# The firehose (bench.py's stream generator and SLO block, copied)
# --------------------------------------------------------------------------------------

FIREHOSE_SLOS = {
    "p99_queue_latency_ms": 250.0,
    "max_drop_rate": 0.05,
}


def _pace_stream(engine, pool, rate: float, duration: float,
                 drain_timeout: float) -> tuple[int, float]:
    """Seeded synthetic gossip generator: pace ``rate`` att/s of pool items
    into the engine in 1 ms micro-bursts (the intake is non-blocking;
    overflow sheds inside the engine, never stalls the generator). Returns
    (items offered, wall seconds incl. drain)."""
    t_start = time.perf_counter()
    n_stream = 0
    per_tick = max(1, int(rate / 1000))
    while True:
        elapsed = time.perf_counter() - t_start
        if elapsed >= duration:
            break
        target = min(int(rate * elapsed) + per_tick, int(rate * duration))
        while n_stream < target:
            engine.submit(pool[n_stream % len(pool)])
            n_stream += 1
        time.sleep(0.001)
    engine.stop(drain_timeout=drain_timeout)
    return n_stream, time.perf_counter() - t_start


def _slo_block(st, n_stream: int) -> dict:
    """Measured-vs-declared SLO block for a firehose stats snapshot."""
    drop_rate = st.dropped / n_stream if n_stream else 0.0
    p99_ms = st.p99_latency_s * 1e3 if st.p99_latency_s is not None else None
    return {
        "declared": dict(FIREHOSE_SLOS),
        "measured": {"p99_queue_latency_ms": p99_ms, "drop_rate": drop_rate},
        "met": {
            "p99_queue_latency_ms": (
                p99_ms is not None and p99_ms <= FIREHOSE_SLOS["p99_queue_latency_ms"]
            ),
            "drop_rate": drop_rate <= FIREHOSE_SLOS["max_drop_rate"],
        },
    }


def _spread(ms: list) -> dict:
    """Median, min and max of repeated wall times."""
    ms = sorted(ms)
    return {"median": ms[len(ms) // 2], "min": ms[0], "max": ms[-1]}


def _profiled(fn, host_ops: bool = True):
    """One call of ``fn`` under torch.profiler: (its result, wall ms, device
    microseconds by kernel name, aten ops dispatched). ``host_ops=False``
    traces the device alone (aten ops None): the host trace of a call of
    ~100k ops costs tens of seconds to aggregate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    # summed over the trace's raw events: key_averages first builds a Python
    # event tree, seconds for a call of ten thousand launches
    dev_us: dict = {}
    n_ops = 0 if host_ops else None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "cuda" not in str(e.device_type()).lower():
            if host_ops and name.startswith("aten::"):
                n_ops += 1
            continue
        us = e.duration_ns() / 1e3
        if us:
            dev_us[name] = dev_us.get(name, 0.0) + us
    return out, wall_ms, dev_us, n_ops


def _bisect_calls(order: list, bad: set) -> int:
    """Verify calls the reference's bisection (firehose/bisect.py) makes
    after a failed whole batch, for single-item groups in ``order``:
    written out here independently of the port's copy."""
    def rec(lo, hi, known_failed):
        if hi <= lo:
            return 0
        n = 0
        if not known_failed:
            n += 1
            if not any(order[i] in bad for i in range(lo, hi)):
                return n
        if hi - lo == 1:
            return n
        mid = (lo + hi) // 2
        return n + rec(lo, mid, False) + rec(mid, hi, False)

    return rec(0, len(order), True)


# --------------------------------------------------------------------------------------
# The state transition (phases 11 and 12)
# --------------------------------------------------------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compressed(raw) -> list:
    """48-byte compressed G1 encodings of the registry's affine points (the
    port's vectorised ``compress_affine``; main spot-checks rows against the
    oracle's ``g1_compress``)."""
    from lighthouse_tpu_torch.beacon_chain.pubkey_cache import compress_affine

    buf = compress_affine(raw).tobytes()
    return [buf[48 * i: 48 * i + 48] for i in range(raw.shape[0])]


def _refill_deposits(state, rng, count: int = 8) -> None:
    """Top the pending-deposit queue back up to ``count`` 1 ETH top-ups of
    known validators (bench.py's _refill_epoch_deposits)."""
    from lighthouse_tpu_torch.types.containers import for_preset

    ns = for_preset("mainnet")
    pending = list(state.pending_deposits)
    while len(pending) < count:
        v = state.validators[int(rng.integers(0, len(state.validators)))]
        pending.append(ns.PendingDeposit(
            pubkey=bytes(v.pubkey), withdrawal_credentials=bytes(v.withdrawal_credentials),
            amount=10**9, signature=b"\x00" * 96, slot=1,
        ))
    state.pending_deposits = pending


def _epoch_state(spec, raw, comp, rng):
    """An electra mainnet-preset state over the registry's first
    ``raw.shape[0]`` keys, shaped after bench.py's _build_epoch_state
    (BASELINE config #4): the registry's own (unique) pubkeys, ~1/16
    compounding and ~7/16 0x01 credentials, 32 ejectable validators at
    15 ETH, balances 31-33 ETH, random participation, 8 pending deposits
    and 4 pending consolidations, at the last slot of epoch
    ``STATE_EPOCH``. Besides, what a block needs: a post-merge execution
    header, a current sync committee of 512 registry validators and a next
    one of 512 others. Returns (state, the current sync committee's
    validator indices)."""
    import numpy as np

    from lighthouse_tpu_torch.types.containers import Checkpoint, Fork, Validator, for_preset
    from lighthouse_tpu_torch.types.spec import FAR_FUTURE_EPOCH

    ns = for_preset(spec.preset.name)
    p = spec.preset
    n = raw.shape[0]
    state = ns.BeaconStateElectra()
    state.slot = (STATE_EPOCH + 1) * p.SLOTS_PER_EPOCH - 1
    state.fork = Fork(previous_version=spec.electra_fork_version,
                      current_version=spec.electra_fork_version, epoch=0)
    state.genesis_validators_root = rng.bytes(32)
    eff = np.full(n, 32 * 10**9, dtype=np.uint64)
    eff[rng.choice(n, size=min(32, n // 64), replace=False)] = 15 * 10**9
    creds = rng.integers(0, 16, n)
    prefix = [b"\x02" if c == 0 else b"\x01" if c < 8 else b"\x00" for c in creds]
    far = FAR_FUTURE_EPOCH
    state.validators = [
        Validator(pubkey=comp[i], withdrawal_credentials=prefix[i] + b"\x00" * 31,
                  effective_balance=int(eff[i]), slashed=False,
                  activation_eligibility_epoch=0, activation_epoch=0, exit_epoch=far,
                  withdrawable_epoch=far)
        for i in range(n)
    ]
    state.balances = rng.integers(31 * 10**9, 33 * 10**9, n, dtype=np.int64).astype(np.uint64)
    state.previous_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
    state.current_epoch_participation = rng.integers(0, 8, n).astype(np.uint8)
    state.inactivity_scores = np.zeros(n, dtype=np.uint64)
    state.block_roots = [rng.bytes(32) for _ in range(p.SLOTS_PER_HISTORICAL_ROOT)]
    cur = STATE_EPOCH
    state.finalized_checkpoint = Checkpoint(epoch=cur - 2, root=rng.bytes(32))
    state.previous_justified_checkpoint = Checkpoint(epoch=cur - 2, root=rng.bytes(32))
    state.current_justified_checkpoint = Checkpoint(epoch=cur - 1, root=rng.bytes(32))
    state.justification_bits = np.ones(4, dtype=bool)
    state.eth1_deposit_index = n
    state.deposit_requests_start_index = 0
    _refill_deposits(state, rng)
    state.pending_consolidations = [
        ns.PendingConsolidation(source_index=int(rng.integers(0, n)),
                                target_index=int(rng.integers(0, n)))
        for _ in range(4)
    ]
    state.latest_execution_payload_header = ns.payload_header_types["electra"](
        block_hash=rng.bytes(32), block_number=1, timestamp=0)
    sync_idx = rng.choice(n, size=p.SYNC_COMMITTEE_SIZE, replace=False)
    state.current_sync_committee = _sync_committee(ns, raw, comp, sync_idx)
    # the next period's committee: other members (drawn without touching
    # rng), so that the light client's batch gathers two committee rows
    next_idx = np.random.default_rng([STATE_EPOCH, n]).choice(n, size=p.SYNC_COMMITTEE_SIZE,
                                                               replace=False)
    state.next_sync_committee = _sync_committee(ns, raw, comp, next_idx)
    return state, sync_idx


def _sync_committee(ns, raw, comp, idx):
    """A SyncCommittee of the registry's validators ``idx`` (compressed keys
    ``comp``, or None to compress them from the affine ``raw`` rows)."""
    from lighthouse_tpu_torch.oracle import curves as oc

    agg, keys = None, []
    for i in idx:
        pt = (int.from_bytes(raw[i, :48].tobytes(), "big"), int.from_bytes(raw[i, 48:].tobytes(), "big"))
        agg = oc.g1_add(agg, pt)
        keys.append(comp[i] if comp is not None else oc.g1_compress(pt))
    return ns.SyncCommittee(pubkeys=keys, aggregate_pubkey=oc.g1_compress(agg))


def _next_epoch(spec, state, rng) -> None:
    """From the first slot of an epoch to its last (slots skipped, as the
    reference's bench does between boundaries), with fresh participation
    and a refilled deposit queue, so every boundary does the same work."""
    import numpy as np

    state.slot += spec.preset.SLOTS_PER_EPOCH - 1
    state.current_epoch_participation = rng.integers(0, 8, len(state.validators)).astype(np.uint8)
    _refill_deposits(state, rng)


def _epoch_parity(dev_state, twin) -> None:
    """bench.py's _assert_epoch_parity (1686), plus the tree roots."""
    import numpy as np

    def col(s, attr):
        return np.fromiter((int(getattr(v, attr)) for v in s.validators), dtype=np.uint64)

    checks = {
        "balances": (np.asarray(dev_state.balances, np.uint64), np.asarray(twin.balances, np.uint64)),
        "inactivity": (np.asarray(dev_state.inactivity_scores, np.uint64),
                       np.asarray(twin.inactivity_scores, np.uint64)),
    }
    if len(dev_state.validators) != len(twin.validators):
        raise RuntimeError("epoch parity: registry length diverged")
    for attr in ("effective_balance", "exit_epoch", "withdrawable_epoch", "activation_epoch",
                 "activation_eligibility_epoch"):
        checks[attr] = (col(dev_state, attr), col(twin, attr))
    for name, (a, b) in checks.items():
        if not np.array_equal(a, b):
            raise RuntimeError(f"epoch parity: {name} diverged")
    for attr in ("deposit_balance_to_consume", "exit_balance_to_consume", "earliest_exit_epoch"):
        if int(getattr(dev_state, attr)) != int(getattr(twin, attr)):
            raise RuntimeError(f"epoch parity: {attr} diverged")
    for attr in ("finalized_checkpoint", "pending_deposits", "pending_consolidations"):
        if getattr(dev_state, attr) != getattr(twin, attr):
            raise RuntimeError(f"epoch parity: {attr} diverged")
    if dev_state.tree_root() != twin.tree_root():
        raise RuntimeError("epoch parity: tree_root diverged")


def epoch_phase(spec, raw, comp, dev, rng, profile: bool = True) -> tuple:
    """Phase 11: the state over the whole registry through one warm-up,
    EPOCH_TIMED timed and one profiled epoch boundary, each through
    ``process_slots`` with the epoch backend "device" on ``dev``. Every
    boundary must be handled by the device engine (read at its seam), with
    a clean ``epoch_device`` supervisor and the mirror bound once. Returns
    (state at the first slot after the last boundary, sync committee
    indices, measurements)."""
    import torch

    from lighthouse_tpu_torch import epoch_engine, resilience
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.analysis import memory
    from lighthouse_tpu_torch.analysis.recompile import BuildSentinel
    from lighthouse_tpu_torch.epoch_engine import engine

    n = raw.shape[0]
    t = time.time()
    state, sync_idx = _epoch_state(spec, raw, comp, rng)
    build_s = time.time() - t
    sup = resilience.epoch_supervisor()
    snap0 = sup.snapshot()
    epoch_engine.set_backend("device", device=dev)
    t = time.time()
    _sync(dev)
    alloc0 = torch.cuda.memory_allocated(dev)
    epoch_engine.prepare_state(state)
    _sync(dev)
    bind_s = time.time() - t
    # phase 24 (b): the mirror's registry columns against the model and the allocator
    resident = _resident_row("epoch_mirror", list(engine.mirror_of(state).cols.values()),
                             torch.cuda.memory_allocated(dev) - alloc0,
                             memory.epoch_mirror_bytes(n, include_epoch_planes=False))
    sentinel, mark, timed_builds = BuildSentinel(), None, None
    seam_calls, prof = [], {}
    real = epoch_engine.maybe_process_epoch_on_device

    def seam(spec_, state_, device=None):  # per_epoch.process_epoch calls it
        t0 = time.perf_counter()
        if prof.get("on"):
            # the profiler traces the thread that starts it: for this one
            # boundary the supervisor runs the sweep on the calling thread
            # (no watchdog) so that its kernels are in the trace
            deadline = sup.config.deadline_s
            sup.config.deadline_s = 0
            try:
                ok, wall_ms, dev_us, ops = _profiled(lambda: real(spec_, state_, device))
            finally:
                sup.config.deadline_s = deadline
            prof.update(wall_ms=wall_ms, dev_us=dev_us, aten_ops=ops)
        else:
            ok = real(spec_, state_, device)
            _sync(dev)
        seam_calls.append((ok, time.perf_counter() - t0))
        return ok

    n_bound = 2 + EPOCH_TIMED  # warm-up, timed, profiled
    bounds = []
    epoch_engine.maybe_process_epoch_on_device = seam
    try:
        for i in range(n_bound):
            prof["on"] = profile and i == n_bound - 1
            if i == 1:  # phase 24 (c): the timed boundaries under the build sentinel
                mark = sentinel.snapshot()
            t0 = time.perf_counter()
            st.process_slots(spec, state, state.slot + 1)
            _sync(dev)
            slots_s = time.perf_counter() - t0
            if i == EPOCH_TIMED:
                timed_builds = sentinel.builds_since(mark)
            if len(seam_calls) != i + 1 or seam_calls[i][0] is not True:
                raise RuntimeError(f"epoch boundary {i}: not handled on the device ({seam_calls})")
            stats = epoch_engine.engine_stats(state)
            bounds.append({"epoch_ms": seam_calls[i][1] * 1e3, "slots_ms": slots_s * 1e3,
                           "h2d_bytes": stats["last_host_to_device_bytes"]})
            if i < n_bound - 1:
                t0 = time.perf_counter()
                _next_epoch(spec, state, rng)
                bounds[-1]["next_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        epoch_engine.maybe_process_epoch_on_device = real
    snap = sup.snapshot()
    for k in ("faults", "retries", "demotions", "fallback_calls", "watchdog_timeouts",
              "exhausted", "hung_threads"):
        if snap[k] != snap0[k]:
            raise RuntimeError(f"epoch_device supervisor not clean: {snap}")
    if snap["state"] != "HEALTHY" or snap["calls"] - snap0["calls"] != n_bound:
        raise RuntimeError(f"epoch_device supervisor: {snap}")
    stats = epoch_engine.engine_stats(state)
    if stats["full_syncs"] != 1 or stats["epochs"] != n_bound:
        raise RuntimeError(f"epoch mirror: {stats}")
    timed = bounds[1:1 + EPOCH_TIMED]
    ep = _spread([b["epoch_ms"] for b in timed])
    # the sweep's least traffic: per padded row, the registry (5 x 8 + 2 x 1 B),
    # balances, inactivity and two participation bytes read once (60 B), seven
    # 8-byte columns written once (56 B)
    sweep_bytes = 116 * engine.mirror_of(state).n_pad
    out = {
        "validators": n, "build_s": build_s, "bind_s": bind_s, "warmup": bounds[0],
        "timed": timed, "epoch_ms": ep, "validators_per_s": n / (ep["median"] / 1e3),
        "h2d_bytes_per_epoch": [b["h2d_bytes"] for b in timed], "mirror": stats,
        "supervisor": snap, "profiled": bounds[-1], "sweep_bytes": sweep_bytes,
        "bound_ms": sweep_bytes / H100_BYTES_PER_S * 1e3, "resident": resident,
        "timed_builds": timed_builds,
    }
    if prof.get("dev_us"):
        busy = sum(prof["dev_us"].values()) / 1e3
        out.update(busy_ms=busy, profiled_ms=prof["wall_ms"], aten_ops=prof["aten_ops"],
                   idle_share=1 - busy / ep["median"],
                   device_ms_by_name={k: us / 1e3 for k, us in sorted(
                       prof["dev_us"].items(), key=lambda kv: -kv[1])[:8]})
    return state, sync_idx, out


def epoch_parity_phase(spec, raw, comp, dev, rng) -> dict:
    """Phase 11's parity: at PARITY_VALIDATORS, one device boundary against
    the port's numpy per_epoch on a copy of the same state."""
    from lighthouse_tpu_torch import epoch_engine
    from lighthouse_tpu_torch.state_transition.per_epoch import process_epoch

    n = min(PARITY_VALIDATORS, raw.shape[0])
    state, _ = _epoch_state(spec, raw[:n], comp[:n], rng)
    t = time.time()
    state.tree_root()  # the copy below carries the per-validator root memos
    root_s = time.time() - t
    twin = state.copy()
    t = time.time()
    mesh_twin = state.copy()  # phase 23 (e): the same boundary over row blocks
    mesh_copy_s = time.time() - t
    epoch_engine.set_backend("device", device=dev)
    t = time.time()
    if not epoch_engine.maybe_process_epoch_on_device(spec, state):
        raise RuntimeError("epoch parity: the device engine refused the state")
    _sync(dev)
    dev_s = time.time() - t
    epoch_engine.set_backend("numpy")
    t = time.time()
    process_epoch(spec, twin)
    numpy_s = time.time() - t
    epoch_engine.set_backend("device", device=dev)
    _epoch_parity(state, twin)
    t = time.time()
    mesh = mesh_epoch_check(spec, mesh_twin, state, dev)
    mesh["phase_s"] = time.time() - t + mesh_copy_s
    return {"validators": n, "device_s": dev_s, "numpy_s": numpy_s, "first_root_s": root_s,
            "mesh": mesh}


def _state_block(spec, state, sk0: int, sync_idx, rng):
    """A signed electra block at ``state.slot`` (one of the first slots of
    an epoch) through the port's own types, and its poisoned twin: ATT_SLOTS
    attestations, each over every committee of one of the last slots of
    the previous epoch, a full sync aggregate, the randao reveal and an
    execution payload carrying the expected withdrawals; the state root
    from a dry run without signatures, then the proposer's signature. Every
    aggregate is (sum of the secret keys) * H(m), one oracle signature.
    Returns (block, poisoned twin, the attesters' validator indices)."""
    import numpy as np

    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.ssz import uint64
    from lighthouse_tpu_torch.state_transition.per_block import (
        _expected_withdrawals_list,
        compute_timestamp_at_slot,
    )
    from lighthouse_tpu_torch.types.containers import (
        AttestationData,
        Checkpoint,
        SigningData,
        for_preset,
    )
    from lighthouse_tpu_torch.types.helpers import compute_signing_root, get_domain

    def sign(sk, root):
        return oc.g2_compress(cs.sign(sk % R, root))

    ns = for_preset(spec.preset.name)
    spe = spec.preset.SLOTS_PER_EPOCH
    slot = int(state.slot)
    epoch, prev = slot // spe, slot // spe - 1
    n_comm = st.get_committee_count_per_slot(spec, state, prev)
    att_domain = get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=prev)
    target = Checkpoint(epoch=prev, root=st.get_block_root(spec, state, prev))
    committee_bits = np.zeros(spec.preset.MAX_COMMITTEES_PER_SLOT, dtype=bool)
    committee_bits[:n_comm] = True
    atts, attesters = [], []
    for s in range(epoch * spe - ATT_SLOTS, epoch * spe):
        members = np.concatenate([st.get_beacon_committee(spec, state, s, c) for c in range(n_comm)])
        attesters.append(members)
        data = AttestationData(slot=s, index=0,
                               beacon_block_root=st.get_block_root_at_slot(spec, state, s),
                               source=state.previous_justified_checkpoint, target=target)
        atts.append(ns.AttestationElectra(
            aggregation_bits=np.ones(members.size, dtype=bool), data=data,
            signature=sign(members.size * sk0 + int(members.sum()),
                           compute_signing_root(data, att_domain)),
            committee_bits=committee_bits.copy(),
        ))
    prev_slot = slot - 1
    sync_root = SigningData(
        object_root=st.get_block_root_at_slot(spec, state, prev_slot),
        domain=get_domain(spec, state, spec.DOMAIN_SYNC_COMMITTEE,
                          epoch=spec.compute_epoch_at_slot(prev_slot)),
    ).tree_root()
    sync = ns.SyncAggregate(
        sync_committee_bits=np.ones(len(sync_idx), dtype=bool),
        sync_committee_signature=sign(len(sync_idx) * sk0 + int(np.sum(sync_idx)), sync_root),
    )
    proposer = st.get_beacon_proposer_index(spec, state)
    randao_root = SigningData(
        object_root=uint64.hash_tree_root(epoch),
        domain=get_domain(spec, state, spec.DOMAIN_RANDAO, epoch=epoch),
    ).tree_root()
    header = state.latest_execution_payload_header
    payload = ns.payload_types["electra"](
        parent_hash=bytes(header.block_hash), prev_randao=st.get_randao_mix(spec, state, epoch),
        timestamp=compute_timestamp_at_slot(spec, state, slot),
        block_number=int(header.block_number) + 1, block_hash=rng.bytes(32),
        withdrawals=_expected_withdrawals_list(spec, state),
    )
    body = ns.body_types["electra"](
        randao_reveal=sign(sk0 + proposer, randao_root), eth1_data=state.eth1_data,
        attestations=atts, sync_aggregate=sync, execution_payload=payload,
    )
    block_cls = ns.block_types["electra"]
    block = dict(block_cls.FIELDS)["message"](
        slot=slot, proposer_index=proposer, parent_root=state.latest_block_header.tree_root(),
        state_root=b"\x00" * 32, body=body,
    )
    trial = state.copy()
    st.per_block_processing(spec, trial, block_cls(message=block, signature=b"\x00" * 96),
                            strategy=st.BlockSignatureStrategy.NO_VERIFICATION,
                            verify_block_root=False)
    block.state_root = trial.tree_root()
    del trial
    domain = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
    signed = block_cls(message=block, signature=sign(sk0 + proposer, compute_signing_root(block, domain)))
    bad = block_cls.decode(signed.serialize())
    bad.message.body.attestations[ATT_SLOTS // 2].signature = atts[0].signature
    return signed, bad, np.concatenate(attesters)


def state_block_phase(spec, state, raw, sk0: int, sync_idx, dev, rng) -> dict:
    """Phase 12: the block through ``per_block_processing(VERIFY_BULK)``
    with the state root checked; its signatures must reach the port's
    ``bls`` as one batch, which runs on ``dev``. Pubkeys come from the
    registry by index (``get_pubkey``), not by decompression. The poisoned
    twin must raise. Counts: set to 0 just before the valid block, read by
    the caller just after this returns."""
    import numpy as np

    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.ops.shuffle import shuffle_list

    n = len(state.validators)
    t = time.time()
    shuffle_list(np.arange(n, dtype=np.uint64), rng.bytes(32), spec.preset.SHUFFLE_ROUND_COUNT)
    shuffle_s = time.time() - t
    t = time.time()  # the previous epoch's committee cache: active indices + shuffle
    st.get_beacon_committee(spec, state, state.slot - spec.preset.SLOTS_PER_EPOCH, 0)
    committees_s = time.time() - t
    t = time.time()
    block, bad, _ = _state_block(spec, state, sk0, sync_idx, rng)
    build_s = time.time() - t
    keys: dict = {}

    def get_pubkey(i):
        pk = keys.get(i)
        if pk is None:
            pk = keys[i] = bls.PublicKey((int.from_bytes(raw[i, :48].tobytes(), "big"),
                                          int.from_bytes(raw[i, 48:].tobytes(), "big")))
        return pk

    batches, roots = [], []
    real_verify = bls.verify_signature_sets
    state_cls = type(state)
    real_root = state_cls.tree_root

    def verify(sets, *, device=None):  # per_block's one batch, timed by halves
        sets = list(sets)
        t0 = time.perf_counter()
        prepared = bls.prepare_sets(sets, dev)
        _sync(dev)
        t1 = time.perf_counter()
        ok = bls.verify_prepared_sets(prepared)
        _sync(dev)
        batches.append({"sets": len(sets), "keys": sum(len(s.signing_keys) for s in sets),
                        "start": t0, "host_half_ms": (t1 - t0) * 1e3,
                        "device_half_ms": (time.perf_counter() - t1) * 1e3, "ok": ok})
        return ok

    def timed_root(self):
        t0 = time.perf_counter()
        r = real_root(self)
        roots.append((time.perf_counter() - t0) * 1e3)
        return r

    bls.set_backend("device", device=dev)
    bls.verify_signature_sets = verify
    state_cls.tree_root = timed_root
    try:
        from lighthouse_tpu_torch.ops.bls import fused_mul as fm

        fm.reset_counts()
        t0 = time.perf_counter()
        st.per_block_processing(spec, state, block, strategy=st.BlockSignatureStrategy.VERIFY_BULK,
                                get_pubkey=get_pubkey)
        total_ms = (time.perf_counter() - t0) * 1e3
        runs = {"state_block": _read_counts("state-transition block")}
        if len(batches) != 1 or batches[0]["ok"] is not True:
            raise RuntimeError(f"state block: {len(batches)} bls batches {batches}")
        if len(roots) != 1:
            raise RuntimeError(f"state block: {len(roots)} state roots")
        valid = dict(batches[0])
        fm.reset_counts()
        try:
            st.per_block_processing(spec, state, bad,
                                    strategy=st.BlockSignatureStrategy.VERIFY_BULK,
                                    get_pubkey=get_pubkey)
        except st.BlockProcessingError as e:
            if "bulk signature" not in str(e):
                raise
        else:
            raise RuntimeError("the poisoned state block was processed")
        runs["state_block_bad"] = _read_counts("poisoned state-transition block")
        if len(batches) != 2 or batches[1]["ok"] is not False:
            raise RuntimeError(f"poisoned state block: batches {batches[1:]}")
    finally:
        bls.verify_signature_sets = real_verify
        state_cls.tree_root = real_root
    host_ms = (valid.pop("start") - t0) * 1e3
    verify_ms = valid["host_half_ms"] + valid["device_half_ms"]
    return {
        "slot": int(block.message.slot), "attestations": len(block.message.body.attestations),
        "sets": valid["sets"], "keys": valid["keys"], "build_s": build_s,
        "shuffle_s": shuffle_s, "committees_s": committees_s,
        "host_part_ms": host_ms, "verify": valid, "state_root_ms": roots[0],
        "operations_ms": total_ms - host_ms - verify_ms - roots[0], "total_ms": total_ms,
        "runs": runs, "block": block, "bad": bad,
    }


# --------------------------------------------------------------------------------------
# The beacon chain (phase 13)
# --------------------------------------------------------------------------------------


def _recent_checkpoints(spec, state) -> None:
    """Justification one epoch behind and finality two, as on a healthy
    chain. Phase 11's random participation never justifies, and fork
    choice only takes a block as head while its voting source is within two
    epochs of the current one (``proto_array._node_is_viable_for_head``)."""
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.types.containers import Checkpoint

    e = st.get_current_epoch(spec, state)
    state.current_justified_checkpoint = Checkpoint(epoch=e - 1, root=st.get_block_root(spec, state, e - 1))
    state.previous_justified_checkpoint = Checkpoint(epoch=e - 2, root=st.get_block_root(spec, state, e - 2))
    state.finalized_checkpoint = state.previous_justified_checkpoint.copy()


class _ImportSplit:
    """One ``chain.process_block`` split into its parts by wrapping the
    calls it makes: the chain's own (instance attributes shadow the methods
    of this one chain), ``process_slots`` and ``per_block_processing`` as
    the chain module imported them, the ``bls`` batch (timed by halves, as
    phase 12 does), the state root inside block processing, and the epoch
    engine's seam. ``split()`` gives the parts in ms after the import."""

    def __init__(self, chain, dev):
        import lighthouse_tpu_torch.beacon_chain.chain as chain_mod
        from lighthouse_tpu_torch import bls, epoch_engine

        self.chain, self.dev, self.t = chain, dev, {}
        self.batches, self.roots, self.epochs, self.in_pbp = [], [], [], False
        self._patches = _Patches()
        patch = self._patches.set
        state_cls = type(chain.head.state)

        def span(key, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.t[key] = (t0, time.perf_counter())
            return run

        patch(chain, "get_state_for_block", span("pre_state", chain.get_state_for_block))
        patch(chain_mod, "process_slots", span("process_slots", chain_mod.process_slots))
        real_pbp = chain_mod.per_block_processing

        def pbp(*a, **k):
            self.in_pbp = True
            try:
                return span("pbp", real_pbp)(*a, **k)
            finally:
                self.in_pbp = False

        patch(chain_mod, "per_block_processing", pbp)
        real_verify = bls.verify_signature_sets

        def verify(sets, *, device=None):
            sets = list(sets)
            t0 = time.perf_counter()
            prepared = bls.prepare_sets(sets, dev)
            _sync(dev)
            t1 = time.perf_counter()
            ok = bls.verify_prepared_sets(prepared)
            _sync(dev)
            self.batches.append({"sets": len(sets), "keys": sum(len(s.signing_keys) for s in sets),
                                 "start": t0, "host_half_ms": (t1 - t0) * 1e3,
                                 "device_half_ms": (time.perf_counter() - t1) * 1e3, "ok": ok})
            return ok

        patch(bls, "verify_signature_sets", verify)
        real_root = state_cls.tree_root

        def timed_root(st_self):
            t0 = time.perf_counter()
            r = real_root(st_self)
            if self.in_pbp:
                self.roots.append((time.perf_counter() - t0) * 1e3)
            return r

        patch(state_cls, "tree_root", timed_root)
        real_seam = epoch_engine.maybe_process_epoch_on_device

        def seam(spec_, state_, device=None):
            t0 = time.perf_counter()
            ok = real_seam(spec_, state_, device)
            _sync(dev)
            self.epochs.append((ok, (time.perf_counter() - t0) * 1e3))
            return ok

        patch(epoch_engine, "maybe_process_epoch_on_device", seam)
        patch(chain, "_import_block", span("import_block", chain._import_block))
        patch(chain.pubkey_cache, "import_new_pubkeys",
              span("pubkeys", chain.pubkey_cache.import_new_pubkeys))
        patch(chain.store, "atomic_block_import", span("store", chain.store.atomic_block_import))
        patch(chain, "_justified_balances", span("justified", chain._justified_balances))
        patch(chain.fork_choice, "on_block", span("on_block", chain.fork_choice.on_block))
        patch(chain, "recompute_head", span("head", chain.recompute_head))
        patch(chain, "persist_fork_choice", span("persist", chain.persist_fork_choice))

    def restore(self) -> None:
        self._patches.undo()

    def split(self, total_ms: float) -> dict:
        t = self.t

        def ms(key):
            return (t[key][1] - t[key][0]) * 1e3

        v = self.batches[0]
        pbp_ms = ms("pbp")
        host_ms = (v["start"] - t["pbp"][0]) * 1e3
        verify_ms = v["host_half_ms"] + v["device_half_ms"]
        root_ms = sum(self.roots)
        return {
            "total_ms": total_ms, "pre_state_ms": ms("pre_state"),
            "process_slots_ms": ms("process_slots") if "process_slots" in t else 0.0,
            "epoch_ms": [e[1] for e in self.epochs],
            "block_processing_ms": pbp_ms, "host_part_ms": host_ms,
            "verify_host_half_ms": v["host_half_ms"], "verify_device_half_ms": v["device_half_ms"],
            "operations_ms": pbp_ms - host_ms - verify_ms - root_ms, "state_root_ms": root_ms,
            "new_pubkeys_ms": ms("pubkeys"),
            "store_write_ms": (t["store"][1] - t["pubkeys"][1]) * 1e3,
            "fork_choice_ms": ms("justified") + ms("on_block"),
            "justified_balances_ms": ms("justified"), "on_block_ms": ms("on_block"),
            "block_attestations_to_fork_choice_ms": (t["head"][0] - t["on_block"][1]) * 1e3,
            "recompute_head_ms": ms("head"), "import_block_ms": ms("import_block"),
            "persist_ms": ms("persist") if "persist" in t else 0.0,
            "sets": v["sets"], "keys": v["keys"],
        }


_MISSING = object()


class _Patches:
    """Attributes replaced for one measured run and put back after it."""

    def __init__(self):
        self._undo = []

    def set(self, obj, name, new) -> None:
        self._undo.append((obj, name, obj.__dict__.get(name, _MISSING)))
        setattr(obj, name, new)

    def undo(self) -> None:
        for obj, name, old in reversed(self._undo):
            if old is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, old)
        self._undo.clear()


def _timed_import(chain, signed, dev) -> tuple:
    """``chain.process_block(signed)`` under ``_ImportSplit``, with the
    supervisors' default configuration: (block root, split, bls batches,
    epoch seam calls)."""
    sp = _ImportSplit(chain, dev)
    try:
        t0 = time.perf_counter()
        root = chain.process_block(signed)
        _sync(dev)
        total_ms = (time.perf_counter() - t0) * 1e3
    finally:
        sp.restore()
    return root, sp.split(total_ms), sp.batches, sp.epochs


def _lc_timer(chain) -> list:
    """The chain's light-client server cache timed inside every import: its
    block observer replaced by one that appends [slot, ms, error or None] to
    the list returned (the chain swallows observer errors: ``_lc_ms``
    raises on one)."""
    rec = []
    obs = chain.block_observers
    i = obs.index(chain.light_client_cache.on_imported_block)
    real = obs[i]

    def timed(signed):
        t0, err = time.perf_counter(), None
        try:
            real(signed)
        except Exception as e:
            err = repr(e)
            raise
        finally:
            rec.append([int(signed.message.slot), (time.perf_counter() - t0) * 1e3, err])

    obs[i] = timed
    return rec


def _lc_ms(rec: list, since: int) -> float:
    """The server cache's ms over the imports recorded from ``since`` on;
    raises on an error recorded there."""
    bad = [r for r in rec[since:] if r[2]]
    if bad:
        raise RuntimeError(f"the light-client server cache failed inside an import: {bad}")
    return sum(r[1] for r in rec[since:])


def _profiled_replay(spec, chain, state, signed) -> dict:
    """The device-bearing tail of an import replayed on ``state`` (a copy of
    the pre-state one slot before the block) under torch.profiler: the last
    slot, with the epoch boundary when the block opens an epoch, then block
    processing as ``process_block`` calls it, and the post-state root held
    to the block's. Both supervisors run their device work on the calling
    thread for this call only, so the trace holds it. Wall, device busy,
    aten ops and idle share."""
    from lighthouse_tpu_torch import resilience
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.state_transition.per_block import ConsensusContext

    def replay():
        st.process_slots(spec, state, int(signed.message.slot))
        ctxt = ConsensusContext()
        ctxt.get_pubkey_index = chain.pubkey_cache.get_index
        st.per_block_processing(spec, state, signed, strategy=st.BlockSignatureStrategy.VERIFY_BULK,
                                ctxt=ctxt, get_pubkey=chain.pubkey_cache.get)
        return state.tree_root()

    sups = (resilience.bls_supervisor(), resilience.epoch_supervisor())
    deadlines = [s.config.deadline_s for s in sups]
    try:
        for s in sups:
            s.config.deadline_s = 0
        root, wall_ms, dev_us, ops = _profiled(replay)
    finally:
        for s, d in zip(sups, deadlines):
            s.config.deadline_s = d
    if root != bytes(signed.message.state_root):
        raise RuntimeError("profiled replay: the post-state root != the block's state_root")
    busy_ms = sum(dev_us.values()) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "aten_ops": ops, "idle_share": 1 - busy_ms / wall_ms}


def _fork_choice_view(chain) -> tuple:
    fc = chain.fork_choice
    return ([(n.root, n.parent, int(n.weight), n.best_child, n.best_descendant) for n in fc.proto.nodes],
            fc.store.justified_checkpoint, fc.store.finalized_checkpoint,
            len(fc.queued_attestations), fc.proto._vote_cur.copy(), fc.proto._vote_next.copy())


def _sign_all(h, sks) -> list:
    """Compressed oracle signatures sk * h for each sk."""
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R

    return [oc.g2_compress(oc.g2_mul(h, sk % R)) for sk in sks]


def _gossip_fixture(spec, chain, sk0: int, n_att: int, n_agg: int, bad_pos: int,
                    offset: int = 0, target_root: bytes | None = None):
    """Gossip for the head slot, signed by the oracle: ``n_att``
    unaggregated electra attestations by the members of committee 0 from
    position ``offset`` on (the one at ``bad_pos`` signed by another
    member), and
    ``n_agg`` SignedAggregateAndProofs of the whole committee by aggregators
    whose selection proofs select them, the last carrying another
    aggregator's (valid, selecting) proof. The target is the head (the
    epoch's first block) unless ``target_root`` names the epoch's first
    block. Returns (attestations, aggregates, the attesters' validator
    indices in order)."""
    import hashlib

    import numpy as np

    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.ssz import uint64
    from lighthouse_tpu_torch.types.containers import AttestationData, Checkpoint, SigningData, for_preset
    from lighthouse_tpu_torch.types.helpers import compute_signing_root, get_domain

    ns = for_preset(spec.preset.name)
    state = chain.head.state
    slot, epoch = int(state.slot), st.get_current_epoch(spec, state)
    committee = st.get_beacon_committee(spec, state, slot, 0)
    data = AttestationData(slot=slot, index=0, beacon_block_root=chain.head.root,
                           source=state.current_justified_checkpoint,
                           target=Checkpoint(epoch=epoch, root=target_root or chain.head.root))
    h = cs.hash_to_g2(compute_signing_root(data, get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER,
                                                            epoch=epoch)))
    cbits = np.zeros(spec.preset.MAX_COMMITTEES_PER_SLOT, dtype=bool)
    cbits[0] = True
    members = [int(v) for v in committee[offset:offset + n_att]]
    sigs = _sign_all(h, [sk0 + v for v in members])
    sigs[bad_pos] = sigs[(bad_pos + 1) % n_att]
    atts = []
    for j, sig in enumerate(sigs):
        bits = np.zeros(committee.size, dtype=bool)
        bits[offset + j] = True
        atts.append(ns.AttestationElectra(aggregation_bits=bits, data=data, signature=sig,
                                          committee_bits=cbits.copy()))
    aggregate = ns.AttestationElectra(
        aggregation_bits=np.ones(committee.size, dtype=bool), data=data,
        signature=_sign_all(h, [committee.size * sk0 + int(committee.sum())])[0],
        committee_bits=cbits.copy())
    sel_h = cs.hash_to_g2(SigningData(
        object_root=uint64.hash_tree_root(slot),
        domain=get_domain(spec, state, spec.DOMAIN_SELECTION_PROOF, epoch=epoch)).tree_root())
    modulo = max(1, committee.size // spec.target_aggregators_per_committee)
    chosen = []
    for v in committee:
        if len(chosen) == n_agg:
            break
        proof = _sign_all(sel_h, [sk0 + int(v)])[0]
        if int.from_bytes(hashlib.sha256(proof).digest()[:8], "little") % modulo == 0:
            chosen.append((int(v), proof))
    if len(chosen) < n_agg:
        raise RuntimeError(f"only {len(chosen)} aggregators selected in the committee")
    env_domain = get_domain(spec, state, spec.DOMAIN_AGGREGATE_AND_PROOF, epoch=epoch)
    aggs = []
    for k, (v, proof) in enumerate(chosen):
        if k == n_agg - 1:
            proof = chosen[0][1]  # another aggregator's proof: it selects, it does not verify
        msg = ns.AggregateAndProofElectra(aggregator_index=v, aggregate=aggregate,
                                          selection_proof=proof)
        env = compute_signing_root(msg, env_domain)
        aggs.append(ns.SignedAggregateAndProofElectra(
            message=msg, signature=_sign_all(cs.hash_to_g2(env), [sk0 + v])[0]))
    return atts, aggs, members


def _clean(before: dict, after: dict, calls: int | None, what: str) -> None:
    for k in ("faults", "retries", "demotions", "fallback_calls", "watchdog_timeouts",
              "exhausted", "hung_threads"):
        if after[k] != before[k]:
            raise RuntimeError(f"{what} supervisor not clean: {before} -> {after}")
    if after["state"] != "HEALTHY":
        raise RuntimeError(f"{what} supervisor: {after}")
    if calls is not None and after["calls"] - before["calls"] != calls:
        raise RuntimeError(f"{what} supervisor: {after['calls'] - before['calls']} calls, not {calls}")


def chain_phase(spec, anchor, raw, sk0: int, sync_idx, block, bad, dev_cache, dev, rng) -> dict:
    """Phase 13: the port's ``BeaconChain`` on ``anchor`` (phase 11's
    post-boundary state), its pubkey cache seeded from the registry's
    affine points; phase 12's block and its poisoned twin through
    ``process_block``; a second block at the first slot of the next epoch
    (the boundary inside the import, on the device engine) carrying
    attestations to the first; gossip through ``BeaconProcessor`` into the
    batch paths; the firehose. Counts are set to 0 before each import or
    gossip run and read after it (``runs``)."""
    import resource

    import numpy as np
    import torch

    from lighthouse_tpu_torch import bls, epoch_engine, resilience
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.beacon_chain import BeaconChain, BlockError, ValidatorPubkeyCache
    from lighthouse_tpu_torch.beacon_processor import (
        BeaconProcessor,
        BeaconProcessorConfig,
        Work,
        WorkType,
    )
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.store import HotColdDB
    from lighthouse_tpu_torch.store.kv import DBColumn
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    out, runs = {"validators": len(anchor.validators)}, {}
    bls.set_backend("device", device=dev)
    epoch_engine.set_backend("device", device=dev)
    bls_sup, epoch_sup = resilience.bls_supervisor(), resilience.epoch_supervisor()

    # 1. boot: the seeded pubkey cache, checked against the state's keys
    t = time.time()
    cache = ValidatorPubkeyCache.from_affine(anchor, raw, device=dev)
    seed_s = time.time() - t
    twisted = raw[:8].copy()
    twisted[3, 47] ^= 1
    tiny = type("Anchor", (), {"validators": anchor.validators[:8]})()
    try:
        ValidatorPubkeyCache.from_affine(tiny, twisted, device=dev)
    except ValueError:
        pass
    else:
        raise RuntimeError("a seed that does not compress to the state's keys was accepted")
    t = time.time()
    if not torch.equal(cache.device_array(), dev_cache):
        raise RuntimeError("the seeded cache's device tensor != device_pubkeys_from_raw")
    _sync(dev)
    upload_s = time.time() - t
    slot1 = int(block.message.slot)
    clock = ManualSlotClock(slot1)
    t = time.time()
    chain = BeaconChain(spec, anchor, store=HotColdDB(), slot_clock=clock, pubkey_cache=cache)
    _sync(dev)
    out["boot"] = {"seed_s": seed_s, "upload_s": upload_s, "chain_s": time.time() - t}
    if chain.pubkey_cache is not cache or len(cache) != len(anchor.validators):
        raise RuntimeError("the chain did not take the seeded cache")
    if chain.head.root != bytes(block.message.parent_root):
        raise RuntimeError("the anchor's root is not the block's parent")
    lc_rec = out["light_client"] = _lc_timer(chain)
    log(f"chain: booted on the {len(anchor.validators)}-validator anchor at slot "
        f"{int(anchor.slot)}: seeded pubkey cache {seed_s:.2f} s (checked against the state's "
        f"compressed keys; a twisted seed raised), device tensor == phase 2's {upload_s:.2f} s, "
        f"BeaconChain {out['boot']['chain_s']:.2f} s")

    # 2. import the valid block, then its poisoned twin
    fm.reset_counts()
    root1, split1, batches, _ = _timed_import(chain, block, dev)
    runs["chain_import"] = _read_counts("chain import")
    split1["light_client_ms"] = _lc_ms(lc_rec, 0)
    if len(batches) != 1 or batches[0]["ok"] is not True:
        raise RuntimeError(f"chain import: bls batches {batches}")
    if chain.head.root != root1:
        raise RuntimeError("chain import: the head did not move to the block")
    sr = bytes(block.message.state_root)
    if chain.store.get_state(sr) is None or chain.store.state_slot(sr) != slot1:
        raise RuntimeError("chain import: the post-state is not stored under the block's state root")
    t = time.time()
    if chain.state_by_root(root1).tree_root() != sr:
        raise RuntimeError("chain import: the post-state root != the block's state_root")
    check_root_s = time.time() - t
    out["import1"] = split1
    log(f"chain import 1 (slot {slot1}, {split1['sets']} sets, {split1['keys']} keys): "
        f"{json.dumps({k: round(v, 2) if isinstance(v, float) else v for k, v in split1.items()})}; "
        f"head == block, stored post-state root == block state_root (checked by a fresh "
        f"tree_root, {check_root_s:.2f} s); launches {json.dumps(runs['chain_import']['by'])}")
    head0, keys0, fc0 = chain.head.root, sorted(chain.store.hot._data), _fork_choice_view(chain)
    fm.reset_counts()
    t = time.time()
    try:
        chain.process_block(bad)
    except BlockError as e:
        err = str(e)
    else:
        raise RuntimeError("chain: the poisoned block was imported")
    bad_s = time.time() - t
    runs["chain_import_bad"] = _read_counts("chain poisoned import")
    fc1 = _fork_choice_view(chain)
    if (chain.head.root != head0 or sorted(chain.store.hot._data) != keys0 or fc1[:4] != fc0[:4]
            or not all(np.array_equal(a, b) for a, b in zip(fc1[4:], fc0[4:]))):
        raise RuntimeError("chain: the poisoned import changed the head, the store or fork choice")
    log(f"chain poisoned twin: BlockError ({err[:60]}) in {bad_s:.2f} s; head, store keys "
        f"and fork choice unchanged")

    # 3. a second block at the first slot of the next epoch, attesting to the first
    spe = spec.preset.SLOTS_PER_EPOCH
    slot2 = (slot1 // spe + 1) * spe
    clock.set_slot(slot2)
    t = time.time()
    last = chain.get_state_for_block(root1, slot2 - 1)  # the epoch's last slot, kept for the replay
    pre2 = last.copy()
    st.process_slots(spec, pre2, slot2)
    block2, _, attesters = _state_block(spec, pre2, sk0, sync_idx, rng)
    del pre2
    build2_s = time.time() - t
    esnap = epoch_sup.snapshot()
    fm.reset_counts()
    n_lc = len(lc_rec)
    root2, split2, batches2, epochs2 = _timed_import(chain, block2, dev)
    runs["chain_import2"] = _read_counts("chain import across the epoch boundary")
    split2["light_client_ms"] = _lc_ms(lc_rec, n_lc)
    if len(batches2) != 1 or batches2[0]["ok"] is not True:
        raise RuntimeError(f"chain import 2: bls batches {batches2}")
    if len(epochs2) != 1 or epochs2[0][0] is not True:
        raise RuntimeError(f"chain import 2: the epoch boundary was not handled on the device {epochs2}")
    _clean(esnap, epoch_sup.snapshot(), 1, "epoch_device")
    if chain.head.root != root2:
        raise RuntimeError("chain import 2: the head did not move to the second block")
    # block 1's own weight (its subtree's less block 2's, which holds the
    # proposer boost) is its attesters' justified balances, to the Gwei
    fc = chain.fork_choice
    node1, node2 = (fc.proto.nodes[fc.proto.indices[r]] for r in (root1, root2))
    votes = int(node1.weight) - int(node2.weight)
    want = int(fc.store.justified_balances[np.unique(attesters).astype(np.int64)].sum())
    if votes != want or want == 0:
        raise RuntimeError(f"fork choice: block 1's votes weigh {votes}, its attesters {want}")
    esnap = epoch_sup.snapshot()
    prof = _profiled_replay(spec, chain, last, block2)
    del last
    _clean(esnap, epoch_sup.snapshot(), 1, "epoch_device (profiled replay)")
    out.update(import2=split2, build2_s=build2_s, profile2=prof, block1_votes=votes,
               block2_boost=int(node2.weight), block1_attesters=int(np.unique(attesters).size))
    log(f"chain import 2 (slot {slot2}, across the epoch boundary; block built in {build2_s:.1f} s): "
        f"{json.dumps({k: round(v, 2) if isinstance(v, float) else v for k, v in split2.items()})}; "
        f"boundary on the device engine, epoch_device clean; head == block 2; block 1's votes "
        f"{votes} == its {out['block1_attesters']} attesters' justified balances (block 2: "
        f"proposer boost {int(node2.weight)}); "
        f"launches {json.dumps(runs['chain_import2']['by'])}; its last slot, boundary and block "
        f"processing replayed on a copy under the profiler: {prof['wall_ms']:.2f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms, {prof['aten_ops']} aten ops, idle share {prof['idle_share']:.5f}, "
        f"post-state root == block 2's")

    # 4. gossip through the beacon processor into the chain's batch paths
    n_att, bad_pos = 64, 23
    t = time.time()
    atts, aggs, members = _gossip_fixture(spec, chain, sk0, n_att, 4, bad_pos)
    out["gossip_fixture_s"] = time.time() - t
    calls = []
    real_batch = chain._batch_verify_items

    def counting(items):
        calls.append(list(items))
        return real_batch(items)

    chain._batch_verify_items = counting
    proc = BeaconProcessor(BeaconProcessorConfig(max_batch_size=64), synchronous=False)
    proc.shutdown()  # drained inline below
    results, agg_results = [], []
    for a in atts:
        proc.submit(Work(WorkType.GossipAttestation, a,
                         process_batch=lambda xs: results.extend(chain.verify_unaggregated_attestations(xs))))
    bsnap = bls_sup.snapshot()
    fm.reset_counts()
    t = time.perf_counter()
    proc.run_until_idle()
    _sync(dev)
    att_ms = (time.perf_counter() - t) * 1e3
    runs["chain_gossip"] = _read_counts("chain gossip attestations")
    if proc.batches_formed != 1 or len(results) != n_att:
        raise RuntimeError(f"beacon processor: {proc.batches_formed} batches, {len(results)} verdicts")
    rejected = [atts.index(a) for a, v in results if isinstance(v, Exception)]
    if rejected != [bad_pos]:
        raise RuntimeError(f"gossip: rejected {rejected}, poisoned {bad_pos}")
    pos = {v: j for j, v in enumerate(members)}
    order = [pos[it[0][0]] for it in calls[0]]
    n_ref = 1 + _bisect_calls(order, {bad_pos})
    if len(calls) != n_ref:
        raise RuntimeError(f"gossip bisection: {len(calls)} verify calls, the reference makes {n_ref}")
    n_calls_att = len(calls)
    calls.clear()
    for sap in aggs:
        proc.submit(Work(WorkType.GossipAggregate, sap,
                         process_batch=lambda xs: agg_results.extend(chain.verify_aggregated_attestations(xs))))
    fm.reset_counts()
    t = time.perf_counter()
    proc.run_until_idle()
    _sync(dev)
    agg_ms = (time.perf_counter() - t) * 1e3
    runs["chain_aggregates"] = _read_counts("chain gossip aggregates")
    agg_rejected = [aggs.index(a) for a, v in agg_results if isinstance(v, Exception)]
    if agg_rejected != [len(aggs) - 1] or len(agg_results) != len(aggs):
        raise RuntimeError(f"aggregates: rejected {agg_rejected} of {len(agg_results)}")
    chain._batch_verify_items = real_batch
    _clean(bsnap, bls_sup.snapshot(), None, "bls_device")
    out["gossip"] = {"attestations": n_att, "batch_ms": att_ms, "verify_calls": n_calls_att,
                     "reference_calls": n_ref, "verified_att_per_s": (n_att - 1) / (att_ms / 1e3),
                     "aggregates": len(aggs), "aggregate_batch_ms": agg_ms,
                     "aggregate_verify_calls": len(calls)}
    log(f"chain gossip: {n_att} attestations of committee 0 at slot {slot2} through one "
        f"BeaconProcessor batch: exactly the poisoned one ({bad_pos}) rejected; {n_calls_att} "
        f"verify calls (reference bisection: {n_ref}); {att_ms:.2f} ms, "
        f"{out['gossip']['verified_att_per_s']:.2f} verified att/s; {len(aggs)} aggregates, the "
        f"one with another aggregator's selection proof rejected, {agg_ms:.2f} ms, "
        f"{len(calls)} verify calls; bls_device clean")

    # 5. the same valid attestations through the chain's firehose
    valid = [a for i, a in enumerate(atts) if i != bad_pos]
    engine = chain.create_firehose()
    bsnap = bls_sup.snapshot()
    fm.reset_counts()
    t = time.perf_counter()
    for a in valid:
        if not engine.submit(a):
            raise RuntimeError("firehose refused an attestation")
    engine.stop(drain_timeout=120.0)
    fh_s = time.perf_counter() - t
    runs["chain_firehose"] = _read_counts("chain firehose")
    fst = engine.stats()
    if fst.verified != len(valid) or fst.dropped or fst.rejected or fst.errored or fst.device_faults:
        raise RuntimeError(f"chain firehose: {fst.as_dict()}")
    _clean(bsnap, bls_sup.snapshot(), None, "bls_device")
    out["firehose"] = {"verified": fst.verified, "wall_s": fh_s,
                       "verified_att_per_s": fst.verified / fh_s, "batches": fst.batches_formed}
    out["gossip_atts"] = valid  # node C's pool in phase 18
    out["gossip_bad"] = atts[bad_pos]  # phase 23 (c)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out["peak_rss_bytes"] = rss
    log(f"chain firehose: {fst.verified} of {len(valid)} verified, 0 dropped, in {fh_s * 1e3:.2f} ms "
        f"({out['firehose']['verified_att_per_s']:.2f} att/s, {fst.batches_formed} batches); "
        f"bls_device clean, no oracle rung; host peak RSS {rss} bytes")
    out["runs"] = runs
    return out, chain


# --------------------------------------------------------------------------------------
# PeerDAS columns (phase 14)
# --------------------------------------------------------------------------------------


def _cell_rows(ctx, blobs) -> list:
    """Per blob: its coefficient form and the field values of all its cells
    (host FFTs, as ``CellContext.compute_cells_and_kzg_proofs`` computes them)."""
    rows = []
    for blob in blobs:
        coeffs = ctx.blob_to_coeffs(blob)
        rows.append((coeffs, ctx.cells_from_coeffs(coeffs)))
    return rows


def _cell_proofs(ctx, rows, columns, dev=None, ms=None) -> dict:
    """{(blob, column): proof} for ``columns`` only: one
    ``CellContext._cell_proof`` per cell — at mainnet geometry one device MSM
    over 4032 setup points when ``ctx`` runs its MSMs on the device. Each
    proof's wall ms (to the synchronised result) is appended to ``ms``."""
    out = {}
    for b, (coeffs, vals) in enumerate(rows):
        for col in columns:
            t = time.perf_counter()
            out[(b, col)] = ctx._cell_proof(coeffs, col, vals[col])
            if dev is not None:
                _sync(dev)
            if ms is not None:
                ms.append((time.perf_counter() - t) * 1e3)
    return out


def _column_sidecars(ns, signed_block, rows, proofs, columns) -> dict:
    """The sidecars ``make_data_column_sidecars`` builds, for ``columns``
    only ({column: sidecar}): the cells of every blob, the proofs of
    ``_cell_proofs``, the block's signed header and the commitments' inclusion
    proof."""
    from lighthouse_tpu_torch.beacon_chain.data_columns import commitments_list_inclusion_proof
    from lighthouse_tpu_torch.kzg.fr import bls_field_to_bytes
    from lighthouse_tpu_torch.types.containers import BeaconBlockHeader, SignedBeaconBlockHeader

    blk = signed_block.message
    header = SignedBeaconBlockHeader(
        message=BeaconBlockHeader(slot=blk.slot, proposer_index=blk.proposer_index,
                                  parent_root=blk.parent_root, state_root=blk.state_root,
                                  body_root=blk.body.tree_root()),
        signature=signed_block.signature,
    )
    inclusion = commitments_list_inclusion_proof(blk.body)
    commitments = [bytes(c) for c in blk.body.blob_kzg_commitments]
    pad = b"\x00" * (ns.BYTES_PER_CELL - len(rows[0][1][0]) * 32)
    return {
        col: ns.DataColumnSidecar(
            index=col,
            column=[b"".join(bls_field_to_bytes(v) for v in vals[col]) + pad for _, vals in rows],
            kzg_commitments=commitments,
            kzg_proofs=[proofs[(b, col)] for b in range(len(rows))],
            signed_block_header=header,
            kzg_commitments_inclusion_proof=inclusion,
        )
        for col in columns
    }


def _cell_bytes(rows, b: int, col: int) -> bytes:
    from lighthouse_tpu_torch.kzg.fr import bls_field_to_bytes

    return b"".join(bls_field_to_bytes(v) for v in rows[b][1][col])


def _column_claims(kz, columns) -> tuple:
    """(commitments, cell indices, cells, proofs) of every blob's cell in
    ``columns``, column by column: the lists ``verify_cell_proof_batch``
    takes."""
    n = len(kz["blobs"])
    items = [(b, c) for c in columns for b in range(n)]
    return ([kz["commitments"][b] for b, _ in items], [c for _, c in items],
            [_cell_bytes(kz["rows"], b, c) for b, c in items],
            [kz["proofs"][(b, c)] for b, c in items])


def kzg_fixture(seed: int, dev) -> dict:
    """Phase 2's PeerDAS part: the port's mainnet trusted setup, a
    ``CellContext`` at 128 cells of 64 field elements whose MSMs run on the
    device, MAX_BLOBS_PER_BLOCK blobs of 4096 random field elements, their
    commitments and blob proofs (one 4096-lane device MSM each), a node id
    and its custody columns, and the custody columns' cell proofs (one
    4032-lane device MSM each). The sampled columns' proofs wait for the
    block root (phase 14)."""
    import hashlib

    import numpy as np

    from lighthouse_tpu_torch.beacon_chain.data_columns import CUSTODY_REQUIREMENT, custody_columns
    from lighthouse_tpu_torch.kzg import Kzg, load_trusted_setup
    from lighthouse_tpu_torch.kzg.cells import CellContext
    from lighthouse_tpu_torch.kzg.fr import bls_field_to_bytes
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.types.spec import mainnet_spec

    kz = {}
    t = time.time()
    setup = load_trusted_setup()
    kz["setup_s"] = time.time() - t
    kzg = Kzg(setup)
    ctx = CellContext(kzg, 128, msm_backend="device")  # on the bls seam's device
    kz.update(kzg=kzg, ctx=ctx, host_ctx=CellContext(kzg, 128, msm_backend="host"))
    n_blobs = mainnet_spec().preset.MAX_BLOBS_PER_BLOCK
    rng = np.random.default_rng(seed + 14)
    kz["blobs"] = [
        b"".join(bls_field_to_bytes(int.from_bytes(rng.bytes(32), "big") % R)
                 for _ in range(kzg.n))
        for _ in range(n_blobs)
    ]
    kz["commit_ms"], kz["commitments"], kz["blob_proofs"] = [], [], []
    for blob in kz["blobs"]:
        t = time.perf_counter()
        c = kzg.blob_to_kzg_commitment(blob)
        _sync(dev)
        kz["commit_ms"].append((time.perf_counter() - t) * 1e3)
        kz["commitments"].append(c)
        kz["blob_proofs"].append(kzg.compute_blob_kzg_proof(blob, c))
    kz["node_id"] = hashlib.sha256(b"chip_smoke node " + seed.to_bytes(8, "little")).digest()
    kz["custody"] = custody_columns(kz["node_id"], CUSTODY_REQUIREMENT, ctx.cells)
    t = time.time()
    kz["rows"] = _cell_rows(ctx, kz["blobs"])
    kz["cells_s"] = time.time() - t
    kz["proof_ms"] = []
    kz["proofs"] = _cell_proofs(ctx, kz["rows"], kz["custody"], dev, kz["proof_ms"])
    return kz


def kzg_warmup(kz, dev) -> dict:
    """Phase 3's PeerDAS part: the engine's batch tables and its coset-shift
    table built once each (timed; only the single-cell check reads the
    latter), then one column verify (one custody column's cells) and one
    batch at each row count a slot's required cells can pad to (custody
    plus samples: 8 to 12 columns; the custody cells repeated to 8 and 12
    columns' worth: n_pad 64 and 128) through ``verify_cell_proof_batch``.
    Returns each one's launch log, the batches' under "batches" by n_pad."""
    from lighthouse_tpu_torch.beacon_chain.peerdas import SAMPLES_PER_SLOT
    from lighthouse_tpu_torch.kzg import engine as kzg_engine
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    ctx, logs = kz["ctx"], {"batches": {}}
    kzg_engine.set_kzg_backend("device", device=dev)
    eng = kzg_engine.get_engine(ctx)
    fm.reset_counts()
    eng.tables()
    eng.z2_tab  # built here to time it and hold its chains exact in phase 4
    logs["tables"] = dict(fm.launch_log)
    kz.update(table_build_s=eng.table_build_s, z2_build_s=eng.z2_build_s,
              table_bytes=eng.table_bytes())
    fm.reset_counts()
    if not kzg_engine.verify_cell_proof_batch(ctx, *_column_claims(kz, kz["custody"][:1])):
        raise RuntimeError("warm-up: a custody column did not verify")
    logs["kzg_column"] = dict(fm.launch_log)
    claims = _column_claims(kz, kz["custody"])
    n_blobs, n_cust = len(kz["blobs"]), len(kz["custody"])
    for n_cols in (max(n_cust, SAMPLES_PER_SLOT), n_cust + SAMPLES_PER_SLOT):
        n = n_cols * n_blobs
        batch = tuple((x * (n // len(x) + 1))[:n] for x in claims)
        fm.reset_counts()
        if not kzg_engine.verify_cell_proof_batch(ctx, *batch):
            raise RuntimeError(f"warm-up: the {n}-cell batch did not verify")
        logs["batches"][kzg_engine._bucket(n, floor=4)] = dict(fm.launch_log)
    return logs


def _blob_block(spec, chain, secret_key, rng, commitments):
    """A signed electra block one slot after the chain's head carrying the
    blob ``commitments`` (no attestations, an empty sync aggregate with the
    infinity signature), its state root from a dry run without signatures,
    then the proposer's signature (``secret_key(i)`` is validator i's)."""
    import numpy as np

    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.ssz import uint64
    from lighthouse_tpu_torch.state_transition.per_block import (
        _expected_withdrawals_list,
        compute_timestamp_at_slot,
    )
    from lighthouse_tpu_torch.types.containers import SigningData, for_preset
    from lighthouse_tpu_torch.types.helpers import compute_signing_root, get_domain

    def sign(sk, root):
        return oc.g2_compress(cs.sign(sk % R, root))

    ns = for_preset(spec.preset.name)
    slot = int(chain.head.slot) + 1
    state = chain.get_state_for_block(chain.head.root, slot)
    epoch = slot // spec.preset.SLOTS_PER_EPOCH
    proposer = st.get_beacon_proposer_index(spec, state)
    randao_root = SigningData(
        object_root=uint64.hash_tree_root(epoch),
        domain=get_domain(spec, state, spec.DOMAIN_RANDAO, epoch=epoch),
    ).tree_root()
    header = state.latest_execution_payload_header
    payload = ns.payload_types["electra"](
        parent_hash=bytes(header.block_hash), prev_randao=st.get_randao_mix(spec, state, epoch),
        timestamp=compute_timestamp_at_slot(spec, state, slot),
        block_number=int(header.block_number) + 1, block_hash=rng.bytes(32),
        withdrawals=_expected_withdrawals_list(spec, state),
    )
    sync = ns.SyncAggregate(
        sync_committee_bits=np.zeros(spec.preset.SYNC_COMMITTEE_SIZE, dtype=bool),
        sync_committee_signature=b"\xc0" + b"\x00" * 95,
    )
    body = ns.body_types["electra"](
        randao_reveal=sign(secret_key(proposer), randao_root), eth1_data=state.eth1_data,
        sync_aggregate=sync, execution_payload=payload, blob_kzg_commitments=list(commitments),
    )
    block_cls = ns.block_types["electra"]
    block = dict(block_cls.FIELDS)["message"](
        slot=slot, proposer_index=proposer, parent_root=chain.head.root,
        state_root=b"\x00" * 32, body=body,
    )
    domain = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
    st.per_block_processing(spec, state, block_cls(message=block, signature=b"\x00" * 96),
                            strategy=st.BlockSignatureStrategy.NO_VERIFICATION,
                            verify_block_root=False)
    block.state_root = state.tree_root()
    del state
    return block_cls(message=block,
                     signature=sign(secret_key(proposer), compute_signing_root(block, domain)))


def _fr_stage_bound(n_pad: int, k: int):
    """The Fr stage's least time on the card (``batch_scalars`` on n_pad rows
    of k field elements): the limb multiply-adds of its Fr products
    (interpolation n_pad k^2, the descaled weights and their weighted sum
    2 n_pad k, the shift weights n_pad; an Fr value fills 16 16-bit limbs,
    so 16 x 16 per product, a multiply-add counting two) against its bytes
    (cell values, weights, the inverse-NTT matrix, the gathered descale and
    shift rows read once, the setup scalars and shift weights written once,
    32 bytes per Fr value; the int64 indices read once)."""
    n_ops = 2 * 16 * 16 * (n_pad * k * k + 2 * n_pad * k + n_pad)
    n_bytes = 32 * (n_pad * k + n_pad + k * k + n_pad * k + n_pad + k + n_pad) + 8 * n_pad
    return _bound(n_ops, n_bytes)


def kzg_phase(spec, chain, kz, secret_key, dev, rng) -> dict:
    """Phase 14: one slot of blob data on a sampling node — the chain of
    phase 13 with column sampling on (custody 4, 8 samples), a block one
    slot after its head carrying the blobs' commitments; pending, a poisoned
    column rejected, the required columns verified on the card one by one
    until the block is available and imported; all their cells in one
    batch; the blobs' batch proof on the host. Counts are set to 0 before
    each run and read after it (``runs``)."""
    import torch

    from lighthouse_tpu_torch import resilience
    from lighthouse_tpu_torch.beacon_chain.chain import BlockPendingAvailability
    from lighthouse_tpu_torch.beacon_chain.data_columns import (
        DataColumnError,
        verify_data_column_sidecar,
    )
    from lighthouse_tpu_torch.kzg import engine as kzg_engine
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.ops.kzg import verify as kverify
    from lighthouse_tpu_torch.types.containers import for_preset

    ns, ctx, kzg = for_preset(spec.preset.name), kz["ctx"], kz["kzg"]
    out, runs = {}, {}
    kzg_engine.set_kzg_backend("device", device=dev)
    torch.cuda.reset_peak_memory_stats()
    sampler = chain.enable_peerdas(ctx, kz["node_id"])
    if sampler.custody != kz["custody"]:
        raise RuntimeError("the sampler's custody != the fixture's")

    # the block and gate 1: pending
    t = time.time()
    block = _blob_block(spec, chain, secret_key, rng, kz["commitments"])
    out["build_s"] = time.time() - t
    root, slot = block.message.tree_root(), int(block.message.slot)
    chain.slot_clock.set_slot(slot)
    head0, keys0 = chain.head.root, sorted(chain.store.hot._data)
    fm.reset_counts()
    try:
        chain.process_block(block)
    except BlockPendingAvailability as e:
        if e.block_root != root:
            raise RuntimeError("pending: another root") from None
    else:
        raise RuntimeError("the blob block was imported without its columns")
    runs["kzg_pending"] = _read_counts("kzg pending block", need=())
    if fm.launches or chain.head.root != head0 or sorted(chain.store.hot._data) != keys0:
        raise RuntimeError("the pending block launched a kernel or changed the head or store")
    need = sampler.required_columns(root)
    extra = [c for c in need if c not in kz["custody"]]
    t = time.time()
    ms = kz["proof_ms"]
    kz["proofs"].update(_cell_proofs(ctx, kz["rows"], extra, dev, ms))
    sidecars = _column_sidecars(ns, block, kz["rows"], kz["proofs"], need)
    out.update(required=need, sampled=sampler.sample_columns(root), custody=kz["custody"],
               sample_proofs_s=time.time() - t)
    log(f"kzg: block at slot {slot} with {len(kz['commitments'])} blob commitments built in "
        f"{out['build_s']:.1f} s; process_block raised BlockPendingAvailability, head and store "
        f"unchanged, no launch; required columns {need} (custody {kz['custody']}); "
        f"{len(extra) * len(kz['blobs'])} sampled cell proofs on the device in "
        f"{out['sample_proofs_s']:.1f} s")

    sup = resilience.kzg_supervisor()
    snap0 = sup.snapshot()
    # gate 2: a column with another blob's cell swapped in
    src = sidecars[need[0]]
    bad = ns.DataColumnSidecar.decode(ns.DataColumnSidecar.encode(src))
    bad.column[0] = bytes(src.column[1])
    fm.reset_counts()
    try:
        verify_data_column_sidecar(ns, bad, ctx)
    except DataColumnError as e:
        poison_err = str(e)
    else:
        raise RuntimeError("the poisoned column verified")
    runs["kzg_poisoned"] = _read_counts("kzg poisoned column")
    if sampler.verified_columns(root) or chain.data_columns_for(root):
        raise RuntimeError("the poisoned column was marked verified")

    # gates 3 and 4: the honest columns one by one, then the import
    fm.reset_counts()
    col_ms = []
    for i, c in enumerate(need):
        t = time.perf_counter()
        verify_data_column_sidecar(ns, sidecars[c], ctx)
        _sync(dev)
        col_ms.append((time.perf_counter() - t) * 1e3)
        if chain.put_data_column(sidecars[c]) != root:
            raise RuntimeError("put_data_column: another root")
        sampler.on_verified_column(root, c)
        if i < len(need) - 1 and (sampler.is_available(root)
                                  or chain.da_checker.notify_columns(root) is not None):
            raise RuntimeError(f"available after {i + 1} of {len(need)} columns")
    runs["kzg_columns"] = _read_counts("kzg column verifies")
    if not sampler.is_available(root) or sorted(chain.data_columns_for(root)) != need:
        raise RuntimeError("not available after every required column")
    released = chain.da_checker.notify_columns(root)
    if released is None or released[1] != []:
        raise RuntimeError("notify_columns did not release the block")
    fm.reset_counts()
    t = time.time()
    with chain.lock:
        chain._process_block_locked(released[0], released[0].message, root, True,
                                    check_availability=False)
    _sync(dev)
    out["import_s"] = time.time() - t
    runs["kzg_import"] = _read_counts("kzg block import")
    sr = bytes(block.message.state_root)
    if chain.head.root != root or chain.store.get_state(sr) is None:
        raise RuntimeError("the released block did not become head with its state stored")
    if chain.state_by_root(root).tree_root() != sr:
        raise RuntimeError("the imported post-state root != the block's state_root")
    log(f"kzg: poisoned column {need[0]} rejected ({poison_err}), never marked verified; "
        f"{len(need)} columns verified on the card and put into the chain one by one "
        f"({json.dumps([round(x, 2) for x in col_ms])} ms), available only after the last; "
        f"notify_columns released the block, imported in {out['import_s']:.1f} s: head == block, "
        f"stored post-state root == block state_root")

    # gate 5: every required cell in one batch; one column through the host loop
    claims = _column_claims(kz, need)
    n_cells = len(claims[2])
    probe0 = dict(kverify.PROBE)
    batch_ms = []
    fm.reset_counts()
    for _ in range(KZG_BATCH_REPS):
        t = time.perf_counter()
        ok = kzg_engine.verify_cell_proof_batch(ctx, *claims)
        _sync(dev)
        batch_ms.append((time.perf_counter() - t) * 1e3)
        if ok is not True:
            raise RuntimeError(f"the {n_cells}-cell batch did not verify")
    runs["kzg_batch"] = _read_counts("kzg cell batch")
    probe = {k: kverify.PROBE[k] - probe0[k] for k in probe0}
    if probe != {"pairing_checks": KZG_BATCH_REPS, "pairs": 2 * KZG_BATCH_REPS,
                 "scale_scans": KZG_BATCH_REPS}:
        raise RuntimeError(f"PROBE over {KZG_BATCH_REPS} batches: {probe}")
    one = _column_claims(kz, need[-1:])
    t = time.time()
    host_ok = kz["host_ctx"].verify_cell_kzg_proof_batch(*one)
    host_s = time.time() - t
    if host_ok is not True:
        raise RuntimeError("the host CellContext loop rejected an honest column")

    # timed column verifies (the entry a node calls per column)
    probe0 = dict(kverify.PROBE)
    col_ms = []
    fm.reset_counts()
    for _ in range(KZG_COLUMN_REPS):
        t = time.perf_counter()
        verify_data_column_sidecar(ns, sidecars[need[-1]], ctx)
        _sync(dev)
        col_ms.append((time.perf_counter() - t) * 1e3)
    runs["kzg_column"] = _read_counts("kzg timed column verifies")
    probe = {k: kverify.PROBE[k] - probe0[k] for k in probe0}
    if probe != {"pairing_checks": KZG_COLUMN_REPS, "pairs": 2 * KZG_COLUMN_REPS,
                 "scale_scans": KZG_COLUMN_REPS}:
        raise RuntimeError(f"PROBE over {KZG_COLUMN_REPS} column verifies: {probe}")

    # gate 6: the blobs' batch proof on the host
    t = time.time()
    blob_ok = kzg.verify_blob_kzg_proof_batch(kz["blobs"], kz["commitments"], kz["blob_proofs"])
    swapped = [kz["blob_proofs"][1], kz["blob_proofs"][0]] + kz["blob_proofs"][2:]
    blob_bad = kzg.verify_blob_kzg_proof_batch(kz["blobs"], kz["commitments"], swapped)
    blob_s = time.time() - t
    if blob_ok is not True or blob_bad is not False:
        raise RuntimeError(f"verify_blob_kzg_proof_batch: {blob_ok}, swapped {blob_bad}")

    # the profiles: a column verify, the batch, and the batch's Fr stage alone
    eng = kzg_engine.get_engine(ctx)
    deadline = sup.config.deadline_s
    try:
        sup.config.deadline_s = 0  # the rungs on this thread, so the trace holds them
        profs = {
            "column": _profiled(lambda: verify_data_column_sidecar(ns, sidecars[need[-1]], ctx)
                                is None),
            "batch": _profiled(lambda: kzg_engine.verify_cell_proof_batch(ctx, *claims)),
        }
    finally:
        sup.config.deadline_s = deadline
    n_pad = kzg_engine._bucket(n_cells, floor=4)
    arrays = eng.marshal(*claims, n_pad)
    tables = eng.tables()
    kverify.batch_scalars(tables, *arrays[:3])
    profs["fr_stage"] = _profiled(lambda: kverify.batch_scalars(tables, *arrays[:3]) is not None)
    fr_bound_ms, fr_bound_by = _fr_stage_bound(n_pad, ctx.k)
    _clean(snap0, sup.snapshot(), None, "kzg_device")
    peak = torch.cuda.max_memory_allocated()

    col_t, batch_t = _spread(col_ms), _spread(batch_ms)
    prof_out = {}
    for name, (ok, wall, dev_us, ops) in profs.items():
        if ok is not True:
            raise RuntimeError(f"the profiled {name} gave {ok}")
        busy = sum(dev_us.values()) / 1e3
        base = {"column": col_t["median"], "batch": batch_t["median"]}.get(name)
        prof_out[name] = {
            "wall_ms": wall, "busy_ms": busy, "aten_ops": ops,
            "idle_share": (1 - busy / base) if (busy and base) else None,
            "device_ms_by_name": {k[:80]: v / 1e3 for k, v in
                                  sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]},
        }
    per = {
        "column": {k: v / KZG_COLUMN_REPS for k, v in runs["kzg_column"]["by"].items()},
        "batch": {k: v / KZG_BATCH_REPS for k, v in runs["kzg_batch"]["by"].items()},
    }
    out.update(
        cells=n_cells, n_pad=n_pad, column_ms=col_t, batch_ms=batch_t,
        table_build_ms=kz["table_build_s"] * 1e3, z2_build_ms=kz["z2_build_s"] * 1e3,
        table_bytes=kz["table_bytes"],
        proof_msm_ms=_spread(ms), commit_msm_ms=_spread(kz["commit_ms"]),
        setup_load_s=kz["setup_s"], cells_fft_s=kz["cells_s"], host_column_s=host_s,
        blob_batch_s=blob_s, launches_per_verify=per, profiles=prof_out,
        fr_stage={"device_ms": prof_out["fr_stage"]["busy_ms"], "bound_ms": fr_bound_ms,
                  "bound_by": fr_bound_by, "n_pad": n_pad, "k": ctx.k},
        peak_bytes=peak, supervisor=sup.snapshot(), runs=runs,
    )
    log(f"kzg: {n_cells} cells of {len(need)} columns in one verify_cell_proof_batch "
        f"(n_pad {n_pad}) True, {json.dumps(batch_t)} ms over {KZG_BATCH_REPS}; PROBE one "
        f"pairing check, two pairs, one scale ladder per batch; column {need[-1]}'s "
        f"{len(one[2])} cells True through the host CellContext loop too ({host_s:.2f} s)")
    log(f"kzg: column verify (verify_data_column_sidecar, {len(kz['blobs'])} cells, n_pad "
        f"{kzg_engine._bucket(len(kz['blobs']), floor=4)}) "
        f"{json.dumps(col_t)} ms over {KZG_COLUMN_REPS}; launches per verify: column "
        f"{json.dumps(per['column'])}, batch {json.dumps(per['batch'])}; blob batch proof "
        f"(host) True, one proof swapped False ({blob_s:.2f} s); table build "
        f"{out['table_build_ms']:.1f} ms, coset-shift table {out['z2_build_ms']:.1f} ms "
        f"({kz['table_bytes']} B in all); proof MSM ({kzg.n - ctx.k} "
        f"lanes) {json.dumps(out['proof_msm_ms'])} ms over {len(ms)}; commitment MSM ({kzg.n} lanes) "
        f"{json.dumps(out['commit_msm_ms'])} ms; kzg_device clean; peak {peak} B")
    for name, p in prof_out.items():
        log(f"kzg profiled {name}: {p['wall_ms']:.2f} ms wall, device busy {p['busy_ms']:.3f} ms, "
            f"{p['aten_ops']} aten ops, idle share {p['idle_share']}; top "
            f"{json.dumps({k[:50]: round(v, 4) for k, v in p['device_ms_by_name'].items()})}")
    log(f"kzg Fr stage (batch_scalars at n_pad {n_pad}, k {ctx.k}): device "
        f"{out['fr_stage']['device_ms']:.4f} ms, bound {fr_bound_ms:.6f} ms ({fr_bound_by})")
    return out


# --------------------------------------------------------------------------------------
# The network (phase 15)
# --------------------------------------------------------------------------------------


class _Held:
    """A synchronous ``BeaconProcessor`` held: gossip queues (no worker
    drains it) until ``release`` drains it inline in one pass, so a burst
    forms batches as the worker pool would form them."""

    def __init__(self, proc):
        self.proc = proc
        proc.synchronous = False

    def release(self) -> int:
        self.proc.synchronous = True
        return self.proc.run_until_idle()


class _CorruptPeer:
    """A peer at node B's anchor: blocks by root served honestly from node
    A, blocks by range from node A with one block's proposer signature
    swapped for another block's (a valid point over another message)."""

    def __init__(self, node, status, victim: bytes, donor):
        self.node, self.status, self.victim, self.donor = node, status, victim, donor

    def on_rpc(self, method, payload, from_peer):
        if method == "status":
            return self.status
        if method == "blocks_by_root":
            return self.node.blocks_by_root(payload)
        if method == "blocks_by_range":
            out = []
            for b in self.node.blocks_by_range(*payload):
                if b.message.tree_root() == self.victim:
                    b = b.copy()
                    b.signature = bytes(self.donor.signature)
                out.append(b)
            return out
        raise ValueError(method)

    def on_gossip(self, *a):
        pass


def _sync_fixture(spec, chain, sk0: int, n_msg: int, bad_pos: int):
    """SyncCommitteeMessages for the head by the members at positions
    0 .. n_msg - 1 of the current sync committee (sync subnet 0), the one at
    ``bad_pos`` carrying the next member's signature, and one
    SignedContributionAndProof of subnet 0 by the first member over the same
    positions, all signed by the oracle. Returns (messages, contribution)."""
    import numpy as np

    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.types.containers import for_preset
    from lighthouse_tpu_torch.types.helpers import (
        compute_signing_root,
        get_domain,
        sync_committee_signing_root,
    )

    ns = for_preset(spec.preset.name)
    state, root = chain.head.state, chain.head.root
    slot = int(state.slot)
    epoch = slot // spec.preset.SLOTS_PER_EPOCH
    members = [chain.pubkey_cache.get_index(bytes(pk))
               for pk in state.current_sync_committee.pubkeys[:n_msg]]
    h = cs.hash_to_g2(sync_committee_signing_root(spec, state, slot, root))
    sigs = _sign_all(h, [sk0 + v for v in members])
    sigs[bad_pos] = sigs[(bad_pos + 1) % n_msg]
    msgs = [ns.SyncCommitteeMessage(slot=slot, beacon_block_root=root, validator_index=v,
                                    signature=sig) for v, sig in zip(members, sigs)]
    bits = np.zeros(spec.preset.SYNC_COMMITTEE_SIZE // 4, dtype=bool)
    bits[:n_msg] = True
    contribution = ns.SyncCommitteeContribution(
        slot=slot, beacon_block_root=root, subcommittee_index=0, aggregation_bits=bits,
        signature=_sign_all(h, [n_msg * sk0 + sum(members)])[0])
    aggor = members[0]
    sel = compute_signing_root(
        ns.SyncAggregatorSelectionData(slot=slot, subcommittee_index=0),
        get_domain(spec, state, spec.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, epoch=epoch))
    cp = ns.ContributionAndProof(aggregator_index=aggor, contribution=contribution,
                                 selection_proof=_sign_all(cs.hash_to_g2(sel), [sk0 + aggor])[0])
    env = compute_signing_root(cp, get_domain(spec, state, spec.DOMAIN_CONTRIBUTION_AND_PROOF,
                                              epoch=epoch))
    return msgs, ns.SignedContributionAndProof(
        message=cp, signature=_sign_all(cs.hash_to_g2(env), [sk0 + aggor])[0])


def _wait_for(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"network: timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)


def _ensure_proofs(kz, columns, dev) -> None:
    """The cell proofs of ``columns`` not built yet (one device MSM each)."""
    missing = sorted({c for c in columns if (0, c) not in kz["proofs"]})
    if missing:
        kz["proofs"].update(_cell_proofs(kz["ctx"], kz["rows"], missing, dev, kz["proof_ms"]))


def _verdicts(results, items) -> list:
    """Positions in ``items`` of the results that are errors (by root: over
    sockets the results hold decoded copies)."""
    roots = [x.tree_root() for x in items]
    return sorted(roots.index(x.tree_root()) for x, v in results if isinstance(v, Exception))


def network_phase(spec, chain, kz, raw, sk0: int, dev, rng, seed: int, lc_a: list) -> tuple:
    """Phase 15: a second node over the network, on phase 13-14's chain.
    Node A serves that chain; node B boots from a copy of phase 13's
    post-import-2 state (its own seeded pubkey cache, store, PeerDAS custody)
    on one ``LoopbackTransport``; B range-syncs phase 14's blob block and the
    blocks built here (one segment batch, the blob block's columns fetched by
    root and verified), backfills below its anchor (a corrupt peer's segment
    rejected first), takes gossip through ``Router`` and ``BeaconProcessor``
    (a blob block and its columns, attestations, aggregates, sync-committee
    messages and a contribution); then two gossipsub ``SocketTransport``
    endpoints met through a ``BootNode`` carry attestations, a
    BlocksByRange and a DataColumnSidecarsByRoot. Counts are set to 0
    before each run and read after it (``runs``). Both nodes' light-client
    server caches are timed inside every import (``lc_a``: node A's record,
    from phase 13). Returns (measurements, the nodes: A, B, B's chain and
    their bus, for phase 16)."""
    import hashlib
    import random
    import resource

    import torch

    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.beacon_chain import BeaconChain, BlockError, ValidatorPubkeyCache
    from lighthouse_tpu_torch.beacon_chain import data_columns as dcm
    from lighthouse_tpu_torch.beacon_chain.chain import BlockPendingAvailability
    from lighthouse_tpu_torch.beacon_processor import WorkType
    from lighthouse_tpu_torch.kzg import engine as kzg_engine
    from lighthouse_tpu_torch.network import (
        BeaconNodeService,
        BootNode,
        GossipsubTransport,
        LoopbackTransport,
        MessageCodec,
        Topic,
    )
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.store import HotColdDB
    from lighthouse_tpu_torch.types.containers import for_preset
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    ns, ctx = for_preset(spec.preset.name), kz["ctx"]
    out, runs, patches = {"validators": len(chain.head.state.validators)}, {}, _Patches()
    n_lc_a = len(lc_a)
    kzg_engine.set_kzg_backend("device", device=dev)
    bls.set_backend("device", device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def secret_key(i):
        return sk0 + i

    # 1. node A on the chain; the blocks it adds; node B from a checkpoint
    bus = LoopbackTransport()
    a = BeaconNodeService("A", spec, None, bus, chain=chain, device=dev)
    blob_block = chain.get_signed_block(chain.head.root)
    root2 = bytes(blob_block.message.parent_root)
    block2 = chain.get_signed_block(root2)
    root1 = bytes(block2.message.parent_root)
    block1 = chain.get_signed_block(root1)
    t = time.time()
    anchor_b = chain.state_by_root(root2).copy()
    out["anchor_copy_s"] = time.time() - t
    segment = [blob_block]
    fm.reset_counts()
    t = time.time()
    for _ in range(NET_BLOCKS):
        blk = _blob_block(spec, chain, secret_key, rng, [])
        chain.slot_clock.set_slot(int(blk.message.slot))
        if chain.process_block(blk) != blk.message.tree_root() or chain.head.root != blk.message.tree_root():
            raise RuntimeError("network: node A did not import its own block")
        segment.append(blk)
    runs["net_build"] = _read_counts("network: node A's new blocks")
    out["build_s"] = time.time() - t
    t = time.time()
    cache_b = ValidatorPubkeyCache.from_affine(anchor_b, raw, device=dev)
    chain_b = BeaconChain(spec, anchor_b, store=HotColdDB(),
                          slot_clock=ManualSlotClock(int(chain.head.slot)), pubkey_cache=cache_b)
    cache_b.device_array()
    _sync(dev)
    lc_b = _lc_timer(chain_b)
    b = BeaconNodeService("B", spec, None, bus, chain=chain_b, device=dev)
    sampler_b = chain_b.enable_peerdas(ctx, hashlib.sha256(b"chip_smoke node B").digest())
    out["boot_b_s"] = time.time() - t
    del anchor_b
    if chain_b.genesis_block_root != root2:
        raise RuntimeError("network: node B's anchor root != block 2's root")
    blob_root = blob_block.message.tree_root()
    need_b = sampler_b.required_columns(blob_root)
    held_a = chain.data_columns_for(blob_root)
    extra = [c for c in need_b if c not in held_a]
    t = time.time()
    _ensure_proofs(kz, extra, dev)
    for sc in _column_sidecars(ns, blob_block, kz["rows"], kz["proofs"], extra).values():
        chain.put_data_column(sc)
    out["serve_columns_s"] = time.time() - t
    log(f"network: node A on the {out['validators']}-validator chain built and imported "
        f"{NET_BLOCKS} blocks in {out['build_s']:.1f} s; node B booted from a copy of the "
        f"post-import-2 state (copy {out['anchor_copy_s']:.1f} s; seeded pubkey cache, its own "
        f"2^{int(out['validators']).bit_length() - 1}-key device tensor, store and custody "
        f"{sampler_b.custody}) in {out['boot_b_s']:.1f} s; node A holds B's {len(need_b)} required "
        f"columns of the blob block ({len(extra)} built for it in {out['serve_columns_s']:.1f} s)")

    # 2. range sync with column coupling (the corrupt peer known, at B's anchor)
    corrupt = _CorruptPeer(a, b.local_status(), root1, block2)
    bus.register("C", corrupt)
    b.sync.backfill_enabled = False
    b.sync.on_peer_status("C", corrupt.status)
    reqs, col_ms, seg_calls, bls_calls = [], [], [], []
    real_request, real_verify = bus.request, dcm.verify_data_column_sidecar
    real_bls = bls.verify_signature_sets
    real_segment = chain_b.process_chain_segment

    def request(frm, to, method, payload):
        t0 = time.perf_counter()
        res = real_request(frm, to, method, payload)
        reqs.append({"method": method, "ms": (time.perf_counter() - t0) * 1e3,
                     "items": len(res) if isinstance(res, list) else None})
        return res

    def verify_column(ns_, sc, ctx_):
        t0 = time.perf_counter()
        try:
            return real_verify(ns_, sc, ctx_)
        finally:
            _sync(dev)
            col_ms.append((time.perf_counter() - t0) * 1e3)

    def verify_sets(sets, *, device=None):
        sets = list(sets)
        t0 = time.perf_counter()
        prepared = bls.prepare_sets(sets, dev)
        _sync(dev)
        t1 = time.perf_counter()
        ok = bls.verify_prepared_sets(prepared)
        _sync(dev)
        bls_calls.append({"sets": sets, "host_half_ms": (t1 - t0) * 1e3,
                          "device_half_ms": (time.perf_counter() - t1) * 1e3, "ok": ok})
        return ok

    def process_segment(blocks, *a_, **k_):
        t0 = time.perf_counter()
        try:
            res = real_segment(blocks, *a_, **k_)
        except BlockPendingAvailability:
            seg_calls.append(("pending", (time.perf_counter() - t0) * 1e3))
            raise
        seg_calls.append(("imported", (time.perf_counter() - t0) * 1e3))
        return res

    patches.set(bus, "request", request)
    patches.set(dcm, "verify_data_column_sidecar", verify_column)
    patches.set(bls, "verify_signature_sets", verify_sets)
    patches.set(chain_b, "process_chain_segment", process_segment)
    fm.reset_counts()
    t = time.perf_counter()
    try:
        b.connect("A")
        _sync(dev)
    finally:
        patches.undo()
    sync_ms = (time.perf_counter() - t) * 1e3
    runs["net_segment"] = _read_counts("network: range sync")
    if chain_b.head.root != chain.head.root or int(chain_b.head.slot) != int(chain.head.slot):
        raise RuntimeError("network: node B's head != node A's after range sync")
    for blk in segment:
        sr, r = bytes(blk.message.state_root), blk.message.tree_root()
        if chain_b.store.get_state(sr) is None or chain_b.get_signed_block(r) is None:
            raise RuntimeError(f"network: node B lacks block {int(blk.message.slot)} or its post-state")
    t = time.time()
    if chain_b.head.state.tree_root() != bytes(segment[-1].message.state_root):
        raise RuntimeError("network: node B's head post-state root != node A's block state_root")
    head_root_s = time.time() - t
    if b.sync.peer_failures:
        raise RuntimeError(f"network: range sync demoted {b.sync.peer_failures}")
    if [c for c, _ in seg_calls] != ["pending", "imported"]:
        raise RuntimeError(f"network: segment imports {seg_calls}")
    if len(bls_calls) != 1 or bls_calls[0]["ok"] is not True or len(bls_calls[0]["sets"]) != 2 * len(segment):
        raise RuntimeError(f"network: the segment's bls batches {[(len(c['sets']), c['ok']) for c in bls_calls]}")
    fetched = [r for r in reqs if r["method"] == "data_column_sidecars_by_root"]
    if len(fetched) != 1 or sorted(chain_b.data_columns_for(blob_root)) != sorted(need_b):
        raise RuntimeError(f"network: column fetch {fetched}, held {sorted(chain_b.data_columns_for(blob_root))}")
    if not sampler_b.is_available(blob_root) or len(col_ms) != len(need_b):
        raise RuntimeError("network: the blob block's columns were not all verified")
    download = [r for r in reqs if r["method"] == "blocks_by_range"]
    seg_sets = bls_calls[0]["sets"]
    out["range_sync"] = {
        "blocks": len(segment), "sets": len(seg_sets), "total_ms": sync_ms,
        "download_ms": [r["ms"] for r in download], "segment_calls": seg_calls,
        "segment_bls_host_half_ms": bls_calls[0]["host_half_ms"],
        "segment_bls_device_half_ms": bls_calls[0]["device_half_ms"],
        "column_fetch_ms": fetched[0]["ms"], "columns": len(need_b),
        "column_verify_ms": _spread(col_ms), "head_root_check_s": head_root_s,
    }
    log(f"network range sync: node B took {len(segment)} blocks (slots "
        f"{int(segment[0].message.slot)}-{int(segment[-1].message.slot)}) from node A in "
        f"{sync_ms:.1f} ms: download {json.dumps([round(x, 2) for x in out['range_sync']['download_ms']])} "
        f"ms; process_chain_segment parked on availability ({seg_calls[0][1]:.1f} ms), then "
        f"imported ({seg_calls[1][1]:.1f} ms) with one bls batch of {len(seg_sets)} sets (host half "
        f"{bls_calls[0]['host_half_ms']:.2f} ms, device half {bls_calls[0]['device_half_ms']:.2f} ms); "
        f"{len(need_b)} columns fetched by root in {fetched[0]['ms']:.2f} ms, verified on the card "
        f"{json.dumps(out['range_sync']['column_verify_ms'])} ms; heads, stored blocks and "
        f"post-states equal node A's (fresh head state root {head_root_s:.1f} s); no peer demoted; "
        f"launches {json.dumps(runs['net_segment']['by'])}")

    # 3. backfill below the anchor: the corrupt peer's segment first, then node A's
    hist, vcalls = [], []
    real_hist, real_batch = chain_b.import_historical_blocks, chain_b._batch_verify_items

    def import_hist(blocks):
        t0 = time.perf_counter()
        try:
            n = real_hist(blocks)
        except BlockError as e:
            hist.append(("rejected", str(e), (time.perf_counter() - t0) * 1e3))
            raise
        _sync(dev)
        hist.append(("accepted", n, (time.perf_counter() - t0) * 1e3))
        return n

    def counting(items):
        vcalls.append(list(items))
        return real_batch(items)

    patches.set(chain_b, "import_historical_blocks", import_hist)
    patches.set(chain_b, "_batch_verify_items", counting)
    b.sync.backfill_enabled = True
    fm.reset_counts()
    t = time.perf_counter()
    try:
        b.sync.maybe_sync()
        _sync(dev)
    finally:
        patches.undo()
    backfill_ms = (time.perf_counter() - t) * 1e3
    runs["net_historical"] = _read_counts("network: backfill")
    if [h[0] for h in hist] != ["rejected", "accepted"] or "signatures" not in hist[0][1] or hist[1][1] != 1:
        raise RuntimeError(f"network: backfill imports {hist}")
    if b.sync.peer_failures != {"C": 1}:
        raise RuntimeError(f"network: backfill demotions {b.sync.peer_failures}")
    if (chain_b.oldest_block_slot != int(block1.message.slot) or chain_b.get_signed_block(root1) is None
            or chain_b.get_signed_block(root2) is None):
        raise RuntimeError("network: node B did not backfill blocks 1 and 2")
    if len(vcalls) != 2 or [len(c) for c in vcalls] != [1, 1]:
        raise RuntimeError(f"network: backfill verify calls {[len(c) for c in vcalls]}")
    out["backfill"] = {"total_ms": backfill_ms, "rejected_ms": hist[0][2], "accepted_ms": hist[1][2],
                       "oldest_slot": chain_b.oldest_block_slot}
    log(f"network backfill: the anchor block by root, then below it the corrupt peer's segment "
        f"(block 1 with block 2's proposer signature) rejected in {hist[0][2]:.2f} ms and its peer "
        f"demoted; node A's segment accepted in {hist[1][2]:.2f} ms (one indexed batch on the "
        f"card each); oldest slot {chain_b.oldest_block_slot}; {backfill_ms:.1f} ms in all; "
        f"launches {json.dumps(runs['net_historical']['by'])}")

    # 4. gossip through Router -> BeaconProcessor -> chain on node B
    gblock = _blob_block(spec, chain, secret_key, rng, kz["commitments"])
    groot, gslot = gblock.message.tree_root(), int(gblock.message.slot)
    for c in (chain, chain_b):
        c.slot_clock.set_slot(gslot)
    need_g = sampler_b.required_columns(groot)
    t = time.time()
    _ensure_proofs(kz, need_g, dev)
    gsidecars = _column_sidecars(ns, gblock, kz["rows"], kz["proofs"], need_g)
    out["gossip_columns_build_s"] = time.time() - t
    head0 = chain_b.head.root
    fm.reset_counts()
    a.publish_block(gblock)
    runs["net_gossip_block"] = _read_counts("network: gossip blob block", need=())
    if fm.launches or chain_b.head.root != head0:
        raise RuntimeError("network: the pending gossip block launched a kernel or moved the head")
    bad = ns.DataColumnSidecar.decode(ns.DataColumnSidecar.encode(gsidecars[need_g[0]]))
    bad.column[0] = bytes(gsidecars[need_g[0]].column[1])
    fm.reset_counts()
    a.publish_data_column(bad)
    if sampler_b.verified_columns(groot) or chain_b.data_columns_for(groot):
        raise RuntimeError("network: the column with a swapped cell was kept")
    gcol_ms = []
    for i, c in enumerate(need_g):
        t0 = time.perf_counter()
        a.publish_data_column(gsidecars[c])
        _sync(dev)
        gcol_ms.append((time.perf_counter() - t0) * 1e3)
        if (chain_b.head.root == groot) != (i == len(need_g) - 1):
            raise RuntimeError(f"network: head after {i + 1} of {len(need_g)} gossip columns")
    runs["net_columns"] = _read_counts("network: gossip columns")
    if chain_b.store.get_state(bytes(gblock.message.state_root)) is None:
        raise RuntimeError("network: the gossip block's post-state is not stored")
    out["gossip_block"] = {"columns": len(need_g), "column_ms": gcol_ms}
    log(f"network gossip: blob block at slot {gslot} pending on node B with no launch; a column "
        f"with a swapped cell dropped; {len(need_g)} required columns over {Topic.DATA_COLUMN_SIDECAR}, "
        f"the head moved with the last ({json.dumps([round(x, 1) for x in gcol_ms])} ms each, the "
        f"last one with the import); launches {json.dumps(runs['net_columns']['by'])}")

    state_b = chain_b.head.state
    target = st.get_block_root(spec, state_b, st.get_current_epoch(spec, state_b))
    n_att, bad_pos, bad_sync = 64, 23, 41
    t = time.time()
    atts, aggs, members = _gossip_fixture(spec, chain_b, sk0, n_att, 4, bad_pos, target_root=target)
    msgs, contribution = _sync_fixture(spec, chain_b, sk0, 64, bad_sync)
    out["gossip_fixture_s"] = time.time() - t
    results, agg_results, sync_results, contrib_results, vcalls = [], [], [], [], []

    def recording(name, sink):
        real = getattr(chain_b, name)

        def run(xs):
            res = real(xs)
            sink.extend(res)
            return res
        patches.set(chain_b, name, run)

    recording("verify_unaggregated_attestations", results)
    recording("verify_aggregated_attestations", agg_results)
    recording("verify_sync_committee_messages", sync_results)
    recording("verify_sync_contributions", contrib_results)
    patches.set(chain_b, "_batch_verify_items", counting)
    gossip = {}
    try:
        # attestations and aggregates batch in the processor (held, then
        # drained as a worker would); sync-committee messages run as each
        # arrives, as the reference's processor runs them: a batch holding
        # the poisoned one falls back to one call a message anyway
        for name, publish, items in (("attestations", a.publish_attestation, atts),
                                     ("aggregates", a.publish_aggregate, aggs),
                                     ("sync_messages", a.publish_sync_message, msgs)):
            vcalls.clear()
            held = _Held(b.processor) if name != "sync_messages" else None
            fm.reset_counts()
            t0 = time.perf_counter()
            for x in items:
                publish(x)
            if held is not None:
                held.release()
            _sync(dev)
            gossip[name] = {"ms": (time.perf_counter() - t0) * 1e3, "verify_calls": len(vcalls),
                            "sizes": sorted({len(c) for c in vcalls})}
            if name == "sync_messages":
                a.publish_contribution(contribution)
                _sync(dev)
            runs[{"attestations": "net_gossip", "aggregates": "net_aggregates",
                  "sync_messages": "net_sync"}[name]] = _read_counts(f"network: gossip {name}")
            if name == "attestations":
                pos = {v: j for j, v in enumerate(members)}
                order = [pos[it[0][0]] for it in vcalls[0]]
                gossip[name]["reference_calls"] = 1 + _bisect_calls(order, {bad_pos})
    finally:
        patches.undo()
    if _verdicts(results, atts) != [bad_pos] or len(results) != n_att:
        raise RuntimeError(f"network gossip: attestations rejected {_verdicts(results, atts)}")
    if gossip["attestations"]["verify_calls"] != gossip["attestations"]["reference_calls"]:
        raise RuntimeError(f"network gossip: {gossip['attestations']} verify calls, not the "
                           f"reference bisection's")
    if _verdicts(agg_results, aggs) != [len(aggs) - 1] or len(agg_results) != len(aggs):
        raise RuntimeError(f"network gossip: aggregates rejected {_verdicts(agg_results, aggs)}")
    if _verdicts(sync_results, msgs) != [bad_sync] or len(sync_results) != len(msgs):
        raise RuntimeError(f"network gossip: sync messages rejected {_verdicts(sync_results, msgs)}")
    if gossip["sync_messages"]["verify_calls"] != len(msgs) + 1:
        raise RuntimeError(f"network gossip: {gossip['sync_messages']['verify_calls']} sync verify "
                           f"calls; one per message and the poisoned one's fallback make "
                           f"{len(msgs) + 1}")
    if len(contrib_results) != 1 or contrib_results[0][1] is not True:
        raise RuntimeError(f"network gossip: contribution verdict {contrib_results}")
    proc = b.processor
    drops = {"dropped": {t.name: n for t, n in proc.dropped.items() if n},
             "expired": {t.name: n for t, n in proc.expired.items() if n}}
    gossip["attestations"]["verified_att_per_s"] = (n_att - 1) / (gossip["attestations"]["ms"] / 1e3)
    out["gossip"] = {**gossip, "fixture_s": out["gossip_fixture_s"], "processor": drops}
    log(f"network gossip: {n_att} attestations of one head committee published by node A, one "
        f"BeaconProcessor batch on node B: exactly the poisoned one ({bad_pos}) rejected, "
        f"{gossip['attestations']['verify_calls']} verify calls (reference bisection "
        f"{gossip['attestations']['reference_calls']}), {gossip['attestations']['ms']:.1f} ms, "
        f"{gossip['attestations']['verified_att_per_s']:.2f} att/s; {len(aggs)} aggregates, the "
        f"bad one rejected ({gossip['aggregates']['ms']:.1f} ms); {len(msgs)} sync-committee "
        f"messages of subnet 0, exactly the poisoned one ({bad_sync}) rejected, "
        f"{gossip['sync_messages']['verify_calls']} verify calls (one per message, the poisoned one "
        f"again alone), {gossip['sync_messages']['ms']:.1f} ms; the contribution verified; processor "
        f"drops {json.dumps(drops)}")
    if drops["expired"]:
        log(f"network gossip finding: work expired before dispatch {json.dumps(drops['expired'])}")

    # 5. sockets: two gossipsub endpoints met through a boot node
    boot = BootNode().start()
    ta = GossipsubTransport(spec, rng=random.Random(seed))
    tb = GossipsubTransport(spec, rng=random.Random(seed + 1))
    sa = BeaconNodeService(ta.local_addr, spec, None, ta, chain=chain, device=dev)
    sb = BeaconNodeService(tb.local_addr, spec, None, tb, chain=chain_b, device=dev)
    try:
        ta.discover(boot.local_addr)
        found = tb.discover(boot.local_addr)
        if found != [ta.local_addr]:
            raise RuntimeError(f"network sockets: the boot node returned {found}")
        _wait_for(lambda: ta.local_addr in tb.peers() and tb.local_addr in ta.peers(), 10.0, "peers")
        _wait_for(lambda: ta._topic_peers(Topic.BEACON_ATTESTATION), 10.0, "subscriptions")
        # the next 64 members of the same committee: the wire carries the
        # pre-electra Attestation container (the codec's, as the reference's),
        # so committee 0 is the one its data.index names
        satts, _, smembers = _gossip_fixture(spec, chain_b, sk0, n_att, 0, bad_pos, offset=n_att,
                                             target_root=target)
        sresults, vcalls = [], []
        recording("verify_unaggregated_attestations", sresults)
        patches.set(chain_b, "_batch_verify_items", counting)
        try:
            held = _Held(sb.processor)
            fm.reset_counts()
            t0 = time.perf_counter()
            for x in satts:
                sa.publish_attestation(x)
            # the router queues gossip unvalidated: at small size all 64 queue in well
            # under 10 s on both packages' nodes, after a one-block range sync as after
            # two (tests/test_torch_socket_network.py). A run that missed this wait (once,
            # with NET_BLOCKS = 1) met the host's load at 2^20, not a network fault
            _wait_for(lambda: sb.processor.queue_len(WorkType.GossipAttestation) == n_att, 60.0,
                      "the socket gossip")
            t1 = time.perf_counter()
            held.release()
            _sync(dev)
            sock_ms = (time.perf_counter() - t0) * 1e3
            wire_ms = (t1 - t0) * 1e3
            runs["net_socket"] = _read_counts("network: socket gossip")
        finally:
            patches.undo()
        wire = [ns.Attestation.decode(ns.Attestation.encode(x)) for x in satts]
        if _verdicts(sresults, wire) != [bad_pos] or len(sresults) != n_att:
            raise RuntimeError(f"network sockets: attestations rejected {_verdicts(sresults, wire)}")
        pos = {v: j for j, v in enumerate(smembers)}
        sref = 1 + _bisect_calls([pos[it[0][0]] for it in vcalls[0]], {bad_pos})
        if len(vcalls) != sref:
            raise RuntimeError(f"network sockets: {len(vcalls)} verify calls, the reference makes {sref}")
        t0 = time.perf_counter()
        got = tb.request(sb.node_id, ta.local_addr, "blocks_by_range",
                         (int(segment[0].message.slot), len(segment)))
        bbr_ms = (time.perf_counter() - t0) * 1e3
        if [x.message.tree_root() for x in got] != [x.message.tree_root() for x in segment]:
            raise RuntimeError("network sockets: BlocksByRange roots != the segment's")
        ids = [(blob_root, c) for c in need_b]
        t0 = time.perf_counter()
        cols = tb.request(sb.node_id, ta.local_addr, "data_column_sidecars_by_root", ids)
        dcr_ms = (time.perf_counter() - t0) * 1e3
        want = chain.data_columns_for(blob_root)
        if [x.tree_root() for x in cols] != [want[c].tree_root() for c in need_b]:
            raise RuntimeError("network sockets: DataColumnSidecarsByRoot roots != node A's columns")
    finally:
        sb.stop()
        sa.stop()
        boot.stop()
    codec = MessageCodec(spec)
    enc = {}
    for label, topic, obj in (("block", Topic.BEACON_BLOCK, block1),
                              ("column", Topic.DATA_COLUMN_SIDECAR, gsidecars[need_g[0]])):
        e_ms, d_ms = [], []
        for _ in range(NET_CODEC_REPS):
            t0 = time.perf_counter()
            data = codec.encode_gossip(topic, obj)
            t1 = time.perf_counter()
            back = codec.decode_gossip(topic, data)
            d_ms.append((time.perf_counter() - t1) * 1e3)
            e_ms.append((t1 - t0) * 1e3)
        if back.tree_root() != obj.tree_root():
            raise RuntimeError(f"network codec: the decoded {label} != the encoded one")
        enc[label] = {"bytes": len(data), "encode_ms": _spread(e_ms), "decode_ms": _spread(d_ms)}
    out["sockets"] = {"attestations_ms": sock_ms, "wire_ms": wire_ms, "verify_calls": len(vcalls),
                      "reference_calls": sref,
                      "verified_att_per_s": (n_att - 1) / (sock_ms / 1e3),
                      "blocks_by_range_ms": bbr_ms, "columns_by_root_ms": dcr_ms, "codec": enc}
    log(f"network sockets: two gossipsub SocketTransports on 127.0.0.1 met through a BootNode; "
        f"{n_att} more attestations of the committee (members {n_att}-{2 * n_att - 1}) over the mesh as "
        f"the wire's pre-electra container: exactly the poisoned one rejected, "
        f"{len(vcalls)} verify calls (reference {sref}), {sock_ms:.1f} ms "
        f"({out['sockets']['verified_att_per_s']:.2f} att/s; published to all queued on node B "
        f"{wire_ms:.1f} ms, the batch after it {sock_ms - wire_ms:.1f} ms); BlocksByRange of the "
        f"{len(segment)}-block segment {bbr_ms:.1f} ms and DataColumnSidecarsByRoot of "
        f"{len(need_b)} columns {dcr_ms:.1f} ms, decoded roots == the sent ones; codec "
        f"{json.dumps(enc)}")

    # 6. the segment batch under the profiler; memory
    ok, wall, dev_us, ops = _profiled(lambda: bls.verify_signature_sets(seg_sets, device=dev))
    if ok is not True:
        raise RuntimeError("network: the profiled segment batch did not verify")
    busy = sum(dev_us.values()) / 1e3
    out["segment_profile"] = {"wall_ms": wall, "busy_ms": busy, "aten_ops": ops,
                              "idle_share": 1 - busy / wall if busy else None}
    out["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    log(f"network profiled segment batch ({len(seg_sets)} sets): {wall:.2f} ms wall, device busy "
        f"{busy:.3f} ms, {ops} aten ops, idle share {out['segment_profile']['idle_share']}; host peak "
        f"RSS {out['peak_rss_bytes']} bytes (two chains), peak device bytes {out['peak_device_bytes']}")
    out["light_client"] = {"A": lc_a[n_lc_a:], "B": lc_b, "A_ms": _lc_ms(lc_a, n_lc_a),
                           "B_ms": _lc_ms(lc_b, 0)}
    log(f"network light-client server caches inside the phase's imports: node A "
        f"{json.dumps([[r[0], round(r[1], 3)] for r in lc_a[n_lc_a:]])} (slot, ms), node B "
        f"{json.dumps([[r[0], round(r[1], 3)] for r in lc_b])}")
    out["runs"] = runs
    return out, {"a": a, "b": b, "bus": bus, "chain_b": chain_b}


# --------------------------------------------------------------------------------------
# The light client (phase 16)
# --------------------------------------------------------------------------------------


def _lc_sessions(spec, committees, gvr: bytes, sk0: int, n: int, rng, slot0: int) -> list:
    """``n`` optimistic-update sessions alternating over ``committees``
    ((SyncCommittee, validator indices) pairs): ~75% random bitfields,
    distinct attested slots from ``slot0`` on, random header roots, each
    signed by the oracle with the sum of its participants' secret keys
    (validator i's is sk0 + i), as the reference's ``fabricate_lc_sessions``
    signs them. Returns (update, committee) pairs."""
    import numpy as np

    from lighthouse_tpu_torch.light_client.types import light_client_types
    from lighthouse_tpu_torch.light_client.verify import sync_signing_root
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.types.containers import BeaconBlockHeader, for_preset

    ns = for_preset(spec.preset.name)
    lc = light_client_types(spec.preset.name, spec.fork_name_at_slot(slot0))
    floor = max(1, int(spec.preset.MIN_SYNC_COMMITTEE_PARTICIPANTS))
    out = []
    for i in range(n):
        committee, idx = committees[i % len(committees)]
        idx = np.asarray(idx, dtype=np.int64)
        bits = rng.random(idx.size) < 0.75
        while bits.sum() < floor:
            bits[rng.integers(0, idx.size)] = True
        update = lc.LightClientOptimisticUpdate(
            attested_header=lc.LightClientHeader(beacon=BeaconBlockHeader(
                slot=slot0 + i, proposer_index=int(rng.integers(0, 1 << 20)),
                parent_root=rng.bytes(32), state_root=rng.bytes(32), body_root=rng.bytes(32))),
            sync_aggregate=ns.SyncAggregate(sync_committee_bits=bits,
                                            sync_committee_signature=b"\x00" * 96),
            signature_slot=slot0 + i + 1)
        sk = (int(bits.sum()) * sk0 + int(idx[bits].sum())) % R
        update.sync_aggregate.sync_committee_signature = oc.g2_compress(
            cs.sign(sk, sync_signing_root(spec, update, gvr)))
        out.append((update, committee))
    return out


def _lc_tampered(session, mode: str):
    """A copy of ``session`` with one bit of its signature's x flipped
    ("signature"), its header's state root changed ("header": the signature
    no longer covers it) or its signature's compression bit cleared
    ("malformed")."""
    update, committee = session
    u = type(update).decode(update.serialize())
    sig = bytearray(bytes(u.sync_aggregate.sync_committee_signature))
    if mode == "signature":
        sig[50] ^= 0x01
    elif mode == "malformed":
        sig[0] &= 0x7F
    else:
        u.attested_header.beacon.state_root = b"\xfe" * 32
    u.sync_aggregate.sync_committee_signature = bytes(sig)
    return u, committee


def _lc_roots(x):
    """Tree roots of a light-client response (None stays None)."""
    if x is None:
        return None
    if isinstance(x, list):
        return [u.tree_root() for u in x]
    return x.tree_root()


def lc_warmup(spec, raw, sk0: int, dev, seed: int) -> dict:
    """Phase 3's light-client paths at phase 16's shapes: two committees of
    512 registry validators (random ones: the kernels' shapes depend only on
    the batch and committee sizes) and LC_SESSIONS sessions over them
    through the engine phase 16 uses; one batch of all of them (path
    ``lc_batch``) and one of LC_MIXED (path ``lc_serve``: the updates from
    the wire and the mixed batch's bisection all pad to 4 rows). Returns
    their launch logs and times."""
    import numpy as np

    from lighthouse_tpu_torch.light_client import engine as lce
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.types.containers import for_preset

    rng = np.random.default_rng(seed + 16)
    ns, n = for_preset(spec.preset.name), raw.shape[0]
    t = time.time()
    committees = []
    for _ in range(2):
        idx = rng.choice(n, size=spec.preset.SYNC_COMMITTEE_SIZE, replace=False)
        committees.append((_sync_committee(ns, raw, None, idx), idx))
    gvr = rng.bytes(32)
    sessions = _lc_sessions(spec, committees, gvr, sk0, LC_SESSIONS, rng,
                            STATE_EPOCH * spec.preset.SLOTS_PER_EPOCH)
    out = {"fixture_s": time.time() - t, "logs": {}}
    eng = lce.get_engine(spec, dev)
    t = time.time()
    for c, _ in committees:
        eng.committee_row(c)
    out["rows_s"] = time.time() - t
    t = time.time()
    for path, batch in (("lc_batch", sessions), ("lc_serve", sessions[:LC_MIXED])):
        fm.reset_counts()
        if not eng.verify_batch(batch, gvr):
            raise RuntimeError(f"warm-up of the light-client path {path} did not verify")
        out["logs"][path] = dict(fm.launch_log)
    _sync(dev)
    out["verify_s"] = time.time() - t
    return out


def lc_phase(spec, chain, net, sk0: int, dev, rng, seed: int) -> dict:
    """Phase 16: a light client of the port's node and the mass-service
    batch, on phases 13-15's chain (node A, its ``LightClientServerCache``
    live since phase 13) and node B. (a) what A's server holds; (b) B
    requests the four light-client methods from A over the loopback (each
    message through the codec) and over a gossipsub socket pair, checks
    the bootstrap and verifies the updates through ``verify_update_batch``
    on the card (path ``lc_serve``); (c) LC_SESSIONS sessions over the
    state's current and next sync committees in one dispatch, timed
    (``lc_batch``), a tampered one, a mixed subset against the host loop,
    the ``lc_device`` ladder with both device rungs faulted, one batch
    under the profiler. Counts are set to 0 before each run on the card and
    read after it (``runs``)."""
    import random

    from lighthouse_tpu_torch import bls, resilience
    from lighthouse_tpu_torch.bls.backend import bucket
    from lighthouse_tpu_torch.light_client import engine as lce
    from lighthouse_tpu_torch.light_client.verify import verify_bootstrap
    from lighthouse_tpu_torch.network import BeaconNodeService, BootNode, GossipsubTransport, MessageCodec
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.ops.lc import verify as lcv
    from lighthouse_tpu_torch.resilience.inject import injector
    from lighthouse_tpu_torch.resilience.supervisor import SupervisorConfig

    out, runs = {}, {}
    server = chain.light_client_cache
    gvr = bytes(chain.head.state.genesis_validators_root)
    lce.set_lc_backend("device", device=dev)
    eng = lce.get_engine(spec)

    # (a) the server: what the imports of phases 13-15 left in it
    opt = server.latest_optimistic
    if opt is None:
        raise RuntimeError("light client: node A's server holds no optimistic update")
    att_root = opt.attested_header.beacon.tree_root()
    att_state = chain.state_by_root(att_root)
    fin_held = chain.get_signed_block(bytes(att_state.finalized_checkpoint.root)) is not None
    if fin_held and server.latest_finality is None:
        raise RuntimeError("light client: the attested state's finalized block is held, no finality update")
    periods = server.update_store.known_periods()
    if not periods:
        raise RuntimeError("light client: node A's update store holds no period")
    out["server"] = {"optimistic_signature_slot": int(opt.signature_slot),
                     "attested_slot": int(opt.attested_header.beacon.slot),
                     "finalized_block_held": fin_held, "finality": server.latest_finality is not None,
                     "periods": periods}
    log(f"light client server (node A): latest optimistic update signed at slot "
        f"{int(opt.signature_slot)} over the block at slot {int(opt.attested_header.beacon.slot)}; "
        f"the attested state's finalized block {'held: a finality update' if fin_held else 'not held (the anchor state finalizes a block the chain never imported): no finality update'}; "
        f"update store periods {periods}")

    # (b) a light client over the wire
    requests = [("light_client_bootstrap", att_root),
                ("light_client_updates_by_range", (periods[0], periods[-1] - periods[0] + 1)),
                ("light_client_optimistic_update", None), ("light_client_finality_update", None)]
    codec, bus = MessageCodec(spec), net["bus"]
    want, wire, got_loop, got_sock = {}, {}, {}, {}
    for method, payload in requests:
        t0 = time.perf_counter()
        req = codec.decode_request(method, codec.encode_request(method, payload))
        want[method] = bus.request("B", "A", method, req)  # node A's own answer
        data = codec.encode_response(method, want[method])
        got_loop[method] = codec.decode_response(method, data)
        wire[method] = {"loopback_ms": (time.perf_counter() - t0) * 1e3, "bytes": len(data)}
    boot_node = BootNode().start()
    ta = GossipsubTransport(spec, rng=random.Random(seed + 16))
    tb = GossipsubTransport(spec, rng=random.Random(seed + 17))
    sa = BeaconNodeService(ta.local_addr, spec, None, ta, chain=chain, device=dev)
    sb = BeaconNodeService(tb.local_addr, spec, None, tb, chain=net["chain_b"], device=dev)
    try:
        ta.discover(boot_node.local_addr)
        if tb.discover(boot_node.local_addr) != [ta.local_addr]:
            raise RuntimeError("light client: the boot node did not return node A")
        _wait_for(lambda: ta.local_addr in tb.peers() and tb.local_addr in ta.peers(), 10.0, "peers")
        for method, payload in requests:
            t0 = time.perf_counter()
            got_sock[method] = tb.request(sb.node_id, ta.local_addr, method, payload)
            wire[method]["socket_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        sb.stop()
        sa.stop()
        boot_node.stop()
    for method, _ in requests:
        w = _lc_roots(want[method])
        if _lc_roots(got_loop[method]) != w or _lc_roots(got_sock[method]) != w:
            raise RuntimeError(f"light client: {method} decoded roots != node A's")
    boot = got_sock["light_client_bootstrap"]
    if boot is None or not verify_bootstrap(spec, boot, att_root):
        raise RuntimeError("light client: the bootstrap from node A did not verify")
    flipped = type(boot).decode(boot.serialize())
    branch = [bytes(x) for x in flipped.current_sync_committee_branch]
    branch[3] = bytes([branch[3][0] ^ 1]) + branch[3][1:]
    flipped.current_sync_committee_branch = branch
    if verify_bootstrap(spec, flipped, att_root):
        raise RuntimeError("light client: a bootstrap with a flipped branch node verified")
    committee = boot.current_sync_committee
    serve = [(got_sock["light_client_optimistic_update"], committee)]
    serve += [(u, committee) for u in got_sock["light_client_updates_by_range"]]
    if got_sock["light_client_finality_update"] is not None:
        serve.append((got_sock["light_client_finality_update"], committee))
    t = time.time()
    eng.committee_row(committee)  # decompressed once (bls.PublicKey: subgroup checks)
    serve_row_s = time.time() - t
    fm.reset_counts()
    t0 = time.perf_counter()
    verdicts = lce.verify_update_batch(spec, serve, gvr)
    _sync(dev)
    serve_ms = (time.perf_counter() - t0) * 1e3
    runs["lc_serve"] = _read_counts("light client: the updates from the wire")
    if verdicts != [True] * len(serve):
        raise RuntimeError(f"light client: the served updates' verdicts {verdicts}")
    out["wire"] = {"methods": wire, "sessions": len(serve),
                   "committee_row_s": serve_row_s, "verify_ms": serve_ms}
    log(f"light client over the wire: node B requested the four methods from node A over the "
        f"loopback (through the codec) and a gossipsub socket pair: "
        f"{json.dumps({m.split('light_client_')[1]: {k: round(v, 2) for k, v in w.items()} for m, w in wire.items()})}"
        f" (ms, bytes); decoded roots == node A's; the bootstrap verifies, with one branch node "
        f"flipped it does not; {len(serve)} updates verified through verify_update_batch on the card "
        f"in {serve_ms:.2f} ms (the committee's row decompressed first, {serve_row_s:.2f} s); launches "
        f"{json.dumps(runs['lc_serve']['by'])}")

    # (c) the mass-service batch: LC_SESSIONS sessions over two committees
    state = chain.head.state
    committees = [(c, [chain.pubkey_cache.get_index(bytes(pk)) for pk in c.pubkeys])
                  for c in (state.current_sync_committee, state.next_sync_committee)]
    t = time.time()
    sessions = _lc_sessions(spec, committees, gvr, sk0, LC_SESSIONS, rng, int(state.slot) + 1)
    fixture_s = time.time() - t
    t = time.time()
    rows = {eng.committee_row(c) for c, _ in committees}
    rows_s = time.time() - t
    if len(rows) != 2:
        raise RuntimeError(f"light client: the two committees share a cache row ({rows})")
    n_pad = bucket(LC_SESSIONS)
    probe0 = dict(lcv.PROBE)
    host_ms, batch_ms = [], []
    fm.reset_counts()
    for _ in range(LC_REPS):
        t0 = time.perf_counter()
        b_ = eng.marshal(sessions, gvr, n_pad)
        _sync(dev)
        t1 = time.perf_counter()
        ok = bool(eng.run(b_))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        host_ms.append((t1 - t0) * 1e3)
        if not ok:
            raise RuntimeError("light client: the honest batch did not verify")
    runs["lc_batch"] = _read_counts("light client: the mass-service batch")
    probe = {k: lcv.PROBE[k] - probe0[k] for k in probe0}
    if probe != {"pairing_checks": LC_REPS, "pairs": LC_REPS * (n_pad + 1), "agg_sums": LC_REPS}:
        raise RuntimeError(f"light client: PROBE over {LC_REPS} batches {probe}")
    bad = list(sessions)
    bad[5] = _lc_tampered(sessions[5], "signature")
    fm.reset_counts()
    if eng.verify_batch(bad, gvr):
        raise RuntimeError("light client: the batch with a tampered signature verified")
    runs["lc_tampered"] = _read_counts("light client: the tampered batch")
    mixed = [_lc_tampered(sessions[0], "signature"), sessions[1], _lc_tampered(sessions[2], "header"),
             _lc_tampered(sessions[3], "malformed")]
    fm.reset_counts()
    dev_v = lce.verify_update_batch(spec, mixed, gvr)
    runs["lc_mixed"] = _read_counts("light client: the mixed batch")
    try:
        bls.set_backend("oracle")
        lce.set_lc_backend("host")
        t = time.time()
        host_v = lce.verify_update_batch(spec, mixed, gvr)
        host_s = time.time() - t
    finally:
        bls.set_backend("device", device=dev)
        lce.set_lc_backend("device", device=dev)
    if dev_v != host_v or host_v != [False, True, False, False]:
        raise RuntimeError(f"light client: mixed verdicts device {dev_v}, host loop {host_v}")
    # both device rungs faulted: every session unverified, no host rung (one
    # retry, millisecond backoff: the verdict, not the backoff, is checked)
    sup, patches, host_calls = resilience.lc_supervisor(), _Patches(), []
    saved_config = sup.config
    sup.config = SupervisorConfig(max_retries=1, backoff_base_s=0.001, backoff_max_s=0.005)
    real_host = lce.verify_light_client_update
    patches.set(lce, "verify_light_client_update",
                lambda *a, **k: host_calls.append(1) or real_host(*a, **k))
    injector.install("stage=lc.batch_verify;mode=raise;every=1|"
                     "stage=lc.batch_verify/device_reduced;mode=raise;every=1")
    try:
        closed = lce.verify_update_batch(spec, sessions[:LC_MIXED], gvr)
        snap = sup.snapshot()
    finally:
        injector.clear()
        patches.undo()
        sup.config = saved_config
        sup.reset()
    if closed != [False] * LC_MIXED or host_calls or not snap["exhausted"]:
        raise RuntimeError(f"light client: faulted ladder gave {closed}, host calls {len(host_calls)}, "
                           f"supervisor {snap}")
    prof_ok, prof_ms, dev_us, ops = _profiled(lambda: eng.verify_batch(sessions, gvr))
    if prof_ok is not True:
        raise RuntimeError("light client: the profiled batch did not verify")
    busy = sum(dev_us.values()) / 1e3
    spread = _spread(batch_ms)
    out["batch"] = {
        "sessions": LC_SESSIONS, "n_pad": n_pad, "committee_size": len(committees[0][1]),
        "cache_rows": sorted(rows), "fixture_s": fixture_s, "committee_rows_s": rows_s,
        "batch_ms": spread, "host_half_ms": _spread(host_ms),
        "sessions_per_s": LC_SESSIONS / (spread["median"] / 1e3),
        "launches_per_batch": {k: v / LC_REPS for k, v in runs["lc_batch"]["by"].items()},
        "probe_per_batch": {k: v / LC_REPS for k, v in probe.items()},
        "busy_ms": busy, "profiled_ms": prof_ms, "aten_ops": ops,
        "idle_share": 1 - busy / spread["median"] if busy else None,
        "cache_bytes": eng.cache_bytes(), "mixed": dev_v, "host_loop_s": host_s,
        "host_loop_sessions_per_s": len(mixed) / host_s, "fail_closed": closed,
        "fail_closed_supervisor": snap,
        "device_ms_by_name": {k[:80]: v / 1e3 for k, v in sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]},
    }
    log(f"light client batch: {LC_SESSIONS} optimistic-update sessions over the state's current and "
        f"next sync committees ({len(committees[0][1])} keys each, cache rows {sorted(rows)}, "
        f"decompressed in {rows_s:.2f} s; sessions signed in {fixture_s:.2f} s), n_pad {n_pad}: "
        f"{LC_REPS} batches {json.dumps(spread)} ms (host half {json.dumps(_spread(host_ms))} ms), "
        f"{out['batch']['sessions_per_s']:.2f} sessions/s; one pairing check of {n_pad + 1} pairs and "
        f"one aggregation sum per batch (PROBE); launches per batch "
        f"{json.dumps(out['batch']['launches_per_batch'])}; profiled: device busy {busy:.3f} ms of "
        f"{prof_ms:.3f} ms ({ops} aten ops), idle share {out['batch']['idle_share']}; committee cache "
        f"{eng.cache_bytes()} B on the card; a tampered signature: False; mixed {dev_v} == host loop "
        f"on the oracle ({len(mixed) / host_s:.3f} sessions/s); both device rungs faulted: "
        f"{closed}, no host rung")
    out["runs"] = runs
    return out


# --------------------------------------------------------------------------------------
# The slasher (phase 17)
# --------------------------------------------------------------------------------------

SLASHER_PAIRS = 16384  # honest (cur-1, cur) votes a tick (bench.py:1893 _inner_slasher)
SLASHER_TICKS = 16  # timed ticks of the bench cell (its BENCH_SLASHER_TICKS default)
SLASHER_DEPLOY_TICKS = 4  # timed ticks of the deployment window
SLASHER_TICKS_PER_EPOCH = 4
SLASHER_HISTORY = 64  # the bench cell's window (its BENCH_SLASHER_HISTORY default)
SLASHER_DEPLOY_HISTORY = 4096  # Lighthouse's --slasher-history-length default (config.rs:11)
SLASHER_SMALL = 1 << 15  # validators of the parity stream and the fault drill
HBM_BYTES_PER_S = 3.35e12  # one H100's memory rate


def _slasher_cell(n_val: int, history: int, iters: int, dev, first: int = 0) -> dict:
    """The reference bench's slasher cell (``bench.py:1893 _inner_slasher``,
    its seed and traffic) on the card: a ``SpanStore`` over ``n_val``
    validators and a ``history``-epoch window; one warm-up tick, then
    ``iters`` timed ticks of SLASHER_PAIRS honest (cur-1, cur) votes (tag
    1), SLASHER_TICKS_PER_EPOCH ticks an epoch, so the window rolls inside
    the timed ticks; then its injected ticks: 4 surrounds, then 4 double
    votes; then one epoch of honest ticks under the profiler (the sweeps on
    the calling thread, so the trace holds their ops). The pairs are
    drawn before the clock starts (the reference draws them inside it).
    The timed ticks are ticks ``first`` to ``first + iters - 1`` of that
    traffic (the reference's are 0 to iters - 1, the first one repeating
    the warm-up's epoch): ``first=1`` puts one roll in 4 timed ticks.
    Gates: 4 of 4 surrounds and doubles flagged, no flag on the honest
    stream, the store on the card (``mode == "device"``) with no demotion."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.analysis import memory
    from lighthouse_tpu_torch.analysis.recompile import BuildSentinel
    from lighthouse_tpu_torch.resilience import slasher_supervisor
    from lighthouse_tpu_torch.slasher.engine import SpanStore

    rng = np.random.default_rng(0x51A5)
    pairs = min(n_val, SLASHER_PAIRS)

    def honest(t):
        cur = 100 + t // SLASHER_TICKS_PER_EPOCH
        vidx = rng.choice(n_val, size=pairs, replace=False).astype(np.int64)
        return (vidx, np.full(pairs, cur - 1, np.int64), np.full(pairs, cur, np.int64),
                np.ones(pairs, np.uint32), cur)

    warm = honest(0)
    timed = [honest(t) for t in range(first, first + iters)]
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    store = SpanStore(history, use_device=True, device=dev)
    store.ensure_capacity(n_val)
    store.apply(*warm[:4], warm[4])
    bind_s = time.perf_counter() - t0
    plane_bytes = sum(p.numel() * p.element_size() for p in store.dev)
    # phase 24 (b), (c): the planes against the model and the allocator; the
    # timed ticks under the build sentinel
    torch.cuda.synchronize(dev)
    resident = _resident_row(f"slasher_planes@{n_val}x{history}", list(store.dev),
                             torch.cuda.memory_allocated(dev) - base,
                             memory.slasher_span_bytes(n_val, history))
    sentinel = BuildSentinel()
    mark = sentinel.snapshot()
    full = store.n_pad * history * 16  # every cell read once and written once (8 B each way)
    ms, false_pos, data_bytes, epoch, rolls = [], 0, 0, store.epoch, 0
    for vidx, src, tgt, vh, cur in timed:
        rolls += cur > epoch
        t = time.perf_counter()
        res = store.apply(vidx, src, tgt, vh, cur)  # numpy out: the tick has ended on the card
        ms.append((time.perf_counter() - t) * 1e3)
        false_pos += int(res["min_flag"].sum() + res["max_flag"].sum() + res["dbl_flag"].sum())
        # what this tick's data needs: the whole planes when the window rolls,
        # else the touched rows; each pair's 21 B in and 11 B out
        data_bytes += (full if cur > epoch else np.unique(vidx).size * history * 16) + pairs * 32
        epoch = cur
    tick_builds = sentinel.builds_since(mark)
    cur = 100 + (first + iters) // SLASHER_TICKS_PER_EPOCH + 1
    inj = rng.choice(n_val, size=8, replace=False).astype(np.int64)
    res = store.apply(
        np.concatenate([inj, inj[:4]]),
        np.concatenate([np.full(8, cur - 2, np.int64), np.full(4, cur - 3, np.int64)]),
        np.concatenate([np.full(8, cur - 1, np.int64), np.full(4, cur, np.int64)]),
        np.concatenate([np.ones(8, np.uint32), np.full(4, 2, np.uint32)]), cur)
    surround = int(res["min_flag"][8:].sum())
    res = store.apply(inj[4:], np.full(4, cur - 2, np.int64), np.full(4, cur - 1, np.int64),
                      np.full(4, 3, np.uint32), cur)
    double = int(res["dbl_flag"].sum())
    prof = [honest(4 * (cur - 99) + k) for k in range(SLASHER_TICKS_PER_EPOCH)]
    sup = slasher_supervisor()
    deadline, sup.config.deadline_s = sup.config.deadline_s, 0  # the sweep on this thread
    try:
        _, prof_ms, dev_us, ops = _profiled(lambda: [store.apply(*p[:4], p[4]) for p in prof])
    finally:
        sup.config.deadline_s = deadline
    peak = torch.cuda.max_memory_allocated(dev)
    st = store.stats()
    if st["mode"] != "device" or st["demotions"] or st["backend"] != "device":
        raise RuntimeError(f"slasher cell {n_val}x{history}: the store left the card: {st}")
    if surround != 4 or double != 4 or false_pos:
        raise RuntimeError(f"slasher cell {n_val}x{history}: surrounds {surround} of 4, doubles "
                           f"{double} of 4, {false_pos} flags on the honest stream")
    busy = sum(dev_us.values()) / 1e3
    spread = _spread(ms)
    out = {
        "validators": n_val, "history_length": history, "pairs_per_tick": pairs,
        "ticks_timed": iters, "ticks_per_epoch": SLASHER_TICKS_PER_EPOCH, "window_rolls": rolls,
        "slashable_checks_per_s": pairs * iters / (sum(ms) / 1e3), "ms_per_tick": spread,
        "ms_per_tick_mean": sum(ms) / iters, "ms": ms, "bind_s": bind_s,
        "plane_bytes": plane_bytes, "peak_bytes": peak, "baseline_bytes": base,
        "cell_peak_bytes": peak - base, "bound_ms": full / HBM_BYTES_PER_S * 1e3,
        "bound_data_ms": data_bytes / iters / HBM_BYTES_PER_S * 1e3,
        "profiled_ticks": len(prof), "profiled_ms": prof_ms, "busy_ms": busy,
        "busy_ms_per_tick": busy / len(prof), "aten_ops": ops,
        "idle_share": 1 - busy / prof_ms if busy else None,
        "device_ms_by_name": {k[:80]: v / 1e3 for k, v in
                              sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]},
        "detection": {"injected_surround": 4, "flagged_surround": surround,
                      "injected_double": 4, "flagged_double": double,
                      "false_positives": false_pos},
        "span": st, "resident": resident, "tick_builds": tick_builds,
    }
    del store
    torch.cuda.empty_cache()
    log(f"slasher cell {n_val} x {history}: {out['slashable_checks_per_s']:.2f} checks/s; ms per tick "
        f"{json.dumps(spread)} over {iters} ticks ({rolls} window rolls; "
        f"bind + first tick {bind_s:.2f} s); byte bound {out['bound_ms']:.4f} ms a tick with every "
        f"plane read and written, {out['bound_data_ms']:.4f} ms for this run's data (rolls + touched "
        f"rows); profiled epoch of {len(prof)} ticks: busy {busy:.3f} of {prof_ms:.3f} ms, idle share "
        f"{out['idle_share']}, {ops} aten ops; planes {plane_bytes} B, allocator peak {peak} B "
        f"({peak - base} B over the {base} B held before); surrounds {surround}/4, doubles "
        f"{double}/4, {false_pos} false positives; mode {st['mode']}, demotions {st['demotions']}")
    return out


def _slasher_pairs(rng, v: int, cur: int, n: int, p: int):
    """Random pairs as the port's tests draw them: rows past the registry,
    votes out of the window and reversed, tags from a small set (conflicts
    on shared cells), the all-ones tag, a fifth invalid (padding)."""
    import numpy as np

    vidx = rng.integers(0, v + 3, p).astype(np.int64)
    tgt = rng.integers(cur - n - 3, cur + 3, p).astype(np.int64)
    src = tgt - rng.integers(-1, 6, p)
    vh = rng.integers(1, 6, p).astype(np.uint32)
    vh[rng.random(p) < 0.05] = 0xFFFFFFFF
    return vidx, src, tgt, vh, rng.random(p) > 0.2


def _slasher_parity(dev, rng) -> dict:
    """Phase 17 (c): at SLASHER_SMALL x SLASHER_HISTORY, 8 ticks of
    ``_slasher_pairs`` (a roll past the whole window among them): the card's
    planes and per-pair outputs equal ``sweep_numpy``'s and the torch sweep
    on the CPU (in tiles of 1000 rows), bit for bit."""
    import numpy as np

    from lighthouse_tpu_torch.slasher import kernels
    from lighthouse_tpu_torch.slasher.engine import empty_planes_np, sweep_numpy

    v, n, p = SLASHER_SMALL, SLASHER_HISTORY, SLASHER_PAIRS
    host = list(empty_planes_np(v, n))
    card, cpu = kernels.empty_planes(v, n, dev), kernels.empty_planes(v, n, "cpu")
    epoch, cur, deltas, flags = 35, 40, [], [0, 0, 0]
    t0 = time.time()
    for step in range(8):
        args = _slasher_pairs(rng, v, cur, n, p)
        delta = cur - epoch
        twin = sweep_numpy(*host, delta, *args, cur, n)
        a = kernels.sweep_(card, delta, *args, cur, n=n)
        b = kernels.sweep_(cpu, delta, *args, cur, n=n, rows=1000)
        got_card = (*kernels.planes_from_device(card), *(x.cpu().numpy() for x in a))
        got_cpu = (*kernels.planes_from_device(cpu), *(x.numpy() for x in b))
        for i, (w, c, h) in enumerate(zip(twin, got_card, got_cpu)):
            w = np.asarray(w)
            if not (c.dtype == w.dtype and np.array_equal(c, w) and np.array_equal(h, w)):
                raise RuntimeError(f"slasher parity: output {i} at tick {step}: card/CPU != numpy twin")
        for j in range(3):
            flags[j] += int(np.asarray(twin[5 + j]).sum())
        host, epoch = list(twin[:3]), cur
        deltas.append(delta)
        cur += int(rng.integers(0, 3)) if step != 4 else n + 7
    out = {"validators": v, "history_length": n, "pairs_per_tick": p, "ticks": 8,
           "deltas": deltas, "min_flags": flags[0], "max_flags": flags[1],
           "dbl_flags": flags[2], "s": time.time() - t0}
    log(f"slasher parity at {v} x {n}: 8 ticks of {p} pairs (window rolls {deltas}; {flags[0]} "
        f"surrounding, {flags[1]} surrounded, {flags[2]} double-vote candidates): the card's planes "
        f"and five per-pair outputs == sweep_numpy == the torch sweep on the CPU, bit for bit; "
        f"{out['s']:.1f} s")
    return out


def _slasher_fault_drill(dev, rng) -> dict:
    """Phase 17 (d): a span store on the card (host checkpoint every 3
    sweeps) beside the numpy twin over 7 ticks; ``slasher.sweep`` injected
    with corruption at the 5th: the store demotes (``mode == "host"``, one
    demotion, the supervisor's numpy fallback noted), its checkpoint plus
    the replayed journal give the twin's planes, and with probation cut to
    0 s the next tick puts the planes back on the card. Per-pair outputs
    equal the twin's throughout. Never timed."""
    import numpy as np

    from lighthouse_tpu_torch.resilience import injector, slasher_supervisor
    from lighthouse_tpu_torch.slasher.engine import SpanStore

    sup = slasher_supervisor()
    sup.reset()
    store = SpanStore(SLASHER_HISTORY, use_device=True, device=dev, checkpoint_every=3)
    twin = SpanStore(SLASHER_HISTORY, use_device=False)
    prev = sup.config.probation_s
    modes = []
    injector.install("stage=slasher.sweep;mode=corrupt;at=5;times=1")
    try:
        for t in range(7):
            cur = 40 + t // 2
            vidx = rng.choice(SLASHER_SMALL, size=SLASHER_SMALL // 8, replace=False).astype(np.int64)
            tgt = rng.integers(cur - 8, cur + 1, vidx.size).astype(np.int64)
            src = tgt - rng.integers(0, 4, vidx.size)
            vh = rng.integers(1, 4, vidx.size).astype(np.uint32)
            if t == 5:
                sup.config.probation_s = 0.0  # this tick is probation's probe
            a = store.apply(vidx, src, tgt, vh, cur)
            b = twin.apply(vidx, src, tgt, vh, cur)
            if any(not np.array_equal(a[k], b[k]) for k in a):
                raise RuntimeError(f"slasher fault drill: tick {t}'s outputs != the twin's")
            modes.append(store.mode)
            if t in (4, 6) and any(not np.array_equal(x, y)
                                   for x, y in zip(store.planes(), twin.planes())):
                raise RuntimeError(f"slasher fault drill: planes != the twin's after tick {t}")
    finally:
        sup.config.probation_s = prev
        injector.clear()
    snap = sup.snapshot()
    st = store.stats()
    if modes != ["device"] * 4 + ["host", "device", "device"] or st["demotions"] != 1 \
            or st["promotions"] != 1 or snap["fallback_calls"] < 1:
        raise RuntimeError(f"slasher fault drill: modes {modes}, {st}, supervisor {snap}")
    sup.reset()
    out = {"modes": modes, "span": st, "supervisor": snap}
    log(f"slasher fault drill at {SLASHER_SMALL} x {SLASHER_HISTORY}: corruption injected at sweep 5 "
        f"-> modes {modes}; demotions {st['demotions']}, promotions {st['promotions']}, checkpoints "
        f"{st['checkpoints']}; planes and outputs == the numpy twin's throughout; supervisor "
        f"{json.dumps(snap)}")
    return out


def _slasher_types(ns):
    """The engine's container types for electra attestations."""
    import types

    return types.SimpleNamespace(IndexedAttestation=ns.IndexedAttestationElectra,
                                 AttesterSlashing=ns.AttesterSlashingElectra)


def _committee_votes(spec, chain, sk0: int, votes):
    """Single-member electra attestations of committee 0 at the head slot,
    signed by the oracle: ``votes`` is [(position in the committee,
    beacon_block_root)], all with the head epoch's target. Returns (the
    attestations, the committee's validator indices)."""
    import numpy as np

    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.types.containers import AttestationData, Checkpoint, for_preset
    from lighthouse_tpu_torch.types.helpers import compute_signing_root, get_domain

    ns = for_preset(spec.preset.name)
    state = chain.head.state
    slot, epoch = int(state.slot), st.get_current_epoch(spec, state)
    committee = st.get_beacon_committee(spec, state, slot, 0)
    start = spec.start_slot(epoch)
    target = chain.head.root if slot == start else bytes(st.get_block_root(spec, state, epoch))
    domain = get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=epoch)
    cbits = np.zeros(spec.preset.MAX_COMMITTEES_PER_SLOT, dtype=bool)
    cbits[0] = True
    out, msgs = [], {}
    for pos, root in votes:
        data = AttestationData(slot=slot, index=0, beacon_block_root=root,
                               source=state.current_justified_checkpoint,
                               target=Checkpoint(epoch=epoch, root=target))
        if root not in msgs:
            msgs[root] = cs.hash_to_g2(compute_signing_root(data, domain))
        bits = np.zeros(committee.size, dtype=bool)
        bits[pos] = True
        out.append(ns.AttestationElectra(aggregation_bits=bits, data=data, committee_bits=cbits.copy(),
                                         signature=_sign_all(msgs[root], [sk0 + int(committee[pos])])[0]))
    return out, [int(v) for v in committee]


def slasher_node_phase(spec, chain, sk0: int, dev) -> tuple:
    """Phase 17 (e): a ``SlasherService`` (window SLASHER_HISTORY, the engine
    on the card) on node A's chain observers; 64 single attestations of
    committee 0 at A's head through the chain's gossip batch path: 63
    members vote the head, and member 0 votes the head's parent too, for the
    same target. After ``tick`` the op pool holds exactly one
    ``AttesterSlashing``, naming member 0, whose two signatures verify on the
    card; the honest votes give none. Returns (measurements, the slasher,
    its pool, the committee, A's head epoch)."""
    from lighthouse_tpu_torch import slasher
    from lighthouse_tpu_torch.op_pool import OperationPool
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.types.containers import for_preset

    ns = for_preset(spec.preset.name)
    runs, out = {}, {}
    head, parent = chain.head.root, bytes(chain._blocks[chain.head.root].message.parent_root)
    t = time.time()
    atts, committee = _committee_votes(spec, chain, sk0, [(j, head) for j in range(63)] + [(0, parent)])
    out["fixture_s"] = time.time() - t
    sl = slasher.make_slasher(None, _slasher_types(ns),
                              slasher.SlasherConfig(history_length=SLASHER_HISTORY), device=dev)
    pool = OperationPool(spec, ns.Attestation)
    svc = slasher.SlasherService(chain, sl, pool)
    chain.attestation_observers.append(svc.attestation_observed)
    chain.block_observers.append(svc.block_observed)
    try:
        fm.reset_counts()
        t = time.perf_counter()
        res = chain.verify_unaggregated_attestations(atts)
        _sync(dev)
        out["gossip_ms"] = (time.perf_counter() - t) * 1e3
        runs["slasher_gossip"] = _read_counts("slasher gossip")
        if [isinstance(v, Exception) for _, v in res] != [False] * len(atts):
            raise RuntimeError("slasher: a gossip attestation was rejected")
        epoch = int(atts[0].data.target.epoch)
        t = time.perf_counter()
        stats = svc.tick(current_epoch=epoch)
        out["tick_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        chain.attestation_observers.remove(svc.attestation_observed)
        chain.block_observers.remove(svc.block_observed)
    found = list(pool._attester_slashings)
    common = [sorted(set(map(int, s.attestation_1.attesting_indices))
                     & set(map(int, s.attestation_2.attesting_indices))) for s in found]
    if common != [[committee[0]]] or stats["double_vote_slashings"] != 1 or stats["surround_slashings"]:
        raise RuntimeError(f"slasher: slashings naming {common}, stats {stats}")
    st = sl.stats()
    if st["mode"] != "device" or st["demotions"]:
        raise RuntimeError(f"slasher: the engine left the card: {st}")
    fm.reset_counts()
    items = [chain._attester_item_fast(a) for a in (found[0].attestation_1, found[0].attestation_2)]
    if chain._batch_verify_items(items) is not True:
        raise RuntimeError("slasher: the slashing's signatures did not verify")
    runs["slasher_sigs"] = _read_counts("slasher slashing signatures")
    out.update(stats=stats, span=st, slashing_validator=committee[0], runs=runs,
               attestations=len(atts))
    log(f"slasher on node A: {len(atts)} attestations of committee 0 at slot {int(atts[0].data.slot)} "
        f"(built in {out['fixture_s']:.1f} s) through the gossip batch path in {out['gossip_ms']:.2f} ms, "
        f"all verified; tick {out['tick_ms']:.2f} ms: {json.dumps(stats)}; the pool holds one "
        f"AttesterSlashing naming validator {committee[0]}, its two signatures verified on the card; "
        f"span {json.dumps(st)}; launches {json.dumps({k: v['by'] for k, v in runs.items()})}")
    return out, sl, pool, committee, epoch


def slasher_phase(spec, chain, sk0: int, dev, rng) -> tuple:
    """Phase 17: the bench cell, the deployment window, parity on the card,
    the fault drill and the slasher on node A (see the module docstring)."""
    from lighthouse_tpu_torch import slasher

    slasher.set_backend("device", device=dev)
    t = time.time()
    out = {"bench": _slasher_cell(1 << 20, SLASHER_HISTORY, SLASHER_TICKS, dev)}
    out["bench"]["s"] = time.time() - t
    t = time.time()
    out["deploy"] = _slasher_cell(1 << 20, SLASHER_DEPLOY_HISTORY, SLASHER_DEPLOY_TICKS, dev, first=1)
    out["deploy"]["s"] = time.time() - t
    out["parity"] = _slasher_parity(dev, rng)
    out["fault_drill"] = _slasher_fault_drill(dev, rng)
    node, sl, pool, committee, epoch = slasher_node_phase(spec, chain, sk0, dev)
    out["node"] = node
    out["runs"] = node.pop("runs")
    return out, (sl, pool, committee, epoch)


# --------------------------------------------------------------------------------------
# Restart from disk (phase 18)
# --------------------------------------------------------------------------------------


def _durable_store(root: str, owner: str):
    from lighthouse_tpu_torch.store import HotColdDB
    from lighthouse_tpu_torch.store.kv import LevelStore

    return HotColdDB(hot=LevelStore(os.path.join(root, "chain.db"), owner=owner),
                     cold=LevelStore(os.path.join(root, "freezer.db"), owner=owner))


def _node_view(chain, pool) -> dict:
    from lighthouse_tpu_torch.op_pool import persistence as pool_persist

    fc = chain.fork_choice
    return {"head": (chain.head.root, int(chain.head.slot)),
            "nodes": [(n.root, n.parent, int(n.weight), n.best_child, n.best_descendant)
                      for n in fc.proto.nodes],
            "finalized": fc.store.finalized_checkpoint, "justified": fc.store.justified_checkpoint,
            "pool": pool_persist.serialize_pool(pool),
            "slashings": [type(s).encode(s) for s in pool._attester_slashings]}


def restart_phase(spec, node_a, block, gossip, raw, sk0: int, box17: list, dev, root: str) -> dict:
    """Phase 18: node C, a ``BeaconChain`` over ``HotColdDB`` with
    ``LevelStore`` hot and cold stores under ``root``, anchored on node A's
    anchor (phase 13's) with A's seeded pubkey cache: it imports phase 12's
    ``block`` (fork choice persisted at the import barrier), takes phase
    13's valid gossip attestations and phase 17's slashing into its op pool
    and persists the pool; phase 17's slasher checkpoints into C's hot
    store. Then every object is dropped and the stores reopened: a pubkey
    cache seeded from the registry's affine points, ``recover_node_state``
    and ``make_slasher(store.hot)``. Gates: head, fork-choice nodes and
    weights, checkpoints and pool equal C's before the crash; a gossip batch
    (one poisoned) verifies on the card through the recovered chain, exactly
    the poisoned one rejected; a double vote after the restart against a vote
    from before it is convicted by the restored slasher, its sweep on the
    card. ``box17`` holds phase 17's (slasher, pool, committee, epoch), the
    only reference to that slasher: the crash drops it."""
    import gc

    import numpy as np

    from lighthouse_tpu_torch import slasher
    from lighthouse_tpu_torch.beacon_chain import BeaconChain, ValidatorPubkeyCache
    from lighthouse_tpu_torch.beacon_chain.recovery import recover_node_state
    from lighthouse_tpu_torch.fork_choice import persistence as fc_persist
    from lighthouse_tpu_torch.op_pool import OperationPool
    from lighthouse_tpu_torch.op_pool import persistence as pool_persist
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.store.kv import DBColumn
    from lighthouse_tpu_torch.types.containers import for_preset
    from lighthouse_tpu_torch.utils.slot_clock import ManualSlotClock

    sl, slash_pool, committee, epoch17 = box17.pop()
    ns = for_preset(spec.preset.name)
    anchor = node_a.genesis_state
    runs, out = {}, {}
    slot1 = int(block.message.slot)

    # before the crash
    t = time.time()
    store = _durable_store(root, "node_c")
    chain = BeaconChain(spec, anchor, store=store, slot_clock=ManualSlotClock(slot1),
                        pubkey_cache=node_a.pubkey_cache)
    out["boot_s"] = time.time() - t
    if not chain._durable:
        raise RuntimeError("restart: node C's store is not durable")
    fm.reset_counts()
    root1, split, batches, _ = _timed_import(chain, block, dev)
    runs["restart_import"] = _read_counts("restart: node C's import")
    if len(batches) != 1 or batches[0]["ok"] is not True or chain.head.root != root1:
        raise RuntimeError(f"restart: node C's import: bls batches {batches}")
    out["import"] = split
    pool = OperationPool(spec, ns.Attestation)
    t = time.perf_counter()
    for a in gossip:
        pool.insert_attestation(a)
    for s in slash_pool._attester_slashings:
        pool.insert_attester_slashing(s)
    out["pool_insert_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pool_persist.persist(store, pool)
    out["pool_persist_ms"] = (time.perf_counter() - t) * 1e3
    n_sl_atts = len(sl._atts)
    t = time.perf_counter()
    if not sl.persist(store=store.hot):
        raise RuntimeError("restart: the slasher wrote no checkpoint")
    out["slasher_persist_ms"] = (time.perf_counter() - t) * 1e3
    out["slasher_checkpoint_bytes"] = len(store.hot.get(DBColumn.SlasherMeta, sl.PERSIST_KEY))
    before = _node_view(chain, pool)
    if len(before["slashings"]) != 1 or pool.num_attestations() != 1:
        raise RuntimeError(f"restart: node C's pool: {pool.num_attestations()} attestation "
                           f"variants, {len(before['slashings'])} slashings")
    out["fork_choice_snapshot_bytes"] = len(store.get_meta(fc_persist.META_KEY))
    out["pool_snapshot_bytes"] = len(before["pool"])

    log(f"restart: node C over LevelStores booted on node A's anchor in {out['boot_s']:.2f} s; "
        f"phase 12's block imported in {split['total_ms']:.2f} ms (store write "
        f"{split['store_write_ms']:.2f} ms), fork choice persisted at the import barrier in "
        f"{split['persist_ms']:.2f} ms ({out['fork_choice_snapshot_bytes']} B); pool of "
        f"{len(gossip)} attestations and phase 17's slashing persisted in "
        f"{out['pool_persist_ms']:.2f} ms ({out['pool_snapshot_bytes']} B); phase 17's slasher "
        f"checkpoint {out['slasher_checkpoint_bytes']} B in {out['slasher_persist_ms']:.2f} ms")

    # the crash: every object dropped, the files closed
    for kv in (store.hot, store.cold):
        kv.close()
    out["wal_bytes"] = {f: os.path.getsize(os.path.join(root, f)) for f in ("chain.db", "freezer.db")}
    log(f"restart: WAL {json.dumps(out['wal_bytes'])} B")
    del chain, store, pool, sl, slash_pool, split, batches
    gc.collect()

    # the recovery
    t0 = time.perf_counter()
    cache = ValidatorPubkeyCache.from_affine(anchor, raw, device=dev)
    _sync(dev)
    cache_s = time.perf_counter() - t0
    t = time.perf_counter()
    store = _durable_store(root, "node_c")
    reopen_s = time.perf_counter() - t
    state_cls = type(anchor)
    decode_s = {"state": 0.0, "block": 0.0}
    patches = _Patches()

    def timed_decode(cls, key):
        real = cls.decode

        def decode(data):
            t1 = time.perf_counter()
            try:
                return real(data)
            finally:
                decode_s[key] += time.perf_counter() - t1
        return decode

    block_cls = type(block)
    patches.set(state_cls, "decode", timed_decode(state_cls, "state"))
    patches.set(block_cls, "decode", timed_decode(block_cls, "block"))
    try:
        chain, pool, report = recover_node_state(spec, anchor, store, slot_clock=ManualSlotClock(slot1),
                                                 pubkey_cache=cache)
    finally:
        patches.undo()
    after = _node_view(chain, pool)
    for k in ("head", "nodes", "finalized", "justified", "pool", "slashings"):
        if after[k] != before[k]:
            raise RuntimeError(f"restart: the recovered {k} != node C's before the crash")
    if not report["fork_choice_restored"] or report["truncated_bytes"] or chain.pubkey_cache is not cache:
        raise RuntimeError(f"restart: recovery report {report}")
    out["recovery"] = {
        **{k: v for k, v in report.items() if k != "head_root"},
        "pubkey_cache_s": cache_s, "reopen_s": reopen_s, "state_decode_s": decode_s["state"],
        "block_decode_s": decode_s["block"], "total_s": cache_s + reopen_s + report["recovery_s"],
    }

    # gossip through the recovered chain, on the card
    n_att, bad_pos = 64, 23
    t = time.time()
    from lighthouse_tpu_torch import state_transition as st

    head_epoch = st.get_current_epoch(spec, chain.head.state)
    atts, _, _ = _gossip_fixture(
        spec, chain, sk0, n_att, 0, bad_pos,
        target_root=bytes(st.get_block_root(spec, chain.head.state, head_epoch)))
    out["gossip_fixture_s"] = time.time() - t
    fm.reset_counts()
    t = time.perf_counter()
    res = chain.verify_unaggregated_attestations(atts)
    _sync(dev)
    out["gossip_ms"] = (time.perf_counter() - t) * 1e3
    runs["restart_gossip"] = _read_counts("restart: gossip through the recovered chain")
    rejected = [i for i, (_, v) in enumerate(res) if isinstance(v, Exception)]
    if rejected != [bad_pos]:
        raise RuntimeError(f"restart: gossip rejected {rejected}, poisoned {bad_pos}")

    # the restored slasher convicts a post-restart double vote
    t = time.perf_counter()
    sl = slasher.make_slasher(store.hot, _slasher_types(ns),
                              slasher.SlasherConfig(history_length=SLASHER_HISTORY), device=dev)
    out["slasher_restore_ms"] = (time.perf_counter() - t) * 1e3
    if len(sl._atts) != n_sl_atts or sl.span.mode != "device":
        raise RuntimeError(f"restart: the slasher restored {len(sl._atts)} of {n_sl_atts} "
                           f"attestations, mode {sl.span.mode}")
    voter = committee[1]
    att, _ = _committee_votes(spec, node_a, sk0, [(1, bytes(
        node_a._blocks[node_a.head.root].message.parent_root))])
    data = att[0].data
    if int(data.target.epoch) != epoch17:
        raise RuntimeError("restart: the double vote's target is not phase 17's")
    sl.accept_attestation(ns.IndexedAttestationElectra(
        attesting_indices=[voter], data=data, signature=att[0].signature))
    t = time.perf_counter()
    stats = sl.process_queued(epoch17)
    out["slasher_tick_ms"] = (time.perf_counter() - t) * 1e3
    new = [s for s in sl.get_attester_slashings()
           if voter in set(map(int, s.attestation_1.attesting_indices))
           & set(map(int, s.attestation_2.attesting_indices))]
    st = sl.stats()
    if stats["double_vote_slashings"] != 1 or len(new) != 1 or st["mode"] != "device" \
            or st["demotions"] or st["sweeps"] != 1:
        raise RuntimeError(f"restart: the post-restart double vote: {stats}, {len(new)} slashings, {st}")
    out.update(slasher_stats=stats, slasher_span=st, runs=runs,
               head_slot=int(chain.head.slot), fc_nodes=report["fc_nodes"])
    rec = out["recovery"]
    log(f"restart: every object dropped, stores reopened ({reopen_s:.2f} s: "
        f"{rec['replayed_frames']} frames, {rec['replayed_records']} records replayed, "
        f"{rec['truncated_bytes']} B truncated); pubkey cache seeded from affine points "
        f"{cache_s:.2f} s; recover_node_state {rec['recovery_s']:.2f} s (state decode "
        f"{rec['state_decode_s']:.2f} s, block decode {rec['block_decode_s']:.3f} s); head slot "
        f"{out['head_slot']}, {rec['fc_nodes']} fork-choice nodes, weights, checkpoints and pool == "
        f"node C's before the crash; {n_att} gossip attestations (fixture {out['gossip_fixture_s']:.1f} "
        f"s) through the recovered chain in {out['gossip_ms']:.2f} ms, exactly the poisoned one "
        f"rejected; slasher restored in {out['slasher_restore_ms']:.2f} ms ({n_sl_atts} "
        f"attestations, mode device) and validator {voter}'s post-restart double vote convicted in "
        f"{out['slasher_tick_ms']:.2f} ms; launches {json.dumps({k: v['by'] for k, v in runs.items()})}")
    return out


# --------------------------------------------------------------------------------------
# The client surface (phase 19)
# --------------------------------------------------------------------------------------


API_INDICES = 16  # validators asked for by index, and as many by pubkey
API_DUTIES = 64  # validators whose attester duties are asked for
API_ATTS = 64  # attestations posted, one poisoned
API_OFFSET = 128  # committee 0's members the posted attestations come from (phase 17 took 0-62)
CLI_VALIDATORS = 64  # the CLI node's interop registry (every key derived by the oracle)


def _http(url: str, method: str = "GET", body=None, headers=None, timeout: float = 300.0):
    """(status, body bytes, headers) of one request through ``urllib``."""
    import urllib.error
    import urllib.request

    data = body if body is None or isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def api_phase(spec, chain, node_a, sk0: int, dev) -> dict:
    """Phase 19 (a): the Beacon API over node A at full width. A
    ``BeaconApiServer`` over A's chain, op pool, network service and load
    monitor, a ``MetricsServer`` and a ``ValidatorMonitor`` on committee 0
    of the head slot. Every request goes through the port's
    ``BeaconNodeHttpClient`` or ``urllib``; each read is timed and checked
    against the chain's own value. Then ``API_ATTS`` single-key
    attestations of committee 0 at A's head, one signed by another member,
    are posted: 400 naming exactly that one, the others in A's op pool, the
    reference bisection's verify calls, on the card; the aggregate served
    for their data is the naive pool's, and ``/metrics`` counts the
    monitored attestations. Counts are set to 0 before the part and read
    after it (``runs["api"]``)."""
    import re

    import numpy as np

    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.api_client import BeaconNodeHttpClient
    from lighthouse_tpu_torch.beacon_chain.validator_monitor import ValidatorMonitor
    from lighthouse_tpu_torch.http_api import BeaconApiServer
    from lighthouse_tpu_torch.http_metrics import MetricsServer
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.types.containers import for_preset

    ns = for_preset(spec.preset.name)
    out, ms, sizes = {}, {}, {}
    state, head = chain.head.state, chain.head.root
    slot, epoch = int(state.slot), st.get_current_epoch(spec, state)
    n_val = len(state.validators)
    committee = [int(v) for v in st.get_beacon_committee(spec, state, slot, 0)]
    offset = min(API_OFFSET, len(committee) - API_ATTS)
    if offset < 63:  # members phase 17 has voted with at this head
        raise RuntimeError(f"api: committee 0 has {len(committee)} members")
    target = head if slot == spec.start_slot(epoch) else bytes(st.get_block_root(spec, state, epoch))
    bad_pos = 23
    t = time.time()
    atts, _, members = _gossip_fixture(spec, chain, sk0, API_ATTS, 0, bad_pos, offset=offset,
                                       target_root=target)
    # the HTTP wire carries the pre-electra container: committee 0 is data.index's
    wire = [ns.Attestation(aggregation_bits=a.aggregation_bits, data=a.data, signature=a.signature)
            for a in atts]
    out["fixture_s"] = time.time() - t

    monitor = ValidatorMonitor(chain, indices=committee)
    server = BeaconApiServer(chain, op_pool=node_a.op_pool, network_service=node_a,
                             load_monitor=node_a.load_monitor).start()
    metrics = MetricsServer().start()
    client = BeaconNodeHttpClient(server.url, timeout=300.0)
    calls, verify_ms, patches = [], [], _Patches()
    real_batch = chain._batch_verify_items

    def counting(items):
        calls.append(list(items))
        t0 = time.perf_counter()
        try:
            return real_batch(items)
        finally:
            _sync(dev)
            verify_ms.append((time.perf_counter() - t0) * 1e3)

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return res

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"api: {what}")

    fm.reset_counts()
    try:
        # reads, each against the chain's own value
        g = timed("genesis", client.get_genesis)
        gs = chain.genesis_state
        check((g.genesis_time, g.genesis_validators_root) == (
            int(gs.genesis_time), bytes(gs.genesis_validators_root)), "genesis")
        fork = timed("fork", lambda: client.get_fork("head"))
        check(fork == {"previous_version": bytes(state.fork.previous_version),
                       "current_version": bytes(state.fork.current_version),
                       "epoch": int(state.fork.epoch)}, f"fork {fork}")
        fin = timed("finality_checkpoints", lambda: client.get_finality_checkpoints("head"))
        check(fin == {k: {"epoch": int(c.epoch), "root": bytes(c.root)} for k, c in (
            ("previous_justified", state.previous_justified_checkpoint),
            ("current_justified", state.current_justified_checkpoint),
            ("finalized", state.finalized_checkpoint))}, f"finality {fin}")
        hh = timed("head_header", client.get_head_header)
        check(hh == {"root": head, "slot": slot}, f"head header {hh}")
        version, raw = timed("block_by_root", lambda: client.get_block_ssz("0x" + head.hex()))
        sb = chain.get_signed_block(head)
        check(version == spec.fork_name_at_slot(slot) and raw == type(sb).encode(sb), "block by root")
        sizes["block_by_root"] = len(raw)
        step = max(1, n_val // (2 * API_INDICES))
        by_index = list(range(0, n_val, 2 * step))[:API_INDICES]
        by_key = list(range(step, n_val, 2 * step))[:API_INDICES]
        ids = [str(i) for i in by_index] + ["0x" + bytes(state.validators[i].pubkey).hex()
                                            for i in by_key]
        code, body, _ = timed("validators", lambda: _http(
            server.url + "/eth/v1/beacon/states/head/validators?id=" + ",".join(ids)))
        vals = json.loads(body)["data"] if code == 200 else None
        check(vals is not None and [int(v["index"]) for v in vals] == by_index + by_key, "validators")
        for v in vals:
            i = int(v["index"])
            check(int(v["balance"]) == int(state.balances[i]) and v["validator"]["pubkey"]
                  == "0x" + bytes(state.validators[i].pubkey).hex()
                  and int(v["validator"]["effective_balance"])
                  == int(state.validators[i].effective_balance), f"validator {i}")
        code, body, _ = timed("validator_balances", lambda: _http(
            server.url + "/eth/v1/beacon/states/head/validator_balances?id="
            + ",".join(map(str, by_index + by_key))))
        check(code == 200 and [(int(b["index"]), int(b["balance"])) for b in json.loads(body)["data"]]
              == [(i, int(state.balances[i])) for i in by_index + by_key], "validator balances")
        code, body, _ = timed("committees", lambda: _http(
            server.url + f"/eth/v1/beacon/states/head/committees?epoch={epoch}"))
        check(code == 200, f"committees: HTTP {code}")
        sizes["committees"] = len(body)
        comms = json.loads(body)["data"]
        per_slot = st.get_committee_count_per_slot(spec, state, epoch)
        check(len(comms) == spec.preset.SLOTS_PER_EPOCH * per_slot, f"{len(comms)} committees")
        seen = np.zeros(n_val, dtype=np.int64)
        for c in comms:
            want = st.get_beacon_committee(spec, state, int(c["slot"]), int(c["index"]))
            got = np.asarray([int(v) for v in c["validators"]], dtype=np.int64)
            check(np.array_equal(got, np.asarray(want, dtype=np.int64)),
                  f"committee {c['slot']}/{c['index']}")
            seen[got] += 1
        active = np.asarray(st.get_active_validator_indices(state, epoch), dtype=np.int64)
        check(int(seen.sum()) == active.size and (seen[active] == 1).all(),
              "the epoch's committees do not cover each active validator once")
        duties = timed("proposer_duties", lambda: client.get_proposer_duties(epoch))
        check([d.slot for d in duties] == list(range(spec.start_slot(epoch),
                                                     spec.start_slot(epoch + 1))), "proposer slots")
        for d in duties:
            want = st.get_beacon_proposer_index(spec, state, slot=d.slot)
            check(d.validator_index == want and d.pubkey == bytes(state.validators[want].pubkey),
                  f"proposer at slot {d.slot}")
        asked = committee[:API_DUTIES // 2] + by_index + by_key
        asked = list(dict.fromkeys(asked))[:API_DUTIES]
        att_duties = timed("attester_duties", lambda: client.get_attester_duties(epoch, asked))
        check(sorted(d.validator_index for d in att_duties) == sorted(asked), "attester duties")
        for d in att_duties:
            c = st.get_beacon_committee(spec, state, d.slot, d.committee_index)
            check(int(c[d.validator_committee_index]) == d.validator_index
                  and d.committee_length == len(c) and d.committees_at_slot == per_slot,
                  f"attester duty of {d.validator_index}")
        syncing = timed("syncing", client.get_syncing)
        check(int(syncing["head_slot"]) == slot, f"syncing {syncing}")
        code, _, _ = timed("health", lambda: _http(server.url + "/eth/v1/node/health"))
        check(code in (200, 206), f"health: HTTP {code}")
        code, body, _ = timed("spec", lambda: _http(server.url + "/eth/v1/config/spec"))
        cfg = json.loads(body)["data"]
        check(cfg["PRESET_BASE"] == spec.preset.name
              and int(cfg["SLOTS_PER_EPOCH"]) == spec.preset.SLOTS_PER_EPOCH, f"spec {cfg}")

        # the write: a poisoned batch through the chain's gossip batch path, on the card
        patches.set(chain, "_batch_verify_items", counting)
        body = [{"data": "0x" + ns.Attestation.encode(a).hex()} for a in wire]
        code, reply, _ = timed("post_attestations", lambda: _http(
            server.url + "/eth/v1/beacon/pool/attestations", "POST", body))
        _sync(dev)
        patches.undo()
        failures = json.loads(json.loads(reply)["message"]) if code == 400 else None
        check(failures is not None and [f["index"] for f in failures] == [bad_pos],
              f"POST attestations: HTTP {code}, {reply[:300]!r}")
        pos = {v: j for j, v in enumerate(members)}
        order = [pos[it[0][0]] for it in calls[0]]
        n_ref = 1 + _bisect_calls(order, {bad_pos})
        check(len(calls) == n_ref, f"{len(calls)} verify calls, the reference bisection makes {n_ref}")
        data_root = type(atts[0].data).hash_tree_root(atts[0].data)
        valid = [offset + j for j in range(API_ATTS) if j != bad_pos]
        entry = node_a.op_pool._attestations.get(data_root)
        pooled = np.zeros(len(committee), dtype=bool)
        for bits, _sig in (entry[1] if entry else ()):
            pooled |= np.asarray(bits, dtype=bool)
        check(pooled[valid].all() and not pooled[offset + bad_pos],
              "the valid attestations are not in A's op pool")
        agg = timed("aggregate_attestation", lambda: client.get_aggregate_attestation(data_root))
        naive = chain.naive_aggregation_pool.get_by_root(data_root)
        check(naive is not None and agg == ns.Attestation.encode(naive), "the served aggregate")
        bits = np.asarray(ns.Attestation.decode(agg).aggregation_bits, dtype=bool)
        check(bits[valid].all() and not bits[offset + bad_pos], "the aggregate's bits")
        code, text, _ = timed("metrics", lambda: _http(metrics.url + "/metrics"))
        m = re.search(rb"^validator_monitor_attestations_total (\S+)$", text, re.M)
        check(code == 200 and m is not None and float(m.group(1)) == API_ATTS - 1,
              f"validator_monitor_attestations_total {m.group(1) if m else None}")
    finally:
        patches.undo()
        server.stop()
        metrics.stop()
        chain.attestation_observers.remove(monitor._on_attestation)
        chain.block_observers.remove(monitor._on_block)
    runs = {"api": _read_counts("api: the client surface over node A")}
    out.update(ms=ms, bytes=sizes, verify_calls=len(calls), reference_calls=n_ref,
               post_verify_ms=sum(verify_ms),
               attestations=API_ATTS, offset=offset, validators=n_val, runs=runs,
               monitor=monitor.epoch_summary(int(atts[0].data.target.epoch)))
    log(f"api over node A ({n_val} validators, head slot {slot}): reads against the chain "
        f"(ms) {json.dumps({k: round(v, 2) for k, v in ms.items()})}; committees of epoch "
        f"{epoch} {sizes['committees']} B of JSON; POST of {API_ATTS} attestations (committee 0, "
        f"members {offset}-{offset + API_ATTS - 1}, fixture {out['fixture_s']:.1f} s): 400 naming "
        f"exactly the poisoned one ({bad_pos}), {len(calls)} verify calls (reference bisection: "
        f"{n_ref}; {sum(verify_ms):.2f} ms of the POST inside them), the other {API_ATTS - 1} in A's op pool and the served aggregate; "
        f"validator_monitor_attestations_total {API_ATTS - 1}; launches "
        f"{json.dumps(runs['api']['by'])}")
    return out


def _close_stores(client) -> None:
    for kv in (client.chain.store.hot, client.chain.store.cold):
        kv.close()


def _cli_block(c) -> tuple:
    """A block for the current slot from CLI node ``c``: produced over
    ``/eth/v2/validator/blocks`` with the proposer's randao reveal, signed
    with its interop key by the oracle. Returns (signed block, fork, slot,
    proposer, produce ms)."""
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.api_client import BeaconNodeHttpClient
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.ssz import uint64
    from lighthouse_tpu_torch.state_transition.genesis import interop_secret_keys
    from lighthouse_tpu_torch.types.containers import SigningData
    from lighthouse_tpu_torch.types.helpers import compute_signing_root, get_domain

    spec, ns = c.chain.spec, c.chain.ns
    client = BeaconNodeHttpClient(c.http_server.url, timeout=300.0)
    slot = max(c.chain.current_slot(), int(c.chain.head.slot) + 1)
    state = c.chain.head.state.copy()
    st.process_slots(spec, state, slot)
    proposer = st.get_beacon_proposer_index(spec, state)
    sk = interop_secret_keys(CLI_VALIDATORS)[proposer]
    epoch = spec.compute_epoch_at_slot(slot)
    randao_root = SigningData(object_root=uint64.hash_tree_root(epoch), domain=get_domain(
        spec, state, spec.DOMAIN_RANDAO, epoch=epoch)).tree_root()
    reveal = _sign_all(cs.hash_to_g2(randao_root), [sk])[0]
    t0 = time.perf_counter()
    version, raw = client.produce_block(slot, reveal)
    produce_ms = (time.perf_counter() - t0) * 1e3
    block = dict(ns.block_types[version].FIELDS)["message"].decode(raw)
    domain = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
    signed = ns.block_types[version](message=block, signature=_sign_all(
        cs.hash_to_g2(compute_signing_root(block, domain)), [sk])[0])
    return signed, version, slot, proposer, produce_ms


def cli_phase(dev, root: str) -> dict:
    """Phase 19 (b): the CLI in process, at interop size. ``cli.run_bn`` on a
    minimal-preset electra interop genesis of CLI_VALIDATORS keys, two slots
    old, with HTTP and metrics on ephemeral ports and a datadir: the joined
    warm-up healthy; a block for the current slot produced over
    ``/eth/v2/validator/blocks``, signed with the proposer's interop key by
    the oracle and published as SSZ: 200, the head that block's root, one
    ``bls`` batch, on the card (counts set to 0 before the publish and read
    after, ``runs["cli_publish"]``); a second node checkpoint-synced from
    the first, its anchor the first one's finalized state; the first node
    stopped and booted again on its datadir: fork choice restored, the head
    slot and root as before the stop. Phase 21 (b) (``vc_cli_phase``) runs on
    the first node before the restart (the interop mock execution layer
    keeps no payloads across one, so the restarted node cannot produce a
    block); its result is ``out["vc_cli"]``, its time its ``phase_s``."""
    from lighthouse_tpu_torch import bls, cli
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    out, runs = {}, {}
    sps = 6  # the minimal preset's SECONDS_PER_SLOT
    genesis_time = int(time.time()) - 2 * sps
    forks = [a for f in ("altair", "bellatrix", "capella", "deneb", "electra")
             for a in (f"--{f}-fork-epoch", "0")]
    parser = cli.build_parser()

    def argv(datadir, *extra):
        return parser.parse_args([
            "bn", "--preset", "minimal", "--interop-validators", str(CLI_VALIDATORS),
            "--http-port", "0", "--datadir", os.path.join(root, datadir),
            "--genesis-time", str(genesis_time), *forks, *extra])

    def boot(args, what):
        t0 = time.time()
        c = cli.run_bn(args)
        boot_s = time.time() - t0
        warm = c.wait_for_warmup(600)
        if not warm or warm["healthy"] is not True:
            c.stop()
            raise RuntimeError(f"cli: {what}: the warm-up reported {warm}")
        if c.chain.pubkey_cache.device_array().device.type != dev.type:
            raise RuntimeError(f"cli: {what}: the pubkey cache is not on {dev}")
        return c, {"boot_s": boot_s, "warmup_s": warm["seconds"],
                   "joined_s": time.time() - t0 - boot_s}

    c1, out["boot"] = boot(argv("node1", "--metrics", "--metrics-port", "0"), "boot")
    try:
        code, _, _ = _http(c1.http_server.url + "/eth/v1/node/health")
        if code not in (200, 206):
            raise RuntimeError(f"cli: health HTTP {code}")
        ns = c1.chain.ns
        signed, version, slot, proposer, out["produce_ms"] = _cli_block(c1)
        block = signed.message
        batches, patches = [], _Patches()
        real_verify = bls.verify_signature_sets

        def counting(sets, *, device=None):
            sets = list(sets)
            batches.append(len(sets))
            return real_verify(sets, device=device)

        patches.set(bls, "verify_signature_sets", counting)
        fm.reset_counts()
        t0 = time.perf_counter()
        try:
            code, reply, _ = _http(c1.http_server.url + "/eth/v1/beacon/blocks", "POST",
                                   ns.block_types[version].encode(signed),
                                   {"Content-Type": "application/octet-stream",
                                    "Eth-Consensus-Version": version})
            _sync(dev)
        finally:
            patches.undo()
        out["publish_ms"] = (time.perf_counter() - t0) * 1e3
        runs["cli_publish"] = _read_counts("cli: the block publish")
        root_b = block.tree_root()
        if code != 200 or c1.chain.head.root != root_b or len(batches) != 1:
            raise RuntimeError(f"cli: publish HTTP {code} {reply[:200]!r}, head "
                               f"{c1.chain.head.root.hex()[:16]} (block {root_b.hex()[:16]}), "
                               f"bls batches {batches}")
        out.update(slot=slot, fork=version, proposer=proposer, block_sets=batches[0])

        # a second node from the first one's finalized state
        finalized = c1.http_server._state("finalized")
        c2, out["checkpoint_boot"] = boot(argv("node2", "--checkpoint-sync-url",
                                               c1.http_server.url), "checkpoint sync")
        try:
            if c2.chain.genesis_state.tree_root() != finalized.tree_root():
                raise RuntimeError("cli: the checkpoint anchor is not the first node's finalized state")
        finally:
            c2.stop()
            _close_stores(c2)

        t_vc = time.time()
        out["vc_cli"] = vc_cli_phase(c1, dev, root)
        out["vc_cli"]["phase_s"] = time.time() - t_vc

        # restart on the same datadir
        before = (c1.chain.head.root, int(c1.chain.head.slot), len(c1.chain.fork_choice.proto.nodes))
        t0 = time.time()
        c1.stop()
        _close_stores(c1)
        out["stop_s"] = time.time() - t0
        c1, out["restart"] = boot(argv("node1"), "restart")
        after = (c1.chain.head.root, int(c1.chain.head.slot), len(c1.chain.fork_choice.proto.nodes))
        if after != before:
            raise RuntimeError(f"cli: after the restart head/slot/fork-choice nodes {after[1:]} "
                               f"!= {before[1:]}")
    finally:
        c1.stop()
        _close_stores(c1)
    out["runs"] = runs
    log(f"cli: bn booted in {out['boot']['boot_s']:.2f} s ({CLI_VALIDATORS} interop validators, "
        f"electra, minimal; warm-up {out['boot']['warmup_s']} s, healthy); block at slot {slot} "
        f"produced over HTTP in {out['produce_ms']:.2f} ms, published as SSZ in "
        f"{out['publish_ms']:.2f} ms ({batches[0]} sets in one bls batch on the card, the head "
        f"moved to it); checkpoint-synced node in {out['checkpoint_boot']['boot_s']:.2f} s (anchor "
        f"== the finalized state); stop {out['stop_s']:.2f} s, restart "
        f"{out['restart']['boot_s']:.2f} s to the same head and fork choice; launches "
        f"{json.dumps(runs['cli_publish']['by'])}")
    return out


VC_KEYS = 1024  # phase 21 (a): the keys of a large operator's validator client
VC_SYNC_KEYS = 16  # of them members of the current sync committee, so every service has work
VC_SLOTS = 2  # consecutive slots of node A's clock driven through ``run_slot``
VC_TIMEOUT_S = 600.0  # phase 21 (a)'s API client timeout (``vc`` gives 10 s; see ``vc_phase``)
VC_CLI_KEYS = 2  # phase 21 (b): keystores written by account-manager, and as many by vm create
VC_CLI_REMOTE = 8  # the CLI node's last interop keys, served by a MockWeb3Signer
VC_SEED = "5eed" * 16  # EIP-2333 seed of the (b) keystores


def _route(method: str, path: str) -> str:
    """A request as its route: the query dropped, each number as {n}."""
    import re

    return f"{method} " + re.sub(r"/\d+(?=/|$)", "/{n}", path.split("?")[0])


class _HttpLog:
    """Every request one ``BeaconNodeHttpClient`` makes: (route, ms)."""

    def __init__(self, client, patches):
        self.calls = []
        real = client._req

        def req(method, path, body=None):
            t0 = time.perf_counter()
            try:
                return real(method, path, body)
            finally:
                self.calls.append((_route(method, path), (time.perf_counter() - t0) * 1e3))

        patches.set(client, "_req", req)

    def by_route(self, since: int = 0) -> dict:
        out: dict = {}
        for route, ms in self.calls[since:]:
            d = out.setdefault(route, {"calls": 0, "ms": 0.0})
            d["calls"] += 1
            d["ms"] += ms
        return out


VC_DUTY_ROUTES = ("GET /eth/v1/beacon/states/head/validators",
                  "GET /eth/v1/validator/duties/proposer/{n}",
                  "POST /eth/v1/validator/duties/attester/{n}",
                  "POST /eth/v1/validator/duties/sync/{n}")
VC_PUBLISH_ROUTES = {"attestations": "POST /eth/v1/beacon/pool/attestations",
                     "aggregates": "POST /eth/v1/validator/aggregate_and_proofs",
                     "sync": "POST /eth/v1/beacon/pool/sync_committees",
                     "block": "POST /eth/v1/beacon/blocks"}


class _NodeVerdicts:
    """The node's verdict on every attestation, aggregate and sync message
    the chain judged, and its bls batches by route (calls and ms)."""

    ROUTES = {"attestations": "verify_unaggregated_attestations",
              "aggregates": "verify_aggregated_attestations",
              "sync": "verify_sync_committee_messages"}

    def __init__(self, chain, dev, patches):
        import threading

        self.results = {k: [] for k in self.ROUTES}
        self.calls = {k: 0 for k in self.ROUTES}
        self.verify_ms = {k: 0.0 for k in self.ROUTES}
        local = threading.local()
        real_batch = chain._batch_verify_items

        def batch(items):
            t0 = time.perf_counter()
            try:
                return real_batch(items)
            finally:
                _sync(dev)
                route = getattr(local, "route", None)
                if route is not None:
                    self.calls[route] += 1
                    self.verify_ms[route] += (time.perf_counter() - t0) * 1e3

        patches.set(chain, "_batch_verify_items", batch)
        for route, name in self.ROUTES.items():
            def judged(objs, _real=getattr(chain, name), _route=route):
                local.route = _route
                try:
                    res = _real(objs)
                finally:
                    local.route = None
                self.results[_route].extend(res)
                return res

            patches.set(chain, name, judged)


def _oracle_verdicts(spec, state, secret_key, results: dict) -> dict:
    """The oracle's verdict on each object the node judged, in order: each
    signature equal to sk * H(signing root), with the signing roots computed
    here from the node's state and ``secret_key(i)`` validator i's key (a
    valid signature under a known key is that one point)."""
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.ssz import uint64
    from lighthouse_tpu_torch.types.containers import SigningData
    from lighthouse_tpu_torch.types.helpers import (
        compute_signing_root,
        get_domain,
        sync_committee_signing_root,
    )

    points: dict = {}

    def signed(root: bytes, sk: int) -> bytes:
        if root not in points:
            points[root] = cs.hash_to_g2(root)
        return oc.g2_compress(oc.g2_mul(points[root], sk % R))

    def attestation_ok(att) -> bool:
        data = att.data
        committee = st.get_beacon_committee(spec, state, int(data.slot), int(data.index))
        members = [int(v) for v, bit in zip(committee, att.aggregation_bits) if bit]
        domain = get_domain(spec, state, spec.DOMAIN_BEACON_ATTESTER, epoch=int(data.target.epoch))
        return bytes(att.signature) == signed(compute_signing_root(data, domain),
                                              sum(secret_key(v) for v in members))

    def aggregate_ok(sap) -> bool:
        msg, slot = sap.message, int(sap.message.aggregate.data.slot)
        epoch = spec.compute_epoch_at_slot(slot)
        sk = secret_key(int(msg.aggregator_index))
        sel = SigningData(object_root=uint64.hash_tree_root(slot), domain=get_domain(
            spec, state, spec.DOMAIN_SELECTION_PROOF, epoch=epoch)).tree_root()
        env = compute_signing_root(msg, get_domain(spec, state, spec.DOMAIN_AGGREGATE_AND_PROOF,
                                                   epoch=epoch))
        return (bytes(msg.selection_proof) == signed(sel, sk)
                and bytes(sap.signature) == signed(env, sk) and attestation_ok(msg.aggregate))

    def sync_ok(m) -> bool:
        root = sync_committee_signing_root(spec, state, int(m.slot), bytes(m.beacon_block_root))
        return bytes(m.signature) == signed(root, secret_key(int(m.validator_index)))

    check = {"attestations": attestation_ok, "aggregates": aggregate_ok, "sync": sync_ok}
    return {route: [check[route](obj) for obj, _ in res] for route, res in results.items()}


def _vc_verdict_gate(what: str, spec, state, secret_key, nv, rejected: frozenset = frozenset()) -> dict:
    """Every object the node judged, as the oracle judges it, the oracle's
    False exactly at ``rejected`` ((route, position) pairs); the counts per
    route."""
    oracle = _oracle_verdicts(spec, state, secret_key, nv.results)
    for route, res in nv.results.items():
        node = [not isinstance(v, Exception) for _, v in res]
        want = [(route, j) not in rejected for j in range(len(res))]
        if node != oracle[route] or oracle[route] != want:
            raise RuntimeError(f"{what}: {route} node verdicts {node}, oracle {oracle[route]}, "
                               f"expected {want}")
    return {route: len(res) for route, res in nv.results.items()}


def vc_phase(spec, chain, node_a, sk0: int, dev) -> dict:
    """Phase 21 (a): a validator client against node A at full width. VC_KEYS
    keys of A's registry (``sk0 + i`` is validator i's; one per 64
    validators below 2^16, where the registry leaves no free range of
    1,008): a contiguous range, and VC_SYNC_KEYS members of the current sync
    committee, none seen attesting in the head epoch nor proposing at the
    driven slots (the range holds no other sync-committee member where the
    registry leaves such a range). A ``ProductionValidatorClient`` (the port's
    ``ValidatorStore``, ``BeaconNodeFallback`` and services) over a
    ``BeaconApiServer`` on A, its API client given VC_TIMEOUT_S instead of
    the 10 s that ``vc`` gives it (the epoch-after duty routes take 17-22 s
    at 2^20; with the default every poll times out, ROADMAP Queue 3):
    ``run_slot`` for VC_SLOTS slots of A's clock after its head (duties
    poll, attestations, selection proofs and aggregates, sync messages),
    every publish over HTTP and answered 200; one more POST of an
    attestation carrying another's signature answered 400; A's verdict on
    each object equal to the oracle's (False exactly for that one), the
    valid attestations in A's op pool, bls_device and epoch_device (the
    lookahead duties cross a boundary) clean, no plain version; the last
    slot under the profiler. A second ``ValidatorStore`` on the same
    slashing database is refused a double vote and nothing reaches the
    node; one doppelganger liveness check over the keys is timed and finds
    exactly the keys A saw attest. Counts are set to 0 before the part and
    read after it (``runs["vc"]``)."""
    import logging
    from types import SimpleNamespace

    import numpy as np

    from lighthouse_tpu_torch import bls, resilience
    from lighthouse_tpu_torch import state_transition as st
    from lighthouse_tpu_torch.api_client import BeaconNodeHttpClient
    from lighthouse_tpu_torch.http_api import BeaconApiServer
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.validator_client import DoppelgangerService, NotSafe, ValidatorStore
    from lighthouse_tpu_torch.validator_client import validator_store as vstore
    from lighthouse_tpu_torch.validator_client.runner import ProductionValidatorClient

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"vc: {what}")

    def secret_key(i):
        return sk0 + i

    out, ms, patches = {}, {}, _Patches()
    state, spe = chain.head.state, spec.preset.SLOTS_PER_EPOCH
    head_slot, n_val = int(chain.head.slot), len(state.validators)
    n_keys = min(VC_KEYS, n_val // 64)
    check(n_keys > VC_SYNC_KEYS, f"{n_val} validators are too few for a validator client")
    slots = [head_slot + 1 + k for k in range(VC_SLOTS)]
    epoch = head_slot // spe
    check(slots[-1] // spe == epoch, f"slots {slots} leave the head's epoch {epoch}")

    # the keys: none seen attesting this epoch, none proposing at the slots
    t = time.time()
    bad = np.zeros(n_val, dtype=bool)
    bad[sorted(chain._observed_attesters.get(epoch, ()))] = True
    proposers = [int(st.get_beacon_proposer_index(spec, state, slot=s)) for s in slots]
    bad[proposers] = True
    members = [chain.pubkey_cache.get_index(bytes(pk)) for pk in state.current_sync_committee.pubkeys]
    sync_keys = [v for v in dict.fromkeys(members) if not bad[v]][:VC_SYNC_KEYS]
    check(len(sync_keys) == VC_SYNC_KEYS, "too few sync-committee members free")
    n_range = n_keys - len(sync_keys)
    for excluded in (members, sync_keys):  # no other member in the range, if the registry allows
        bad_r = bad.copy()
        bad_r[excluded] = True
        csum = np.concatenate([[0], np.cumsum(bad_r, dtype=np.int64)])
        free = np.flatnonzero(csum[n_range:] == csum[:-n_range])
        if free.size:
            break
    check(free.size, "no free key range")
    first = int(free[0])
    indices = sync_keys + list(range(first, first + n_range))
    n_sync = len(set(indices) & set(members))
    out.update(keys=len(indices), range=[first, first + n_range - 1], sync_keys=sync_keys,
               sync_duty_keys=n_sync,
               slots=slots, head_slot=head_slot, validators=n_val,
               observed_attesters=int(len(chain._observed_attesters.get(epoch, ()))))

    server = BeaconApiServer(chain, op_pool=node_a.op_pool, network_service=node_a,
                             load_monitor=node_a.load_monitor).start()
    # not the 10 s that ``vc`` gives its client: the epoch-after duty routes outlast it at 2^20
    client = BeaconNodeHttpClient(server.url, timeout=VC_TIMEOUT_S)
    http = _HttpLog(client, patches)
    vc = ProductionValidatorClient(spec, [client])
    for i in indices:
        vc.store.add_validator_sk(bls.SecretKey.from_bytes((secret_key(i) % R).to_bytes(32, "big")))
    out["keys_s"] = time.time() - t
    sign_ms = [0.0]
    real_sign = vstore.SigningMethod.sign

    def timed_sign(self, root):
        t0 = time.perf_counter()
        try:
            return real_sign(self, root)
        finally:
            sign_ms[0] += (time.perf_counter() - t0) * 1e3

    posts = [0]
    real_post = server.publish_attestations

    def counted_post(body):
        posts[0] += 1
        return real_post(body)

    bls_sup, epoch_sup = resilience.bls_supervisor(), resilience.epoch_supervisor()
    try:
        t0 = time.perf_counter()
        vc.connect()
        ms["connect"] = (time.perf_counter() - t0) * 1e3
        patches.set(vstore.SigningMethod, "sign", timed_sign)
        patches.set(server, "publish_attestations", counted_post)
        nv = _NodeVerdicts(chain, dev, patches)
        bsnap, esnap = bls_sup.snapshot(), epoch_sup.snapshot()
        fm.reset_counts()
        slot_out = []
        for k, s in enumerate(slots):
            chain.slot_clock.set_slot(s)
            since, sign_ms[0] = len(http.calls), 0.0
            t0 = time.perf_counter()
            if k == len(slots) - 1:  # the steady slot under the profiler
                stats, prof_ms, dev_us, ops = _profiled(lambda: vc.run_slot(s))
                busy = sum(dev_us.values()) / 1e3
                prof = {"wall_ms": prof_ms, "busy_ms": busy, "aten_ops": ops,
                        "idle_share": 1 - busy / prof_ms}
            else:
                stats = vc.run_slot(s)
                prof = None
            # the profiled slot's wall is the profiler's own (its report costs seconds after)
            wall = prof["wall_ms"] if prof else (time.perf_counter() - t0) * 1e3
            routes = http.by_route(since)
            epoch_duties = vc.duties.attesters_at(s, epoch)
            check(stats["attested"] == len(epoch_duties) > 0 and not stats["proposed"]
                  and stats["sync_signed"] == n_sync
                  and VC_PUBLISH_ROUTES["attestations"] in routes
                  and VC_PUBLISH_ROUTES["sync"] in routes, f"slot {s}: {stats}")
            slot_out.append({
                "slot": s, "stats": stats, "wall_ms": wall, "sign_ms": sign_ms[0],
                "duties_poll_ms": {r: routes[r]["ms"] for r in VC_DUTY_ROUTES if r in routes},
                "duty_calls": [c for c in http.calls[since:] if c[0] in VC_DUTY_ROUTES],
                "publish_ms": {k_: routes[r]["ms"] for k_, r in VC_PUBLISH_ROUTES.items()
                               if r in routes},
                "routes": routes, "profile": prof,
            })
        # one attestation carrying another's signature: 400, and the node's False on the card
        atts = [a for a, _ in nv.results["attestations"]]
        check(len(atts) >= 2, f"{len(atts)} attestations")
        tampered = type(atts[0]).decode(type(atts[0]).encode(atts[0]))
        tampered.signature = atts[1].signature
        rejected = frozenset({("attestations", len(atts))})
        t0 = time.perf_counter()
        code, reply, _ = _http(server.url + "/eth/v1/beacon/pool/attestations", "POST",
                               [{"data": "0x" + type(tampered).encode(tampered).hex()}])
        _sync(dev)
        ms["tampered_post"] = (time.perf_counter() - t0) * 1e3
        failures = json.loads(json.loads(reply)["message"]) if code == 400 else None
        check(failures is not None and [f["index"] for f in failures] == [0]
              and len(nv.results["attestations"]) == len(atts) + 1,
              f"the tampered attestation: HTTP {code}, {reply[:300]!r}")
        check(vc.duties.validator_indices() == {bytes(state.validators[i].pubkey): i for i in indices},
              "the duties service's indices")
        _clean(bsnap, bls_sup.snapshot(), None, "bls_device")
        _clean(esnap, epoch_sup.snapshot(), None, "epoch_device")  # the lookahead duties' boundary

        # a second store on the same slashing database: a double vote is refused, nothing posted
        att0 = nv.results["attestations"][0][0]
        committee = st.get_beacon_committee(spec, state, int(att0.data.slot), int(att0.data.index))
        voter = int(committee[int(np.flatnonzero(np.asarray(att0.aggregation_bits))[0])])
        twin = ValidatorStore(spec, slashing_db=vc.store.slashing_db)
        pk = twin.add_validator_sk(bls.SecretKey.from_bytes((secret_key(voter) % R).to_bytes(32, "big")))
        other = type(att0.data).decode(type(att0.data).encode(att0.data))
        other.beacon_block_root = bytes(32)
        fork_info = vc.ctx.fork_info()
        n_calls, n_posts = len(http.calls), posts[0]
        try:
            twin.sign_attestation(pk, other, fork_info)
            refused = False
        except NotSafe:
            refused = True
        check(refused and len(http.calls) == n_calls and posts[0] == n_posts,
              "a second store on the slashing database signed a double vote")

        # one doppelganger liveness check over the keys
        watched = SimpleNamespace(validators=dict.fromkeys(vc.store.validators),
                                  doppelganger_suspect=set())
        dg = DoppelgangerService(watched, vc.client)
        dg.register_all(epoch)
        quiet = logging.getLogger("lighthouse_tpu_torch.doppelganger")
        level = quiet.level
        quiet.setLevel(logging.CRITICAL)  # one alert line per live key otherwise
        try:
            t0 = time.perf_counter()
            dg.check(epoch + 1, vc.duties.validator_indices())
            ms["doppelganger_check"] = (time.perf_counter() - t0) * 1e3
        finally:
            quiet.setLevel(level)
    finally:
        patches.undo()
        server.stop()
    runs = {"vc": _read_counts("vc: the validator client over node A")}

    counts = _vc_verdict_gate("vc", spec, state, secret_key, nv, rejected)
    valid = [(att, indexed) for att, indexed in nv.results["attestations"]
             if not isinstance(indexed, Exception)]
    voted = set()
    for att, indexed in valid:
        voted.update(int(i) for i in indexed.attesting_indices)
    check(set(dg.detected()) == {bytes(state.validators[i].pubkey) for i in voted},
          "the doppelganger check did not find exactly the keys A saw attest")
    for att, _ in valid:
        entry = node_a.op_pool._attestations.get(type(att.data).hash_tree_root(att.data))
        bits = np.asarray(att.aggregation_bits, dtype=bool)
        pooled = np.zeros(bits.size, dtype=bool)
        for b, _sig in (entry[1] if entry else ()):
            pooled |= np.asarray(b, dtype=bool)
        check(pooled[bits].all(), f"an attestation of slot {int(att.data.slot)} is not in A's op pool")
    out.update(ms=ms, slots_out=slot_out, judged=counts, verify_calls=nv.calls,
               verify_ms=nv.verify_ms, double_vote_refused=True, tampered_rejected=True,
               client_timeout_s=VC_TIMEOUT_S,
               doppelganger_detected=len(dg.detected()), runs=runs)
    poll = {r: sum(s_["duties_poll_ms"].get(r, 0.0) for s_ in slot_out) for r in VC_DUTY_ROUTES}
    log(f"vc over node A ({n_val} validators, head slot {head_slot}): {len(indices)} keys (range "
        f"{first}-{first + n_range - 1} and {len(sync_keys)} sync-committee members; "
        f"{n_sync} with sync duties) in "
        f"{out['keys_s']:.2f} s; slots {slots}: "
        + "; ".join(f"{s_['slot']}: {json.dumps(s_['stats'])} in {s_['wall_ms']:.1f} ms (sign "
                    f"{s_['sign_ms']:.1f} ms, publish "
                    f"{json.dumps({k: round(v, 1) for k, v in s_['publish_ms'].items()})})"
                    for s_ in slot_out)
        + f"; duties poll (ms) {json.dumps({k: round(v, 1) for k, v in poll.items()})}; judged "
        f"{json.dumps(counts)}, every verdict the oracle's; bls calls {json.dumps(nv.calls)}; "
        f"profiled slot: busy {slot_out[-1]['profile']['busy_ms']:.2f} of "
        f"{slot_out[-1]['profile']['wall_ms']:.1f} ms, idle share "
        f"{slot_out[-1]['profile']['idle_share']:.5f}; double vote refused with no request; "
        f"doppelganger check {ms['doppelganger_check']:.2f} ms ({len(dg.detected())} live); "
        f"the tampered attestation 400 in {ms['tampered_post']:.1f} ms; client timeout "
        f"{VC_TIMEOUT_S:.0f} s; launches {json.dumps(runs['vc']['by'])}")
    return out


def vc_cli_phase(c, dev, root: str) -> dict:
    """Phase 21 (b): the CLI's validator client on phase 19 (b)'s ``bn``
    node ``c`` (64 interop keys, minimal, electra), before its restart. ``account-manager`` and
    ``validator-manager create`` each write VC_CLI_KEYS EIP-2335 keystores
    (scrypt); a ``vc`` parsed by ``cli.build_parser()`` and built by
    ``cli.run_vc`` loads the first's keystores, interop keys 0-55 and, through
    ``--web3signer-url``, keys 56-63 from a ``MockWeb3Signer``, and serves
    its keymanager on an ephemeral port; ``validator-manager import`` and
    ``list`` go through it. ``run_slot`` for the current slot: the VC
    proposes (the node imports the block in one bls batch on the card, its
    head the block) and its attesters, aggregator and sync-committee
    members publish (each verdict the oracle's); remote keys sign real
    duties. A ``WatchService`` records the slot and its ``WatchServer``
    answers the head's root; a second proposal for the slot is refused by
    slashing protection before any HTTP request. Counts are set to 0 before
    the part and read after it (``runs["vc_cli"]``)."""
    import contextlib
    import io
    import urllib.request

    from lighthouse_tpu_torch import bls, cli
    from lighthouse_tpu_torch.keys import derive_sk_from_path
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.oracle import ciphersuite as cs
    from lighthouse_tpu_torch.oracle import curves as oc
    from lighthouse_tpu_torch.state_transition.genesis import interop_secret_keys
    from lighthouse_tpu_torch.validator_client import MockWeb3Signer, NotSafe
    from lighthouse_tpu_torch.validator_client import web3signer
    from lighthouse_tpu_torch.watch import WatchDB, WatchServer, WatchService

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"vc cli: {what}")

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return res

    def quiet(fn):
        """``fn()`` with what it prints captured: (result, printed JSON)."""
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            res = fn()
        return res, json.loads(buf.getvalue())

    chain, ms, patches = c.chain, {}, _Patches()
    spec, url = chain.spec, c.http_server.url
    n_keys = len(chain.head.state.validators)
    sks = interop_secret_keys(n_keys)
    parser = cli.build_parser()
    forks = [a for f in ("altair", "bellatrix", "capella", "deneb", "electra")
             for a in (f"--{f}-fork-epoch", "0")]
    am_dir, vm_dir = os.path.join(root, "am"), os.path.join(root, "vm")
    fm.reset_counts()

    def derived(i):
        sk = derive_sk_from_path(bytes.fromhex(VC_SEED), f"m/12381/3600/{i}/0/0")
        return "0x" + oc.g1_compress(cs.sk_to_pk(sk)).hex()

    _, wrote = timed("account_manager", lambda: quiet(lambda: cli.run_account_manager(parser.parse_args(
        ["am", "--output-dir", am_dir, "--count", str(VC_CLI_KEYS), "--password", "pw",
         "--mnemonic-seed", VC_SEED]))))
    check(len(wrote["wrote"]) == VC_CLI_KEYS, f"account-manager wrote {wrote}")
    _, wrote = timed("vm_create", lambda: quiet(lambda: cli.run_validator_manager(parser.parse_args(
        ["vm", "create", "--output-dir", vm_dir, "--count", str(VC_CLI_KEYS), "--first-index",
         str(VC_CLI_KEYS), "--password", "pw", "--mnemonic-seed", VC_SEED]))))
    check(len(wrote["wrote"]) == VC_CLI_KEYS, f"validator-manager create wrote {wrote}")
    n_local = n_keys - VC_CLI_REMOTE
    signer = MockWeb3Signer([bls.SecretKey.from_bytes(sk.to_bytes(32, "big"))
                             for sk in sks[n_local:]]).start()
    vc = None
    remote = [0]
    real_remote = web3signer.Web3SignerMethod.sign

    def counted_remote(self, root):
        remote[0] += 1
        return real_remote(self, root)

    try:
        vc = timed("vc_build", lambda: cli.run_vc(parser.parse_args(
            ["vc", "--preset", "minimal", *forks, "--beacon-node", url, "--validators-dir", am_dir,
             "--password", "pw", "--interop-validators", str(n_local), "--web3signer-url",
             signer.url, "--keymanager-port", "0"])))
        km = vc.keymanager.url
        _, imported = timed("vm_import", lambda: quiet(lambda: cli.run_validator_manager(
            parser.parse_args(["vm", "import", "--keystores-dir", vm_dir, "--password", "pw",
                               "--vc-url", km]))))
        check(imported == [{"status": "imported"}] * VC_CLI_KEYS, f"validator-manager import: {imported}")
        _, listed = timed("vm_list", lambda: quiet(lambda: cli.run_validator_manager(
            parser.parse_args(["vm", "list", "--vc-url", km]))))
        local = {"0x" + bls.SecretKey.from_bytes(sk.to_bytes(32, "big")).public_key().serialize().hex()
                 for sk in sks[:n_local]}
        local |= {derived(i) for i in range(2 * VC_CLI_KEYS)}
        check({d["validating_pubkey"] for d in listed} == local and len(listed) == len(local),
              f"validator-manager list: {len(listed)} keystores")
        check(len(vc.keymanager.list_remotekeys()) == VC_CLI_REMOTE, "the remote keys")

        # the current slot's duties
        while chain.current_slot() <= int(chain.head.slot):
            time.sleep(0.2)
        slot = chain.current_slot()
        http = _HttpLog(vc.client.candidates[0].client, patches)
        nv = _NodeVerdicts(chain, dev, patches)
        patches.set(web3signer.Web3SignerMethod, "sign", counted_remote)
        batches, in_block = [], [False]
        real_verify, real_import = bls.verify_signature_sets, chain.process_block

        def counting(sets, *, device=None):
            sets = list(sets)
            if in_block[0]:
                batches.append(len(sets))
            return real_verify(sets, device=device)

        def importing(*a, **k):  # the block's own bls batches, apart from the gossip routes'
            in_block[0] = True
            try:
                return real_import(*a, **k)
            finally:
                in_block[0] = False

        patches.set(bls, "verify_signature_sets", counting)
        patches.set(chain, "process_block", importing)
        stats = timed("run_slot", lambda: vc.run_slot(slot))
        _sync(dev)
        patches.undo()
        routes = http.by_route()
        head = chain.head
        block = chain.get_signed_block(head.root).message
        duty = vc.duties.proposers_at(slot, slot // spec.preset.SLOTS_PER_EPOCH)[0]
        check(stats["proposed"] and int(head.slot) == slot and int(block.proposer_index)
              == duty.validator_index and len(batches) == 1,
              f"slot {slot}: {stats}, head slot {int(head.slot)}, bls batches {batches}")
        check(stats["attested"] > 0 and stats["aggregated"] > 0 and stats["sync_signed"] > 0
              and remote[0] > 0, f"slot {slot}: {stats}, {remote[0]} remote signatures")
        counts = _vc_verdict_gate("vc cli", spec, head.state, lambda i: sks[i], nv)
        check(counts == {"attestations": stats["attested"], "aggregates": stats["aggregated"],
                         "sync": stats["sync_signed"]}, f"judged {counts}, published {stats}")

        # watch records the slot; its server answers the head's root
        wdb = WatchDB()
        rows = timed("watch_update", lambda: WatchService(wdb, url, spec).update())
        wserver = WatchServer(wdb).start()
        try:
            code, body, _ = _http(wserver.url + "/v1/slots/highest")
            got = json.loads(body)["data"] if code == 200 else None
            code2, body2, _ = _http(wserver.url + f"/v1/blocks/{slot}")
            blk = json.loads(body2)["data"] if code2 == 200 else None
        finally:
            wserver.stop()
            wdb.close()
        check(got == {"slot": slot, "root": "0x" + head.root.hex(), "skipped": False}
              and blk is not None and blk["proposer_index"] == duty.validator_index,
              f"watch: {got}, {blk}")

        # a second proposal for the slot: refused before any request
        fork_info = vc.ctx.fork_info()
        other = type(block).decode(type(block).encode(block))
        other.body.graffiti = b"\x01" * 32
        n_open = [0]
        real_open = urllib.request.urlopen

        def counted_open(*a, **k):
            n_open[0] += 1
            return real_open(*a, **k)

        patches.set(urllib.request, "urlopen", counted_open)
        try:
            vc.store.sign_block(duty.pubkey, other, fork_info)
            refused = False
        except NotSafe:
            refused = True
        finally:
            patches.undo()
        check(refused and n_open[0] == 0, f"the second proposal: refused {refused}, "
              f"{n_open[0]} requests")
    finally:
        patches.undo()
        if vc is not None:
            vc.stop()
            vc.keymanager.stop()
        signer.stop()
    runs = {"vc_cli": _read_counts("vc cli: the CLI's validator client on the bn node")}
    out = {"slot": slot, "stats": stats, "ms": ms, "routes": routes, "judged": counts,
           "verify_calls": nv.calls, "verify_ms": nv.verify_ms, "block_sets": batches[0],
           "remote_signatures": remote[0], "imported": imported, "keystores_listed": len(listed),
           "watch_rows": rows, "runs": runs}
    log(f"vc cli on the bn node ({n_keys} interop keys): keystores am {ms['account_manager']:.0f} ms, "
        f"vm create {ms['vm_create']:.0f} ms, vc built {ms['vc_build']:.0f} ms ({n_local} interop, "
        f"{VC_CLI_KEYS} keystores, {VC_CLI_REMOTE} remote), vm import {ms['vm_import']:.0f} ms, list "
        f"{len(listed)}; slot {slot}: {json.dumps(stats)} in {ms['run_slot']:.1f} ms (block of "
        f"{batches[0]} sets in one bls batch on the card, the head; {remote[0]} remote signatures; "
        f"judged {json.dumps(counts)}, every verdict the oracle's); watch {rows} rows in "
        f"{ms['watch_update']:.1f} ms, the head's root served; a second proposal refused with no "
        f"request; launches {json.dumps(runs['vc_cli']['by'])}")
    return out


VECTOR_CASES = 99  # cases under tests/vectors (run_all on the CPU counts the same)
VECTOR_FORKS = ("phase0", "altair", "bellatrix", "capella", "deneb", "electra")


def conformance_phase(dev) -> dict:
    """Phase 20 (a): ``conformance.run_all(device=dev)`` over the repo's
    vector tree (nothing pruned): every case passes, every file consumed,
    VECTOR_CASES cases; the bls, epoch and KZG backends on the card for the
    run; every epoch boundary of the state families on the device engine,
    counted per fork (each fork's count above 0, none on numpy); clean
    ``bls_device``, ``epoch_device`` and ``kzg_device`` supervisors; counts
    set to 0 before and read after (``runs["conformance"]``), the plain
    version never run. Each family timed, with its launches by entry."""
    from lighthouse_tpu_torch import conformance, epoch_engine, resilience
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    sups = {"bls_device": resilience.bls_supervisor(),
            "epoch_device": resilience.epoch_supervisor(),
            "kzg_device": resilience.kzg_supervisor()}
    snaps = {k: sup.snapshot() for k, sup in sups.items()}
    fams, cur = {}, {}

    def observer(event, fork, runner, n):
        _sync(dev)
        if event == "start":
            cur.update(t=time.perf_counter(), by=dict(fm.launches_by), n=n)
            return
        f = fams.setdefault(runner, {"s": 0.0, "cases": 0, "forks": [],
                                     "by": dict.fromkeys(fm.launches_by, 0)})
        f["s"] += time.perf_counter() - cur["t"]
        f["cases"] += n - cur["n"]
        f["forks"].append(fork)
        for k, v in fm.launches_by.items():
            f["by"][k] += v - cur["by"][k]

    epoch_engine.reset_boundary_counts()
    fm.reset_counts()
    t0 = time.perf_counter()
    n = conformance.run_all(device=dev, observer=observer)
    _sync(dev)
    run_s = time.perf_counter() - t0
    runs = {"conformance": _read_counts("conformance")}
    if n != VECTOR_CASES:
        raise RuntimeError(f"conformance: {n} cases ran, the vector tree holds {VECTOR_CASES}")
    bounds = epoch_engine.boundary_counts()
    per_fork = {f: bounds.get((f, "device"), 0) for f in VECTOR_FORKS}
    off = {f"{k[0]}/{k[1]}": v for k, v in bounds.items() if k[1] != "device"}
    if off or not all(per_fork.values()):
        raise RuntimeError(f"conformance: epoch boundaries per fork {per_fork}, off the device {off}")
    for name, sup in sups.items():
        _clean(snaps[name], sup.snapshot(), None, name)
    out = {"cases": n, "run_s": run_s, "boundaries": per_fork, "families": fams,
           "launches": runs["conformance"]["by"], "runs": runs}
    log(f"conformance: run_all(device={dev}) over tests/vectors: {n} cases passed, every file "
        f"consumed, in {run_s:.2f} s; epoch boundaries on the device engine per fork "
        f"{json.dumps(per_fork)}, none on numpy; bls_device, epoch_device and kzg_device clean; "
        f"launches {json.dumps(runs['conformance']['by'])}")
    for name, f in fams.items():
        log(f"conformance family {name}: {f['cases']} cases over {len(f['forks'])} forks in "
            f"{f['s']:.2f} s; launches {json.dumps(f['by'])}")
    return out


def native_phase(block, block_bad, device_verdicts, device_half) -> dict:
    """Phase 20 (b): phase 8's block and its poisoned twin through
    ``bls.set_backend("native")`` (the C++ backend built from the checkout
    with g++): verdicts equal to the card's (True, False); each timed beside
    phase 8's device half. The backend is restored after."""
    from lighthouse_tpu_torch import bls

    prev = bls.get_backend(), bls.get_device()
    bls.set_backend("native")
    try:
        t0 = time.perf_counter()
        ok = bls.verify_signature_sets(block)
        t1 = time.perf_counter()
        bad = bls.verify_signature_sets(block_bad)
        t2 = time.perf_counter()
    finally:
        bls.set_backend(prev[0], device=prev[1])
    if (ok, bad) != tuple(device_verdicts) or (ok, bad) != (True, False):
        raise RuntimeError(f"native: verdicts {(ok, bad)} != the card's {device_verdicts}")
    out = {"valid_ms": (t1 - t0) * 1e3, "poisoned_ms": (t2 - t1) * 1e3,
           "device_half_ms": device_half}
    log(f"native: phase 8's block ({len(block)} sets, "
        f"{sum(len(x.signing_keys) for x in block)} compressed keys) through the C++ backend: "
        f"True in {out['valid_ms']:.2f} ms, the poisoned twin False in {out['poisoned_ms']:.2f} ms "
        f"(the card's device half {json.dumps(device_half)} ms); verdicts == the card's")
    return out


def _cli_digest() -> bytes:
    """The fork digest of the CLI nodes' interop genesis (minimal, electra at
    epoch 0): what their ENRs advertise and the boot node must too."""
    from lighthouse_tpu_torch.state_transition.genesis import interop_genesis_state
    from lighthouse_tpu_torch.types.helpers import compute_fork_digest
    from lighthouse_tpu_torch.types.spec import minimal_spec

    spec = minimal_spec(**{f"{f}_fork_epoch": 0 for f in VECTOR_FORKS[1:]})
    state = interop_genesis_state(spec, CLI_VALIDATORS, 0)
    return compute_fork_digest(bytes(state.fork.current_version),
                               bytes(state.genesis_validators_root))


def start_enr_boot_node(root: str):
    """``python -m lighthouse_tpu_torch boot-node --enr`` in a subprocess on
    127.0.0.1 (an ephemeral UDP port), advertising the CLI nodes' fork
    digest; its log goes to ``root``. Returns the process (its ENR is the
    first line of its stdout)."""
    log_f = open(os.path.join(root, "boot_node.log"), "w")
    return subprocess.Popen(
        [sys.executable, "-m", "lighthouse_tpu_torch", "boot-node", "--enr", "--host",
         "127.0.0.1", "--port", "0", "--fork-digest", _cli_digest().hex()],
        cwd=HERE, stdout=subprocess.PIPE, stderr=log_f, text=True)


def _read_enr(proc, timeout: float) -> str:
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    if not ready:
        raise RuntimeError(f"discovery: the boot node printed no ENR in {timeout} s")
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"discovery: the boot node exited ({proc.poll()})")
    return json.loads(line)["enr"]


def discovery_phase(dev, proc, root: str) -> dict:
    """Phase 20 (c): two ``bn`` nodes (``cli.run_bn`` in process, as phase
    19's: CLI_VALIDATORS interop keys, minimal, electra at epoch 0, on the
    card) given only the ENR boot node's record (``--boot-enrs``, no
    ``--boot-nodes``) and ephemeral TCP listeners. Node 2's startup lookup
    finds node 1 and dials it; node 1's next lookup finds node 2; each
    holds the other in its routing table and as a TCP peer. A block for
    the current slot produced by node 1 and published to it as SSZ (its
    bls batch on the card) reaches node 2's head over gossip (node 2's
    batch on the card too): counts set to 0 before the publish, read after
    node 2's head moved (``runs["discovery_publish"]``)."""
    from lighthouse_tpu_torch import bls, cli
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    out, runs = {}, {}
    t0 = time.perf_counter()
    enr = _read_enr(proc, 300.0)
    out["boot_node_s"] = time.perf_counter() - t0  # beyond phase 20 (a) and (b)
    genesis_time = int(time.time()) - 2 * 6  # two minimal slots old
    forks = [a for f in VECTOR_FORKS[1:] for a in (f"--{f}-fork-epoch", "0")]
    parser = cli.build_parser()

    def boot(name):
        t = time.perf_counter()
        c = cli.run_bn(parser.parse_args([
            "bn", "--preset", "minimal", "--interop-validators", str(CLI_VALIDATORS),
            "--http-port", "0", "--listen-port", "0", "--boot-enrs", enr,
            "--genesis-time", str(genesis_time), *forks]))
        warm = c.wait_for_warmup(600)
        if not warm or warm["healthy"] is not True:
            c.stop()
            raise RuntimeError(f"discovery: {name}: the warm-up reported {warm}")
        return c, time.perf_counter() - t

    nodes = []
    try:
        c1, out["node1_boot_s"] = boot("node 1")
        nodes.append(c1)
        c2, out["node2_boot_s"] = boot("node 2")
        nodes.append(c2)
        t1, t2 = (c.network_service.transport for c in (c1, c2))
        t = time.perf_counter()
        t1.discover_enr()  # node 1's next lookup: node 2 joined after node 1's first one
        out["lookup_ms"] = (time.perf_counter() - t) * 1e3

        def known(a, b):
            return b.discovery.enr.node_id in {e.node_id for e in a.discovery.table.all_records()}

        _wait_for(lambda: known(t1, t2) and known(t2, t1), 30.0, "each node in the other's table")
        _wait_for(lambda: t1.local_addr in t2.peers() and t2.local_addr in t1.peers(), 30.0,
                  "the two nodes peered")
        out["peered_s"] = time.perf_counter() - t0
        _wait_for(lambda: t1._topic_peers("beacon_block") and t2._topic_peers("beacon_block"),
                  30.0, "block topic subscriptions")
        signed, version, slot, _, out["produce_ms"] = _cli_block(c1)
        root_b = signed.message.tree_root()
        batches, patches = [], _Patches()
        real_verify = bls.verify_signature_sets

        def counting(sets, *, device=None):
            sets = list(sets)
            batches.append(len(sets))
            return real_verify(sets, device=device)

        patches.set(bls, "verify_signature_sets", counting)
        fm.reset_counts()
        t = time.perf_counter()
        try:
            code, reply, _ = _http(c1.http_server.url + "/eth/v1/beacon/blocks", "POST",
                                   c1.chain.ns.block_types[version].encode(signed),
                                   {"Content-Type": "application/octet-stream",
                                    "Eth-Consensus-Version": version})
            if code != 200:
                raise RuntimeError(f"discovery: publish HTTP {code} {reply[:200]!r}")
            _wait_for(lambda: c2.chain.head.root == root_b, 60.0, "node 2's head at the block")
            _sync(dev)
        finally:
            patches.undo()
        out["gossip_ms"] = (time.perf_counter() - t) * 1e3
        runs["discovery_publish"] = _read_counts("discovery: the block publish and its gossip")
        if c1.chain.head.root != root_b or len(batches) != 2:
            raise RuntimeError(f"discovery: node 1 head {c1.chain.head.root.hex()[:16]}, bls "
                               f"batches {batches} (node 1's import and node 2's)")
        out.update(slot=slot, fork=version, batches=batches)
    finally:
        for c in nodes:
            c.stop()
    out["runs"] = runs
    log(f"discovery: an ENR boot node in a subprocess (its record after {out['boot_node_s']:.2f} s "
        f"beyond (a) and (b)); bn 1 booted in {out['node1_boot_s']:.2f} s and bn 2 in "
        f"{out['node2_boot_s']:.2f} s (warm-ups joined) on --boot-enrs alone; node 1's second "
        f"lookup {out['lookup_ms']:.1f} ms; each node in the other's routing table and peered "
        f"{out['peered_s']:.2f} s after the boot node's record; a block at slot {slot} "
        f"({version}) published to node 1 reached node 2's head over gossip in "
        f"{out['gossip_ms']:.2f} ms (bls batches {batches}, node 1's and node 2's, on the card); "
        f"launches {json.dumps(runs['discovery_publish']['by'])}")
    return out


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(10)


# --------------------------------------------------------------------------------------
# The local network, the session fabricator and Karabina squaring (phase 22)
# --------------------------------------------------------------------------------------

LN_NODES = 4
LN_VALIDATORS = CLI_VALIDATORS  # phase 19 (b)'s interop cut: the oracle derives every key
LN_LOSS = 0.02  # seeded gossip loss (the reference's chaos scenario)
LN_MAX_SLOTS = 64  # 8 minimal epochs: finality at >= 2 comes by slot ~33
LN_KILL_SLOT = 10  # the kill plan goes in before this slot
LN_KILL_AT = 9  # the WAL frame barrier (store.commit) it kills at
LN_RESTART_AFTER = 2  # slots the killed node stays down
LN_PROFILED_SLOT = 24  # the slot run under the profiler
LN_SESSIONS = 16  # phase 22 (b): fabricated light-client sessions
KAR_REPS = 2  # phase 22 (c): timed repeats (after a warm-up) of each arm's |x| power and final exponentiation (5 until phase 23)
DOMAINS = ("bls", "epoch", "slasher", "lc")


def _domain_snapshots() -> dict:
    from lighthouse_tpu_torch import resilience

    sups = {"bls": resilience.bls_supervisor, "epoch": resilience.epoch_supervisor,
            "slasher": resilience.slasher_supervisor, "lc": resilience.lc_supervisor}
    return {k: sups[k]().snapshot() for k in DOMAINS}


def _domains_clean(before: dict, what: str) -> dict:
    """No fault domain faulted, fell back, was demoted or quarantined since
    ``before``; returns the snapshots."""
    after = _domain_snapshots()
    for k in DOMAINS:
        moved = {c: after[k][c] - before[k][c]
                 for c in ("faults", "demotions", "fallback_calls", "exhausted")
                 if after[k][c] != before[k][c]}
        if moved or after[k]["state"] != "HEALTHY" or after[k]["hard_quarantined"]:
            raise RuntimeError(f"{what}: the {k} fault domain moved: {moved}, {after[k]}")
    return after


def _tampered_attestation(net):
    """An attestation of node 0's head carrying another attester's
    signature (the reference chaos scenario's adversarial item)."""
    node = net.nodes[0]
    slot = int(node.chain.head.slot)
    atts = net.harness.unaggregated_attestations_for_slot(node.chain.head.state, slot,
                                                          node.chain.head.root)
    if len(atts) < 2:
        raise RuntimeError(f"local network: {len(atts)} attesters at slot {slot}")
    bad = atts[0]
    bad.signature = atts[1].signature
    return bad


def _tampered_block(net, slot: int):
    """Node 0's proposal for ``slot`` on its head, with its randao reveal
    right and its block signature made by the next validator's key."""
    from lighthouse_tpu_torch.ssz import uint64
    from lighthouse_tpu_torch.state_transition import (
        get_beacon_proposer_index, get_current_epoch, process_slots,
    )
    from lighthouse_tpu_torch.types.containers import SigningData
    from lighthouse_tpu_torch.types.helpers import compute_signing_root, get_domain

    spec, chain = net.spec, net.nodes[0].chain
    net.clock.set_slot(slot)
    state = chain.head.state.copy()
    process_slots(spec, state, slot)
    proposer = get_beacon_proposer_index(spec, state)
    epoch = get_current_epoch(spec, state)
    domain_r = get_domain(spec, state, spec.DOMAIN_RANDAO, epoch=epoch)
    reveal = net.harness._sign(proposer, SigningData(
        object_root=uint64.hash_tree_root(epoch), domain=domain_r).tree_root())
    block, _ = chain.produce_block_on_state(chain.head.state, slot, reveal)
    domain_b = get_domain(spec, state, spec.DOMAIN_BEACON_PROPOSER, epoch=epoch)
    wrong = (proposer + 1) % len(state.validators)
    sig = net.harness._sign(wrong, compute_signing_root(block, domain_b))
    return chain.ns.block_types[spec.fork_name_at_epoch(epoch)](message=block, signature=sig)


def local_network_phase(dev, root: str, seed: int) -> dict:
    """Phase 22 (a): LN_NODES nodes of the port's ``LocalNetwork`` on the
    card until every node finalizes at >= 2, one node killed at a WAL
    barrier and restarted from disk; then a tampered attestation and a
    tampered block offered to every node."""
    import torch

    from lighthouse_tpu_torch import bls, epoch_engine, slasher
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.resilience.inject import injector
    from lighthouse_tpu_torch.slasher import SlasherConfig
    from lighthouse_tpu_torch.testing import LocalNetwork
    from lighthouse_tpu_torch.types.spec import minimal_spec

    bls.set_backend("device", device=dev)
    epoch_engine.set_backend("device", device=dev)
    slasher.set_backend("device", device=dev)
    before = _domain_snapshots()
    spec = minimal_spec(altair_fork_epoch=0)
    t = time.time()
    net = LocalNetwork(spec, LN_NODES, LN_VALIDATORS, slasher=True, sync_committee=True,
                       datadir=root, device=dev, batch_gossip=True,
                       slasher_config=SlasherConfig(validator_chunk_size=16, history_length=64))
    net.transport.set_gossip_loss(LN_LOSS, seed=seed)
    build_s = time.time() - t
    torch.cuda.reset_peak_memory_stats()
    fm.reset_counts()
    slot_ms, crash, report, prof = [], None, None, None
    slot = 0
    try:
        while slot < LN_MAX_SLOTS:
            slot += 1
            if slot == LN_KILL_SLOT:
                injector.install(f"stage=store.commit;mode=kill;at={LN_KILL_AT}")
            t = time.time()
            if slot == LN_PROFILED_SLOT:
                _, wall_ms, dev_us, host_ops = _profiled(lambda: net.run_slot(slot))
                busy = sum(dev_us.values()) / 1e3
                prof = {"slot": slot, "wall_ms": wall_ms, "busy_ms": busy, "aten_ops": host_ops,
                        "idle_share": 1 - busy / wall_ms if busy else None}
            else:
                net.run_slot(slot)
                torch.cuda.synchronize()
                slot_ms.append((time.time() - t) * 1e3)
            if net.dead and crash is None:
                injector.clear()
                i = next(iter(net.dead))
                crash = {"node": i, "slot": slot, "head_slot": int(net.nodes[i].chain.head.slot),
                         "head_root": bytes(net.nodes[i].chain.head.root).hex()}
            if crash is not None and report is None and slot == crash["slot"] + LN_RESTART_AFTER:
                net.restart_node(crash["node"], from_disk=True)
                report = dict(net.recovery_reports[-1])
            if (report is not None and slot > crash["slot"] + LN_RESTART_AFTER + 1
                    and slot > LN_PROFILED_SLOT and min(net.finalized_epochs()) >= 2
                    and net.heads_agree()):
                break
    finally:
        injector.clear()
    torch.cuda.synchronize()
    runs = {"local_net": _read_counts("local network")}
    peak = torch.cuda.max_memory_allocated()
    if crash is None or report is None:
        raise RuntimeError(f"local network: the kill at barrier {LN_KILL_AT} never fired")
    fins = net.finalized_epochs()
    if not net.heads_agree() or min(fins) < 2:
        raise RuntimeError(f"local network: heads {net.head_slots()} finalized {fins} after "
                           f"{slot} slots")
    if not (report["fc_nodes"] > 0 and crash["head_slot"] - 1 <= report["head_slot"]
            <= crash["head_slot"]):
        raise RuntimeError(f"local network: recovery report {report} against the pre-crash "
                           f"head {crash}")
    back = net.nodes[crash["node"]].chain.head
    if bytes(back.root) != bytes(net.nodes[0].chain.head.root):
        raise RuntimeError("local network: the restarted node is not at the network's head")
    for i, n in enumerate(net.nodes):
        slashed = [v for v, val in enumerate(n.chain.head.state.validators) if val.slashed]
        pooled = len(n.op_pool._attester_slashings) + len(n.op_pool._proposer_slashings)
        if slashed or pooled:
            raise RuntimeError(f"local network: node {i}'s slasher convicted an honest "
                               f"validator: slashed {slashed}, {pooled} pooled")
    # the tampered objects, offered to every node but the one that makes them
    fm.reset_counts()
    bad_att = _tampered_attestation(net)
    bad_block = _tampered_block(net, slot + 1)
    verdicts = []
    for i, n in enumerate(net.nodes[1:], start=1):
        res = n.chain.verify_unaggregated_attestations([bad_att])
        head = bytes(n.chain.head.root)
        try:
            n.chain.process_block(bad_block)
            block_refused, why = False, None
        except Exception as e:  # noqa: BLE001 — any refusal; the head must stay put too
            block_refused, why = bytes(n.chain.head.root) == head, f"{type(e).__name__}: {e}"[:120]
        verdicts.append({"node": i, "attestation_refused": isinstance(res[0][1], Exception),
                         "attestation_why": str(res[0][1])[:120],
                         "block_refused": block_refused, "block_why": why})
    torch.cuda.synchronize()
    runs["local_net_tampered"] = _read_counts("local network tampered objects")
    if not all(v["attestation_refused"] and v["block_refused"] for v in verdicts):
        raise RuntimeError(f"local network: a tampered object was accepted: {verdicts}")
    domains = _domains_clean(before, "local network")
    n_slots = len(slot_ms) + 1
    by = runs["local_net"]["by"]
    calls = runs["local_net"]["by_name"].get(("CHAIN", "cyc_exp_abs_x"), 0) / 5
    out = {
        "nodes": LN_NODES, "validators": LN_VALIDATORS, "slots": n_slots, "build_s": build_s,
        "slot_ms": _spread(slot_ms), "finalized": fins, "head_slot": int(net.nodes[0].chain.head.slot),
        "missed_proposals": net.missed_proposals, "crash": crash,
        "recovery": {k: (v.hex() if isinstance(v, bytes) else v) for k, v in report.items()},
        "gossip_delivered": net.transport.gossip_delivered,
        "gossip_dropped": net.transport.gossip_dropped,
        "verify_calls_per_slot_per_node": calls / n_slots / LN_NODES,
        "launches_per_slot_per_node": {k: v / n_slots / LN_NODES for k, v in by.items()},
        "profiled": prof, "peak_bytes": peak, "tampered": verdicts, "domains": domains,
        "runs": runs, "net": net,
    }
    log(f"local network: {LN_NODES} nodes x {LN_VALIDATORS} validators (minimal, altair from "
        f"genesis, slasher and sync committees, gossip loss {LN_LOSS}) built in {build_s:.1f} s; "
        f"{n_slots} slots to finalized {fins}, heads agree; ms per slot "
        f"{json.dumps(out['slot_ms'])}; {out['verify_calls_per_slot_per_node']:.2f} verify "
        f"calls and launches {json.dumps({k: round(v, 1) for k, v in out['launches_per_slot_per_node'].items()})} "
        f"per slot per node; node {crash['node']} killed at barrier {LN_KILL_AT} in slot "
        f"{crash['slot']} (head slot {crash['head_slot']}), recovered from disk in "
        f"{report['recovery_s']:.3f} s to head slot {report['head_slot']} with "
        f"{report['fc_nodes']} fork-choice nodes, back at the head; tampered attestation and "
        f"block refused by nodes 1-{LN_NODES - 1}; no slashing; {net.missed_proposals} missed "
        f"proposals; gossip {out['gossip_delivered']} delivered, {out['gossip_dropped']} "
        f"dropped; profiled slot {json.dumps(prof)}; peak {peak} bytes")
    return out


def lc_fabricated_phase(net, dev, seed: int) -> dict:
    """Phase 22 (b): LN_SESSIONS sessions from ``fabricate_lc_sessions`` on
    the network's altair harness, through the port's LC engine on the card,
    beside the host loop (native backend; two sessions on the oracle too)."""
    import torch

    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.light_client import engine
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.testing import fabricate_lc_sessions, tamper_session

    t = time.time()
    sessions, gvr = fabricate_lc_sessions(net.harness, LN_SESSIONS, seed)
    bad = [tamper_session(sessions[3], "signature")]
    fixture_s = time.time() - t
    before = _domain_snapshots()
    bls.set_backend("device", device=dev)
    engine.set_lc_backend("device", device=dev)
    engine.verify_update_batch(net.spec, sessions, gvr)  # warm-up: the committee rows
    torch.cuda.synchronize()
    fm.reset_counts()
    t = time.time()
    got = engine.verify_update_batch(net.spec, sessions, gvr)
    torch.cuda.synchronize()
    batch_ms = (time.time() - t) * 1e3
    got_bad = engine.verify_update_batch(net.spec, bad, gvr)
    torch.cuda.synchronize()
    runs = {"lc_fabricated": _read_counts("fabricated sessions")}
    engine.set_lc_backend("host")
    bls.set_backend("native")
    t = time.time()
    host = engine.verify_update_batch(net.spec, sessions + bad, gvr)
    host_ms = (time.time() - t) * 1e3
    bls.set_backend("oracle")
    oracle = engine.verify_update_batch(net.spec, [sessions[0]] + bad, gvr)
    bls.set_backend("device", device=dev)
    engine.set_lc_backend("device", device=dev)
    if got + got_bad != host or host != [True] * LN_SESSIONS + [False]:
        raise RuntimeError(f"fabricated sessions: card {got + got_bad} != host loop {host}")
    if oracle != [True, False]:
        raise RuntimeError(f"fabricated sessions: oracle {oracle}")
    _domains_clean(before, "fabricated sessions")
    log(f"fabricated sessions: {LN_SESSIONS} over the network's genesis sync committee "
        f"({net.spec.preset.SYNC_COMMITTEE_SIZE} keys) built in {fixture_s:.2f} s; the batch on "
        f"the card {batch_ms:.2f} ms, all True, a tampered signature False; the host loop "
        f"(native) {host_ms:.1f} ms, equal; the oracle equal on two; launches "
        f"{json.dumps(runs['lc_fabricated']['by'])}")
    return {"sessions": LN_SESSIONS, "fixture_s": fixture_s, "batch_ms": batch_ms,
            "host_ms": host_ms, "runs": runs}


def karabina_phase(cache, batch, poisoned, dev, gen) -> dict:
    """Phase 22 (c): one main-path batch verified with the Karabina switch
    off and on; each arm's |x| power, final exponentiation and batch timed;
    KARABINA_SQR held bit-exact against its plain version."""
    import torch

    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.bls import backend
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm, pairing, tower

    bls.set_backend("device", device=dev)
    b = backend.prepare_batch(batch, device=dev)
    mxa, mya = backend.h2c_stage(b["u0"], b["u1"])
    pre = backend.prep_stage(cache, b["idx"], b["mask"], b["sxc0"], b["sxc1"], b["s_flag"],
                             b["sig_wf"], b["scalars"], b["valid"])
    f = pairing.miller_loop_product(*backend.pair_inputs(*pre[:4], mxa, mya, b["valid"]))
    g = tower.fq12_mul(tower.fq12_conj(f), tower.fq12_inv(f))
    g = tower.fq12_mul(tower.fq12_frobenius(g, 2), g)  # cyclotomic: the |x| powers' domain
    arms, canon = {}, {}
    for arm in (False, True):
        name = "karabina" if arm else "direct"
        cyc_ms = _time(lambda: tower.fq12_cyclotomic_exp_abs_x(g, compressed=arm), KAR_REPS)
        fe_ms = _time(lambda: pairing.final_exponentiation(f, compressed=arm), KAR_REPS)
        canon[name] = (tower.t_canon(tower.fq12_cyclotomic_exp_abs_x(g, compressed=arm)),
                       tower.t_canon(pairing.final_exponentiation(f, compressed=arm)))
        bls.set_backend("device", device=dev, karabina=arm)
        backend.verify_indexed_sets_device(cache, batch, device=dev)  # warm-up
        torch.cuda.synchronize()
        fm.reset_counts()
        t = time.time()
        ok = backend.verify_indexed_sets_device(cache, batch, device=dev)
        torch.cuda.synchronize()
        batch_ms = (time.time() - t) * 1e3
        bad = backend.verify_indexed_sets_device(cache, poisoned, device=dev)
        torch.cuda.synchronize()
        counts = _read_counts(f"karabina arm {name}")
        if ok is not True or bad is not False:
            raise RuntimeError(f"karabina arm {name}: valid {ok}, poisoned {bad}")
        arms[name] = {"cyc_exp_abs_x_ms": cyc_ms, "final_exp_ms": fe_ms,
                      "batch_ms": batch_ms, "launches": counts["by"], "log": counts["log"],
                      "by_name": counts["by_name"]}
    bls.set_backend("device", device=dev, karabina=False)
    for k, (a, c) in enumerate(zip(canon["direct"], canon["karabina"])):
        if not torch.equal(a, c):
            raise RuntimeError(f"karabina: the arms' {('|x| powers', 'final exponentiations')[k]} "
                               f"differ")
    sched = fm.SCHEDULES["kar_sqr_c"]
    a = _operand(1, sched.n_a, sched.in_bounds[0], gen, dev)
    got = fm.cuda_fused(sched, a, a)
    torch.cuda.synchronize()
    if not torch.equal(got, fm.plain_plan(sched, a, a)):
        raise RuntimeError("KARABINA_SQR: plan kernel != plain")
    step = plan_timing("kar_sqr_c", 1, dev, gen)
    log("karabina: " + "; ".join(
        f"{k}: |x| power {v['cyc_exp_abs_x_ms']:.4f} ms, final exponentiation "
        f"{v['final_exp_ms']:.3f} ms, batch {v['batch_ms']:.2f} ms, launches "
        f"{json.dumps(v['launches'])}" for k, v in arms.items())
        + f"; verdicts equal (valid True, poisoned False), the canonical |x| powers and final "
        f"exponentiations equal; KARABINA_SQR (14 lanes, 8 rows) bit-exact at rows 1, "
        f"{step['ms']:.5f} ms a step")
    runs = {"karabina": {"by": arms["karabina"]["launches"], "log": arms["karabina"].pop("log"),
                         "by_name": arms["karabina"].pop("by_name")},
            "karabina_direct": {"by": arms["direct"]["launches"], "log": arms["direct"].pop("log"),
                                "by_name": arms["direct"].pop("by_name")}}
    return {"arms": arms, "kar_sqr_step": step, "runs": runs}


# --------------------------------------------------------------------------------------
# The serving mesh (phase 23)
# --------------------------------------------------------------------------------------

MESH_SHARDS = 4  # logical shards of the mesh on the one card: [cuda:0] * 4
MESH_TIMED = 3  # (a): timed combined batches
MESH_STREAM_S = 1.0  # (b): the stream through the MeshVerifier
MESH_INTAKE = 32  # (b): its intake (phase 9's holds 1024: a shorter drain)
MESH_API = 2  # (a): the bls API's mesh on phase 8's small sets


# the timed repeats cut to pay for phase 23: name -> (count before, count now)
REPEAT_CUTS = {"BLOCK_REPS": (5, BLOCK_REPS), "EPOCH_TIMED": (3, EPOCH_TIMED),
               "KZG_COLUMN_REPS": (5, KZG_COLUMN_REPS), "KZG_BATCH_REPS": (3, KZG_BATCH_REPS),
               "NET_CODEC_REPS": (5, NET_CODEC_REPS), "LC_REPS": (5, LC_REPS),
               "KAR_REPS": (5, KAR_REPS), "FIREHOSE_ALONE": (8, FIREHOSE_ALONE),
               "PLAIN_REPS": (10, PLAIN_REPS), "TIMING_REPS": (100, TIMING_REPS)}


def _repeat_cuts(block_t, epoch_m, km, nm, lm, ka, fh, krows) -> dict:
    """What the cut repeats would have cost in this run: each loop's
    per-repeat time as this run printed it (its median; for PLAIN_REPS the
    sum over the plan rows timed, one call each) times the repeats cut."""
    codec = nm["sockets"]["codec"].values()
    per = {
        "BLOCK_REPS": block_t["host_ms"]["median"] + block_t["device_half_ms"]["median"],
        "EPOCH_TIMED": _spread([b["slots_ms"] + b["next_ms"] for b in epoch_m["timed"]])["median"],
        "KZG_COLUMN_REPS": km["column_ms"]["median"],
        "KZG_BATCH_REPS": km["batch_ms"]["median"],
        "NET_CODEC_REPS": sum(c["encode_ms"]["median"] + c["decode_ms"]["median"] for c in codec),
        "LC_REPS": lm["batch"]["batch_ms"]["median"],
        "KAR_REPS": sum(a["cyc_exp_abs_x_ms"] + a["final_exp_ms"] for a in ka["arms"].values()),
        "FIREHOSE_ALONE": fh["standalone_ms_per_batch"],
        "PLAIN_REPS": sum(r["plain_ms"] for r in krows if r["kind"] != "CHAIN" and not r.get("reused")),
        "TIMING_REPS": sum(r["ms"] + r["launch_ms"] for r in krows
                           if r["kind"] != "CHAIN" and not r.get("reused")),
    }
    return {k: {"before": b, "now": n, "per_repeat_ms": per[k], "saved_s": (b - n) * per[k] / 1e3}
            for k, (b, n) in REPEAT_CUTS.items()}


def _mesh(n: int, dev) -> list:
    return [dev] * n


def mesh_main_phase(cache, batches, poisoned, small, small_bad, small_oracle, main_ms,
                    dev) -> dict:
    """Phase 23 (a): phase 5's batches over the resident cache on a mesh of
    MESH_SHARDS logical shards on the card. Combined (``sharded.
    verify_indexed_sets_sharded``: per-shard partials, one final
    exponentiation): the poisoned batch False (the warm-up), MESH_TIMED
    timed valid batches True, as phase 5 judged them; per shard
    (``verify_staged_pershard`` through the chain's ``MeshBackend``): a
    valid batch all True, its dispatch the profiled call (the device traced
    alone), and the poisoned batch rotated so its bad set sits in shard 2:
    exactly shard 2 False; the bls API's mesh arm (a mesh of MESH_API) on
    phase 8's small sets gives the oracle's verdicts. Counts set to 0 before
    each run and read after."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.bls import mesh, sharded
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    devs = _mesh(MESH_SHARDS, dev)
    runs = {}
    fm.reset_counts()
    t = time.time()  # the poisoned batch first: it is the warm-up too
    if sharded.verify_indexed_sets_sharded(cache, poisoned, devs) is not False:
        raise RuntimeError("mesh: the poisoned batch verified (combined)")
    warm_s = time.time() - t
    ms = []
    for items in batches[1:1 + MESH_TIMED]:
        t = time.perf_counter()
        ok = sharded.verify_indexed_sets_sharded(cache, items, devs)
        ms.append((time.perf_counter() - t) * 1e3)
        if ok is not True:
            raise RuntimeError("mesh: a valid batch did not verify (combined)")
    runs["mesh_combined"] = _read_counts("mesh: combined verdicts")
    mb = mesh.make_mesh_backend(lambda: cache, devs)
    cap = len(batches[1]) // MESH_SHARDS
    ids = tuple(range(MESH_SHARDS))
    rotated = poisoned[2 * cap:] + poisoned[:2 * cap]  # poisoned set 0 -> row 2 * cap
    fm.reset_counts()
    t = time.perf_counter()
    staged = mb.stage([batches[1][s * cap:(s + 1) * cap] for s in ids], ids, cap)
    stage_ms = (time.perf_counter() - t) * 1e3
    t_prof = time.time()
    good, pershard_ms, dev_us, ops = _profiled(lambda: mb.dispatch(None, ids, staged=staged),
                                               host_ops=False)
    profile_s = time.time() - t_prof
    bad = mb.dispatch([rotated[s * cap:(s + 1) * cap] for s in ids], ids, shard_cap=cap)
    runs["mesh_pershard"] = _read_counts("mesh: per-shard verdicts")
    want_bad = [s != 2 for s in ids]
    if good != [True] * MESH_SHARDS or bad != want_bad:
        raise RuntimeError(f"mesh: per-shard verdicts {good}, poisoned {bad} (want {want_bad})")
    t_api = time.time()
    try:
        bls.set_backend("device", device=dev, mesh_devices=_mesh(MESH_API, dev))
        fm.reset_counts()
        api = [bls.verify_signature_sets(x, device=dev) for x in (small, small_bad)]
        runs["mesh_api"] = _read_counts("mesh: the bls API's mesh arm")
    finally:
        bls.set_backend("device", device=dev, mesh_devices=[])
    if api != small_oracle:
        raise RuntimeError(f"mesh: the bls API's mesh arm {api} != the oracle's {small_oracle}")
    api_s = time.time() - t_api
    busy = sum(dev_us.values()) / 1e3
    spread = _spread(ms)
    out = {
        "shards": MESH_SHARDS, "devices": [str(d) for d in devs], "rows_per_shard": cap,
        "api_s": api_s, "profile_s": profile_s,
        "warmup_s": warm_s, "combined_ms": spread, "combined_all_ms": ms,
        "phase5_ms_per_batch": main_ms, "sets_per_s": len(batches[1]) / (spread["median"] / 1e3),
        "launches_per_batch": {k: v / (len(ms) + 1)
                               for k, v in runs["mesh_combined"]["by"].items()},
        "pershard_stage_ms": stage_ms, "pershard_profiled_ms": pershard_ms, "pershard": good,
        "pershard_poisoned": bad, "api_small": api, "busy_ms": busy,
        "aten_ops": ops, "idle_share": 1 - busy / pershard_ms if busy else None,
        "device_ms_by_name": {k[:80]: v / 1e3 for k, v in sorted(dev_us.items(),
                                                                  key=lambda kv: -kv[1])[:8]},
    }
    log(f"mesh (a): {len(batches[1])} sets x {len(batches[1][0][0])} keys on {MESH_SHARDS} "
        f"logical shards of {cap} rows on {dev} (the poisoned batch, the warm-up, False in "
        f"{warm_s:.2f} s): combined "
        f"{json.dumps(spread)} ms a batch over {len(ms)} (phase 5: {main_ms:.2f} ms unsharded), "
        f"valid True; per shard: staged in {stage_ms:.2f} ms, dispatched under the profiler "
        f"(the device alone) in {pershard_ms:.2f} ms, busy {busy:.3f} ms, idle share "
        f"{out['idle_share']}, valid {good}, poisoned set in shard 2 -> {bad}; the bls API's "
        f"mesh arm ({MESH_API} shards) on the small sets {api} == oracle {small_oracle}; "
        f"launches per combined batch {json.dumps(out['launches_per_batch'])}; the API check "
        f"{api_s:.2f} s, the profiled dispatch {profile_s:.2f} s")
    out["runs"] = runs
    return out


def mesh_firehose_phase(cache, pool, bis_items, bad_pos, sk0: int, dev, verify_gossip,
                        alone_rate) -> dict:
    """Phase 23 (b): the firehose with a ``MeshVerifier`` planner over
    MESH_SHARDS logical shards (per-shard verdicts, prep-thread staging,
    bisection only inside a failed shard), paced at phase 9's rate for
    MESH_STREAM_S s with phase 10's two poisoned items in the stream: every
    verdict as the oracle judges it (the fixture's construction, and the
    oracle on one poisoned and one honest item). Then ``mesh.shard1``
    injected twice: ``bls_shard1`` quarantined and out of the healthy set,
    the next ticks served by the mesh of 2 with no false verify; after its
    probation shard 1 back HEALTHY and the tick on all 4."""
    from lighthouse_tpu_torch.bls import mesh
    from lighthouse_tpu_torch.firehose import FirehoseConfig, FirehoseEngine, MeshVerifier
    from lighthouse_tpu_torch.oracle import ciphersuite as cs, curves as oc
    from lighthouse_tpu_torch.oracle.fields import R
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm
    from lighthouse_tpu_torch.resilience.inject import injector

    devs = _mesh(MESH_SHARDS, dev)
    mb = mesh.make_mesh_backend(lambda: cache, devs)
    dispatched = []

    def dispatch(shard_items, device_ids, staged=None, shard_cap=None):
        dispatched.append(tuple(device_ids))
        return mb.dispatch(shard_items, device_ids, staged=staged, shard_cap=shard_cap)

    mv = MeshVerifier(MESH_SHARDS, dispatch_fn=dispatch, stage_fn=mb.stage, probe_fn=mb.probe,
                      single_fn=verify_gossip, oracle_fn=None)
    for s in (mv.mesh_sup, *mv.shard_sups):
        s.reset()
    bad = {id(bis_items[j]) for j in bad_pos}
    # the poisoned items lead the stream: the first MESH_INTAKE items are accepted
    stream = [bis_items[j] for j in bad_pos] + [it for k, it in enumerate(pool) if k not in bad_pos]
    verdicts = []
    engine = FirehoseEngine(
        prepare_fn=lambda ps: [([p], None) for p in ps], verify_items_fn=verify_gossip,
        config=FirehoseConfig(max_batch=64, deadline_s=0.010, intake_capacity=MESH_INTAKE),
        shard_planner=mv,
    )
    engine.default_callback = lambda p, ok, m: verdicts.append((id(p) in bad, ok))
    fm.reset_counts()
    n_stream, wall = _pace_stream(engine, stream, FIREHOSE_RATE, MESH_STREAM_S, 120.0)
    st = engine.stats()
    runs = {"mesh_firehose": _read_counts("mesh: the firehose")}
    n_bad = sum(1 for b, _ in verdicts if b)
    wrong = [(b, ok) for b, ok in verdicts if ok == b]
    if wrong or n_bad < len(bad_pos) or st.errored or st.device_faults or not st.verified:
        raise RuntimeError(f"mesh firehose: {len(wrong)} verdicts not the oracle's, {n_bad} "
                           f"poisoned seen; {st.as_dict()}")
    j_bad = bad_pos[0]
    t = time.time()
    oracle = [cs.verify(cs.sk_to_pk((sk0 + v) % R), msg, oc.g2_decompress(sig))
              for (v,), msg, sig in (bis_items[j_bad], pool[j_bad])]
    oracle_s = time.time() - t
    if oracle != [False, True]:
        raise RuntimeError(f"mesh firehose: the oracle judged the poisoned / honest item {oracle}")
    slo = _slo_block(st, n_stream)

    # the fault ladder: shard 1 faults twice, leaves the mesh, comes back
    groups = [[it] for it in pool[:63]] + [[bis_items[j_bad]]]
    fm.reset_counts()
    injector.install("stage=mesh.shard1;mode=raise;kind=oom;every=1;times=2")
    try:
        faulted = [mv.verify_groups(groups)]
        shrunk = dispatched[-1]  # the first faulted tick: the other half of the mesh
        faulted.append(mv.verify_groups(groups))
    finally:
        injector.clear()
    sup1 = mv.shard_sups[1]
    state1, healthy = sup1.snapshot()["state"], mv.healthy_indices()
    probation = [mv.mesh_sup.config.probation_s, sup1.config.probation_s]
    mv.mesh_sup.config.probation_s = sup1.config.probation_s = 0.0
    back = []
    try:
        for _ in range(12):
            back.append(mv.verify_groups(groups))
            if sup1.snapshot()["state"] == "HEALTHY" and dispatched[-1] == tuple(range(MESH_SHARDS)):
                break
    finally:
        mv.mesh_sup.config.probation_s, sup1.config.probation_s = probation
    runs["mesh_ladder"] = _read_counts("mesh: the fault ladder")
    if any(v[-1] for v in faulted + back):
        raise RuntimeError("mesh ladder: the poisoned group verified")
    if state1 != "QUARANTINED" or 1 in healthy or shrunk != (2, 3):
        raise RuntimeError(f"mesh ladder: shard 1 {state1}, healthy {healthy}, served by {shrunk}")
    # group g sits in shard g % m (least-loaded, ties to the lowest shard); the
    # poisoned group 63 condemns exactly its own shard's groups (the second
    # faulted tick may fall to the single device, whose one verdict is False)
    n_g = len(groups)
    if faulted[0] != [g % 2 != (n_g - 1) % 2 for g in range(n_g)] or \
            back[-1] != [g % MESH_SHARDS != (n_g - 1) % MESH_SHARDS for g in range(n_g)]:
        raise RuntimeError(f"mesh ladder: per-group verdicts {faulted[0]} / {back[-1]}")
    snap = mv.snapshot()
    if sup1.snapshot()["state"] != "HEALTHY" or dispatched[-1] != tuple(range(MESH_SHARDS)):
        raise RuntimeError(f"mesh ladder: shard 1 did not come back: {snap}")
    out = {
        "shards": MESH_SHARDS, "offered": n_stream, "offered_att_per_s": FIREHOSE_RATE,
        "stream_s": MESH_STREAM_S, "intake": MESH_INTAKE, "accepted": st.submitted,
        "verified": st.verified, "rejected": st.rejected, "dropped": st.dropped,
        "drop_rate": st.dropped / n_stream, "wall_s": wall,
        "verified_att_per_s": st.verified / wall, "p99_queue_ms": st.p99_latency_s * 1e3,
        "slo": slo, "poisoned_verdicts": n_bad, "oracle": oracle, "oracle_s": oracle_s,
        "phase9_standalone_att_per_s": alone_rate, "ladder": {
            "quarantined": state1, "healthy_while_out": healthy, "served_by": list(shrunk),
            "ticks_to_return": len(back), "snapshot": snap},
    }
    alone = "" if alone_rate is None else f" (phase 9 standalone {alone_rate:.2f})"
    log(f"mesh (b): the firehose over a MeshVerifier of {MESH_SHARDS} shards: offered "
        f"{FIREHOSE_RATE:.0f} att/s for {MESH_STREAM_S} s ({n_stream}), intake {MESH_INTAKE}: "
        f"{st.submitted} accepted, {st.verified} verified, {st.rejected} rejected (the poisoned, "
        f"{n_bad} seen: every verdict as the oracle's; oracle on one poisoned / one honest item "
        f"{oracle} in {oracle_s:.2f} s), {st.dropped} dropped (rate {out['drop_rate']:.4f}), "
        f"{out['verified_att_per_s']:.2f} att/s{alone}, p99 "
        f"{out['p99_queue_ms']:.2f} ms; mesh.shard1 injected twice: bls_shard1 {state1}, "
        f"healthy {healthy}, the first faulted tick served by {list(shrunk)}, the poisoned group "
        f"False in every tick; back on all "
        f"{MESH_SHARDS} after {len(back)} ticks")
    out["runs"] = runs
    return out


def mesh_chain_phase(chain, atts, bad_att, dev) -> dict:
    """Phase 23 (c): phase 13's chain with the mesh on. The bls backend
    gets ``mesh_devices=[dev] * MESH_SHARDS``; the chain builds its planner
    (a ``MeshVerifier``, no oracle rung on a card) and its batch-verify
    route and firehose take it: phase 13's valid gossip True through the
    mesh, with the poisoned attestation False, as the route judges them
    with the mesh off. The mesh is turned off again after."""
    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.firehose import MeshVerifier
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    items = [chain._attester_item_fast(chain._indexed_attestation_fast(a)) for a in atts]
    bad = chain._attester_item_fast(chain._indexed_attestation_fast(bad_att))
    runs = {}
    try:
        bls.set_backend("device", device=dev, mesh_devices=_mesh(MESH_SHARDS, dev))
        mv = chain._mesh_planner()
        if not isinstance(mv, MeshVerifier) or mv.n_devices != MESH_SHARDS or mv.oracle_fn:
            raise RuntimeError(f"mesh chain: planner {mv!r}")
        if chain.create_firehose(synchronous=True).shard_planner is not mv:
            raise RuntimeError("mesh chain: the chain's firehose has no planner")
        for s in (mv.mesh_sup, *mv.shard_sups):
            s.reset()
        fm.reset_counts()
        t = time.perf_counter()
        on = [chain._batch_verify_items(items), chain._batch_verify_items(items + [bad])]
        on_ms = (time.perf_counter() - t) * 1e3
        runs["mesh_chain"] = _read_counts("mesh: the chain's batch route")
        snap = mv.snapshot()
    finally:
        bls.set_backend("device", device=dev, mesh_devices=[])
    if chain._mesh_planner() is not None:
        raise RuntimeError("mesh chain: the planner outlived the mesh")
    off = [chain._batch_verify_items(items), chain._batch_verify_items(items + [bad])]
    if on != off or on != [True, False] or snap["mesh"]["state"] != "HEALTHY":
        raise RuntimeError(f"mesh chain: verdicts {on} with the mesh, {off} without; {snap}")
    log(f"mesh (c): phase 13's chain with the mesh on: planner MeshVerifier({MESH_SHARDS}), no "
        f"oracle rung, the chain's firehose on it; {len(items)} gossip items True, with the "
        f"poisoned one False ({on_ms:.2f} ms for both), as the route judges them with the mesh "
        f"off; bls_mesh {snap['mesh']['state']}")
    return {"items": len(items), "verdicts": on, "ms": on_ms, "snapshot": snap, "runs": runs}


def mesh_epoch_check(spec, state_copy, unsharded, dev) -> dict:
    """Phase 23 (e), epoch: phase 11's parity state (a copy taken before its
    device boundary) through the boundary over MESH_SHARDS row blocks: its
    tree root, which hashes every field, equals the unsharded device
    boundary's; where it does not, the fields are compared one by one to
    name the first that diverged."""
    from lighthouse_tpu_torch import epoch_engine
    from lighthouse_tpu_torch.epoch_engine import engine as epoch_eng

    import torch

    from lighthouse_tpu_torch.analysis import memory

    try:
        epoch_engine.set_backend("device", device=dev, mesh_devices=_mesh(MESH_SHARDS, dev))
        t = time.time()
        # phase 24 (b): the row blocks bound first, against the model and the allocator
        _sync(dev)
        alloc0 = torch.cuda.memory_allocated(dev)
        epoch_engine.prepare_state(state_copy)  # the backend's device and mesh, set above
        _sync(dev)
        cols = epoch_eng.mirror_of(state_copy).cols
        n_val = len(state_copy.validators)
        per_block = memory.epoch_mirror_bytes(n_val, include_epoch_planes=False,
                                              mesh_devices=MESH_SHARDS)
        resident = _resident_row(f"epoch_row_blocks@{MESH_SHARDS}",
                                 [b for col in cols.values() for b in col],
                                 torch.cuda.memory_allocated(dev) - alloc0,
                                 MESH_SHARDS * per_block)
        blocks_ok = all(sum(col[k].nbytes for col in cols.values()) == per_block
                        for k in range(MESH_SHARDS))
        resident["ok"] = resident["ok"] and blocks_ok
        resident["per_block_model_bytes"] = per_block
        if not epoch_engine.maybe_process_epoch_on_device(spec, state_copy):
            raise RuntimeError("mesh epoch: the device engine refused the state")
        _sync(dev)
        dev_s = time.time() - t
    finally:
        epoch_engine.set_backend("device", device=dev, mesh_devices=[])
    blocks = [t.shape[0] for t in epoch_eng.mirror_of(state_copy).cols["effective"]]
    if state_copy.tree_root() != unsharded.tree_root():
        _epoch_parity(state_copy, unsharded)  # names the field that diverged
        raise RuntimeError("mesh epoch: tree_root diverged")
    log(f"mesh (e): the parity boundary at {len(state_copy.validators)} validators over "
        f"{MESH_SHARDS} row blocks of {blocks[0]} (first bind included) {dev_s:.3f} s: the tree "
        f"root (every field) == the unsharded device boundary's")
    return {"validators": len(state_copy.validators), "blocks": blocks, "device_s": dev_s,
            "resident": resident}


def mesh_slasher_check(dev) -> dict:
    """Phase 23 (e), slasher: phase 17's cell (2^20 x 64, its seed and
    traffic) cut to one warm-up, four honest ticks and the injected ticks,
    on an unsharded span store and on one split into MESH_SHARDS validator
    row blocks: per-pair outputs equal every tick, 4/4 surrounds and
    doubles, no flag on the honest stream, and equal planes after (compared
    on the card)."""
    import numpy as np
    import torch

    from lighthouse_tpu_torch.slasher.engine import SpanStore

    n_val, hist = 1 << 20, SLASHER_HISTORY
    rng = np.random.default_rng(0x51A5)
    pairs = min(n_val, SLASHER_PAIRS)
    ticks = []
    for t in range(5):
        cur = 100 + t // SLASHER_TICKS_PER_EPOCH
        ticks.append((rng.choice(n_val, size=pairs, replace=False).astype(np.int64),
                      np.full(pairs, cur - 1, np.int64), np.full(pairs, cur, np.int64),
                      np.ones(pairs, np.uint32), cur))
    cur = ticks[-1][4] + 1
    inj = rng.choice(n_val, size=8, replace=False).astype(np.int64)
    ticks.append((np.concatenate([inj, inj[:4]]),
                  np.concatenate([np.full(8, cur - 2, np.int64), np.full(4, cur - 3, np.int64)]),
                  np.concatenate([np.full(8, cur - 1, np.int64), np.full(4, cur, np.int64)]),
                  np.concatenate([np.ones(8, np.uint32), np.full(4, 2, np.uint32)]), cur))
    ticks.append((inj[4:], np.full(4, cur - 2, np.int64), np.full(4, cur - 1, np.int64),
                  np.full(4, 3, np.uint32), cur))
    stores = [SpanStore(hist, use_device=True, device=dev),
              SpanStore(hist, use_device=True, mesh_devices=_mesh(MESH_SHARDS, dev))]
    ms = [[], []]
    res = [[], []]
    for tick in ticks:
        for k, store in enumerate(stores):
            t = time.perf_counter()
            res[k].append(store.apply(*tick[:4], tick[4]))
            ms[k].append((time.perf_counter() - t) * 1e3)
    for a, b in zip(*res):
        for key in a:
            if not np.array_equal(a[key], b[key]):
                raise RuntimeError(f"mesh slasher: {key} differs between the stores")
    honest = sum(int(r[f].sum()) for r in res[1][:5] for f in ("min_flag", "max_flag", "dbl_flag"))
    surround, double = int(res[1][5]["min_flag"][8:].sum()), int(res[1][6]["dbl_flag"].sum())
    st = stores[1].stats()
    if honest or surround != 4 or double != 4 or st["mode"] != "device" or st["demotions"]:
        raise RuntimeError(f"mesh slasher: {honest} honest flags, surrounds {surround}/4, doubles "
                           f"{double}/4; {st}")
    t = time.time()  # the planes compared where they live, the blocks joined on the card
    if stores[0].mode != "device" or stores[1].mode != "device":
        raise RuntimeError("mesh slasher: a store left the card")
    for p, whole in enumerate(stores[0].dev):
        joined = torch.cat([block[p] for block in stores[1].dev])
        if not torch.equal(whole[:n_val], joined[:n_val]):
            raise RuntimeError("mesh slasher: the planes differ")
        del joined
    planes_s = time.time() - t
    del stores
    torch.cuda.empty_cache()
    out = {"validators": n_val, "history_length": hist, "blocks": MESH_SHARDS,
           "ticks": len(ticks), "ms_per_tick": {"unsharded": _spread(ms[0][1:5]),
                                                "blocked": _spread(ms[1][1:5])},
           "surround": surround, "double": double, "false_positives": honest,
           "planes_compare_s": planes_s}
    log(f"mesh (e): the slasher cell {n_val} x {hist} over {MESH_SHARDS} validator row blocks: "
        f"per-pair outputs == the unsharded store's over {len(ticks)} ticks, surrounds "
        f"{surround}/4, doubles {double}/4, {honest} flags on the honest ticks; planes equal "
        f"on the card ({planes_s:.2f} s to compare); ms per honest tick unsharded "
        f"{json.dumps(out['ms_per_tick']['unsharded'])}, blocked "
        f"{json.dumps(out['ms_per_tick']['blocked'])}")
    return out


# --------------------------------------------------------------------------------------
# The analysis passes on the card (phase 24)
# --------------------------------------------------------------------------------------

# (b): the graphs whose peaks the card measures, at the main path's batch
PEAK_GRAPHS = ("fq.mont_mul", "tower.fq12_mul", "pairing.miller_loop_product",
               "pairing.final_exponentiation", "kzg.fr_dot")
PEAK_BATCH = 32
LARGE_ALLOC = 1 << 20  # the caching allocator splits a block above this size only


def _resident(name: str, dev, build, model: int) -> dict:
    """Build a device-resident structure (``build()`` returns its tensors)
    between two reads of the allocator; its bytes, the allocator's change
    and the model's bytes. The allocator charges each allocation rounded up
    to 512 B, and a large one (above 1 MiB) may take up to 1 MiB more from a
    pooled block it does not split."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    tensors = list(build())
    torch.cuda.synchronize(dev)
    delta = torch.cuda.memory_allocated(dev) - before
    return _resident_row(name, tensors, delta, model)


def _resident_row(name: str, tensors, delta: int, model: int) -> dict:
    from lighthouse_tpu_torch.analysis import memory

    nbytes = memory.tensor_bytes(tensors)
    rounded = memory.rounded_bytes(tensors)
    slack = sum(LARGE_ALLOC for t in tensors if t.untyped_storage().nbytes() > LARGE_ALLOC)
    return {"structure": name, "model_bytes": int(model), "nbytes": nbytes,
            "allocator_delta": int(delta), "rounded_bytes": rounded, "large_slack": slack,
            "tensors": len(tensors),
            "ok": nbytes == model and rounded <= delta <= rounded + slack}


def _graph_peaks(dev, cert: dict) -> list:
    """(b): each PEAK_GRAPHS graph at PEAK_BATCH on the card after one
    warm-up, the allocator's cache emptied first: ``max_memory_allocated``
    over the run (the arguments included) against the meta walk's
    allocator bound (``peak_alloc_bytes``: a cached block above 1 MiB can be
    handed out unsplit, up to 1 MiB over the request; after phases 1-23 on
    an H100 the Miller product's count ran 1,192,448 B over its requests),
    and the card's requested bytes (``memory_stats``) against the walk's
    exact peak."""
    import torch

    from lighthouse_tpu_torch.analysis import bounds, memory

    reg = {n: (fn, specs) for n, fn, specs in bounds.graph_registry(PEAK_BATCH)}
    walk = {r["graph"]: r for r in cert["rows"] if r["kind"] == "graph_footprint"}
    rows = []
    for name in PEAK_GRAPHS:
        fn, specs = reg[name]
        args = bounds.materialize(specs, dev)
        fn(*args)
        torch.cuda.synchronize(dev)
        arg_ts = memory._tensors(args)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        requested0 = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
        out = fn(*args)
        torch.cuda.synchronize(dev)
        card = torch.cuda.max_memory_allocated(dev) - before + memory.rounded_bytes(arg_ts)
        requested = (torch.cuda.memory_stats(dev)["requested_bytes.all.peak"] - requested0
                     + memory.tensor_bytes(arg_ts))
        del out, args, arg_ts
        w = walk[f"{bounds.REGIME}@b{PEAK_BATCH}/{name}"]
        rows.append({"graph": name, "batch": PEAK_BATCH, "meta_peak_bytes": w["peak_bytes"],
                     "meta_peak_alloc_bytes": w["peak_alloc_bytes"], "card_peak_bytes": card,
                     "card_requested_peak_bytes": requested,
                     "ratio": card / w["peak_alloc_bytes"],
                     "requested_ratio": requested / w["peak_bytes"],
                     "ok": w["peak_alloc_bytes"] >= card and w["peak_bytes"] >= requested})
    return rows


LD_VALIDATORS = 128  # phase 24 (e)'s registry: its gossip pool's 3 committees of 32
LD_TIMEOUT_S = 300.0  # the lockdep process's limit


def lockdep_child(path: str, seed: int) -> int:
    """Phase 24 (e) in a process of its own (``--lockdep-child PATH``).
    Lockdep's lock factories are installed before the port's modules are
    imported, so every lock of the package (the metrics, the kernels' module
    lock, the supervisors' registry among them) is instrumented from its
    creation, while the main process times its phases on plain locks. Then
    phase 23 (b) as the main process runs it (``mesh_firehose_phase``: the
    firehose over a MeshVerifier of MESH_SHARDS logical shards on the card,
    the two poisoned items leading, ``mesh.shard1`` faulted twice and back)
    over a registry of LD_VALIDATORS keys. Writes the observed lock graph and
    the phase's summary to ``path``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from lighthouse_tpu_torch.analysis import concurrency as lockdep

    lockdep.install()
    from lighthouse_tpu_torch.bls import backend, pubkey_cache

    t = time.time()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 24)
    sk0 = int(rng.integers(1 << 62)) | 1
    raw = _registry_walk((sk0, LD_VALIDATORS))
    pool = _gossip_pool(rng, LD_VALIDATORS, sk0, 3, 32)
    bad_pos = (17, 42)
    bis_items = list(pool[:64])
    for j in bad_pos:  # another committee's signature: a valid point, a wrong signer
        other = next(it for it in pool[64:] if it[1] != bis_items[j][1])
        bis_items[j] = (bis_items[j][0], bis_items[j][1], other[2])
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device=dev)

    def verify_gossip(items):
        return backend.verify_indexed_sets_device(cache, items, device=dev)

    fixture_s = time.time() - t
    try:
        mesh = mesh_firehose_phase(cache, pool, bis_items, bad_pos, sk0, dev, verify_gossip,
                                   None)
    finally:
        observed = lockdep.observed_report()
        lockdep.uninstall()
    mesh.pop("runs")
    with open(path, "w") as f:
        json.dump({"observed": observed, "mesh": mesh, "fixture_s": fixture_s,
                   "seconds": time.time() - t}, f)
    return 0


def _start_lockdep_child(seed: int) -> tuple:
    """Start ``lockdep_child`` in a new process: (process, result path, log path)."""
    d = tempfile.mkdtemp(prefix="chip_smoke_lockdep_")
    out, log_path = os.path.join(d, "observed.json"), os.path.join(d, "child.log")
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--lockdep-child", out,
             "--seed", str(seed)], stdout=lf, stderr=subprocess.STDOUT, cwd=HERE)
    return proc, out, log_path


def _join_lockdep_child(proc, out: str, log_path: str) -> dict:
    """Wait for the lockdep process; its result, or an error with its log's tail."""
    try:
        rc = proc.wait(LD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    with open(log_path) as f:
        lines = f.read().splitlines()
    if rc != 0 or not os.path.exists(out):
        raise RuntimeError(f"analysis (e): the lockdep process exited {rc}: "
                           + "\n".join(lines[-40:]))
    with open(out) as f:
        res = json.load(f)
    res["log"] = [ln for ln in lines if ln.startswith("mesh (b)")]
    shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    return res


def analysis_phase(dev, card: str, done: set, p24: dict, cache, batch, pool, kz, lc_spec,
                   seed: int) -> dict:
    """Phase 24: the analysis passes on the card (see the module docstring).
    ``p24`` holds what earlier phases recorded for it: "builds" (the build
    sentinel around phase 5's timed batches, phase 11's timed boundaries,
    phase 9's firehose and phase 17's ticks) and "resident" (the epoch
    mirror bound in phase 11, the slasher planes of phase 17, the row blocks
    of phase 23 (e)). (e) runs in a process of its own, started first and
    joined after (d); its observed graph is merged into (a)'s static one."""
    import contextlib
    import io

    import torch

    from lighthouse_tpu_torch.analysis import __main__ as cli, concurrency, memory, supervised
    from lighthouse_tpu_torch.bls import backend
    from lighthouse_tpu_torch.kzg.engine import CellEngine
    from lighthouse_tpu_torch.light_client import engine as lce
    from lighthouse_tpu_torch.resilience import bls_supervisor

    out, part_s = {}, {}
    props = torch.cuda.get_device_properties(dev)
    tier = memory.DEVICE_TIERS["h100_80gb"]

    # (e) lockdep in its own process, beside (a)-(d)
    t_e = time.time()
    child = _start_lockdep_child(seed)
    try:
        # (a) the CLI in process, every pass, the certificates in a temporary
        # directory
        t = time.time()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_analysis_") as cert_dir:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--json", "--device", str(dev), "--cert-dir", cert_dir])
            rep = json.loads(buf.getvalue().strip().splitlines()[-1])
            with open(os.path.join(cert_dir, "BOUNDS_CERT.json")) as f:
                bcert = json.load(f)
            with open(os.path.join(cert_dir, "MEMORY_CERT.json")) as f:
                mcert = json.load(f)
            with open(os.path.join(cert_dir, "CONCURRENCY_CERT.json")) as f:
                ccert = json.load(f)
        if rc != 0 or not rep["ok"]:
            bad = {k: v for k, v in rep.items() if isinstance(v, dict) and not v.get("ok")}
            raise RuntimeError(f"analysis: the CLI exited {rc}: {json.dumps(bad)[:2000]}")
        smem_limits = {r["limit"] for r in bcert["obligations"] if r["kind"] == "cuda_smem_bytes"}
        if smem_limits != {props.shared_memory_per_block_optin}:
            raise RuntimeError(f"analysis: cuda_smem_bytes limits {smem_limits} != the card's "
                               f"opt-in {props.shared_memory_per_block_optin}")
        if tier["hbm_bytes"] != props.total_memory:
            raise RuntimeError(f"analysis: h100_80gb hbm_bytes {tier['hbm_bytes']} != the card's "
                               f"total_memory {props.total_memory}")
        if tier["smem_block_optin_bytes"] != props.shared_memory_per_block_optin:
            raise RuntimeError("analysis: h100_80gb smem_block_optin_bytes != the card's")
        if card != f"{tier['card']}, {tier['power_limit']}":
            raise RuntimeError(f"analysis: the card is {card!r}, the tier says "
                               f"{tier['card']!r}, {tier['power_limit']!r}")
        walk = [r for r in mcert["rows"] if r["kind"] == "smem_tile"]
        missing = sorted(s for s in done if not memory.launch_in_walk(walk, *s))
        if missing:
            raise RuntimeError(f"analysis: launched shapes missing from the smem walk: {missing[:8]}")
        out["cli"] = {k: ({kk: vv for kk, vv in v.items() if kk not in ("peaks", "planner",
                                                                        "findings")}
                          if isinstance(v, dict) else v) for k, v in rep.items()}
        out["smem"] = {"rows": len(walk), "shapes_checked": len(done),
                       "max_bytes": max(r["smem_bytes"] for r in walk),
                       "optin_bytes": props.shared_memory_per_block_optin}
        part_s["a"] = time.time() - t

        # (b) the residency models against the allocator, and the graph peaks
        t = time.time()
        resident = list(p24["resident"])
        items = pool[:64]
        staged = {}

        def stage():
            staged.update(backend.prepare_batch(items, device=dev))
            return staged.values()

        k_pad = backend.bucket(max(len(ix) for ix, _, _ in items))
        resident.append(_resident("firehose_staging", dev, stage, memory.firehose_staging_bytes(
            max_batch=len(items), prep_depth=0, k_pad=k_pad)))
        eng = CellEngine(kz["ctx"], device=dev)
        resident.append(_resident("kzg_tables", dev, lambda: [*eng.tables(), eng.z2_tab],
                                  memory.kzg_table_bytes(kz["ctx"].cells, kz["ctx"].k)))
        served = lce.get_engine(lc_spec, dev)
        if not served._host_rows:
            raise RuntimeError("analysis: phase 16's light-client engine holds no committee")
        lc = lce.LcEngine(lc_spec, dev)
        lc._host_rows = list(served._host_rows)  # phase 16's committees, decompressed there
        resident.append(_resident("lc_committee_cache", dev, lambda: [lc.cache_arr()],
                                  memory.lc_committee_cache_bytes(len(lc._host_rows),
                                                                  lc.committee_size)))
        del eng, lc, staged
        bad = [r for r in resident if not r["ok"]]
        if bad:
            raise RuntimeError(f"analysis: residency model or allocator off: {bad}")
        peaks = _graph_peaks(dev, mcert)
        if not all(r["ok"] for r in peaks):
            raise RuntimeError(f"analysis: the meta walk below the card: {peaks}")
        safe = memory.max_safe_shape("pairing.miller_loop_product", "h100_80gb", cert=mcert)
        out.update(resident=resident, peaks=peaks, max_safe_pairing_batch=safe)
        part_s["b"] = time.time() - t

        # (c) the build sentinel around the loops of phases 5, 9, 11 and 17
        builds = p24["builds"]
        if any(builds.values()):
            raise RuntimeError(f"analysis: steady loops built: {builds}")
        out["builds"] = builds

        # (d) the supervisor probe: a main-path batch through the bls ladder
        t = time.time()
        sup = supervised.supervisor_probe(
            dev, steps=2, supervisor=bls_supervisor(),
            call=lambda: backend.verify_indexed_sets_device(cache, batch, device=dev))
        if not sup["ok"] or sup["current_devices"] != [torch.cuda.current_device()]:
            raise RuntimeError(f"analysis: supervisor probe: {sup}")
        out["supervisor"] = sup
        part_s["d"] = time.time() - t

        ld = _join_lockdep_child(*child)
    finally:
        stop_process(child[0])
    part_s["e"] = time.time() - t_e

    # (e) lockdep: the observed graph of phase 23 (b)'s firehose in its own
    # process, alone and merged into (a)'s static graph
    edges = ld["observed"]["edges"]
    ids = {e["from"] for e in edges} | {e["to"] for e in edges}
    static = {lock for lock in concurrency._parse_tree(os.path.join(
        HERE, "lighthouse_tpu_torch")).lock_sites.values()}
    alone = concurrency.merge_observed({}, edges)
    merged = concurrency.merge_observed(
        {(e["from"], e["to"]): tuple(e["site"].rsplit(":", 1))
         for e in ccert["lock_graph"]["edges"]}, edges)
    if not edges or not alone["ok"] or not merged["ok"]:
        raise RuntimeError(f"analysis: lockdep: {len(edges)} edges, alone {alone}, merged "
                           f"{merged}")
    if not ids & static or any(i.startswith("lighthouse_tpu/") for i in ids):
        raise RuntimeError(f"analysis: observed locks not the port's: {sorted(ids)[:8]}")
    out["lockdep"] = {"edges": len(edges), "locks": ld["observed"]["n_locks"],
                      "edge_list": edges, "process_s": ld["seconds"],
                      "fixture_s": ld["fixture_s"], "mesh": ld["mesh"],
                      "static_ids": len(ids & static), "site_ids": len(ids - static),
                      "merged_edges": merged["n_observed_edges"],
                      "static_edges": merged["n_static_edges"]}
    out["part_s"] = part_s
    log(f"analysis (a): python -m lighthouse_tpu_torch.analysis --device {dev} in process, every "
        f"pass ok in {part_s['a']:.1f} s: {rep['bounds']['n_obligations']} bound obligations "
        f"(cuda_smem_bytes limit {props.shared_memory_per_block_optin} == the card's opt-in), "
        f"{rep['memory']['n_rows']} memory rows ({len(walk)} smem rows covering all "
        f"{len(done)} launched shapes, largest {out['smem']['max_bytes']} B), hbm "
        f"{props.total_memory} B == h100_80gb's; {rep['concurrency']['n_lock_classes']} lock "
        f"classes, {rep['concurrency']['n_edges']} static edges")
    log("analysis (b): residency " + json.dumps(
        {r["structure"]: [r["model_bytes"], r["nbytes"], r["allocator_delta"]] for r in resident})
        + " (model, nbytes, allocator delta); peaks at batch 32 " + json.dumps(
        {r["graph"]: [r["meta_peak_alloc_bytes"], r["card_peak_bytes"], round(r["ratio"], 6),
                      r["meta_peak_bytes"], r["card_requested_peak_bytes"],
                      round(r["requested_ratio"], 6)] for r in peaks})
        + " (the walk's allocator bound, the card's max_memory_allocated, their ratio; the walk's "
        f"peak, the card's requested bytes, their ratio); max_safe_shape(pairing."
        f"miller_loop_product, h100_80gb) = {safe}; {part_s['b']:.1f} s")
    log(f"analysis (c): builds after warm-up {json.dumps(builds)}; (d) supervisor probe on "
        f"{sup['device']}: transparent {sup['transparent']}, builds {sup['steady_state_builds']}, "
        f"current devices {sup['current_devices']}, {part_s['d']:.1f} s; (e) lockdep in its own "
        f"process over phase 23 (b)'s firehose at {LD_VALIDATORS} keys ({ld['seconds']:.1f} s, "
        f"fixture {ld['fixture_s']:.1f} s; joined {part_s['e']:.1f} s after its start): "
        f"{len(edges)} observed edges over {ld['observed']['n_locks']} locks, acyclic alone and "
        f"merged: " + json.dumps([[e["from"], e["to"], e["count"]] for e in edges]))
    for ln in ld["log"]:
        log(f"analysis (e), the lockdep process: {ln}")
    return out


# --------------------------------------------------------------------------------------
# Kernel checks
# --------------------------------------------------------------------------------------


SRC = "lighthouse_tpu_torch/csrc/fused_mul.cu"
# phase 13's, 15's, 17's, 18's, 19's and 20's paths and the earlier path of the same shapes whose
# timed rows they share
CHAIN_TWINS = {"chain_import": "state_block", "chain_import2": "state_block",
               "chain_gossip": "gossip", "chain_firehose": "gossip",
               "net_gossip": "gossip", "net_socket": "gossip",
               "slasher_gossip": "gossip", "slasher_sigs": "net_historical",
               "restart_import": "state_block", "restart_gossip": "gossip",
               "api": "gossip", "cli_publish": "net_segment",
               "conformance": "net_segment", "discovery_publish": "net_segment"}
REPLACES = {
    "K1": "lighthouse_tpu/ops/bls/pallas_kernels.py:587 (fused_mul, lazy=False -> _build_call:497)",
    "K3": "lighthouse_tpu/ops/bls/pallas_kernels.py:620 (execute_plan -> _build_call:497)",
    "CHAIN": "lighthouse_tpu/ops/bls/pallas_kernels.py:587/:620 (one _build_call:497 launch per "
             "step of fq.py:887 pow_fixed_scan, tower.py:282 _sqrt_chain, "
             "tower.py:588 fq12_cyclotomic_exp_abs_x, tower.py:634 _cyc_exp_abs_x_compressed)",
}


def _replay_ops(ops, planes: int, w: int):
    """(multiply-adds, final width) of a split/trim/fold schedule."""
    n = 0
    for op in ops:
        if op[0] == "split":
            n += planes * (w + 1)
            w += 1
        elif op[0] == "trim":
            w = op[1]
        else:
            n += planes * 48 * op[1]
            w = 48
    return n, w


def _step_ops(sched) -> int:
    """int32 operations of one plan step on one row (a multiply-add counts
    two): the input lincombs' nonzero terms (int64 multiply-adds, counted as
    int32 ones so the bound stays a lower bound), the 51x51 digit conv, the
    schedule ops and the output map's nonzero terms."""
    terms = [int((pos != neg).sum()) for pos, neg, _ in (sched.lin_a, sched.lin_b)]
    mac = 25 * sum(terms) + sched.L * 2601
    n, w = _replay_ops(sched.pre_ops, sched.L, 101)
    mac += n
    if sched.has_out:
        mac += w * int((sched.mpos != sched.mneg).sum())
        mac += _replay_ops(sched.post_ops, sched.R, w)[0]
    return 2 * mac


def _bound(n_ops: int, n_bytes: int):
    t_ops = n_ops / H100_INT32_OPS_PER_S * 1e3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _time(fn, reps: int, warm: bool = True) -> float:
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _time_graph(fn, reps: int) -> float:
    """Device time per call of ``fn`` (kernel launches only): ``reps`` calls
    captured in one CUDA graph and replayed, so the host's enqueue cost of
    each launch stays out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (3 * reps)


def edge_limbs(lim: int, value_max: int, top: int) -> list[int]:
    """Limbs as large as the budget allows: limbs 0..22 at ``lim``, the top
    two filled greedily up to value ``value_max`` (limb 24 at most ``top``)."""
    edge = [lim] * 23
    room = value_max - sum(v << (16 * i) for i, v in enumerate(edge))
    l24 = min(lim, room >> 384, top)
    l23 = min(lim, (room - (l24 << 384)) >> 368)
    return edge + [l23, l24]


def _operand(rows: int, n_el: int, bound, gen, dev):
    """Random canonical elements, with row 0 at the bound's maxima."""
    import torch

    x = torch.randint(0, 1 << 16, (rows, n_el, 25), generator=gen, dtype=torch.int64)
    x[..., 23] &= 0x0FFF   # value < 2^380 < p
    x[..., 24] = 0
    x[0] = torch.tensor(edge_limbs(*bound), dtype=torch.int64)
    return x.to(dev)


def _check_layouts(sched=None, prog=None, C: int = 1) -> None:
    """The host's shared-memory sizes equal the CUDA source's own layout
    (lh_plan_smem_bytes / lh_chain_smem_bytes) at cluster size C."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    lib = fm._lib()
    if sched is not None:
        want = lib.lh_plan_smem_bytes(
            sched.n_a, sched.n_b, sched.L, sched.lanes_per_cta(C), sched.wmax, C,
            sched.threads(C),
        )
        got, what = sched.smem_bytes(C), sched.label
    else:
        threads, lane_words, all_words, got = prog.launch_shape(C)
        want = lib.lh_chain_smem_bytes(prog.n_state, prog.n_el, lane_words, all_words, threads)
        what = prog.name
    if got != want:
        raise RuntimeError(f"{what} C={C}: host smem {got} != the kernel's layout {want}")


def _signature(sched):
    """The plan cache's key of a K3 schedule without the plan's id: (n_a,
    bound keys of a and b, name, output bound key); None for K1."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    for key, prep in fm._PLAN_CACHE.items():
        if prep.sched is sched:
            return key[1:]
    return None


def _plain_rows(fn, a, b, chunk: int = 4096):
    """``fn(a, b)`` over row chunks (the plan's plain version is
    row-independent): bounded memory at the block's large row counts."""
    import torch

    if a.shape[0] <= chunk:
        return fn(a, b)
    return torch.cat([fn(a[i:i + chunk], b[i:i + chunk]) for i in range(0, a.shape[0], chunk)])


def exact_checks(shapes: dict, dev, gen, done: set) -> int:
    """Hold the plan kernel (K1, K3) and the chain kernel bit-exact against
    their plain versions at every (schedule or chain, rows) in ``shapes``
    (a launch log) not in ``done``; adds them to ``done``. Random canonical
    inputs with row 0 at the bound's maxima. Returns how many it checked."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    n = 0
    for kind, label, rows in sorted(shapes, key=lambda k: (k[0], k[1], k[2])):
        if (kind, label, rows) in done:
            continue
        if kind == "CHAIN":
            prog = fm.CHAINS[label]
            base = _operand(rows, prog.n_el, prog.scheds[0].in_bounds[0], gen, dev)
            got = fm.cuda_chain(prog, base)
            torch.cuda.synchronize()
            err = int((got - fm.plain_chain(prog, base)).abs().max().item())
        else:
            sched = fm.SCHEDULES[label]
            a = _operand(rows, sched.n_a, sched.in_bounds[0], gen, dev)
            b = _operand(rows, sched.n_b, sched.in_bounds[1], gen, dev)
            got = fm.cuda_fused(sched, a, b)
            torch.cuda.synchronize()
            want = _plain_rows(lambda x, y: fm.plain_plan(sched, x, y), a, b)
            err = int((got - want).abs().max().item())
        if err != 0:
            raise RuntimeError(f"{kind} {label} rows={rows}: kernel != plain (max |diff| {err})")
        done.add((kind, label, rows))
        n += 1
    return n


def plan_timing(label: str, rows: int, dev, gen) -> dict:
    """The plan kernel on one schedule at ``rows``: device time (graph
    replay), time per launch from Python, the plain version's time, and the
    bound."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    sched = fm.SCHEDULES[label]
    a = _operand(rows, sched.n_a, sched.in_bounds[0], gen, dev)
    b = _operand(rows, sched.n_b, sched.in_bounds[1], gen, dev)
    C = fm.cluster_size(rows, sched.L) if sched.has_out else 1
    _check_layouts(sched=sched, C=C)
    ms = _time_graph(lambda: fm.cuda_fused(sched, a, b), TIMING_REPS)
    host_ms = _time(lambda: fm.cuda_fused(sched, a, b), TIMING_REPS)
    plain_ms = _time(lambda: _plain_rows(lambda x, y: fm.plain_plan(sched, x, y), a, b), PLAIN_REPS)
    n_bytes = rows * (sched.n_a + sched.n_b + sched.R) * 200 + sched.ints.nbytes + sched.i64.nbytes
    bound_ms, bound_by = _bound(rows * _step_ops(sched), n_bytes)
    log(f"plan {sched.kind} {label} rows={rows} L={sched.L} R={sched.R} C={C}: "
        f"{ms:.5f} ms kernel (graph), {host_ms:.5f} ms per launch from Python, "
        f"{plain_ms:.3f} ms plain, bound {bound_ms:.7f} ms ({bound_by})")
    return {
        "kind": sched.kind, "name": label, "rows": rows, "lanes": sched.L,
        "out_rows": sched.R, "n_pass": sched.n_pass, "cluster": C,
        "threads": sched.threads(C), "smem": sched.smem_bytes(C), "max_abs_err": 0,
        "ms": ms, "launch_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "signature": _signature(sched),
    }


def chain_timing(name: str, rows: int, dev, gen) -> dict:
    """The chain kernel on one chain at ``rows``: device time, time from
    Python, its own step loop of plan launches, the plain version, the
    bound (the sum of its steps)."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    prog = fm.CHAINS[name]
    base = _operand(rows, prog.n_el, prog.scheds[0].in_bounds[0], gen, dev)
    C = prog.cluster(rows)
    _check_layouts(prog=prog, C=C)
    ms = _time_graph(lambda: fm.cuda_chain(prog, base), 5)
    host_ms = _time(lambda: fm.cuda_chain(prog, base), 5)
    step_ms = _time_graph(lambda: fm.replay_chain(prog, base, fm.cuda_fused), 1)
    step_host_ms = _time(lambda: fm.replay_chain(prog, base, fm.cuda_fused), 1)
    # the exact checks ran the plain version at this shape: one timed call, no warm-up
    plain_ms = _time(lambda: fm.plain_chain(prog, base), 1, warm=False)
    n_ops = rows * sum(_step_ops(prog.scheds[d]) for d, *_ in prog.steps if d != fm.COPY)
    n_bytes = rows * prog.n_el * 200 * 2 + prog.prog.nbytes
    bound_ms, bound_by = _bound(n_ops, n_bytes)
    threads, _, _, smem = prog.launch_shape(C)
    log(f"chain {name} rows={rows} C={C} ({prog.n_mults} multiplies): {ms:.4f} ms "
        f"kernel (graph), {host_ms:.4f} ms from Python; step loop {step_ms:.4f} ms (graph), "
        f"{step_host_ms:.4f} ms from Python; {plain_ms:.1f} ms plain; bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return {
        "kind": "CHAIN", "name": name, "rows": rows, "lanes": max(s.L for s in prog.scheds),
        "out_rows": prog.n_el, "n_pass": 0, "cluster": C, "threads": threads,
        "smem": smem, "steps": len(prog.steps), "mults": prog.n_mults, "max_abs_err": 0,
        "ms": ms, "launch_ms": host_ms, "step_loop_ms": step_ms,
        "step_loop_launch_ms": step_host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def timed_rows(path_logs: dict, dev, gen, largest=(), known=None) -> list:
    """For each path's launch log, each schedule and chain timed at its
    most-launched row count there, and for the paths in ``largest`` at its
    largest row count too (one timing per (kind, name, rows) over all
    paths). Each row records the paths that chose it and, per path, the
    launches at that row count. A (kind, name, rows) in ``known`` (earlier
    rows by that key) is not timed again: its timing is copied, marked
    ``reused``."""
    chosen: dict = {}
    for path, shapes in path_logs.items():
        per_name: dict = {}
        for (kind, name, rows), c in shapes.items():
            per_name.setdefault((kind, name), {})[rows] = c
        for (kind, name), seen in per_name.items():
            picks = {max(seen, key=lambda r: (seen[r], r))}
            if path in largest:
                picks.add(max(seen))
            for rows in picks:
                chosen.setdefault((kind, name, rows), {})[path] = {
                    "launches_at_rows": seen[rows],
                    "shapes": {str(r): c for r, c in sorted(seen.items())},
                }
    out = []
    for (kind, name, rows), paths in sorted(chosen.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])):
        if known and (kind, name, rows) in known:
            r = {**known[(kind, name, rows)], "reused": True}
        elif kind == "CHAIN":
            r = chain_timing(name, rows, dev, gen)
        else:
            r = plan_timing(name, rows, dev, gen)
        r["paths"] = paths
        out.append(r)
    return out


def cluster_checks(dev, gen) -> list:
    """Cluster sizes 1, 2, 4 and 8 at rows 1 (the final exponentiation's
    shape): MUL12 and CYC_SQR through the plan kernel and the |x| chain,
    each bit-exact against its plain version and timed."""
    import torch

    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    out = []
    for label in ("fq12_mul_c", "cyc_sqr_c"):
        sched = fm.SCHEDULES[label]
        a = _operand(1, sched.n_a, sched.in_bounds[0], gen, dev)
        b = _operand(1, sched.n_b, sched.in_bounds[1], gen, dev)
        want = fm.plain_plan(sched, a, b)
        for C in (1, 2, 4, 8):
            _check_layouts(sched=sched, C=C)
            got = fm.cuda_fused(sched, a, b, cluster=C)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"{label} cluster {C}: plan kernel != plain")
            ms = _time_graph(lambda: fm.cuda_fused(sched, a, b, cluster=C), 100)
            out.append({"name": label, "cluster": C, "ms": ms})
    prog = fm.CHAINS["cyc_exp_abs_x"]
    base = _operand(1, 12, prog.scheds[0].in_bounds[0], gen, dev)
    want = fm.plain_chain(prog, base)
    for C in (1, 2, 4, 8):
        _check_layouts(prog=prog, C=C)
        got = fm.cuda_chain(prog, base, cluster=C)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"cyc_exp_abs_x cluster {C}: chain kernel != plain")
        ms = _time_graph(lambda: fm.cuda_chain(prog, base, cluster=C), 5)
        out.append({"name": "cyc_exp_abs_x", "cluster": C, "ms": ms})
    log("cluster sizes 1/2/4/8 at rows 1, all exact: " + ", ".join(
        f"{r['name']} C={r['cluster']} {r['ms']:.5f} ms" for r in out))
    return out


# --------------------------------------------------------------------------------------
# Main
# --------------------------------------------------------------------------------------


def _counts_by_name() -> dict:
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    by_name: dict = {}
    for (kind, name, _rows), c in fm.launch_log.items():
        by_name[(kind, name)] = by_name.get((kind, name), 0) + c
    return by_name


def _read_counts(phase: str, need=("K1", "K3", "CHAIN")) -> dict:
    """Counts of the run just driven (set to 0 just before it): every entry
    in ``need`` launched, K2 never outside a chain, the plain version never.
    Returns {"by": launches by entry, "by_name": ..., "log": launch log}."""
    from lighthouse_tpu_torch.ops.bls import fused_mul as fm

    counts = dict(fm.launches_by)
    if fm.plain_calls != 0:
        raise RuntimeError(f"{phase}: the plain version ran {fm.plain_calls} times")
    for kind in need:
        if counts[kind] == 0:
            raise RuntimeError(f"{phase}: kernel entry {kind} never launched")
    if counts["K2"] != 0:
        raise RuntimeError(f"{phase}: K2 launched outside a chain")
    return {"by": counts, "by_name": _counts_by_name(), "log": dict(fm.launch_log),
            "total": fm.launches}


def _snapshot_clean(snap: dict) -> None:
    bad = {k: snap[k] for k in ("faults", "retries", "demotions", "fallback_calls",
                                "watchdog_timeouts", "exhausted", "hung_threads") if snap[k]}
    if bad or snap["state"] != "HEALTHY":
        raise RuntimeError(f"firehose supervisor not clean: {snap}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--validators", type=int, default=1 << 20)
    ap.add_argument("--sets", type=int, default=64)
    ap.add_argument("--keys", type=int, default=512)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--report", default=None,
                    help="also write every measurement as JSON to this path")
    ap.add_argument("--lockdep-child", default=None, metavar="PATH",
                    help="run only phase 24 (e), the process phase 24 starts, and write its "
                         "observed lock graph to PATH")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "lighthouse_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    if args.lockdep_child:
        return lockdep_child(args.lockdep_child, args.seed)

    from lighthouse_tpu_torch import bls
    from lighthouse_tpu_torch.bls import backend, pubkey_cache
    from lighthouse_tpu_torch.firehose import FirehoseConfig, FirehoseEngine
    from lighthouse_tpu_torch.ops.bls import fq, fused_mul as fm
    from lighthouse_tpu_torch.oracle import hash_to_curve as oh
    from lighthouse_tpu_torch.oracle.ciphersuite import DST
    from lighthouse_tpu_torch.resilience import get_supervisor

    dev = torch.device("cuda")
    t_start = time.time()

    # 1. build (the native backend's g++ build runs beside, for phase 20)
    import threading

    from lighthouse_tpu_torch import native

    native_build: dict = {}

    def build_native():
        t0 = time.time()
        try:
            native.load_bls()
        except Exception as e:  # noqa: BLE001 — raised again in phase 20
            native_build["error"] = e
        native_build["s"] = time.time() - t0

    native_thread = threading.Thread(target=build_native, name="native-build", daemon=True)
    native_thread.start()
    t = time.time()
    fm.build(verbose=True)
    log(f"build: {time.time() - t:.2f} s")

    # 2. fixture
    rng = np.random.default_rng(args.seed)
    sk0 = int(rng.integers(1 << 62)) | 1
    t = time.time()
    # the fixtures' oracle arithmetic is pure Python: one spawned worker per
    # host core (no child inherits the parent's threads), terminated on exit
    n_workers = max(1, min(len(os.sched_getaffinity(0)), REGISTRY_CHUNKS))
    with multiprocessing.get_context("spawn").Pool(n_workers) as fixture_pool:
        raw = _registry(args.validators, sk0, fixture_pool)
        log(f"fixture registry: {args.validators} keys in {time.time() - t:.2f} s "
            f"({n_workers} worker processes)")
        t = time.time()
        n_b = args.batches + 2  # warm-up, timed, poisoned
        batches = [_batch(rng, args.validators, sk0, args.sets, args.keys, pool=fixture_pool)
                   for _ in range(n_b - 1)]
        poisoned = _batch(rng, args.validators, sk0, args.sets, args.keys, poison=True,
                          pool=fixture_pool)
        log(f"fixture signatures: {n_b * args.sets} sets in {time.time() - t:.2f} s")
        t = time.time()
        block, block_sks = _block(rng, raw, sk0, BLOCK_ATTESTATIONS, args.keys, pool=fixture_pool)
        block_bad = _poison(block, block_sks, len(block) // 2)
        small, small_sks = _block(rng, raw, sk0, 1, 8, pool=fixture_pool)
        small_bad = _poison(small, small_sks, 3)
        n_block_keys = sum(len(s.signing_keys) for s in block)
        log(f"fixture block: {len(block)} sets, {n_block_keys} keys, in {time.time() - t:.2f} s")
    t = time.time()
    pool = _gossip_pool(rng, args.validators, sk0, COMMITTEES, 32)
    bad_pos = (17, 42)
    bis_items = list(pool[:64])
    for j in bad_pos:  # another committee's signature: a valid point, a wrong signer
        other = next(it for it in pool[64:] if it[1] != bis_items[j][1])
        bis_items[j] = (bis_items[j][0], bis_items[j][1], other[2])
    log(f"fixture gossip pool: {len(pool)} single-key attestations in {time.time() - t:.2f} s")
    t = time.time()
    # the state-transition block's bls shape (phase 12): proposer, randao and
    # ATT_SLOTS + 1 aggregates padded to one slot's attesters (n / 32 keys)
    sblock, _ = _block(np.random.default_rng(args.seed + 12), raw, sk0, ATT_SLOTS,
                       max(1, args.validators // 32))
    log(f"fixture state-block shape: {len(sblock)} sets, "
        f"{sum(len(s.signing_keys) for s in sblock)} keys in {time.time() - t:.2f} s")
    t = time.time()
    fm.reset_counts()
    kz = kzg_fixture(args.seed, dev)
    kzg_fixture_log = dict(fm.launch_log)
    log(f"fixture kzg: the port's trusted setup loaded in {kz['setup_s']:.2f} s; "
        f"{len(kz['blobs'])} blobs of {kz['kzg'].n} field elements, their commitments (one "
        f"4096-lane device MSM each: {json.dumps(_spread(kz['commit_ms']))} ms) and blob proofs; "
        f"cells of every blob ({kz['cells_s']:.1f} s of host FFTs); custody columns "
        f"{kz['custody']} and their {len(kz['proofs'])} cell proofs (one 4032-lane device MSM "
        f"each: {json.dumps(_spread(kz['proof_ms']))} ms); in {time.time() - t:.1f} s")
    cache = pubkey_cache.device_pubkeys_from_raw(raw, device=dev)
    torch.cuda.synchronize()

    def verify_gossip(items):
        return backend.verify_indexed_sets_device(cache, items, device=dev)

    def run_block_phase():
        ok = bls.verify_signature_sets(block, device=dev)
        bad = bls.verify_signature_sets(block_bad, device=dev)
        small_dev = [bls.verify_signature_sets(x, device=dev) for x in (small, small_bad)]
        warm = bls.warmup(device=dev)
        return ok, bad, small_dev, warm

    def run_bisect_phase():
        calls = []

        def counting(items):
            calls.append(list(items))
            return verify_gossip(items)

        engine = FirehoseEngine(
            prepare_fn=lambda ps: [([p], None) for p in ps], verify_items_fn=counting,
            config=FirehoseConfig(max_batch=64), synchronous=True,
        )
        verdicts = {}
        for i, it in enumerate(bis_items):
            engine.submit(it, callback=lambda p, ok, m, i=i: verdicts.__setitem__(i, ok))
        engine.drain()
        return verdicts, calls

    # 3. warm-up: one run of every path (schedules derived, path shapes recorded)
    path_logs = {}
    t = time.time()
    fm.reset_counts()
    if not backend.verify_indexed_sets_device(cache, batches[0], device=dev):
        raise RuntimeError("warm-up batch did not verify")
    path_logs["main"] = dict(fm.launch_log)
    log(f"warm-up batch: {time.time() - t:.2f} s")
    t = time.time()
    fm.reset_counts()
    if not bls.verify_signature_sets(block, device=dev):
        raise RuntimeError("warm-up block did not verify")
    path_logs["block"] = dict(fm.launch_log)  # the block's own shapes, for timing
    block_verify_by = dict(fm.launches_by)  # launches in one block verify
    fm.reset_counts()
    if run_block_phase() != (True, False, [True, False], True):
        raise RuntimeError("warm-up of the block phase gave wrong verdicts")
    block_phase_log = dict(fm.launch_log)
    fm.reset_counts()
    if not verify_gossip(pool[:64]):
        raise RuntimeError("warm-up gossip batch did not verify")
    path_logs["gossip"] = dict(fm.launch_log)
    fm.reset_counts()
    run_bisect_phase()
    bisect_log = dict(fm.launch_log)
    fm.reset_counts()
    if not bls.verify_signature_sets(sblock, device=dev):
        raise RuntimeError("warm-up of the state-block shape did not verify")
    path_logs["state_block"] = dict(fm.launch_log)
    # phase 15's new batch shapes: the segment's single-key sets (two a block) through
    # the bls API; a backfilled block's proposer signature (one indexed item);
    # sync-committee messages (one item each) and a contribution (selection
    # proof, envelope, 64 participants)
    nrng = np.random.default_rng(args.seed + 15)
    seg_sets, _ = _block(nrng, raw, sk0, 2 * (1 + NET_BLOCKS) - 3, 1)
    fm.reset_counts()
    if not bls.verify_signature_sets(seg_sets, device=dev):
        raise RuntimeError("warm-up of the segment shape did not verify")
    path_logs["net_segment"] = dict(fm.launch_log)
    fm.reset_counts()
    if not verify_gossip(pool[:1]):
        raise RuntimeError("warm-up of the historical shape did not verify")
    path_logs["net_historical"] = dict(fm.launch_log)
    fm.reset_counts()
    contribution_shape = [pool[0], pool[1], _batch(nrng, args.validators, sk0, 1, 64)[0]]
    if not (verify_gossip(pool[1:2]) and verify_gossip(contribution_shape)):
        raise RuntimeError("warm-up of the sync-message shapes did not verify")
    path_logs["net_sync"] = dict(fm.launch_log)
    torch.cuda.synchronize()
    log(f"warm-up of the block, gossip, bisection, state-block and network paths: "
        f"{time.time() - t:.2f} s")
    from lighthouse_tpu_torch.types.spec import mainnet_spec

    espec = mainnet_spec(altair_fork_epoch=0, bellatrix_fork_epoch=0, capella_fork_epoch=0,
                         deneb_fork_epoch=0, electra_fork_epoch=0)
    lc_warm = lc_warmup(espec, raw, sk0, dev, args.seed)
    path_logs.update(lc_warm.pop("logs"))
    log(f"warm-up of the light-client paths: two 512-key committees and {LC_SESSIONS} sessions "
        f"built in {lc_warm['fixture_s']:.2f} s, their cache rows decompressed in "
        f"{lc_warm['rows_s']:.2f} s; batches of {LC_SESSIONS} and {LC_MIXED} sessions True in "
        f"{lc_warm['verify_s']:.2f} s")
    t = time.time()
    kz_logs = kzg_warmup(kz, dev)
    path_logs["kzg_column"] = kz_logs["kzg_column"]  # the batch's rows are timed in phase 14
    log(f"warm-up of the kzg paths: batch tables built in {kz['table_build_s'] * 1e3:.1f} ms, "
        f"the coset-shift table in {kz['z2_build_s'] * 1e3:.1f} ms ({kz['table_bytes']} B on "
        f"the card), one column verify and batches at n_pad {sorted(kz_logs['batches'])} True; "
        f"{time.time() - t:.2f} s")

    # 4. kernels against their plain versions at every shape the paths gave them
    gen = torch.Generator().manual_seed(20261017)
    done: set = set()
    t = time.time()
    n_exact = sum(
        exact_checks(lg, dev, gen, done)
        for lg in (*path_logs.values(), block_phase_log, bisect_log, kzg_fixture_log,
                   kz_logs["tables"], *kz_logs["batches"].values())
    )
    log(f"exact: {n_exact} (kernel, schedule or chain, rows) shapes bit-exact against the "
        f"plain versions in {time.time() - t:.2f} s")
    krows = timed_rows(path_logs, dev, gen, largest=("state_block", "lc_batch"))
    clusters = cluster_checks(dev, gen)

    # 5. the main path
    from lighthouse_tpu_torch.analysis.recompile import BuildSentinel

    sentinel = BuildSentinel()  # phase 24 (c): the steady loops build nothing
    p24 = {"builds": {}, "resident": []}
    torch.cuda.reset_peak_memory_stats()
    stage_ms = {"host": 0.0, "h2c": 0.0, "prep": 0.0, "pair": 0.0}
    fm.reset_counts()
    mark = sentinel.snapshot()
    t_main = time.time()
    for items in batches[1:]:
        t = time.time()
        b = backend.prepare_batch(items, device=dev)
        torch.cuda.synchronize()
        t1 = time.time()
        mxa, mya = backend.h2c_stage(b["u0"], b["u1"])
        torch.cuda.synchronize()
        t2 = time.time()
        pre = backend.prep_stage(
            cache, b["idx"], b["mask"], b["sxc0"], b["sxc1"], b["s_flag"], b["sig_wf"],
            b["scalars"], b["valid"],
        )
        torch.cuda.synchronize()
        t3 = time.time()
        ok = bool(backend.pair_stage(*pre[:4], mxa, mya, pre[4], b["valid"]))
        t4 = time.time()
        if not ok:
            raise RuntimeError("a valid batch did not verify")
        for k, dt in zip(stage_ms, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            stage_ms[k] += dt * 1e3
    t_valid = time.time() - t_main
    p24["builds"]["phase5_timed_batches"] = sentinel.builds_since(mark)
    if backend.verify_indexed_sets_device(cache, poisoned, device=dev):
        raise RuntimeError("the poisoned batch verified")
    torch.cuda.synchronize()
    runs = {"main": _read_counts("main path")}
    peak = torch.cuda.max_memory_allocated()
    n_timed = len(batches) - 1
    sets_per_s = n_timed * args.sets / t_valid
    log(f"main path: {n_timed} valid batches of {args.sets} sets x {args.keys} keys "
        f"over {args.validators} validators: {t_valid:.3f} s, {sets_per_s:.2f} sets/s")
    log("ms per batch: " + json.dumps({k: v / n_timed for k, v in stage_ms.items()}))
    per_batch = {k: v / (n_timed + 1) for k, v in runs["main"]["by"].items()}
    log(f"kernel launches per batch: {runs['main']['total'] / (n_timed + 1):.1f} "
        f"({json.dumps(per_batch)})")
    log(f"max_memory_allocated: {peak} bytes")

    # 6. the h2c stage against the oracle's hash_to_curve
    msgs = [m for _, m, _ in batches[1][:2]]
    u0, u1 = backend.h2c.hash_to_field_batch(msgs, DST, dev)
    mx, my = backend.h2c_stage(u0, u1)
    for i, m in enumerate(msgs):
        ox, oy = oh.hash_to_curve_g2(m, DST)
        got = [fq.to_int(fq.canonical(v[i, j])) for v in (mx, my) for j in (0, 1)]
        if got != [ox.c0, ox.c1, oy.c0, oy.c1]:
            raise RuntimeError("h2c stage disagrees with the oracle")
    log("h2c stage == oracle hash_to_curve on 2 messages")

    # 7. device busy share: one more valid batch under the profiler
    prof_ok, prof_wall_ms, dev_us, host_ops = _profiled(
        lambda: backend.verify_indexed_sets_device(cache, batches[1], device=dev))
    if not prof_ok:
        raise RuntimeError("the profiled batch did not verify")
    busy_ms = sum(dev_us.values()) / 1e3
    batch_ms = t_valid * 1e3 / n_timed
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    if busy_ms:
        log(f"device busy per batch: {busy_ms:.3f} ms of {batch_ms:.3f} ms unprofiled "
            f"({prof_wall_ms:.3f} ms profiled): idle share {1 - busy_ms / batch_ms:.4f}")
        log(f"torch (aten) ops dispatched in the profiled batch: {host_ops}")
        for k, us in top:
            log(f"  device time {us / 1e3:9.3f} ms  {k[:100]}")
    else:
        log("device busy share: not measured (the profiler recorded no device time)")

    # 8. the bls API at block width (BASELINE config #3)
    fm.reset_counts()
    host_ms, dev_ms = [], []
    for _ in range(BLOCK_REPS):
        t = time.time()
        prepared = bls.prepare_sets(block, device=dev)
        torch.cuda.synchronize()
        host_ms.append((time.time() - t) * 1e3)
        t = time.time()
        if not bls.verify_prepared_sets(prepared):
            raise RuntimeError("the block did not verify (prepared halves)")
        dev_ms.append((time.time() - t) * 1e3)
    blk_ok, blk_prof_ms, blk_dev_us, blk_ops = _profiled(lambda: bls.verify_prepared_sets(prepared))
    if not blk_ok:
        raise RuntimeError("the profiled block did not verify")
    blk_busy_ms = sum(blk_dev_us.values()) / 1e3
    dev_half = _spread(dev_ms)
    block_t = {"host_ms": _spread(host_ms), "device_half_ms": dev_half,
               "device_busy_ms": blk_busy_ms, "profiled_ms": blk_prof_ms, "aten_ops": blk_ops,
               "idle_share": 1 - blk_busy_ms / dev_half["median"] if blk_busy_ms else None}
    t = time.time()
    block_res = run_block_phase()
    block_phase_s = time.time() - t
    runs["block"] = _read_counts("block phase")
    small_oracle = [bls.verify_signature_sets_oracle(x) for x in (small, small_bad)]
    if block_res[0] is not True:
        raise RuntimeError("verify_signature_sets: the valid block did not verify")
    if block_res[1] is not False:
        raise RuntimeError("verify_signature_sets: the block with a poisoned signature verified")
    if block_res[2] != small_oracle or small_oracle != [True, False]:
        raise RuntimeError(f"small sets: device {block_res[2]} != oracle {small_oracle}")
    if block_res[3] is not True:
        raise RuntimeError("bls.warmup() did not return True")
    n_new = exact_checks(runs["block"]["log"], dev, gen, done)
    log(f"block: {len(block)} sets ({n_block_keys} keys; n_pad {backend.bucket(len(block))}, "
        f"k_pad {backend.bucket(args.keys)}): host half (points -> limbs, hash_to_field, "
        f"padding, upload) {json.dumps(block_t['host_ms'])} ms; device half (aggregation + "
        f"verify, to the verdict; wall, host dispatch included) "
        f"{json.dumps(block_t['device_half_ms'])} ms over {BLOCK_REPS} repeats; device busy "
        f"{blk_busy_ms:.3f} ms ({blk_prof_ms:.3f} ms profiled, {blk_ops} aten ops): idle "
        f"share {block_t['idle_share']}; launches per verify {json.dumps(block_verify_by)}; "
        f"valid True, poisoned False, 4 small sets == oracle "
        f"{small_oracle}, warmup() True; phase {block_phase_s:.2f} s; "
        f"launches {json.dumps(runs['block']['by'])}; {n_new} new shapes checked exact")

    # 9. the gossip firehose at BASELINE config #5
    sup = get_supervisor("chip_smoke.firehose")
    engine = FirehoseEngine(
        prepare_fn=lambda ps: [([p], None) for p in ps],
        verify_items_fn=verify_gossip,
        config=FirehoseConfig(max_batch=64, deadline_s=0.010, intake_capacity=1024),
        supervisor=sup,
    )
    fm.reset_counts()
    mark = sentinel.snapshot()
    n_stream, wall = _pace_stream(engine, pool, FIREHOSE_RATE, STREAM_S, 120.0)
    p24["builds"]["phase9_firehose"] = sentinel.builds_since(mark)
    st = engine.stats()
    runs["gossip"] = _read_counts("firehose phase")
    snap = sup.snapshot()
    if st.rejected or st.errored or st.device_faults:
        raise RuntimeError(f"firehose: rejected/errored/faulted batches: {st.as_dict()}")
    _snapshot_clean(snap)
    if st.verified == 0:
        raise RuntimeError("firehose: nothing verified")
    slo = _slo_block(st, n_stream)
    att_per_s = st.verified / wall
    n_new = exact_checks(runs["gossip"]["log"], dev, gen, done)
    t = time.time()
    n_alone = min(FIREHOSE_ALONE, len(pool) // 64)
    for i in range(n_alone):
        if not verify_gossip(pool[64 * i: 64 * (i + 1)]):
            raise RuntimeError("a standalone gossip batch did not verify")
    alone_s = time.time() - t
    alone_per_s = n_alone * 64 / alone_s
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed")
    card = smi.stdout.strip().splitlines()[0]
    fh = {
        "verified_att_per_s": att_per_s, "offered_att_per_s": FIREHOSE_RATE, "offered": n_stream,
        "accepted": st.submitted, "verified": st.verified, "dropped": st.dropped,
        "drop_rate": st.dropped / n_stream, "batches_formed": st.batches_formed,
        "p50_queue_ms": st.p50_latency_s * 1e3, "p99_queue_ms": st.p99_latency_s * 1e3,
        "wall_s": wall, "slo": slo, "standalone_att_per_s": alone_per_s,
        "standalone_ms_per_batch": alone_s * 1e3 / n_alone,
        "launches_per_batch": runs["gossip"]["total"] / st.batches_formed,
        "supervisor": snap, "card": card,
    }
    log(f"firehose: {att_per_s:.2f} att/s verified (offered {FIREHOSE_RATE:.0f} att/s for "
        f"{STREAM_S} s: {n_stream} offered, {st.submitted} accepted, {st.dropped} "
        f"dropped, drop rate {fh['drop_rate']:.4f}); {st.batches_formed} batches; queue "
        f"latency p50 {fh['p50_queue_ms']:.2f} ms p99 {fh['p99_queue_ms']:.2f} ms; SLO "
        f"{json.dumps(slo)}; card {card}")
    log(f"firehose beside the standalone rate: {alone_per_s:.2f} att/s for {n_alone} batches of "
        f"64 x 1 unthreaded; {fh['launches_per_batch']:.1f} launches per batch "
        f"({json.dumps(runs['gossip']['by'])}); {n_new} new shapes checked exact")

    # 10. bisection on the card
    fm.reset_counts()
    verdicts, calls = run_bisect_phase()
    runs["bisect"] = _read_counts("bisection phase")
    want = [i not in bad_pos for i in range(64)]
    if [verdicts[i] for i in range(64)] != want:
        raise RuntimeError(f"bisection: verdicts {verdicts} != poisoned at {bad_pos}")
    order = [bis_items.index(it) for it in calls[0]]
    n_calls_ref = 1 + _bisect_calls(order, set(bad_pos))
    if len(calls) != n_calls_ref:
        raise RuntimeError(f"bisection: {len(calls)} verify calls, the reference algorithm "
                           f"makes {n_calls_ref}")
    n_new = exact_checks(runs["bisect"]["log"], dev, gen, done)
    log(f"bisection: 64 items, poisoned at {list(bad_pos)}: exactly those False; "
        f"{len(calls)} verify calls (reference algorithm: {n_calls_ref}), sizes "
        f"{[len(c) for c in calls]}; {n_new} new shapes checked exact")

    # 23 (a), (b). the serving mesh: phase 5's batches and the firehose over MESH_SHARDS
    # logical shards on the card (23 (c)-(e) run where their fixtures live: after phase
    # 13, inside phases 11, 14 and 16, after phase 17; 23 (f) after phase 22)
    p23, p23_s = {}, {}
    t = time.time()
    p23["a"] = mesh_main_phase(cache, batches, poisoned, small, small_bad, small_oracle,
                               t_valid * 1e3 / n_timed, dev)
    runs.update(p23["a"].pop("runs"))
    p23_s["a"] = time.time() - t
    t = time.time()
    p23["b"] = mesh_firehose_phase(cache, pool, bis_items, bad_pos, sk0, dev, verify_gossip,
                                   alone_per_s)
    runs.update(p23["b"].pop("runs"))
    p23_s["b"] = time.time() - t

    # 11. epoch boundaries on the device (BASELINE config #4)
    from lighthouse_tpu_torch.oracle import curves as oc

    erng = np.random.default_rng(args.seed + 11)
    t = time.time()
    comp = _compressed(raw)
    for i in (0, 1, 2, args.validators - 1):
        pt = (int.from_bytes(raw[i, :48].tobytes(), "big"), int.from_bytes(raw[i, 48:].tobytes(), "big"))
        if comp[i] != oc.g1_compress(pt):
            raise RuntimeError(f"compressed pubkey {i} != the oracle's")
    log(f"epoch: {args.validators} compressed pubkeys in {time.time() - t:.2f} s")
    t = time.time()
    parity = epoch_parity_phase(espec, raw, comp, dev, erng)
    log(f"epoch parity at {parity['validators']} validators: device boundary == numpy per_epoch "
        f"(balances, inactivity, registry epochs, churn carries, queues, tree_root); device "
        f"{parity['device_s']:.3f} s (first bind included), numpy {parity['numpy_s']:.3f} s, "
        f"first state root {parity['first_root_s']:.2f} s; phase {time.time() - t:.1f} s")
    t = time.time()
    estate, sync_idx, epoch_m = epoch_phase(espec, raw, comp, dev, erng)
    p24["resident"].append(epoch_m["resident"])
    p24["builds"]["phase11_timed_boundary"] = epoch_m["timed_builds"]
    log(f"epoch: {args.validators} validators, state built in {epoch_m['build_s']:.2f} s, mirror "
        f"bound in {epoch_m['bind_s']:.2f} s; warm-up boundary {epoch_m['warmup']['epoch_ms']:.2f} "
        f"ms in the engine ({epoch_m['warmup']['slots_ms']:.2f} ms through process_slots); "
        f"{EPOCH_TIMED} timed boundaries: ms per epoch {json.dumps(epoch_m['epoch_ms'])}, "
        f"{epoch_m['validators_per_s']:.0f} validators/s, process_slots ms "
        f"{[round(b['slots_ms'], 2) for b in epoch_m['timed']]}, host->device bytes per epoch "
        f"{epoch_m['h2d_bytes_per_epoch']}; every boundary on the device, supervisor "
        f"{json.dumps(epoch_m['supervisor'])}; phase {time.time() - t:.1f} s")
    if "busy_ms" in epoch_m:
        log(f"epoch profiled boundary: device busy {epoch_m['busy_ms']:.3f} ms "
            f"({epoch_m['profiled_ms']:.3f} ms profiled, {epoch_m['aten_ops']} aten ops): idle "
            f"share {epoch_m['idle_share']:.4f} of the median epoch; byte bound "
            f"{epoch_m['bound_ms']:.5f} ms ({epoch_m['sweep_bytes']} B at 3.35 TB/s); top "
            f"{json.dumps({k[:60]: round(v, 3) for k, v in epoch_m['device_ms_by_name'].items()})}")
    else:
        log("epoch profiled boundary: device busy time not measured (no device time recorded)")

    # phase 13's anchor: the post-boundary state, justification one epoch behind;
    # the blocks of phases 12 and 13 go one slot later
    from lighthouse_tpu_torch import state_transition as st

    t = time.time()
    _recent_checkpoints(espec, estate)
    anchor = estate.copy()
    st.process_slots(espec, estate, int(estate.slot) + 1)
    log(f"chain anchor: state copied and the block's pre-state advanced one slot in "
        f"{time.time() - t:.1f} s")

    # 12. a block through the state transition (BASELINE config #3)
    t = time.time()
    sb = state_block_phase(espec, estate, raw, sk0, sync_idx, dev, erng)
    del estate
    sb_block, sb_bad = sb.pop("block"), sb.pop("bad")
    runs.update(sb.pop("runs"))
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in ("state_block", "state_block_bad"))
    log(f"state block: slot {sb['slot']}, {sb['attestations']} attestations, {sb['sets']} sets, "
        f"{sb['keys']} keys, built in {sb['build_s']:.2f} s (shuffle of {args.validators} "
        f"indices {sb['shuffle_s']:.3f} s, the previous epoch's committees "
        f"{sb['committees_s']:.3f} s); per_block_processing(VERIFY_BULK) "
        f"{sb['total_ms']:.2f} ms = host part (committees, indexed attestations, sets) "
        f"{sb['host_part_ms']:.2f} + verify {sb['verify']['host_half_ms']:.2f} host half + "
        f"{sb['verify']['device_half_ms']:.2f} device half (one batch) + operations "
        f"{sb['operations_ms']:.2f} + state root {sb['state_root_ms']:.2f} ms; poisoned block "
        f"raised; launches {json.dumps(runs['state_block']['by'])}; {n_new} new shapes checked "
        f"exact; phase {time.time() - t:.1f} s")

    # 13. the beacon chain over the same registry
    t = time.time()
    ch, chain = chain_phase(espec, anchor, raw, sk0, sync_idx, sb_block, sb_bad, cache, dev, erng)
    del anchor  # the chain's genesis_state: node C's anchor in phase 18
    runs.update(ch.pop("runs"))
    gossip13 = ch.pop("gossip_atts")
    chain_runs = ("chain_import", "chain_import_bad", "chain_import2", "chain_gossip",
                  "chain_aggregates", "chain_firehose")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in chain_runs)
    log(f"chain: {n_new} new shapes checked exact; phase {time.time() - t:.1f} s")
    t = time.time()
    p23["c"] = mesh_chain_phase(chain, gossip13, ch.pop("gossip_bad"), dev)
    runs.update(p23["c"].pop("runs"))
    p23_s["c"] = time.time() - t

    # 14. a sampling node's slot of blob data on the same chain
    t = time.time()
    km = kzg_phase(espec, chain, kz, lambda i: sk0 + i, dev, erng)
    runs.update(km.pop("runs"))
    kzg_runs = ("kzg_pending", "kzg_poisoned", "kzg_columns", "kzg_import", "kzg_batch",
                "kzg_column")
    unseen = sorted({s for k in ("kzg_poisoned", "kzg_columns", "kzg_batch", "kzg_column")
                     for s in runs[k]["log"] if s not in done})
    if unseen:
        raise RuntimeError(f"kzg: shapes phase 4 did not check: {unseen}")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in kzg_runs)
    # the batch's rows timed at its own n_pad (the slot's required set decides it)
    krows += timed_rows({"kzg_batch": runs["kzg_batch"]["log"]}, dev, gen)
    log(f"kzg: launches {json.dumps({k: runs[k]['by'] for k in kzg_runs})}; every kzg-path shape "
        f"checked in phase 4; {n_new} import shapes new since phase 4, checked exact; the batch's "
        f"rows timed at n_pad {km['n_pad']}; phase {time.time() - t:.1f} s")

    # 15. a second node over the network, on the same chain
    t = time.time()
    nm, net = network_phase(espec, chain, kz, raw, sk0, dev, erng, args.seed, ch["light_client"])
    runs.update(nm.pop("runs"))
    net_runs = ("net_build", "net_segment", "net_historical", "net_gossip_block", "net_columns",
                "net_gossip", "net_aggregates", "net_sync", "net_socket")
    unseen = sorted({s for k in net_runs for s in runs[k]["log"] if s not in done})
    if unseen:
        raise RuntimeError(f"network: shapes phases 4-14 did not check: {unseen}")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in net_runs)
    nm["phase_s"] = time.time() - t
    log(f"network: launches {json.dumps({k: runs[k]['by'] for k in net_runs})}; every shape "
        f"checked before the phase ({n_new} new); gossip through the network "
        f"{nm['gossip']['attestations']['verified_att_per_s']:.2f} att/s (sockets "
        f"{nm['sockets']['verified_att_per_s']:.2f}) beside phase 13's processor-direct "
        f"{ch['gossip']['verified_att_per_s']:.2f} att/s; phase {nm['phase_s']:.1f} s")

    # 16. a light client of the port's node, and the mass-service batch
    t = time.time()
    lm = lc_phase(espec, chain, net, sk0, dev, erng, args.seed)
    node_a = net["a"]  # phase 19 serves the API over it
    net["bus"].unregister("B")  # node B ends here: A's gossip reaches no one
    del net
    runs.update(lm.pop("runs"))
    lc_runs = ("lc_serve", "lc_batch", "lc_tampered", "lc_mixed")
    unseen = sorted({s for k in lc_runs for s in runs[k]["log"] if s not in done})
    if unseen:
        raise RuntimeError(f"light client: shapes phase 4 did not check: {unseen}")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in lc_runs)
    lm["phase_s"] = time.time() - t
    lc_import_ms = {"phase13": [ch["import1"]["light_client_ms"], ch["import2"]["light_client_ms"]],
                    "phase15": {"A": nm["light_client"]["A_ms"], "B": nm["light_client"]["B_ms"]}}
    log(f"light client: launches {json.dumps({k: runs[k]['by'] for k in lc_runs})}; every shape "
        f"checked in phase 4 ({n_new} new); the server cache inside the imports: phase 13 "
        f"{json.dumps([round(x, 2) for x in lc_import_ms['phase13']])} ms, phase 15 "
        f"{json.dumps({k: round(v, 2) for k, v in lc_import_ms['phase15'].items()})} ms in all; "
        f"phase {lm['phase_s']:.1f} s")

    # 17. the slasher: the bench cell, the deployment window, parity, the fault drill, node A's
    t = time.time()
    sm, sl17 = slasher_phase(espec, chain, sk0, dev, erng)
    runs.update(sm.pop("runs"))
    for cell in ("bench", "deploy"):
        p24["resident"].append(sm[cell]["resident"])
        p24["builds"][f"phase17_{cell}_ticks"] = sm[cell]["tick_builds"]
    slasher_runs = ("slasher_gossip", "slasher_sigs")
    unseen = sorted({s for k in slasher_runs for s in runs[k]["log"] if s not in done})
    if unseen:
        raise RuntimeError(f"slasher: shapes phase 4 did not check: {unseen}")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in slasher_runs)
    sm["phase_s"] = time.time() - t
    log(f"slasher: launches {json.dumps({k: runs[k]['by'] for k in slasher_runs})}; every shape "
        f"checked in phase 4 ({n_new} new); phase {sm['phase_s']:.1f} s")
    t = time.time()
    p23["e_slasher"] = mesh_slasher_check(dev)
    p23_s["e_slasher"] = time.time() - t

    # 18. node C restarts from disk
    t = time.time()
    box17 = [sl17]
    del sl17
    with tempfile.TemporaryDirectory(prefix="chip_smoke_node_c_") as node_dir:
        rm = restart_phase(espec, chain, sb_block, gossip13, raw, sk0, box17, dev, node_dir)
    del gossip13
    runs.update(rm.pop("runs"))
    restart_runs = ("restart_import", "restart_gossip")
    unseen = sorted({s for k in restart_runs for s in runs[k]["log"] if s not in done})
    if unseen:
        raise RuntimeError(f"restart: shapes phase 4 did not check: {unseen}")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in restart_runs)
    rm["phase_s"] = time.time() - t
    log(f"restart: every shape checked in phase 4 ({n_new} new); phase {rm['phase_s']:.1f} s")

    # 19. the client surface: the Beacon API over node A, then the CLI at interop size
    # (phase 21 runs on phase 19's nodes: its part (a) after 19 (a), its part (b) on 19 (b)'s node)
    t = time.time()
    am = api_phase(espec, chain, node_a, sk0, dev)
    runs.update(am.pop("runs"))
    unseen = sorted(s for s in runs["api"]["log"] if s not in done)
    if unseen:
        raise RuntimeError(f"api: shapes phase 4 did not check: {unseen}")
    am["phase_s"] = time.time() - t

    # 21 (a). an operator's validator client against node A
    t = time.time()
    va = vc_phase(espec, chain, node_a, sk0, dev)
    del chain, node_a
    runs.update(va.pop("runs"))
    va["phase_s"] = time.time() - t

    t = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as cli_dir:
        cm = cli_phase(dev, cli_dir)  # 21 (b), the CLI's validator client, runs inside it
    vb = cm.pop("vc_cli")
    runs.update(cm.pop("runs"))
    runs.update(vb.pop("runs"))
    cm["phase_s"] = time.time() - t - vb["phase_s"]
    api_runs = ("api", "cli_publish")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in api_runs)
    log(f"client surface: launches {json.dumps({k: runs[k]['by'] for k in api_runs})}; the API's "
        f"every shape checked in phase 4, {n_new} new shapes (the CLI node's) checked exact; "
        f"api {am['phase_s']:.1f} s, cli {cm['phase_s']:.1f} s")
    vc_runs = ("vc", "vc_cli")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in vc_runs)
    known = {(r["kind"], r["name"], r["rows"]): r for r in krows}
    vc_rows = timed_rows({k: runs[k]["log"] for k in vc_runs}, dev, gen, known=known)
    krows += vc_rows
    log(f"validator client: launches {json.dumps({k: runs[k]['by'] for k in vc_runs})}; {n_new} new "
        f"shapes checked exact; {sum(1 for r in vc_rows if not r.get('reused'))} of "
        f"{len(vc_rows)} kernel rows timed anew; (a) {va['phase_s']:.1f} s, (b) "
        f"{vb['phase_s']:.1f} s")

    # 20. the spec vectors on the card, native beside the device, ENR discovery
    t = time.time()
    native_thread.join()
    if "error" in native_build:
        raise native_build["error"]
    log(f"native: g++ build of lighthouse_tpu_torch/native/bls12_381.cpp {native_build['s']:.2f} s "
        f"(beside phases 1-19)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_enr_") as enr_dir:
        boot_proc = start_enr_boot_node(enr_dir)
        try:
            vm = conformance_phase(dev)
            runs.update(vm.pop("runs"))
            vm["native"] = native_phase(block, block_bad, (block_res[0], block_res[1]),
                                        block_t["device_half_ms"])
            dm = discovery_phase(dev, boot_proc, enr_dir)
            runs.update(dm.pop("runs"))
        finally:
            stop_process(boot_proc)
    vector_runs = ("conformance", "discovery_publish")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in vector_runs)
    vm["phase_s"] = time.time() - t
    log(f"spec vectors: launches {json.dumps({k: runs[k]['by'] for k in vector_runs})}; {n_new} "
        f"new shapes (the vectors' and the discovery nodes') checked exact; phase "
        f"{vm['phase_s']:.1f} s")

    # 22. the local network, the session fabricator and Karabina squaring
    t = time.time()
    part_s = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_local_net_") as ln_dir:
        ln = local_network_phase(dev, ln_dir, args.seed)
        part_s["a"] = time.time() - t
        net22 = ln.pop("net")
        runs.update(ln.pop("runs"))
        fb = lc_fabricated_phase(net22, dev, args.seed)
        runs.update(fb.pop("runs"))
        del net22
    part_s["b"] = time.time() - t - part_s["a"]
    ka = karabina_phase(cache, batches[1], poisoned, dev, gen)
    runs.update(ka.pop("runs"))
    part_s["c"] = time.time() - t - part_s["a"] - part_s["b"]
    ln_runs = ("local_net", "local_net_tampered", "lc_fabricated", "karabina", "karabina_direct")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in ln_runs)
    known = {(r["kind"], r["name"], r["rows"]): r for r in krows}
    ln_rows = timed_rows({k: runs[k]["log"] for k in ("local_net", "lc_fabricated", "karabina")},
                         dev, gen, known=known)
    krows += ln_rows
    ln["phase_s"] = time.time() - t
    part_s["checks"] = ln["phase_s"] - part_s["a"] - part_s["b"] - part_s["c"]
    ln["part_s"] = part_s
    log(f"local network, fabricator, karabina: launches "
        f"{json.dumps({k: runs[k]['by'] for k in ln_runs})}; {n_new} new shapes checked exact "
        f"after the phase; {sum(1 for r in ln_rows if not r.get('reused'))} of {len(ln_rows)} "
        f"kernel rows timed anew; phase {ln['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in part_s.items())})")

    # 23 (f). every shape the mesh ran held exact against its plain version, its new rows timed
    t = time.time()
    mesh_runs = ("mesh_combined", "mesh_pershard", "mesh_api", "mesh_firehose", "mesh_ladder",
                 "mesh_chain")
    n_new = sum(exact_checks(runs[k]["log"], dev, gen, done) for k in mesh_runs)
    known = {(r["kind"], r["name"], r["rows"]): r for r in krows}
    mesh_rows = timed_rows({k: runs[k]["log"] for k in mesh_runs}, dev, gen, known=known)
    krows += mesh_rows
    p23_s["f"] = time.time() - t
    p23_s["e_epoch"] = parity["mesh"]["phase_s"]
    p23.update(e_epoch=parity["mesh"], seconds=p23_s)
    p23["phase_s"] = sum(p23_s.values())
    p23["repeat_cuts"] = _repeat_cuts(block_t, epoch_m, km, nm, lm, ka, fh, krows)
    saved = sum(c["saved_s"] for c in p23["repeat_cuts"].values())
    log(f"mesh: launches {json.dumps({k: runs[k]['by'] for k in mesh_runs})}; {n_new} new shapes "
        f"checked exact; {sum(1 for r in mesh_rows if not r.get('reused'))} of {len(mesh_rows)} "
        f"kernel rows timed anew; phase 23 {p23['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in p23_s.items())}); the repeat cuts saved "
        f"{saved:.1f} s ({', '.join(f'{k} {c['saved_s']:.2f} s' for k, c in p23['repeat_cuts'].items())})")

    # 24. the analysis passes on the card
    t = time.time()
    p24["resident"].append(parity["mesh"]["resident"])
    am24 = analysis_phase(dev, card, done, p24, cache, batches[1], pool, kz, espec, args.seed)
    am24["phase_s"] = time.time() - t
    log(f"analysis: phase 24 {am24['phase_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in am24['part_s'].items())}; (e) beside (a)-(d))")

    log(f"elapsed: {time.time() - t_start:.1f} s")
    table = []
    for r in krows:
        kernel = "chain_kernel" if r["kind"] == "CHAIN" else "plan_kernel"
        for path in r["paths"]:
            launches = runs[path]["by_name"].get((r["kind"], r["name"]), 0)
            if launches == 0:
                raise RuntimeError(f"{r['kind']} {r['name']} never launched on the {path} path")
            table.append({
                "name": f"{kernel} {r['kind']} {r['name']} [{path}]", "route": "cuda",
                "source": SRC, "replaces": REPLACES[r["kind"]], "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                "rows": r["rows"], "lanes": r["lanes"], "out_rows": r["out_rows"],
                "cluster": r["cluster"], "launch_ms": r["launch_ms"],
            })
        for path, twin in CHAIN_TWINS.items():
            launches = runs[path]["by_name"].get((r["kind"], r["name"]), 0)
            if twin in r["paths"] and launches:
                table.append({**table[-1], "name": f"{kernel} {r['kind']} {r['name']} [{path}]",
                              "launches": launches})
    if args.report:
        with open(args.report, "w") as f:
            json.dump({
                "card": card, "config": vars(args), "sets_per_s": sets_per_s,
                "ms_per_batch": {k: v / n_timed for k, v in stage_ms.items()},
                "launches_per_batch": runs["main"]["total"] / (n_timed + 1),
                "launches_by": per_batch, "busy_ms": busy_ms, "batch_ms": batch_ms,
                "aten_ops": host_ops, "device_ms_by_name": {k: us / 1e3 for k, us in top},
                "peak_bytes": peak, "kernels": krows, "clusters": clusters,
                "exact_shapes": len(done),
                "block": {"sets": len(block), "keys": n_block_keys, **block_t,
                          "launches": runs["block"]["by"],
                          "launches_per_verify": block_verify_by},
                "firehose": fh,
                "bisect": {"calls": len(calls), "reference_calls": n_calls_ref,
                           "sizes": [len(c) for c in calls], "launches": runs["bisect"]["by"]},
                "epoch": epoch_m, "epoch_parity": parity,
                "state_block": {**sb, "launches": runs["state_block"]["by"]},
                "chain": {**ch, "launches": {k: runs[k]["by"] for k in chain_runs}},
                "kzg": {**km, "launches": {k: runs[k]["by"] for k in kzg_runs}},
                "network": {**nm, "launches": {k: runs[k]["by"] for k in net_runs}},
                "light_client": {**lm, "warmup": lc_warm, "import_ms": lc_import_ms,
                                 "launches": {k: runs[k]["by"] for k in lc_runs}},
                "slasher": {**sm, "launches": {k: runs[k]["by"] for k in slasher_runs}},
                "restart": {**rm, "launches": {k: runs[k]["by"] for k in restart_runs}},
                "client": {"api": am, "cli": cm,
                           "launches": {k: runs[k]["by"] for k in api_runs}},
                "validator_client": {"a": va, "b": vb,
                                     "launches": {k: runs[k]["by"] for k in vc_runs}},
                "vectors": {**vm, "discovery": dm,
                            "launches": {k: runs[k]["by"] for k in vector_runs}},
                "local_network": {**ln, "fabricated": fb, "karabina": ka,
                                  "launches": {k: runs[k]["by"] for k in ln_runs}},
                "mesh": {**p23, "launches": {k: runs[k]["by"] for k in mesh_runs}},
                "analysis": am24,
            }, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
