#!/usr/bin/env python3
"""Drives the torch/CUDA port (cometbft_tpu_torch) once on one NVIDIA card
and checks it.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --bls-cycles
    python3 chip_smoke.py --serve-peer DIR

`--bls-cycles` runs no phase below: it builds BLS_MICRO_CU alone and
prints one JSON line of clock64 cycles of the BLS kernels' pieces (where
one lane's time goes), and the card's name and power limit.
`--serve-peer DIR` is the p2p phase's child process: it serves the
FileDB block stores under DIR over TCP on the CPU (`serve_peer`).


Phases; any failure exits non-zero:
1. Build the six CUDA kernels from cometbft_tpu_torch/csrc/ (one nvcc
   per source, all started together); then the host C++ sources (csrc/host: the native
   log DB, the p2p link's ChaCha20-Poly1305 and the single-signature
   ed25519 that signs and checks votes) with g++; print the
   build seconds, the registers and spills ptxas reports, the card's
   name and power limit, and `grpc_importable` (whether this host could
   import the grpc package the gRPC transports would need).
2. Generate the pipeline's chain from --seed: 121 blocks of a
   200-validator set, 2 txs a block, through the real executor on the
   card (`engine/chain_gen.generate_chain`, as `bench.py:154` sizes
   blocksync): three full tiles of 40 x 200 = 8,000 lanes and one more
   block (24,200 precommit signatures over real sign-bytes), enough to
   keep several tiles in flight. The chain most later phases use is its
   first 48 blocks (`chain_prefix`: `generate_chain` makes block h the
   same whatever the chain's length, so these are the blocks and
   commits of a 48-block chain from the same seed, 9,600 signatures;
   the generator's app is replayed to 48). The 48-block chain's first
   8,192 lanes, flattened with `marshal_commit`, are the seam's tile.
3. Hold each kernel against its plain torch version on the card at the
   main path's shapes: decompression of the tile's A and R encodings in
   one call of 16,384 lanes, as the RLC verify makes it, with real, edge
   and random encodings (validity exact, points equal mod p, y as
   given), and of the R half alone; window sums per window as group
   elements, epilogue verdicts on cancelling and non-cancelling inputs
   (the clean tile, a changed [S]B digit, a loose point, and a Horner
   case where every window holds a point and only the whole radix-16
   Horner cancels them, with its one-digit variant), point additions as
   group elements (identity, P + (-P) and P + P lanes included), all at
   8192 lanes; decompression, window sums and additions again at 200
   lanes, a count that divides none of their blocks, so each kernel's
   masking of its ragged edge runs, and window sums at 3,000 lanes
   (three chunks, the last part empty); the epilogue's cases again on
   the partials of those 3,000 and 200 lanes (M = 4, and M = 1, the M
   of every light-client flush and mixed-set bucket). Integers allow no
   tolerance: every error must be 0.
   Then every kernel, the decompression at 8,192 lanes
   and the epilogue at M = 128 run under one torch.profiler session: one
   counted call each (the launch counter must equal the profiler's count
   of the source's `__global__` functions), then 20 rounds of one call
   of each in turn; `ms` is the median device time of a call. `call_ms`
   is CUDA events around one wrapper call, the host's launch included.
   Then time where a flush goes: the host marshal, SHA-512, the device
   part of the RLC verify, and (under torch.profiler) the kernel
   launches and device-busy time of the RLC verify and of the per-lane
   verify. Then the two BLS kernels (ops/bls12.py) against their plain
   versions at buckets 4, 16 and 64, exactly
   (final Fq12 limbs and verdicts): `bls_miller_finalexp` on line
   coefficients of the canary items, clean 2-pair commit items, tampered
   aggregates, a 1-pair item, an item with no pairs (identity lines), a
   lane of zero lines (f = 0) and a pad lane (at B = 4 two batches: the
   known-one canary, a clean and a tampered item and a pad lane, then a
   clean item, the 1-pair item, the no-pair item and the zero lane),
   `bls_hard_pow` on the same lanes' Miller products after the easy part
   (0 for the zero lane), and once at a 40-bit exponent; the verdicts
   against the host oracle; each kernel timed per bucket (torch.profiler
   device time, CUDA events around a call, the plain call). The previous
   designs (one thread a lane for decompression and addition, the BLS
   kernels before their redesign), once built beside the port's as
   yardsticks, are gone: their times stay in PERF.md.
4. The paths, each with the launch counters zeroed just before it and
   read just after:
   - the BatchVerifier seam (`create_batch_verifier` ->
     Ed25519BatchVerifier, batch 8192): a clean tile (all True through
     the RLC equation), a tile with tampered s values and a malformed
     lane (False on exactly those), a 200-lane flush (one commit, bucket
     256), and 256 lanes against the oracle `ref_ed25519.verify`;
   - blocksync catch-up, the slice's main path: `BlocksyncReactor.sync`
     from genesis over the chain (tile 40, batch 8192, a fresh SigCache):
     height 48 in two tiles, the generator's app state and validator
     set; the same sync twice more, timed, and once under
     torch.profiler (the card's idle share; its launches per kernel must
     equal the counters'); then again from genesis with height 7's
     block carrying a tampered signature: the peer is banned at height
     6 and the sync still reaches 48;
   - the pipelined catch-up over the 121-block chain, through
     `BlocksyncReactor(pipeline_depth=K)` with a DeviceWatchdog and a
     DeviceSupervisor (canary lanes on): K = 1, 2 and 4, PIPE_REPEATS
     timed syncs each in alternating order (1, 2, 4, then 4, 2, 1), every run
     kept, each with the main thread's and the process's
     CPU time and every `verify_lanes` call's wall and CPU time on the
     thread that made it (`VerifyClock`: the difference is time spent
     waiting for the interpreter lock or the card); one profiled sync
     per depth, kept only if the profiler saw every launch the counters
     made (up to PROFILE_TRIES syncs; where every try missed some, the
     busy time and idle share are null and the misses are printed); the
     tampered sync at depth 1 and 4, which must ban the same height.
     Every run must reach the generator's state with no trip, drain,
     canary failure or quarantine, and launch the three RLC kernels;
   - the device server (`device/server.DeviceServer`, bucket 8192, on
     the card, in this process): two `DeviceClient`s send the seam
     tile's first 4,000 lanes and its next 4,000 (one tampered) at once,
     and each must get `verify_batch`'s in-process verdicts; then the
     48-block chain synced at depth 2 through `DeviceClientBackend`, and
     one `create_batch_verifier` call with COMETBFT_TPU_DEVICE_SERVER
     set, which must give a `RemoteBatchVerifier` that verifies through
     the server. No flush may fail;
   - the light client (`light/`) over the 48-block chain, each pass
     with a fresh signature cache and its own launch counts, which must
     equal each RLC kernel's measured launches per call times the RLC
     verifies the pass made (its flushes and canary runs; a pass whose
     lanes all hit the cache made none and fails): a sequential client
     from height 1 to the tip (48 flushes; headers/s, ms a header; and
     its first 8 headers again under torch.profiler: the card's idle
     share), a
     skipping client trusted at height 24 that jumps to the tip and
     walks back to height 12, a witness that serves a forged tip header
     (ConflictingHeadersError; its attack evidence through the wire
     form and back), and a primary whose commit carries a tampered
     signature (rejected, the flush attributed per lane);
   - a mixed-curve validator set of MIXED_SET (120 ed25519, 15 sr25519,
     15 secp256k1 keys from --seed) and four commits it signs over the
     chain's block ids, each pass counted the same way: the
     `MixedBatchVerifier` seam, clean and with one tampered lane of each
     curve (lane by lane equal to the oracles), `verify_commit` clean
     and with a tampered sr25519 lane, one `verify_tile` of 40 of the
     chain's commits and the four mixed ones (the right verdict each),
     and the set through the state JSON and back; then a chain of
     MIXED_BLOCKS blocks over the set less its sr25519 keys (135
     validators, built by hand as `generate_chain` builds one), synced
     through `BlocksyncReactor(pipeline_depth=2)` in tiles of two
     blocks: every commit verified at marshal, one flush per commit with
     an ed25519 proposer; and once with a tampered signature, which
     must ban height 3 or 4;
   - aggsig (BLS aggregate commits), each pass with the signature cache
     reset: genesis PoP admission of a 150-validator BLS set on the host
     RLC route (`register_pops_batch(device="cpu")`) and on the kernel
     route (the card, the default, with no prewarm: 3 launches), clean
     and with one bad PoP (rejected exactly, and alike on the host route
     over 16 keys);
     `verify_commit` of the set's 150-signer aggregated commit (one
     launch at bucket 4; a flipped aggregate byte is rejected) and of a
     multi-group aggregate over 16 validators (17 pairs: the host Miller
     product, one `bls_hard_pow` launch; a tampered copy fails); a
     63-block chain of 16 validators synced through
     `BlocksyncReactor(tile_size=62)` at depth 1 and 2, twice each, and
     tampered at height 31 (a ban, then it completes): one
     `bls_miller_finalexp` launch per checker call with pending work
     (the first tile: 62 seals + 2 canaries, bucket 64), each launch
     timed with CUDA events (the card's idle share);
   - seal sync (`sealsync.SealAdopter(device="cuda")`) over that
     63-block aggregated chain, three passes into fresh stores and
     caches: the defaults (max_skip 64, tile 32: one pivot, one
     `bls_miller_finalexp` launch), max_skip 1 (63 pivots in tiles of
     32, each tile and 2 canaries in bucket 64: two launches) and the
     deep forgery at the tip ("bitmap": only the pivot's pairing on the
     card rejects it; a ban at 63, then the retry adopts); each must
     adopt to the tip, its launches timed with CUDA events; then the
     bodies backfill through `BlocksyncReactor.sync` into the first
     pass's store with its cache: every seal an "ok" cache hit, no BLS
     launch, the generator's app state;
   - the light-client farm (`farm.VerificationFarm(device="cuda")`)
     over the 48-block chain: 16 sessions subscribe at trusted heights
     1-8 in one wave (8 root commits of 134 lanes: one flush of ~1,070
     lanes), then one height a wave every session below it verifies it
     (one flush a wave, one new commit's 134 lanes after the cache and
     the cross-session dedup), to the tip; every session trusted at 48
     with the sequential light client's heights, the lanes through the
     kernels, no drain; a second farm over a copy of the chain with a
     flipped signature byte in commit 20 rejects the verify of 20 and
     trusts nothing past 19; 8 waves of a third farm under
     torch.profiler (the card's idle share);
   - tx admission (`ingest.IngestPipeline(device="cuda")` over a
     10,000-tx `CListMempool`): 8,192 envelopes from 256 keys (7,872
     valid, 128 tampered, 64 duplicates, 64 malformed, 64 rejected by
     the app), signed before the timer, submitted, one flush: every
     code as made, the FIFO the valid txs in order, one "kernel" batch
     of 8,064 lanes (attributed per lane); then 8,193 distinct valid
     envelopes into a fresh pipeline: IngestShed at the 8,193rd, a
     profiled flush (the card's idle share), the retry admitted;
   - catch-up over p2p into FileDB stores (`run_p2p`, node.py:591-701's
     path without statesync, consensus and the handshake replay): the
     121-block chain and the 63-block aggregated chain written into
     FileDB block stores through `BlockStore.save_block` (NativeDB opens
     the first and sees the same keys), served by a child process
     (`--serve-peer`, CUDA hidden) on loopback TCP, each on its own
     Switch; this process syncs the 121 blocks through
     `PooledSource(NetSource(reactor, switch), lookahead=32, n_workers=4)`
     and `BlocksyncReactor` (tile 40, batch 8192, a fresh SigCache, the
     watchdog and supervisor) into fresh FileDB stores at depth 1, 2 and
     1 profiled, each to the generator's app hash with no trip, drain or
     canary failure and every RLC kernel launched; then to height 60,
     stop, close, reopen (FileDB replay), `run_doctor` (no repair), the
     state from the StateStore at the kept app's height, and a resume
     over a new connection to 121; then `SealAdopter` over
     `NetSealSource` at the defaults (one `bls_miller_finalexp` launch)
     and `max_skip=1` (63 pivots, two launches). It prints walls, sigs/s,
     the bytes each way, the handshake, AEAD, decode and fetch-wait
     seconds, the store write, reopen and doctor figures and the
     peer's own AEAD figures;
   - consensus (`run_consensus`, the shared signature cache off so that
     vote intake leaves the next block's last commit to the card): (a)
     a node that leaves blocksync for consensus at 200 validators: a
     serving node holds the 48-block chain, its ConsensusState at 49
     behind a ConsensusReactor on its own Switch; a laggard blocksyncs
     1..40, builds a non-validator ConsensusState over the state and
     stores blocksync left (node.py:591's switch, by hand), dials it over
     loopback TCP, and its reconciler's round states are served 41..48
     (precommits and parts, under the server's token bucket): every
     precommit through the native `_check_signature`, every block's
     200-signature last commit through `verify_commit` on the card, one
     flush a height (FlushCount), each height at the generator's app
     hash; per height the wall, vote-verify, validate and apply seconds
     and the token bucket's wait; (b) a BLS laggard at 60 over the
     63-block aggregated chain: a forging peer's seal (n-1 signatures
     under a full bitmap) fails the reactor's pairing on the card and
     the peer is banned, then the honest server's seals for 61..63 are
     adopted (`_on_seal_adopt_wire`, `bls_miller_finalexp`) and the
     blocks finalized from their parts; (c) a live net of 4 port
     validators (FilePVs in a temporary directory, the ported WAL, real
     tickers, reconcilers) commits 5 equal heights over loopback TCP;
     `VoteSet.add_votes` of the 48th height's 200 precommits on the card
     with one tampered: one flush, the per-vote verdicts; and the native
     ed25519's host ms a signature beside the oracle's;
   - node boot (`run_node_boot`, through the entry points a user runs):
     (a) the 121-block, 200-validator chain written into a node home
     (config.toml, genesis.json, FileDB block and state stores at 121)
     and served by `python -m cometbft_tpu_torch.cmd.main start --device
     cpu` in a child process (CUDA hidden; its handshake replays the 121
     blocks into a fresh kvstore); a laggard made by `cmd.main init`,
     given the chain's genesis and the server as its persistent peer,
     built as `Node(cfg, device="cuda")` (block sync on, depth 4, batch
     `_device_batch_size(200)` = 4,096, tile 16) and started: its boot
     sync runs the RLC kernels (FlushCount: launches = launches_per_call
     x flushes, the shared signature cache reset first, no trip, drain
     or boot error), then consensus runs at 122; its blocks and app hash
     must equal the generator's, and `status` (less identity and clock
     fields), `block`, `commit` and `validators` at 121 from its RPC
     must equal the server's; then, while the server and that laggard
     still run: (c) a fresh node from `cmd.main init` with `[statesync]`
     on (rpc_servers: the server and laggard (a), trusting block 1),
     `[tx_index] indexer = "sqlite"` and `proxy_app = tcp://` to a port
     `ABCIServer` over a `RecordingApp` in this process, built as
     `Node(cfg, device="cuda")` with a WebSocket subscriber to NewBlock
     opened before `start()`: it must refuse snapshot 120 (header 122
     does not exist), restore 115 through the light client on the card,
     blocksync 116..121 through the RLC kernels and reach consensus at
     122, with the generator's app state and hash, the chain's blocks,
     ABCI calls that pass `check_sequence`, NewBlock 116..121 in order,
     a `tx_search` through sqlite equal to laggard (a)'s kv indexer,
     launches = launches_per_call x (anchor + blocksync flushes), no
     trip or drain; (d) the verifying light proxy
     (`light/rpc.build_light_proxy`, what `cmd.main light` runs) on cuda
     over the server, witness laggard (a): abci_query with a proof and
     an absent key, block, commit and validators at 60 and 120, each
     equal to the server's answer; a proxy over a stub that forges the
     block at 90 must refuse it; (e) `cmd.main bootstrap-state --height
     115 --device cuda` into a fresh home writes (c)'s state at 115; (b)
     a live net of 4 `Node`s on cuda from `cmd.main testnet` homes
     commits 3 heights, then 8 txs through `broadcast_tx_commit` on one
     node, read back with `abci_query` and `tx_search` on another;
   - `pt_add_tiled`, off the node path as in the JAX package: the
     op-level A/B (`tools/ab_pallas.py`), kernel and plain version timed
     at 8192 lanes.
5. Print the {"kernels": [...]} line (launches from the paths, device
   and call times, bounds; `rlc_window_sums` counts two launches a call, and the launches of the
   pipelined syncs, of the device server's paths, of the light client,
   of the mixed set, of the farm and of tx admission; the BLS kernels'
   rows with the launches of their own paths, the aggregated catch-up
   and the multi-group `verify_commit`, and of seal sync's passes; the
   p2p phase's launches of each; the consensus phase's launches of the
   RLC kernels and of the BLS kernels; the node boot's launches, and
   those of its statesync, light proxy and bootstrap-state parts),
   `node boot:`, `statesync:` and `light proxy:` lines, a timing line
   with the catch-up
   sigs/s and
   where the sync's time goes, the pipelined depths' medians and
   spreads, the server's stats, the light client's headers/s and the
   mixed set's pass times, the card's name and power limit, and last
   {"ok": true, "device": {...}}.

Without a CUDA card, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

LANES = 8192          # one blocksync flush (bench.py:154,211 defaults)
VALIDATORS = 200      # BASELINE.json's set; bench.py:154
BLOCKS = 48           # 9,600 signatures: two tiles of catch-up
TILE = 40             # 40 x 200 = 8,000 lanes, one 8192-lane flush
RAGGED = 200          # a lane count that divides no block of the kernels
CHUNKS = 3000         # window sums over three chunks, the last part empty
PIPE_BLOCKS = 121     # three full 40-block tiles (24,000 sigs) and one more
DEPTHS = (1, 2, 4)    # pipeline depths of the pipelined catch-up
# timed syncs per depth, in alternating order: 1 (a cut from 2 that keeps
# the smoke inside its time limit beside the consensus phase; the
# profiled sync is a second wall of each depth)
PIPE_REPEATS = 1
PROFILE_TRIES = 3     # profiled syncs per depth until one misses nothing
PROFILE_TAIL_S = 0.2  # a profile stays open this long past its synchronize
SERVER_LANES = 4000   # lanes each of the two device-server clients sends
SERVER_FLUSH_US = 20_000  # coalescing window: both clients share a flush
# light-client headers verified under torch.profiler: each is ~29,000
# launches, and a profile of all 47 lengthened the run by minutes
PROFILED_HEADERS = 8
# the mixed-curve set: the VerifyCommit configuration's 150 validators
# (BASELINE.json), by key type
MIXED_SET = {"ed25519": 120, "sr25519": 15, "secp256k1": 15}
# the mixed set's chain (its sr25519 keys left out: the validator-set
# hash has no sr25519 form), synced at depth 2 in tiles of two blocks
MIXED_BLOCKS = 6
MIXED_TILE = 2
MIXED_CHAIN_ID = "mixed-chain"
INT32_MAD_PER_S = 132 * 64 * 1.98e9   # H100 SXM: SMs x INT32 lanes x clock
HBM_BYTES_PER_S = 3.35e12
# The least int32 multiply-adds per field operation: a 32x32->64-bit
# product counts as two, the 38-fold of the high half as 8 products.
# A multiplication needs 8x8 products, a squaring only the 36 distinct
# ones (the doubled cross terms are shifts).
MADS_FE_MUL = 64 * 2 + 8 * 2
MADS_FE_SQ = 36 * 2 + 8 * 2
# Decompression per lane: the ref10 chain (251 squarings, 11 products)
# and the decode (4 squarings, 8 products); the sqrt(-1) product, taken
# on some lanes only, is left out, so the bound stays a lower bound.
MADS_DECOMPRESS = (251 + 4) * MADS_FE_SQ + (11 + 8) * MADS_FE_MUL
MADS_ADD = 9 * MADS_FE_MUL                      # add-2008-hwcd-3
MADS_DBL = 4 * MADS_FE_SQ + 4 * MADS_FE_MUL     # dbl-2008-hwcd
PT_BYTES = 4 * 16 * 4                           # one packed point
# each wrapper's source in cometbft_tpu_torch/csrc/, and the line of the
# Pallas kernel it replaces in cometbft_tpu/ops/pallas_verify.py
KERNELS = {
    "pt_decompress_tiled": ("pt_decompress.cu", 411),
    "rlc_window_sums": ("rlc_window_sums.cu", 351),
    "rlc_epilogue": ("rlc_epilogue.cu", 502),
    "pt_add_tiled": ("pt_add.cu", 277),
}
ROUNDS = 20           # timed calls of each kernel under torch.profiler
# The BLS kernels (ops/bls12.py): each source and the line of the jitted
# JAX program it replaces in cometbft_tpu/ops/bls12.py (XLA, not Pallas)
BLS_KERNELS = {
    "bls_miller_finalexp": ("bls_miller_finalexp.cu", 521),
    "bls_hard_pow": ("bls_hard_pow.cu", 230),
}
BLS_BUCKETS = (4, 16, 64)  # the JAX package's batch shapes
BLS_ROUNDS = 5        # timed calls of each BLS kernel a bucket
BLS_STEPS = 63        # Miller steps (bits of |x| after the first)
# The least int32 multiply-adds of the BLS field operations, as above:
# an Fq product is 12 x 12 word products and the reduction's 12 x 12, lo
# and hi; an Fq squaring only the 78 distinct word products, then the
# reduction. An Fq2 product is 3 Fq products (Karatsuba), an Fq2 squaring
# 2 ((a + b)(a - b), 2ab). An Fq12 product is the kernel's 36 Fq2
# products, a sparse line product 18; an Fq12 squaring only the distinct
# ones (6 Fq2 squarings, 15 Fq2 products), and a squaring in the
# cyclotomic subgroup, where the hard chain runs after the easy part, 9
# Fq2 squarings (Granger-Scott).
MADS_FQ = 2 * 2 * 12 * 12
MADS_FQ_SQ = 2 * (78 + 12 * 12)
MADS_FQ2 = 3 * MADS_FQ
MADS_FQ2_SQ = 2 * MADS_FQ
MADS_F12 = 36 * MADS_FQ2
MADS_F12_SQ = 6 * MADS_FQ2_SQ + 15 * MADS_FQ2
MADS_F12_CYC = 9 * MADS_FQ2_SQ
MADS_SPARSE = 18 * MADS_FQ2
# The aggsig paths (PERF.md §4): genesis admission and verify_commit at
# BASELINE.json's 150-validator VerifyCommit set; a multi-group commit
# of 16 validators (17 pairs); catch-up over 63 blocks of 16 validators
# in tiles of 62 (62 seals + 2 canaries fill bucket 64 in one settle;
# host signing, not the card, sets the 16)
AGG_SET = 150
AGG_BAD = 7           # the key whose PoP is replaced in the bad case
AGG_BAD_HOST = 16     # keys of the host route's bad-PoP case
AGG_GROUPS = 16
AGG_BLOCKS = 63
AGG_VALIDATORS = 16
AGG_TILE = 62
# The light-client farm (PERF.md §4): sessions subscribe at trusted
# heights 1..FARM_ROOTS of the 48-block, 200-validator chain, then walk
# to the tip one height a wave; a forged signature in commit FARM_FORGED
# of a copy of the chain; FARM_PROFILED waves of another farm profiled
# 16 sessions: a cut from 64 that keeps the smoke inside its time limit
# beside the consensus phase. The card sees the same flushes (the waves'
# lanes are deduplicated across sessions); each session's host work goes.
FARM_SESSIONS = 16
FARM_ROOTS = 8
FARM_FORGED = 20
FARM_PROFILED = 8
# Tx admission: one burst the width of a blocksync flush
# (`ingest/admission.DEFAULT_MAX_PENDING`), from 256 keys; the mempool
# holds 10,000 (its default 5,000 would answer most of the burst
# "mempool is full")
INGEST_KEYS = 256
INGEST_MIX = {"valid": 7872, "tampered": 128, "duplicate": 64,
              "malformed": 64, "app_invalid": 64}
INGEST_BANNED = b"banned-"
INGEST_MEMPOOL = 10_000
INGEST_SHED_EXTRA = 321   # 7,872 + 321 = 8,193 distinct valid envelopes

# `--bls-cycles`, not a phase of the smoke: where one lane's time goes,
# clock64 cycles of the BLS kernels' pieces on one block, from fq381.cuh as
# the kernels build it: a one-thread Fq product and squaring (MICRO_REPS
# chained), and an Fq12 product, general squaring, cyclotomic squaring,
# product phase, fold phase and barrier on a block of BLS_THREADS
# (MICRO_REPS each).
MICRO_REPS = 256
BLS_MICRO_CU = r"""
#include <cuda_runtime.h>
#include "fq381.cuh"

__global__ void bls_micro_fq(const fq* in, fq* out, long long* cyc, int n) {
  fq x = in[0], y = in[1];
  const long long t0 = clock64();
  for (int i = 0; i < n; i++) x = fq_mul(x, y);
  const long long t1 = clock64();
  for (int i = 0; i < n; i++) y = fq_sq(y);
  cyc[0] = t1 - t0;
  cyc[1] = clock64() - t1;
  out[0] = x;
  out[1] = y;
}

__global__ void __launch_bounds__(BLS_THREADS)
bls_micro_f12(const fq2* in, fq2* out, long long* cyc, int n) {
  __shared__ bls_smem s;
  const int t = threadIdx.x;
  if (t < 6) {
    s.f[t] = in[t];
    s.m[t] = in[6 + t];
  }
  __syncthreads();
  for (int w = 0; w < 6; w++) {
    const long long t0 = clock64();
    for (int i = 0; i < n; i++) {
      if (w == 0) f12_mul_block(&s, s.f, s.f, s.m, false);
      else if (w == 1) f12_sq_block(&s, s.f, s.f);
      else if (w == 2) f12_cyc_block(&s, s.f, s.f);
      else if (w == 3) BLS_STEP(f12_mul_pd(t, s.f, s.m, false, &s));
      else if (w == 4) BLS_STEP(f12_mul_fd(t, s.u, &s));
      else __syncthreads();
    }
    if (t == 0) cyc[w] = clock64() - t0;
  }
  if (t < 6) out[t] = s.f[t];
}

extern "C" int cbt_bls_micro(const void* fq_in, void* fq_out,
                             const void* f12_in, void* f12_out,
                             long long* cyc, int n, void* s) {
  bls_micro_fq<<<1, 1, 0, (cudaStream_t)s>>>((const fq*)fq_in, (fq*)fq_out,
                                             cyc, n);
  bls_micro_f12<<<1, BLS_THREADS, 0, (cudaStream_t)s>>>(
      (const fq2*)f12_in, (fq2*)f12_out, cyc + 2, n);
  return (int)cudaGetLastError();
}
"""
MICRO_KEYS = ("fq_mul", "fq_sq", "f12_mul", "f12_sq", "f12_cyc",
              "product_phase", "fold_phase", "barrier")


def _nvcc(build, name: str, text: str, *inc) -> subprocess.Popen:
    """Start nvcc on `text` as BUILD_DIR/name.cu -> name.so."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", *inc,
         "-o", str(build.BUILD_DIR / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _nvcc_load(build, name: str, proc: subprocess.Popen) -> tuple:
    """Wait for `_nvcc`'s build: (the library, nvcc's output)."""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{text}")
    return ctypes.CDLL(str(build.BUILD_DIR / f"{name}.so")), text


def bls_cycles(torch, build, seed: int) -> tuple:
    """Build BLS_MICRO_CU and run it: (MICRO_KEYS -> clock64 cycles per
    operation, the second of two runs, on canonical Montgomery words from
    `seed`; ptxas's output)."""
    from cometbft_tpu_torch.ops import bls12 as pb
    lib, text = _nvcc_load(build, "bls_micro", _nvcc(
        build, "bls_micro", BLS_MICRO_CU, "-I", str(build.CSRC)))
    fn = lib.cbt_bls_micro
    fn.argtypes = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_void_p)
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(seed)

    def words(n):
        vals = [int.from_bytes(rng.bytes(48), "little") % pb.P_INT
                for _ in range(n)]
        return torch.tensor(
            [[(v >> (32 * k)) & 0xffffffff for k in range(12)]
             for v in vals], dtype=torch.int64).to(torch.int32).cuda()
    fq_in, f12_in = words(2), words(24)
    fq_out, f12_out = torch.empty_like(fq_in), torch.empty_like(f12_in[:12])
    cyc = torch.zeros(8, dtype=torch.int64, device="cuda")
    for _ in range(2):
        rc = fn(fq_in.data_ptr(), fq_out.data_ptr(), f12_in.data_ptr(),
                f12_out.data_ptr(), cyc.data_ptr(), MICRO_REPS,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"BLS micro-benchmark launch failed: {rc}")
        torch.cuda.synchronize()
    return {k: v / MICRO_REPS for k, v in zip(MICRO_KEYS, cyc.tolist())}, text


def _median_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound_ms(mads: float, nbytes: float) -> tuple:
    t_ops = mads / INT32_MAD_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Laps:
    """Each phase's seconds and the smoke's running total, printed as the
    phase ends: where the time limit goes when a slice adds a phase."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.took: dict = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.took[name] = now - self.last
        print(f"phase {name}: {now - self.last:.1f} s (at "
              f"{now - self.start:.1f} s)", flush=True)
        self.last = now


def _gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def make_chain(seed: int, n_blocks: int):
    """A chain of `n_blocks` blocks and the generator's app (its final
    state is what a sync must reach)."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.engine.chain_gen import generate_chain
    apps = []

    def app_factory():
        apps.append(KVStoreApplication())
        return apps[-1]

    chain = generate_chain(n_blocks=n_blocks, n_validators=VALIDATORS,
                           txs_per_block=2, seed=seed,
                           app_factory=app_factory, device="cuda")
    return chain, apps[0]


def chain_prefix(chain, n_blocks: int):
    """The first `n_blocks` blocks of a generated chain and the
    generator's app replayed to that height (the blocks apply as
    verified: their commits were verified as the chain was made).
    `generate_chain` makes block h the same whatever the chain's length,
    so this is the chain `make_chain(seed, n_blocks)` makes, unsigned
    again. The replay must reach the app hash the next block records."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, chain.genesis.initial_height, [], b"")
    executor = BlockExecutor(app, device="cuda")
    state = State.from_genesis(chain.genesis)
    for block_id, block in zip(chain.block_ids[:n_blocks],
                               chain.blocks[:n_blocks]):
        state, _ = executor.apply_block(state, block_id, block,
                                        verified=True)
    if app.last_app_hash != chain.blocks[n_blocks].header.app_hash:
        raise AssertionError("the replayed app does not reach the chain's "
                             f"app hash at height {n_blocks}")
    return dataclasses.replace(
        chain, blocks=chain.blocks[:n_blocks],
        block_ids=chain.block_ids[:n_blocks],
        seen_commits=chain.seen_commits[:n_blocks],
        valsets=chain.valsets[:n_blocks]), app


def tile_from_chain(ref, chain, lanes: int):
    """The first `lanes` (pub, msg, sig) of the chain's commits, flattened
    as the tile verifier marshals them. -> (tile, seconds the marshal
    took: `marshal_commit`, which verify_tile runs for every commit)."""
    from cometbft_tpu_torch.engine.blocksync import TileEntry, marshal_commit
    pubs, msgs, sigs = [], [], []
    t0 = time.perf_counter()
    for h in range(1, chain.max_height() + 1):
        if len(pubs) >= lanes:
            break
        e = TileEntry(height=h, block=chain.blocks[h - 1],
                      block_id=chain.block_ids[h - 1],
                      valset=chain.valsets[h - 1],
                      commit=chain.seen_commits[h - 1])
        _e, rows, _needed = marshal_commit(chain.chain_id, e, pubs, msgs,
                                           sigs)
        if rows is None:
            raise AssertionError(f"generated commit {h} does not marshal")
    marshal_s = time.perf_counter() - t0
    if len(pubs) < lanes:
        raise AssertionError(f"the chain has {len(pubs)} lanes, < {lanes}")
    key = chain.keys[chain.valsets[0].validators[0].address]
    if ref.sign(key.seed, msgs[0]) != sigs[0]:
        raise AssertionError("the cached-key signer disagrees with "
                             "ref_ed25519.sign")
    return (pubs[:lanes], msgs[:lanes], sigs[:lanes]), marshal_s


def _edge_encodings(ref, encs, rng):
    """Replace a few lanes by undecodable and ZIP-215 edge encodings."""
    p = ref.P
    edges = [b"\xff" * 32, (2**255 - 2).to_bytes(32, "little"),
             (1).to_bytes(32, "little"), (p + 1).to_bytes(32, "little"),
             (1 | (1 << 255)).to_bytes(32, "little"),
             (p - 1).to_bytes(32, "little")]
    encs = list(encs)
    for j, e in enumerate(edges):
        encs[j * 997 % len(encs)] = e
    for j in range(64):
        encs[int(rng.integers(len(encs)))] = rng.bytes(32)
    return encs


def _point_err(torch, fe, p, q):
    """Max |limb| of the canonical cross differences X1Z2-X2Z1 and
    Y1Z2-Y2Z1: 0 iff the points are projectively equal."""
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    dx = fe.fe_canonical(fe.fe_sub(fe.fe_mul(x1, z2), fe.fe_mul(x2, z1)))
    dy = fe.fe_canonical(fe.fe_sub(fe.fe_mul(y1, z2), fe.fe_mul(y2, z1)))
    return int(torch.maximum(dx.abs().max(), dy.abs().max()))


def _hold_decompress(torch, pkg, enc):
    """pt_decompress_tiled against its plain version on (32, N) encodings:
    validity exact, points equal mod p, y as given. -> (error, valid)."""
    cv, fe = pkg["cv"], pkg["fe"]
    n = enc.shape[-1]
    pt, ok = cv.pt_decompress_tiled(enc)
    ppt, pok = cv.pt_decompress_plain(enc)
    torch.cuda.synchronize()
    if not torch.equal(ok, pok):
        raise AssertionError(f"pt_decompress_tiled validity differs, N={n}")
    err = max(int((fe.fe_canonical(pt[c]) - fe.fe_canonical(ppt[c]))[:, ok]
                  .abs().max()) for c in range(4))
    err = max(err, int((pt[1] - ppt[1]).abs().max()))
    if err:
        raise AssertionError(f"pt_decompress_tiled points differ, N={n}")
    return err, ok


def _hold_window_sums(torch, pkg, args):
    """rlc_window_sums against its plain version: each window's partials
    summed, compared as group elements. -> (error, kernel output)."""
    cv, ed, fe = pkg["cv"], pkg["ed"], pkg["fe"]
    out = cv.rlc_window_sums(*args)
    pout = cv.rlc_window_sums_plain(*args)
    kw = ed.pt_tree_sum(cv.unpack_point(cv.fold_partials(out).long()))
    pw = ed.pt_tree_sum(cv.unpack_point(cv.fold_partials(pout).long()))
    err = _point_err(torch, fe, kw, pw)
    if err:
        raise AssertionError(
            f"rlc_window_sums window sums differ, N={args[0].shape[-1]}")
    return err, out


def _hold_pt_add(torch, pkg, p, q):
    """pt_add_tiled against its plain version, as group elements, limbs
    in [0, 2^16). -> (error, kernel output)."""
    cv, fe = pkg["cv"], pkg["fe"]
    out = cv.pt_add_tiled(p, q)
    plain = cv.pt_add_tiled_plain(p, q)
    torch.cuda.synchronize()
    if int(out.min()) < 0 or int(out.max()) >= 1 << 16:
        raise AssertionError("pt_add_tiled limbs leave [0, 2^16)")
    err = _point_err(torch, fe, cv.unpack_point(out.long()),
                     cv.unpack_point(plain.long()))
    if err:
        raise AssertionError(f"pt_add_tiled sums differ, N={p.shape[-1]}")
    return err, out


def _enc_tensor(torch, encs, dev):
    return torch.as_tensor(np.stack([np.frombuffer(e, np.uint8)
                                     for e in encs], axis=-1)
                           .astype(np.int32), device=dev)


def check_kernels(torch, pkg, tile, dev, report):
    """Phase 3: each kernel against its plain version at the main path's
    shapes (decompression at 2 N: A and R in one call), and the three
    per-lane kernels again at N = RAGGED, where the last block of each is
    part empty and the kernel masks its edge. Then every kernel under
    torch.profiler (`profile_kernels`).
    Returns the point additions' inputs, which the A/B phase times."""
    cv, ed, fe, ped = pkg["cv"], pkg["ed"], pkg["fe"], pkg["ped"]
    ref = pkg["ref"]
    rng = np.random.default_rng(7)
    pubs, msgs, sigs = tile
    n = len(pubs)

    # decompression as the RLC verify calls it: the tile's A encodings
    # and its R encodings side by side, with edge and random bytes among
    # the R lanes; then the R half alone (N lanes), and RAGGED lanes
    encs = list(pubs) + _edge_encodings(ref, [s[:32] for s in sigs], rng)
    enc = _enc_tensor(torch, encs, dev)
    err, ok = _hold_decompress(torch, pkg, enc)
    want_ok = [ref.pt_decompress(encs[i]) is not None
               for i in range(0, 2 * n, 97)]
    if ok[::97].cpu().tolist() != want_ok:
        raise AssertionError("pt_decompress_tiled disagrees with the oracle")
    enc_r = enc[:, n:].contiguous()
    err_n, _ = _hold_decompress(torch, pkg, enc_r)
    # the ragged lanes: every undecodable lane first, then decodable ones
    pick = torch.argsort(ok.to(torch.int8), stable=True)[:RAGGED]
    err_r, ok_r = _hold_decompress(torch, pkg, enc[:, pick].contiguous())
    report["pt_decompress_tiled"] = {
        "max_abs_err": max(err, err_n, err_r), "lanes": 2 * n,
        "call_ms": _median_ms(torch, lambda: cv.pt_decompress_tiled(enc),
                              20),
        "plain_ms": _median_ms(torch, lambda: cv.pt_decompress_plain(enc), 3),
        "bound": _bound_ms(2 * n * MADS_DECOMPRESS,
                           2 * n * (32 * 4 + 64 * 4 + 1)),
        "invalid_lanes": int((~ok).sum()),
        "ragged_invalid_lanes": int((~ok_r).sum())}

    # window sums and epilogue on the main path's own clean-tile inputs
    pub_a, sig_a, hb, hn, _ = ped.prepare_batch(pubs, msgs, sigs, n, 128)
    z = ped.make_rlc_coefficients(n, rng)
    t = [torch.as_tensor(x, device=dev) for x in (pub_a, sig_a, hb, hn, z)]
    r_enc, s = ped._split_sig(t[1])
    pts, oks = cv.pt_decompress_tiled(torch.cat(
        [t[0].movedim(-1, 0), r_enc], -1).to(torch.int32).contiguous())
    a_pt, r_pt = pts[..., :n], pts[..., n:]
    a_ok, r_ok = oks[:n], oks[n:]
    k = ped._challenge(t[2], t[3])
    s_ok = pkg["sc"].sc_lt_l(s)
    _, s_sum, z16, tk = ped._scalar_side(s, s_ok, a_ok, r_ok, k, t[4])
    ws_args = (ped._neg_packed(a_pt), ped._neg_packed(r_pt),
               pkg["sc"].sc_nibbles(tk).to(torch.int32).contiguous(),
               pkg["sc"].sc_nibbles(z16)[:ped.ZWIN].to(torch.int32)
               .contiguous())
    err, out = _hold_window_sums(torch, pkg, ws_args)
    # the first CHUNKS and RAGGED lanes are RLC batches of their own: their
    # partials and their [S]B digits are the epilogue's inputs at M = 4 and
    # M = 1 (a flush of one LANE_TILE chunk, as the light client and the
    # mixed set's ed25519 bucket make it)
    small, err_r = [], 0
    for nl in (CHUNKS, RAGGED):
        e, o = _hold_window_sums(
            torch, pkg, tuple(a[..., :nl].contiguous() for a in ws_args))
        _, s_nl, _, _ = ped._scalar_side(
            s[..., :nl], s_ok[:nl], a_ok[:nl], r_ok[:nl], k[..., :nl],
            t[4][:nl])
        small.append((cv.fold_partials(o), s_nl))
        err_r = max(err_r, e)
    # the least work: each table 7 doublings (even entries) and 7
    # additions (odd ones), then N - G additions per window
    g = cv.n_tiles(n)
    adds = 14 * n + cv.N_WINDOWS * (n - g)
    dbls = 14 * n
    report["rlc_window_sums"] = {
        "max_abs_err": max(err, err_r),
        "call_ms": _median_ms(torch, lambda: cv.rlc_window_sums(*ws_args),
                              10),
        "plain_ms": _median_ms(torch,
                               lambda: cv.rlc_window_sums_plain(*ws_args), 3),
        "bound": _bound_ms(adds * MADS_ADD + dbls * MADS_DBL,
                           (2 * 64 + 96) * n * 4 + out.numel() * 4)}

    # point additions: R points plus A points of other lanes, with the
    # identity, P + (-P) and P + P in the first three lanes
    p = r_pt.clone()
    q = a_pt.roll(1, dims=-1).clone()
    p[:, :, 0] = 0
    p[1, 0, 0] = p[2, 0, 0] = 1
    q[:, :, 1] = ped._neg_packed(p[:, :, 1:2])[:, :, 0]
    q[:, :, 2] = p[:, :, 2]
    add_args = (p.contiguous(), q.contiguous())
    err, got = _hold_pt_add(torch, pkg, *add_args)
    if not bool(ed.pt_is_identity(cv.unpack_point(got[:, :, 1:2].long()))):
        raise AssertionError("pt_add_tiled: P + (-P) is not the identity")
    err_r, _ = _hold_pt_add(torch, pkg,
                            *(a[..., :RAGGED].contiguous() for a in add_args))
    add8 = tuple(a[..., :8].contiguous() for a in add_args)
    report["pt_add_tiled"] = {
        "max_abs_err": max(err, err_r),
        "bound": _bound_ms(n * MADS_ADD, 3 * n * PT_BYTES)}

    # epilogue at M = 8 (the tile), 4 (CHUNKS lanes) and 1 (RAGGED lanes)
    b_tab = torch.as_tensor(ed.small_base_table(), device=dev)
    folded = cv.fold_partials(out)
    m = folded.shape[-1]
    sdig = pkg["sc"].sc_nibbles(s_sum).to(torch.int32).contiguous()
    err = _hold_epilogue(torch, pkg, folded, sdig, b_tab, dev)
    ms = [m]
    for f, s_nl in small:
        err = max(err, _hold_epilogue(
            torch, pkg, f, pkg["sc"].sc_nibbles(s_nl).to(torch.int32)
            .contiguous(), b_tab, dev))
        ms.append(f.shape[-1])
    # like for like with M = 128: the same partials, identity points after
    m128 = torch.cat([folded, _identity_partials(torch, 128 - m, dev)], -1)
    if not bool(cv.rlc_epilogue(m128, b_tab, sdig)):
        raise AssertionError("rlc_epilogue at M = 128 rejects the clean tile")
    report["rlc_epilogue"] = {
        "max_abs_err": err, "m": m, "m_held": ms,
        "call_ms": _median_ms(
            torch, lambda: cv.rlc_epilogue(folded, b_tab, sdig), 10),
        "plain_ms": _median_ms(
            torch, lambda: cv.rlc_epilogue_plain(folded, b_tab, sdig), 2),
        "bound": _epilogue_bound(m),
        "m128": {"call_ms": _median_ms(
            torch, lambda: cv.rlc_epilogue(m128, b_tab, sdig), 10),
            "bound_ms": _epilogue_bound(128)[0]}}
    profile_kernels(torch, cv, [
        ("pt_decompress_tiled", lambda: cv.pt_decompress_tiled(enc)),
        ("pt_decompress_tiled@n", lambda: cv.pt_decompress_tiled(enc_r)),
        ("rlc_window_sums", lambda: cv.rlc_window_sums(*ws_args)),
        ("rlc_epilogue", lambda: cv.rlc_epilogue(folded, b_tab, sdig)),
        ("rlc_epilogue@m128", lambda: cv.rlc_epilogue(m128, b_tab, sdig)),
        ("pt_add_tiled", lambda: cv.pt_add_tiled(*add_args)),
        # 8 lanes: the fixed cost of a launch of this kernel
        ("pt_add_tiled@lanes8", lambda: cv.pt_add_tiled(*add8)),
    ], report)
    return add_args


def _hold_epilogue(torch, pkg, folded, sdig, b_tab, dev) -> int:
    """rlc_epilogue against its plain version on one batch's partials
    (4, 16, 96, M) and [S]B digits: the clean batch cancels (True); a
    changed [S]B digit and an uncancelled point in one window do not
    (False); the Horner case cancels only through every window (True),
    its variant does not. -> error."""
    cv = pkg["cv"]
    m = folded.shape[-1]
    sdig_bad = sdig.clone()
    sdig_bad[0] = (sdig_bad[0] + 1) % 16
    loose = folded.clone()      # [12345]B (prime order) into one partial
    _set_point(torch, pkg, loose, 9, 0, 12345, dev)
    cases = [(folded, sdig, True), (folded, sdig_bad, False),
             (loose, sdig, False), *_horner_cases(torch, pkg, m, dev)]
    err = 0
    for f, sd, want in cases:
        got = bool(cv.rlc_epilogue(f, b_tab, sd))
        plain = bool(cv.rlc_epilogue_plain(f, b_tab, sd))
        err = max(err, abs(int(got) - int(plain)))
        if not got == plain == want:
            raise AssertionError(
                f"rlc_epilogue at M = {m}: {got}/{plain}, want {want}")
    return err


def _epilogue_bound(m: int) -> tuple:
    mads = ((96 * (m - 1) + 32 + 64 + 63) * MADS_ADD
            + (63 * 4 + 3) * MADS_DBL)
    return _bound_ms(mads, (4 * 16 * 96 * m + 16 * 64 + 64) * 4 + 1)


def _identity_partials(torch, m: int, dev):
    ident = torch.zeros((4, 16, 96, m), dtype=torch.int32, device=dev)
    ident[1, 0] = 1
    ident[2, 0] = 1
    return ident


def _set_point(torch, pkg, folded, w, j, k, dev, neg=False):
    """Partial j of window w := [k]B (or -[k]B), affine."""
    ref, fe = pkg["ref"], pkg["fe"]
    x, y, z, _ = ref.pt_mul(k, ref.BASE)
    zi = pow(z, ref.P - 2, ref.P)
    xa, ya = x * zi % ref.P, y * zi % ref.P
    if neg:
        xa = (ref.P - xa) % ref.P
    for c, v in enumerate((xa, ya, 1, xa * ya % ref.P)):
        folded[c, :, w, j] = torch.as_tensor(fe.limbs_from_int(v), device=dev)


def _horner_cases(torch, pkg, m: int, dev):
    """64 seeded nonzero digits d_i as the [S]B digits and -[S]B in
    window 0, S = sum 16^i d_i mod L: True only through the whole Horner;
    with digit 40 changed, False."""
    d = np.random.default_rng(31).integers(1, 16, 64)
    s = sum(int(x) << (4 * i) for i, x in enumerate(d)) % pkg["ref"].L
    folded = _identity_partials(torch, m, dev)
    _set_point(torch, pkg, folded, 0, m - 1, s, dev, neg=True)
    bad = d.copy()
    bad[40] = bad[40] % 15 + 1
    return [(folded, torch.as_tensor(x, dtype=torch.int32, device=dev), want)
            for x, want in ((d, True), (bad, False))]


def _device_kernels(torch, fn, by_name=None, order=None):
    """Run fn once under the CUDA profiler -> (kernel launches, summed
    kernel microseconds, wall seconds). (0, 0.0, wall) if the profiler
    recorded no device events. `by_name`, a dict, gets the launches of
    each kernel name; `order`, a dict of kernel name -> letter, makes
    the fourth item the letters of those kernels' events in start
    order."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # profiles that stopped right after the last launch lost the
        # last flush's window-sums and epilogue events (PERF.md): the
        # session stays open a while past the synchronize
        time.sleep(PROFILE_TAIL_S)
    dev = _cuda_events(torch, prof)
    if by_name is not None:
        for _t, name, _us in dev:
            by_name[name] = by_name.get(name, 0) + 1
    out = (len(dev), float(sum(us for _t, _n, us in dev)), wall)
    if order is None:
        return out
    seq = sorted((t, order[n]) for t, n, _us in dev if n in order)
    return out + ("".join(c for _, c in seq),)


def _cuda_events(torch, prof) -> list:
    """A finished profile's device events as (start us, kernel name,
    duration us), read from the profiler's raw results: building its
    FunctionEvents (`prof.events()`) took tens of seconds for the
    hundreds of thousands of launches of a profiled sync."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns() / 1e3, _kernel_name(e.name()),
             e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _kernel_name(name: str) -> str:
    return re.match(r"(?:void\s+)?(\w*)", name or "").group(1)


def _source_fns(name: str) -> set:
    """The `__global__` functions of kernel `name`'s source."""
    csrc = Path(__file__).resolve().parent / "cometbft_tpu_torch" / "csrc"
    src = (KERNELS.get(name) or BLS_KERNELS[name])[0]
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                          r"\([^)]*\)\s*)?(\w+)",
                          (csrc / src).read_text()))


def _profile_jobs(torch, cv, jobs, fns_of):
    """One profile session of `profile_kernels`. -> (launches counted
    per job, device-event durations per source's function set, the
    position of the first timed round in each, and a description of
    each set whose events do not number (1 + ROUNDS) times its counted
    launches)."""
    from torch.profiler import ProfilerActivity, profile
    counts = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for label, fn in jobs:
            base, _, tag = label.partition("@")
            cv.reset_launches()
            fn()
            torch.cuda.synchronize()
            counts[label] = cv.LAUNCHES[base]
        for _ in range(ROUNDS):
            for _label, fn in jobs:
                fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_TAIL_S)
    events = sorted(_cuda_events(torch, prof))
    queues, pos = {}, {}
    for label, _fn in jobs:
        fs = fns_of(label)
        if fs not in queues:
            queues[fs] = [us for _t, name, us in events if name in fs]
            pos[fs] = 0
        pos[fs] += counts[label]              # the counted call comes first
    lost = []
    for fs, q in queues.items():
        own = [label for label, _fn in jobs if fns_of(label) == fs]
        want = (1 + ROUNDS) * sum(counts[label] for label in own)
        if len({counts[label] for label in own}) != 1:
            raise AssertionError(f"{sorted(fs)}: launches per call differ "
                                 f"between jobs: {counts}")
        if len(q) != want:
            seen = {label: counts[label] for label in own}
            lost.append(f"{sorted(fs)}: the profiler saw {len(q)} "
                        f"launches, the counters {want} ({seen})")
    return counts, queues, pos, lost


def profile_kernels(torch, cv, jobs, report) -> None:
    """Every job (label, call) under one torch.profiler session: first
    one call of each with its launch count zeroed and read after it, then
    ROUNDS rounds of one call of each job in turn. A label is a wrapper's
    name, or the name and a tag for the wrapper on other inputs.

    The device events named after a source's `__global__` functions must
    number (1 + ROUNDS) times the launches counted for its jobs; a
    session where the profiler lost some runs again, up to PROFILE_TRIES
    sessions. A job's device time is the median over the rounds of the
    summed durations of its launches in a round (both launches of
    `rlc_window_sums`)."""

    def fns_of(label):
        return frozenset(_source_fns(label.partition("@")[0]))

    for attempt in range(1, PROFILE_TRIES + 1):
        counts, queues, pos, lost = _profile_jobs(torch, cv, jobs,
                                                  fns_of)
        if not lost:
            break
        # the profiler dropped device events (on an H100 it once saw 41
        # of 42 decompression launches): the times would be
        # misassigned, so the whole session runs again
        print(f"profile_kernels: try {attempt} of {PROFILE_TRIES} lost "
              f"device events: {lost}", flush=True)
    else:
        raise AssertionError(f"every profile lost device events: {lost}")
    report["profile_tries"] = attempt
    per: dict = {label: [] for label, _fn in jobs}
    for _ in range(ROUNDS):
        for label, _fn in jobs:
            fs = fns_of(label)
            k = counts[label]
            per[label].append(sum(queues[fs][pos[fs]:pos[fs] + k]))
            pos[fs] += k
    for label, _fn in jobs:
        base, _, tag = label.partition("@")
        ms = float(np.median(per[label])) / 1e3
        if tag:
            report[base][f"{tag}_ms"] = ms
            report[base][f"{tag}_launches_per_call"] = counts[label]
            continue
        report[base]["ms"] = ms
        report[base]["launches_per_call"] = counts[label]
        report[base]["launches_per_call_profiled"] = \
            len(queues[fns_of(label)]) // (1 + ROUNDS) // sum(
                1 for other, _fn in jobs if fns_of(other) == fns_of(label))


def breakdown(torch, pkg, tile, dev) -> dict:
    """Where one 8192-lane flush spends its time: the host marshal, the
    device part of the RLC verify (SHA-512 alone, then the whole), and
    the profiler's count of kernel launches and device-busy time for the
    RLC verify and (twice) for the per-lane attribution verify."""
    ped = pkg["ped"]
    pubs, msgs, sigs = tile
    n = len(pubs)
    t0 = time.perf_counter()
    pub_a, sig_a, hb, hn, _ = ped.prepare_batch(pubs, msgs, sigs, n, 128)
    z = ped.make_rlc_coefficients(n)
    out = {"host_marshal_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    t = [torch.as_tensor(x, device=dev) for x in (pub_a, sig_a, hb, hn, z)]
    torch.cuda.synchronize()
    out["h2d_s"] = time.perf_counter() - t0
    out["sha512_ms"] = _median_ms(torch, lambda: ped._challenge(t[2], t[3]),
                                  3)
    out["rlc_verify_ms"] = _median_ms(
        torch, lambda: ped.verify_rlc_core_cuda(*t), 3)
    k, busy, wall = _device_kernels(torch,
                                    lambda: ped.verify_rlc_core_cuda(*t))
    out["rlc_verify_kernel_launches"] = k
    out["rlc_verify_device_busy_ms"] = busy / 1e3
    out["rlc_verify_wall_ms"] = wall * 1e3
    # twice: the spread of the profiler's event count on unchanged code
    runs = [_device_kernels(torch, lambda: ped.verify_core(*t[:4]))
            for _ in range(2)]
    out["verify_core_kernel_launches"] = [r[0] for r in runs]
    out["verify_core_device_busy_ms"] = [r[1] / 1e3 for r in runs]
    out["verify_core_wall_ms"] = [r[2] * 1e3 for r in runs]
    return out


def run_main_path(torch, pkg, tile, e2e):
    """Phase 4, the seam: the BatchVerifier path on the card."""
    ref, ped = pkg["ref"], pkg["ped"]
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    pubs, msgs, sigs = tile
    n = len(pubs)

    def flush(p, m, s, batch_size):
        bv, supported = create_batch_verifier(Ed25519PubKey(p[0]),
                                              batch_size=batch_size)
        if not supported:
            raise AssertionError("ed25519 not supported by the seam")
        for pk, msg, sig in zip(p, m, s):
            bv.add(Ed25519PubKey(pk), msg, sig)
        t0 = time.perf_counter()
        ok, oks = bv.verify()
        torch.cuda.synchronize()
        return ok, oks, time.perf_counter() - t0

    stats0 = dict(ped.STATS)
    ok, oks, e2e["first_flush_s"] = flush(pubs, msgs, sigs, n)
    if not ok or not all(oks) or len(oks) != n:
        raise AssertionError("clean tile did not verify")
    ok, oks, e2e["flush_s"] = flush(pubs, msgs, sigs, n)
    if not ok or not all(oks):
        raise AssertionError("clean tile did not verify (second flush)")
    if ped.STATS["rlc_pass"] - stats0["rlc_pass"] != 2 or \
            ped.STATS["per_lane"] != stats0["per_lane"]:
        raise AssertionError(f"clean tiles left the RLC path: {ped.STATS}")
    e2e["sigs_per_s"] = n / e2e["flush_s"]

    bad_sigs = list(sigs)
    tampered = [17, n // 2, n - 1]
    for i in tampered:
        s = bad_sigs[i]
        bad_sigs[i] = s[:33] + bytes([s[33] ^ 1]) + s[34:]
    malformed = 100
    bad_sigs[malformed] = bad_sigs[malformed][:63]
    ok, bad_oks, e2e["attribution_flush_s"] = flush(pubs, msgs, bad_sigs, n)
    wrong = sorted(i for i, v in enumerate(bad_oks) if not v)
    if ok or wrong != sorted(tampered + [malformed]):
        raise AssertionError(f"bad tile: False lanes {wrong[:10]}")
    if ped.STATS["per_lane"] - stats0["per_lane"] != 1:
        raise AssertionError("bad tile was not attributed per lane")

    ok, oks, e2e["flush_200_s"] = flush(pubs[:VALIDATORS], msgs[:VALIDATORS],
                                        sigs[:VALIDATORS], None)
    if not ok or len(oks) != VALIDATORS:
        raise AssertionError("200-lane flush (bucket 256) did not verify")

    sample = sorted(set(np.random.default_rng(9).choice(n, 256 - 4,
                                                        replace=False)
                        .tolist()) | set(tampered) | {malformed})[:256]
    for i in sample:
        if bad_oks[i] != ref.verify(pubs[i], msgs[i], bad_sigs[i]):
            raise AssertionError(f"lane {i} disagrees with ref.verify")
    e2e["oracle_sample_lanes"] = len(sample)


def run_pt_add_ab(torch, pkg, add_args, report) -> None:
    """The pt_add_tiled path: the op-level A/B of tools/ab_pallas.py,
    the kernel and its plain version timed on the same 8192 lanes."""
    cv = pkg["cv"]
    report["pt_add_tiled"]["call_ms"] = _median_ms(
        torch, lambda: cv.pt_add_tiled(*add_args), 50)
    report["pt_add_tiled"]["plain_ms"] = _median_ms(
        torch, lambda: cv.pt_add_tiled_plain(*add_args), 5)


def run_blocksync(torch, pkg, chain, gen_app, seed, corrupt=None,
                  profile=False, depth=1, guards=False,
                  backend=None, tile=TILE, per_call=None) -> dict:
    """One catch-up from genesis over the chain on the card, through
    `BlocksyncReactor.sync` at `pipeline_depth=depth` (tile `tile`, batch
    8192, a fresh SigCache); checks the final state against the
    generator's and returns the sync's figures: the time spent in each
    span, and the kernel launches of the sync alone (the counts are
    zeroed just before it and read just after, so the kernels' prewarm
    at the reactor's construction is not among them). `guards` gives
    the reactor a DeviceWatchdog and a DeviceSupervisor with canary
    lanes, and then no trip, drain, canary failure or quarantine may
    happen. `backend` is the pipeline's verify backend (default: the
    reactor's in-process one). `profile` runs the sync under
    torch.profiler and adds its kernel launches and device-busy seconds
    (the wall then carries the profiler's cost). With `per_call` (the
    RLC kernels' launches a flush), an unprofiled sync is counted as
    `FlushCount` counts a pass: every launch must belong to a flush or a
    canary run, and `flush_count` holds its flushes."""
    from cometbft_tpu_torch import trace
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.db.kv import MemDB
    from cometbft_tpu_torch.device.health import DeviceSupervisor
    from cometbft_tpu_torch.engine.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.engine.chain_gen import LocalChainSource
    from cometbft_tpu_torch.pipeline.cache import (SigCache,
                                                   reset_shared_cache)
    from cometbft_tpu_torch.pipeline.watchdog import DeviceWatchdog
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.store.blockstore import BlockStore
    ped, cv = pkg["ped"], pkg["cv"]
    # the generator's commit checks filled the process-wide cache; a
    # sync that found every lane there would leave the card idle
    reset_shared_cache()
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    src = LocalChainSource(chain, dict(corrupt or {}))
    supervisor = DeviceSupervisor(canary=True) if guards else None
    watchdog = DeviceWatchdog(supervisor=supervisor) if guards else None
    reactor = BlocksyncReactor(
        BlockExecutor(app, device="cuda"), BlockStore(MemDB()), src,
        chain.chain_id, tile_size=tile, batch_size=LANES, cache=SigCache(),
        pipeline_depth=depth, backend=backend, watchdog=watchdog,
        supervisor=supervisor, device="cuda")
    state = State.from_genesis(chain.genesis)
    stats0 = dict(ped.STATS)
    out: dict = {}

    def sync():
        out["state"] = reactor.sync(state)

    _, recorder = trace.enable(seed=seed)
    try:
        torch.cuda.synchronize()
        cv.reset_launches()
        count = FlushCount(torch, pkg, per_call) \
            if per_call is not None and not profile else None
        if profile:
            names: dict = {}
            # the RLC kernels' events in start order, a flush reading
            # D T W E (decompression, tables, window sums, epilogue):
            # where a profile misses launches, this shows which flush
            letters = {f: c for k, c in (("pt_decompress_tiled", "D"),
                                         ("rlc_epilogue", "E"))
                       for f in _source_fns(k)}
            letters.update(rlc_tables_kernel="T", rlc_window_sums_kernel="W")
            launches, busy_us, wall, order = _device_kernels(
                torch, sync, names, letters)
            out["profiled"] = {"kernel_launches": launches,
                               "rlc_order": order,
                               "device_busy_s": busy_us / 1e6,
                               "wall_s": wall,
                               "idle_share": 1 - busy_us / 1e6 / wall,
                               "launches_by_kernel": {
                                   k: sum(names.get(f, 0)
                                          for f in _source_fns(k))
                                   for k in KERNELS}}
        else:
            t0 = time.perf_counter()
            c0, p0 = time.thread_time(), time.process_time()
            sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out["main_cpu_s"] = time.thread_time() - c0
            out["process_cpu_s"] = time.process_time() - p0
        counted = dict(cv.LAUNCHES)
        spans = recorder.snapshot()
    finally:
        trace.disable()
    state = out["state"]
    span_s: dict = {}
    for sp in spans:
        span_s[sp["name"]] = span_s.get(sp["name"], 0.0) + \
            (sp["t1"] - sp["t0"]) / 1e9
    st = reactor.stats
    top = chain.max_height()
    if state.last_block_height != top or st.blocks_applied != top:
        raise AssertionError(f"sync stopped at {state.last_block_height}, "
                             f"{st}")
    if state.app_hash != gen_app.last_app_hash or \
            app.state != gen_app.state:
        raise AssertionError("synced app state differs from the generator's")
    if state.validators.hash() != \
            chain.blocks[-1].header.next_validators_hash or \
            state.last_block_id != chain.block_ids[-1]:
        raise AssertionError("synced validators or last block id differ")
    fig = {"depth": depth, "wall_s": wall, "sigs_verified": st.sigs_verified,
           "sigs_per_s": st.sigs_verified / wall,
           "tiles_flushed": st.tiles_flushed,
           "respeculations": st.respeculations, "banned": src.banned,
           "rlc_pass": ped.STATS["rlc_pass"] - stats0["rlc_pass"],
           "per_lane": ped.STATS["per_lane"] - stats0["per_lane"],
           "launches": counted, "span_s": span_s,
           **{k: out[k] for k in ("profiled", "main_cpu_s", "process_cpu_s")
              if k in out}}
    if count is not None:
        fig["flush_count"] = count.read(f"sync of {chain.chain_id}, depth "
                                        f"{depth}")
    if guards:
        fig["guards"] = {
            "watchdog_trips": watchdog.trips,
            "watchdog_fallbacks": watchdog.fallbacks,
            "supervisor": supervisor.state_name(),
            "canary_failures": supervisor.canary_failures,
            "quarantines": supervisor.quarantines,
            "cpu_drains": sum(1 for sp in spans
                              if sp["name"] == "pipeline.cpu_drain")}
        g = fig["guards"]
        if (g["watchdog_trips"] or g["watchdog_fallbacks"]
                or g["supervisor"] != "healthy" or g["canary_failures"]
                or g["quarantines"] or g["cpu_drains"]):
            raise AssertionError(f"depth {depth}: a drain, trip or canary "
                                 f"failure: {g}")
    return fig


def _read_path(launches: dict, path: str, kernels) -> dict:
    """The launch counts of one path; every kernel of it must have run."""
    if not all(launches[k] > 0 for k in kernels):
        raise AssertionError(f"{path}: a kernel was not launched: "
                             f"{launches}")
    return dict(launches)


class VerifyClock:
    """Times every `verify_lanes` call of the catch-up on the thread that
    makes it (the main thread at depth 1, the pipeline's worker at depth
    K): its wall time and that thread's CPU time. The rest of the wall
    is time the thread waited, for the interpreter lock or for the card.
    It wraps the function where the synchronous loop and the pipeline's
    in-process backend look it up, and `close` puts it back."""

    def __init__(self):
        from cometbft_tpu_torch.engine import blocksync
        from cometbft_tpu_torch.pipeline import scheduler
        self.mods = (blocksync, scheduler)
        self.orig = blocksync.verify_lanes
        self.calls: list = []

        def timed(*args, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return self.orig(*args, **kw)
            finally:
                self.calls.append((time.perf_counter() - t0,
                                   time.thread_time() - c0))

        for mod in self.mods:
            mod.verify_lanes = timed

    def take(self) -> dict:
        calls, self.calls = self.calls, []
        return {"calls": len(calls), "wall_s": sum(w for w, _ in calls),
                "cpu_s": sum(c for _, c in calls)}

    def close(self) -> None:
        for mod in self.mods:
            mod.verify_lanes = self.orig


def _spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs)), "runs": [float(x) for x in xs]}


def run_pipeline(torch, pkg, chain, gen_app, seed) -> dict:
    """The pipelined catch-up: the chain synced at each depth of DEPTHS,
    PIPE_REPEATS times each in alternating order (1, 2, 4 then 4, 2, 1),
    every run kept, with the watchdog and the supervisor (canaries on);
    then one profiled sync per depth whose profile holds every launch
    the counters made (up to PROFILE_TRIES; the misses of each try are
    kept, and if every try missed some the busy time and idle share are
    null: they would undercount), and the tampered sync at depth 1 and
    at the deepest depth, which must ban the same height. Every sync
    must launch the three RLC kernels."""
    rlc = ("pt_decompress_tiled", "rlc_window_sums", "rlc_epilogue")
    runs: dict = {d: [] for d in DEPTHS}
    clock = VerifyClock()
    try:
        for r in range(PIPE_REPEATS):
            for d in (DEPTHS if r % 2 == 0 else DEPTHS[::-1]):
                fig = run_blocksync(torch, pkg, chain, gen_app, seed,
                                    depth=d, guards=True)
                fig["verify_calls"] = clock.take()
                _read_path(fig["launches"], f"pipelined sync, depth {d}",
                           rlc)
                if fig["banned"] or fig["per_lane"]:
                    raise AssertionError(f"clean pipelined sync: {fig}")
                runs[d].append(fig)
    finally:
        clock.close()
    out: dict = {"blocks": chain.max_height(), "depths": {}}
    for d in DEPTHS:
        misses, orders, totals = [], [], []
        for _ in range(PROFILE_TRIES):
            prof = run_blocksync(torch, pkg, chain, gen_app, seed, depth=d,
                                 guards=True, profile=True)
            _read_path(prof["launches"], f"profiled sync, depth {d}", rlc)
            by_kernel = prof["profiled"]["launches_by_kernel"]
            misses.append({k: prof["launches"][k] - by_kernel[k]
                           for k in rlc})
            orders.append(prof["profiled"]["rlc_order"])
            totals.append(prof["profiled"]["kernel_launches"])
            if not any(misses[-1].values()):
                break
        prof["profiled"]["missed_by_try"] = misses
        prof["profiled"]["order_by_try"] = orders
        prof["profiled"]["launches_by_try"] = totals
        if any(misses[-1].values()):
            # the profile lost device events: its busy time undercounts
            print(f"profiled sync, depth {d}: the profiler missed "
                  f"launches on every try {misses} (RLC order {orders}); "
                  f"busy time and idle share not measured", flush=True)
            prof["profiled"]["device_busy_s"] = None
            prof["profiled"]["idle_share"] = None
        spans = sorted({n for f in runs[d] for n in f["span_s"]})
        out["depths"][d] = {
            "wall_s": _spread([f["wall_s"] for f in runs[d]]),
            "sigs_per_s": _spread([f["sigs_per_s"] for f in runs[d]]),
            "span_s": {n: _spread([f["span_s"].get(n, 0.0)
                                   for f in runs[d]]) for n in spans},
            "main_cpu_s": _spread([f["main_cpu_s"] for f in runs[d]]),
            "process_cpu_s": _spread([f["process_cpu_s"] for f in runs[d]]),
            "verify_wall_s": _spread([f["verify_calls"]["wall_s"]
                                      for f in runs[d]]),
            "verify_cpu_s": _spread([f["verify_calls"]["cpu_s"]
                                     for f in runs[d]]),
            "verify_calls": runs[d][0]["verify_calls"]["calls"],
            "sigs_verified": runs[d][0]["sigs_verified"],
            "tiles_flushed": runs[d][0]["tiles_flushed"],
            "launches": runs[d][0]["launches"],
            "guards": [f["guards"] for f in runs[d]],
            "profiled": prof["profiled"]}
    bad = {d: run_blocksync(torch, pkg, chain, gen_app, seed, {7: "sig"},
                            depth=d, guards=True)
           for d in (DEPTHS[0], DEPTHS[-1])}
    bans = {d: f["banned"] for d, f in bad.items()}
    if not bans[DEPTHS[0]] or bans[DEPTHS[0]][0] not in (6, 7) or \
            len({tuple(b) for b in bans.values()}) != 1:
        raise AssertionError(f"tampered pipelined syncs banned {bans}")
    for d, f in bad.items():
        _read_path(f["launches"], f"tampered sync, depth {d}", rlc)
    out["tampered"] = {d: {k: f[k] for k in ("wall_s", "banned",
                                             "per_lane", "launches",
                                             "guards")}
                       for d, f in bad.items()}
    return out


def run_device_server(torch, pkg, tile, chain, gen_app, seed) -> dict:
    """The device server on the card, in this process: two clients send
    the seam tile's first SERVER_LANES lanes and its next SERVER_LANES
    (one tampered) at once; each client's verdicts must equal
    `verify_batch`'s in-process verdicts on the same lanes. Then one
    pipelined sync of the 48-block chain at depth 2 through
    `DeviceClientBackend`, and one `create_batch_verifier` call with
    COMETBFT_TPU_DEVICE_SERVER set, which must give a
    `RemoteBatchVerifier`. No flush may fail."""
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
    from cometbft_tpu_torch.device import client as dclient
    from cometbft_tpu_torch.device.server import DeviceServer
    from cometbft_tpu_torch.pipeline.scheduler import DeviceClientBackend
    ped, cv = pkg["ped"], pkg["cv"]
    rlc = ("pt_decompress_tiled", "rlc_window_sums", "rlc_epilogue")
    pubs, msgs, sigs = tile
    a = slice(0, SERVER_LANES)
    b = slice(SERVER_LANES, 2 * SERVER_LANES)
    b_sigs = list(sigs[b])
    k = SERVER_LANES // 3   # the tampered lane of the second client
    b_sigs[k] = b_sigs[k][:33] + bytes([b_sigs[k][33] ^ 1]) + b_sigs[k][34:]
    out: dict = {}
    t0 = time.perf_counter()
    srv = DeviceServer(bucket=LANES, flush_us=SERVER_FLUSH_US,
                       device="cuda")
    clients = []
    try:
        srv.start()
        out["start_s"] = time.perf_counter() - t0
        clients = [dclient.DeviceClient(*srv.addr) for _ in range(2)]
        flushes0 = srv.stats["flushes"]
        torch.cuda.synchronize()
        cv.reset_launches()
        t0 = time.perf_counter()
        fa = clients[0].submit(pubs[a], msgs[a], sigs[a])
        fb = clients[1].submit(pubs[b], msgs[b], b_sigs)
        ok_a, oks_a = fa.result()
        ok_b, oks_b = fb.result()
        out["two_clients_s"] = time.perf_counter() - t0
        out["two_clients_flushes"] = srv.stats["flushes"] - flushes0
        out["launches"] = _read_path(dict(cv.LAUNCHES), "device server", rlc)
        want_a = ped.verify_batch(pubs[a], msgs[a], sigs[a],
                                  batch_size=LANES, device="cuda")
        want_b = ped.verify_batch(pubs[b], msgs[b], b_sigs,
                                  batch_size=LANES, device="cuda")
        if oks_a != [bool(v) for v in want_a] or not ok_a or \
                not all(oks_a) or len(oks_a) != SERVER_LANES:
            raise AssertionError("device server: the clean client's "
                                 "verdicts differ")
        if oks_b != [bool(v) for v in want_b] or ok_b or \
                [i for i, v in enumerate(oks_b) if not v] != [k]:
            raise AssertionError("device server: the tampered client's "
                                 "verdicts differ")
        fig = run_blocksync(torch, pkg, chain, gen_app, seed, depth=2,
                            guards=True,
                            backend=DeviceClientBackend(clients[0]))
        _read_path(fig["launches"], "pipelined sync through the server",
                   rlc)
        out["sync"] = {k2: fig[k2] for k2 in ("wall_s", "sigs_per_s",
                                              "sigs_verified", "launches",
                                              "guards", "span_s")}
        os.environ[dclient.ENV_VAR] = f"127.0.0.1:{srv.addr[1]}"
        try:
            bv, supported = create_batch_verifier(Ed25519PubKey(pubs[0]),
                                                  batch_size=LANES)
            if not supported or not isinstance(bv,
                                               dclient.RemoteBatchVerifier):
                raise AssertionError(f"create_batch_verifier gave {bv!r}")
            for pk, msg, sig in zip(pubs[:VALIDATORS], msgs[:VALIDATORS],
                                    sigs[:VALIDATORS]):
                bv.add(Ed25519PubKey(pk), msg, sig)
            flushes0 = srv.stats["flushes"]
            ok, oks = bv.verify()
            if not ok or len(oks) != VALIDATORS or \
                    srv.stats["flushes"] != flushes0 + 1:
                raise AssertionError("RemoteBatchVerifier did not verify "
                                     "through the server")
        finally:
            del os.environ[dclient.ENV_VAR]
            if dclient._shared is not None:
                dclient._shared.close()
                dclient._shared = None
    finally:
        for c in clients:
            c.close()
        srv.stop()
    out["stats"] = dict(srv.stats)
    if srv.stats["flush_failures"]:
        raise AssertionError(f"device server: flushes failed: {srv.stats}")
    return out


class FlushCount:
    """The RLC verifies one path makes, read from the launch counters:
    zeroed (with the canary's and the host protocol's counters noted)
    when it is made, read by `read` just after the path. Every RLC
    verify (`verify_rlc_core_cuda`: a dispatch of `verify_batch`, or a
    canary run before one) launches each RLC kernel its measured
    `launches_per_call` times, and nothing else launches them: the
    counts must be exactly that many, and a path that made no flush
    (every lane a signature-cache hit) fails."""

    def __init__(self, torch, pkg, per_call: dict):
        self.torch, self.cv, self.ped = torch, pkg["cv"], pkg["ped"]
        self.per_call = per_call
        torch.cuda.synchronize()
        self.cv.reset_launches()
        self.c0 = self.ped.canary_stats()
        self.s0 = dict(self.ped.STATS)

    def read(self, path: str, want_flushes=None) -> dict:
        self.torch.cuda.synchronize()
        launches = dict(self.cv.LAUNCHES)
        c1 = self.ped.canary_stats()
        flushes = c1["dispatches"] - self.c0["dispatches"]
        canaries = c1["runs"] - self.c0["runs"]
        stats = {k: self.ped.STATS[k] - self.s0[k] for k in self.s0}
        got = {k: launches[k] for k in self.per_call}
        want = {k: n * (flushes + canaries) for k, n in self.per_call.items()}
        if not flushes or got != want or \
                sum(stats.values()) != flushes or \
                (want_flushes is not None and flushes != want_flushes):
            raise AssertionError(
                f"{path}: {flushes} flushes (want {want_flushes}) and "
                f"{canaries} canary runs, RLC launches {got}, want {want}, "
                f"host protocol {stats}")
        return {"flushes": flushes, "canaries": canaries, **stats,
                "launches": launches}


def run_light_client(torch, pkg, chain, per_call: dict) -> dict:
    """The light client over the chain, on the card, each pass with a
    fresh signature cache (the generator and the syncs filled it) and
    its own launch counts: a sequential client from trusted height 1 to
    the tip (the trust root and every adjacent header, one flush each);
    a skipping client trusted at the middle of the chain, one
    non-adjacent jump to the tip (a 1/3 trusting check and a +2/3 check)
    and the backwards walk to a height below its trust root (hash links,
    no flush); a witness that serves a forged header at the tip, which
    must raise ConflictingHeadersError with evidence that survives its
    wire form; a primary whose commit carries a tampered signature,
    which must be rejected (the flush attributed per lane)."""
    from cometbft_tpu_torch.db.kv import MemDB
    from cometbft_tpu_torch.engine.chain_gen import ChainLightProvider
    from cometbft_tpu_torch.light import (LightBlock, LightClient,
                                          LightStore, SignedHeader,
                                          TrustOptions)
    from cometbft_tpu_torch.light.client import ConflictingHeadersError
    from cometbft_tpu_torch.light.verifier import ErrInvalidHeader
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.types.evidence import decode_evidence
    from cometbft_tpu_torch.types.proto import Timestamp
    top = chain.max_height()
    mid = top // 2
    now = Timestamp(1_700_000_000 + top + 5, 0)

    class Primary(ChainLightProvider):
        """The chain's light blocks; at height `forge` a forged header
        with the original commit (a lying witness), at height `bad_sig`
        a commit with a bit of one signature flipped (a lying
        primary)."""

        def __init__(self, forge=None, bad_sig=None):
            super().__init__(chain)
            self.forge, self.bad_sig = forge, bad_sig

        def light_block(self, height):
            lb = super().light_block(height)
            sh = lb.signed_header
            if lb.height == self.forge:
                hdr = dataclasses.replace(sh.header, app_hash=b"\x66" * 32)
                return LightBlock(SignedHeader(hdr, sh.commit),
                                  lb.validator_set)
            if lb.height == self.bad_sig:
                sigs = list(sh.commit.signatures)
                s = sigs[5].signature
                sigs[5] = dataclasses.replace(
                    sigs[5], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
                commit = dataclasses.replace(sh.commit, signatures=sigs)
                return LightBlock(SignedHeader(sh.header, commit),
                                  lb.validator_set)
            return lb

    def client(root=1, sequential=False, primary=None, witnesses=()):
        opts = TrustOptions(period_seconds=10**9, height=root,
                            hash=chain.blocks[root - 1].hash())
        return LightClient(chain.chain_id, opts, primary or Primary(),
                           list(witnesses), LightStore(MemDB()),
                           sequential=sequential, now_fn=lambda: now,
                           device="cuda")

    out: dict = {"headers": top, "validators": VALIDATORS}
    reset_shared_cache()
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    lc = client(sequential=True)
    lb = lc.verify_light_block_at_height(top)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if lb.header.hash() != chain.blocks[-1].hash() or any(
            lc.trusted_light_block(h) is None for h in range(1, top + 1)):
        raise AssertionError("sequential light client: wrong tip or a gap")
    out["sequential_trusted"] = [h for h in range(1, top + 1)
                                 if lc.trusted_light_block(h)]
    out["sequential"] = {
        "wall_s": wall, "headers_per_s": top / wall,
        "ms_per_header": wall / top * 1e3,
        **count.read("light client, sequential", want_flushes=top)}
    # its first PROFILED_HEADERS headers past the trust root again, under
    # torch.profiler: the card's busy time and idle share (the wall
    # carries the profiler's cost)
    reset_shared_cache()
    lc = client(sequential=True)
    launches, busy_us, wall = _device_kernels(
        torch, lambda: lc.verify_light_block_at_height(PROFILED_HEADERS + 1))
    out["sequential"]["profiled"] = {
        "headers": PROFILED_HEADERS, "kernel_launches": launches,
        "device_busy_s": busy_us / 1e6, "wall_s": wall,
        "idle_share": 1 - busy_us / 1e6 / wall}

    reset_shared_cache()
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    lc = client(root=mid)
    lb = lc.verify_light_block_at_height(top)
    low = lc.verify_light_block_at_height(mid // 2)
    torch.cuda.synchronize()
    if lb.header.hash() != chain.blocks[-1].hash() or \
            low.header.hash() != chain.blocks[mid // 2 - 1].hash() or \
            lc.trusted_light_block(mid + 1) is not None:
        raise AssertionError("skipping light client: wrong headers")
    out["skipping_and_backwards"] = {
        "wall_s": time.perf_counter() - t0, "root": mid,
        "backwards_to": mid // 2,
        **count.read("light client, skipping and backwards",
                     want_flushes=3)}

    reset_shared_cache()
    count = FlushCount(torch, pkg, per_call)
    lc = client(witnesses=[Primary(forge=top)])
    try:
        lc.verify_light_block_at_height(top)
        raise AssertionError("a forged witness header went unnoticed")
    except ConflictingHeadersError as e:
        ev = e.evidence
        back = decode_evidence(ev.encode())
        if back.hash() != ev.hash() or back.encode() != ev.encode() or \
                lc.trusted_light_block(top) is not None:
            raise AssertionError("attack evidence did not survive its wire "
                                 "form, or the disputed header stayed")
        out["forged_witness"] = {
            "error": type(e).__name__, "common_height": ev.common_height,
            "byzantine": len(ev.byzantine_validators),
            "evidence_bytes": len(ev.encode()),
            **count.read("light client, forged witness", want_flushes=3)}

    reset_shared_cache()
    count = FlushCount(torch, pkg, per_call)
    lc = client(sequential=True, primary=Primary(bad_sig=2))
    try:
        lc.verify_light_block_at_height(2)
        raise AssertionError("a tampered commit signature was accepted")
    except ErrInvalidHeader as e:
        out["tampered_commit"] = {
            "error": type(e).__name__, "trusted_2": lc.trusted_light_block(2)
            is not None,
            **count.read("light client, tampered commit", want_flushes=2)}
    if out["tampered_commit"]["trusted_2"] or \
            out["tampered_commit"]["per_lane"] != 1:
        raise AssertionError(f"tampered commit: {out['tampered_commit']}")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in (
        "sequential", "skipping_and_backwards", "forged_witness",
        "tampered_commit")) for k in KERNELS}
    return out


def _mixed_keys(seed: int):
    """MIXED_SET's private keys, drawn from the seed, in a shuffled
    order: (key type, private key)."""
    from cometbft_tpu_torch.crypto.keys import privkey_from_type_bytes
    from cometbft_tpu_torch.crypto.secp256k1 import N as SECP_N
    rng = np.random.default_rng(seed)
    keys = []
    for key_type, n in MIXED_SET.items():
        for _ in range(n):
            raw = rng.bytes(64 if key_type == "sr25519" else 32)
            while key_type == "secp256k1" and \
                    not 1 <= int.from_bytes(raw, "big") < SECP_N:
                raw = rng.bytes(32)
            keys.append((key_type, privkey_from_type_bytes(key_type, raw)))
    return [keys[i] for i in rng.permutation(len(keys))]


def _oracle(key_type, pub, msg, sig, ref) -> bool:
    """One signature's verdict on the host: the ed25519 oracle, or the
    key's own single verify."""
    if key_type == "ed25519":
        return ref.verify(pub.bytes_(), msg, sig)
    return pub.verify_signature(msg, sig)


def _host_costs(keys, ref, reps: int = 5) -> dict:
    """Median host ms of one signature and one single verify of a
    120-byte message, per key type (the first key of each type), and of
    the ed25519 oracle's verify: what a mixed commit's lanes that do not
    batch on the card cost."""
    msg = bytes(range(120))
    out = {}
    for key_type in MIXED_SET:
        key = next(k for t, k in keys if t == key_type)
        pub = key.pub_key()
        sign, verify = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            sig = key.sign(msg)
            t1 = time.perf_counter()
            if not _oracle(key_type, pub, msg, sig, ref):
                raise AssertionError(f"{key_type}: own signature rejected")
            verify.append((time.perf_counter() - t1) * 1e3)
            sign.append((t1 - t0) * 1e3)
        out[key_type] = {"sign_ms": float(np.median(sign)),
                         "verify_ms": float(np.median(verify))}
    return out


def make_mixed_chain(keys, n_blocks: int):
    """A chain of `n_blocks` blocks over the mixed set less its sr25519
    keys, built as `generate_chain` builds one (the executor on the
    card; 2 txs a block) over a genesis of typed keys: no application
    admits a secp256k1 key through a validator update, in either
    package, so a mixed set enters a chain only at its genesis. -> (the
    chain, the generator's app)."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.engine.chain_gen import (GeneratedChain,
                                                     sign_commit)
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import GenesisDoc, State
    from cometbft_tpu_torch.types.block import BlockID, Commit
    from cometbft_tpu_torch.types.proto import Timestamp
    from cometbft_tpu_torch.types.validator import Validator
    privs = [k for t, k in keys if t != "sr25519"]
    by_addr = {k.pub_key().address(): k for k in privs}
    gen = GenesisDoc(chain_id=MIXED_CHAIN_ID,
                     validators=[Validator(k.pub_key(), 10) for k in privs],
                     genesis_time=Timestamp(1_700_000_000, 0))
    state = State.from_genesis(gen)
    app = KVStoreApplication()
    app.init_chain(MIXED_CHAIN_ID, gen.initial_height, [], b"")
    executor = BlockExecutor(app, device="cuda")
    blocks, block_ids, commits, valsets = [], [], [], []
    last_commit = Commit()
    for h in range(1, n_blocks + 1):
        block = state.make_block(
            h, [f"k{h}-{i}=v{h}-{i}".encode() for i in range(2)],
            last_commit, state.validators.get_proposer().address,
            timestamp=Timestamp(1_700_000_000 + h, 0))
        block_id = BlockID(block.hash(), block.make_part_set().header)
        commit = sign_commit(MIXED_CHAIN_ID, h, 0, block_id,
                             state.validators, by_addr)
        valsets.append(state.validators.copy())
        state, _ = executor.apply_block(state, block_id, block)
        blocks.append(block)
        block_ids.append(block_id)
        commits.append(commit)
        last_commit = commit
    return GeneratedChain(chain_id=MIXED_CHAIN_ID, genesis=gen,
                          blocks=blocks, block_ids=block_ids,
                          seen_commits=commits, keys=by_addr,
                          valsets=valsets), app


def run_mixed_sync(torch, pkg, keys, seed: int, per_call: dict) -> dict:
    """The mixed set's chain (`make_mixed_chain`) synced from genesis
    through `BlocksyncReactor(pipeline_depth=2)` on the card, with the
    watchdog and the supervisor, in tiles of MIXED_TILE blocks: every
    commit is verified at marshal on the main thread (an `AggSeal`;
    its ed25519 bucket one flush, where the height's proposer holds an
    ed25519 key) while the worker settles the tile before. Clean: it
    must reach the generator's state with no ban and make exactly one
    flush per such commit. Then with the first signature of height 4's
    last commit tampered: the peer is banned at height 3 or 4 and the
    sync still reaches the tip. The worker's tiles hold no lanes: a
    chain over a mixed set has no commit over an ed25519-only one."""
    t0 = time.perf_counter()
    mchain, mapp = make_mixed_chain(keys, MIXED_BLOCKS)
    out: dict = {"blocks": MIXED_BLOCKS, "tile": MIXED_TILE,
                 "validators": len(mchain.valsets[0].validators),
                 "chain_s": time.perf_counter() - t0}
    n_vals = out["validators"]
    for name, corrupt in (("clean", None), ("tampered", {4: "sig"})):
        fig = run_blocksync(torch, pkg, mchain, mapp, seed, corrupt,
                            depth=2, guards=True, tile=MIXED_TILE,
                            per_call=per_call)
        flushes = fig["flush_count"]["flushes"]
        if corrupt is None:
            commits = fig["sigs_verified"] // n_vals
            want = sum(mchain.valsets[h].get_proposer().pub_key.type_()
                       == "ed25519" for h in range(commits))
            if fig["banned"] or fig["tiles_flushed"] < 3 or \
                    commits < MIXED_BLOCKS - 1 or flushes != want:
                raise AssertionError(
                    f"clean mixed sync: {commits} commits, {flushes} "
                    f"flushes (want {want}), {fig}")
        elif not fig["banned"] or fig["banned"][0] not in (3, 4):
            raise AssertionError(f"tampered mixed sync banned "
                                 f"{fig['banned']}")
        out[name] = {k: fig[k] for k in (
            "wall_s", "sigs_verified", "tiles_flushed", "banned", "rlc_pass",
            "per_lane", "launches", "flush_count", "guards", "span_s")}
    return out


def run_mixed_set(torch, pkg, chain, seed: int, per_call: dict) -> dict:
    """A mixed-curve validator set of MIXED_SET's size (the VerifyCommit
    configuration's 150), its keys drawn from the seed; four commits it
    signs over the block ids of the chain's heights 1-4 (no chain can
    carry such a set: the validator-set hash has no sr25519 key form),
    an ed25519 validator its proposer.
    On the card, each pass with a fresh signature cache and its own
    launch counts: the `MixedBatchVerifier` seam, a clean 150-lane flush
    and one with a tampered lane of each curve, lane-exact against the
    oracles; `validation.verify_commit` on a clean and on a tampered
    commit; `TiledCommitVerifier.verify_tile` on one tile of 40 of the
    chain's ed25519 commits and the mixed ones (one clean, one with a
    tampered secp256k1 lane, one clean, one with a tampered ed25519
    lane); the set through the state JSON and back."""
    from cometbft_tpu_torch.crypto.batch import MixedBatchVerifier
    from cometbft_tpu_torch.engine.blocksync import (TileEntry,
                                                     TiledCommitVerifier)
    from cometbft_tpu_torch.engine.chain_gen import sign_commit
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.state import state as st
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.block import CommitSig
    from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
    ref = pkg["ref"]
    keys = _mixed_keys(seed)
    members = [Validator(k.pub_key(), 10) for _t, k in keys]
    # the proposer's key type decides whether a commit batch-verifies at
    # all (a secp256k1 proposer sends every lane down the per-signature
    # path, in the JAX package too): this height's is an ed25519 one
    vals = ValidatorSet(members, proposer=min(
        (v for v in members if v.pub_key.type_() == "ed25519"),
        key=lambda v: v.address))
    by_addr = {k.pub_key().address(): k for _t, k in keys}
    types = [v.pub_key.type_() for v in vals.validators]
    first = {t: types.index(t) for t in MIXED_SET}
    out: dict = {"set": dict(MIXED_SET), "host_ms": _host_costs(keys, ref)}
    t0 = time.perf_counter()
    commits = [sign_commit(chain.chain_id, h, 0, chain.block_ids[h - 1],
                           vals, by_addr) for h in (1, 2, 3, 4)]
    out["sign_s"] = time.perf_counter() - t0

    def tampered(commit, lanes):
        sigs = list(commit.signatures)
        for i in lanes:
            s = sigs[i].signature
            sigs[i] = CommitSig(sigs[i].block_id_flag,
                                sigs[i].validator_address, sigs[i].timestamp,
                                s[:40] + bytes([s[40] ^ 1]) + s[41:])
        return dataclasses.replace(commit, signatures=sigs)

    # the seam: one MixedBatchVerifier flush of the commit's lanes
    bad_lanes = sorted(first.values())
    for name, commit in (("clean", commits[0]),
                         ("one_bad_per_curve",
                          tampered(commits[0], bad_lanes))):
        lanes = [(v.pub_key, commit.vote_sign_bytes(chain.chain_id, i),
                  cs.signature) for i, (v, cs) in enumerate(
                      zip(vals.validators, commit.signatures))]
        mv = MixedBatchVerifier(device="cuda")
        for lane in lanes:
            mv.add(*lane)
        count = FlushCount(torch, pkg, per_call)
        t0 = time.perf_counter()
        ok, oks = mv.verify()
        wall = time.perf_counter() - t0
        read = count.read(f"MixedBatchVerifier, {name}", want_flushes=1)
        want = [_oracle(t, *lane, ref) for t, lane in zip(types, lanes)]
        if oks != want or ok != all(want) or \
                [i for i, v in enumerate(oks) if not v] != (
                    bad_lanes if name != "clean" else []):
            raise AssertionError(f"MixedBatchVerifier {name}: False lanes "
                                 f"{[i for i, v in enumerate(oks) if not v]}")
        out[f"seam_{name}"] = {"wall_s": wall, "lanes": len(lanes), **read}

    # verify_commit, clean and with a tampered sr25519 lane
    for name, commit, want in (
            ("clean", commits[1], None),
            ("tampered_sr25519", tampered(commits[1], [first["sr25519"]]),
             first["sr25519"])):
        reset_shared_cache()
        count = FlushCount(torch, pkg, per_call)
        t0 = time.perf_counter()
        try:
            validation.verify_commit(chain.chain_id, vals,
                                     chain.block_ids[1], 2, commit,
                                     device="cuda")
            got = None
        except validation.ErrWrongSignature as e:
            got = e.idx
        wall = time.perf_counter() - t0
        if got != want:
            raise AssertionError(f"verify_commit {name}: bad lane {got}, "
                                 f"want {want}")
        out[f"verify_commit_{name}"] = {
            "wall_s": wall, **count.read(f"verify_commit, {name}",
                                         want_flushes=1)}

    # one tile: 40 of the chain's commits and the four mixed ones
    entries = [TileEntry(height=h, block=chain.blocks[h - 1],
                         block_id=chain.block_ids[h - 1],
                         valset=chain.valsets[h - 1],
                         commit=chain.seen_commits[h - 1])
               for h in range(1, TILE + 1)]
    mixed = [commits[0], tampered(commits[1], [first["secp256k1"]]),
             commits[2], tampered(commits[3], [first["ed25519"]])]
    entries += [TileEntry(height=h, block=chain.blocks[h - 1],
                          block_id=chain.block_ids[h - 1], valset=vals,
                          commit=c) for h, c in zip((1, 2, 3, 4), mixed)]
    reset_shared_cache()
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    TiledCommitVerifier(chain.chain_id, batch_size=LANES,
                        device="cuda").verify_tile(entries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    verdicts = [e.commit_ok for e in entries]
    if verdicts != [True] * TILE + [True, False, True, False]:
        raise AssertionError(f"mixed tile verdicts {verdicts[TILE:]}, "
                             f"{verdicts[:TILE].count(True)} of {TILE} "
                             "chain commits")
    # the chain's 8,000 lanes in one flush, each mixed commit's ed25519
    # bucket in one more at marshal
    out["tile"] = {"wall_s": wall, "commits": len(entries),
                   "chain_lanes": TILE * VALIDATORS,
                   **count.read("verify_tile, mixed", want_flushes=5)}

    raw = st._valset_to_json(vals)
    back = st._valset_from_json(raw)
    state = st.State.from_genesis(st.GenesisDoc(chain_id="mixed",
                                                validators=vals.validators))
    sj = st._state_to_json(state)
    if st._valset_to_json(back) != raw or [
            v.pub_key.type_() for v in back.validators] != types or \
            st._state_to_json(st._state_from_json(sj)) != sj:
        raise AssertionError("the mixed set did not survive the state JSON")
    out["state_json_bytes"] = len(sj)
    out["sync"] = run_mixed_sync(torch, pkg, keys, seed, per_call)
    out["launches"] = {k: sum(out[p]["launches"][k] for p in (
        "seam_clean", "seam_one_bad_per_curve", "verify_commit_clean",
        "verify_commit_tampered_sr25519", "tile")) + sum(
            out["sync"][p]["launches"][k] for p in ("clean", "tampered"))
        for k in KERNELS}
    return out


# --- the BLS aggregate-commit kernels and paths (aggsig) ----------------------

def bls_items(bls):
    """The held lanes, distinct: the known-one canary item, a clean 2-pair
    commit item (a key's signature e(-g1, S) e(pk, H(m))), a tampered
    aggregate (the signature of another message), the known-not-one
    canary item, a 1-pair item, then three more clean and one more
    tampered item over other keys and messages. With the host oracle's
    verdicts (`final_exponentiation(miller_product(.)) == 1`)."""
    q = bls.G2_GEN
    items = [[(bls.G1_NEG, q), (bls.G1_GEN, q)]]
    clean, tampered = [], []
    for i in range(4):
        key = bls.Bls12381PrivKey.generate(seed=b"chip-smoke-bls-%d" % i)
        msg = b"chip smoke precommit %d, longer than thirty-two bytes" % i
        h = bls.hash_to_g2_cached(bls._fixed_msg(msg))
        pk = key.pub_key().point
        clean.append([(bls.G1_NEG, bls.g2_decompress(key.sign(msg))),
                      (pk, h)])
        tampered.append([(bls.G1_NEG, bls.g2_decompress(
            key.sign(msg + b"!"))), (pk, h)])
    items += [clean[0], tampered[0], [(bls.G1_GEN, q), (bls.G1_GEN, q)],
              [(bls.G1_GEN, q)], clean[1], tampered[1], clean[2], clean[3]]
    want = [bls.final_exponentiation(bls.miller_product(it)) == bls.F12_ONE
            for it in items]
    if want != [True, True, False, False, False, True, False, True, True]:
        raise AssertionError(f"host oracle verdicts {want}")
    return items, want


# lane kinds beside the items: an item with no pairs (all identity lines),
# a lane whose lines are all zero (f = 0: final value 0, verdict False),
# and a pad lane (identity lines past the items)
BLS_IDENT, BLS_ZERO, BLS_PAD = "identity", "zero", "pad"


def _bls_lanes(items: list, bucket: int) -> list:
    """The held batches of a bucket, each an item index (or lane kind) per
    lane; the first is the timed one. At B = 4 two batches: the known-one
    canary, a clean and a tampered 2-pair item and a pad lane (the lanes
    of a `verify_commit` launch), then a clean item, the 1-pair item, an
    item with no pairs and a zero lane. Above it one batch: the items in
    turn and then the three kinds."""
    kinds = [BLS_IDENT, BLS_ZERO, BLS_PAD]
    if bucket == 4:
        one_pair = next(i for i, it in enumerate(items) if len(it) == 1)
        return [[0, 1, 2, BLS_PAD], [1, one_pair, BLS_IDENT, BLS_ZERO]]
    return [[i % len(items) for i in range(bucket - 3)] + kinds]


def _bls_chain(bits) -> tuple:
    """(Fq12 squarings, products) of the kernels' hard chain (fq381.cuh
    `bls_pow`): the odd powers m .. m^31 (one squaring, 15 products), then
    a squaring a bit and a product a window of up to 5 bits ending on a
    one, the first window a copy."""
    sq, mul, first, i, n = 1, 15, True, 0, len(bits)
    while i < n:
        if not bits[i]:
            sq, i = sq + 1, i + 1
            continue
        j = min(i + 5, n) - 1
        while not bits[j]:
            j -= 1
        if not first:
            sq, mul = sq + j - i + 1, mul + 1
        first, i = False, j + 1
    return sq, mul


def _bls_mads(name: str, bits, lines: np.ndarray) -> int:
    """The least int32 multiply-adds of one call of a BLS kernel on a
    bucket, each operation at its least cost (MADS_F12_SQ and the rest).
    The hard chain is the least we know for these public bits, the 5-bit
    sliding window of `_bls_chain` (1,265 squarings and 227 products for
    HARD_BITS, against square-and-multiply's 1,267 and 632): general
    squarings in `bls_hard_pow`, whose input is any Fq12 element,
    cyclotomic ones after the easy part in `bls_miller_finalexp`. There, per lane, the Miller scan counts only
    the lines that are not the identity (a zero-bit addition slot, an
    absent pair or a pad lane carries the identity), and the first step's
    squaring and its first line product act on f = 1 and cost nothing;
    the easy part is the Fq12 inversion (`_bls_inv12_mads`), two Fq12
    products and the p^2-Frobenius's 8 Fq products (gamma^0 = 1 and
    gamma^3 = -1). `lines` is the bucket's packed lines,
    (63, 2, 2, 3, 2, 24, B)."""
    from cometbft_tpu_torch.ops import bls12 as pb
    n_sq, n_mul = _bls_chain(bits)
    b = lines.shape[-1]
    if name == "bls_hard_pow":
        return b * (n_sq * MADS_F12_SQ + n_mul * MADS_F12)
    slots = lines.reshape(-1, 3 * 2 * pb.NLIMBS, b)
    ident = pb._identity_line().reshape(-1, 1)
    real = (slots != ident[None]).any(axis=1).sum(axis=0)   # (B,)
    miller = sum((BLS_STEPS - 1) * MADS_F12_SQ + (int(r) - 1) * MADS_SPARSE
                 for r in real if r)
    easy = _bls_inv12_mads(pb.P_INT) + 2 * MADS_F12 + 8 * MADS_FQ
    chain = n_sq * MADS_F12_CYC + n_mul * MADS_F12
    return miller + b * (easy + chain)


def _bls_inv12_mads(p: int) -> int:
    """The least multiply-adds of f12_inv_serial (fq381.cuh): the two Fq6
    squarings A^2, B^2 (3 Fq2 squarings and 3 Fq2 products each), the Fq6
    inverse (3 Fq2 squarings, 9 Fq2 products and the Fq2 inverse's 2 Fq
    squarings, 2 Fq products and Fermat chain to p - 2) and two Fq6
    products of 9 Fq2 products."""
    fermat = ((p - 2).bit_length() - 1) * MADS_FQ_SQ \
        + (bin(p - 2).count("1") - 1) * MADS_FQ
    return (2 * (3 * MADS_FQ2_SQ + 3 * MADS_FQ2)
            + 3 * MADS_FQ2_SQ + 9 * MADS_FQ2
            + 2 * MADS_FQ_SQ + 2 * MADS_FQ + fermat
            + 2 * 9 * MADS_FQ2)


def _bls_bytes(kernel: str, bucket: int, nbits: int) -> int:
    lane_in = (BLS_STEPS * 2 * 2 * 3 * 2 * 24 * 4
               if kernel == "bls_miller_finalexp" else 6 * 2 * 24 * 4)
    return bucket * (lane_in + 6 * 2 * 24 * 4 + 1) + 4 * nbits


def check_bls_kernels(torch, dev, report) -> None:
    """Hold both BLS kernels against their plain versions on the card at
    buckets 4, 16 and 64, exactly (the final Fq12 limbs and the
    verdicts), check the lanes' verdicts against the host oracle, hold
    `bls_hard_pow` once more with a short exponent, then time each kernel
    per bucket: device time under torch.profiler (BLS_ROUNDS calls a
    session, two sessions), one call with CUDA events, and the plain
    version's call (the holding run, synchronized)."""
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.ops import bls12 as pb
    items, want = bls_items(bls)
    items = items + [[]]                          # the all-identity item
    want = want + [True]
    n = len(items)
    lines_items = pb._pack_miller_lines(items, 16)   # lane n: a pad lane
    easy = pb._pack([bls.final_exp_easy(bls.miller_product(it))
                     for it in items] + [bls.F12_ONE])
    kind_col = {BLS_IDENT: n - 1, BLS_PAD: n}
    bits = torch.tensor(pb.HARD_BITS, dtype=torch.int32, device=dev)
    short = torch.tensor(pb.HARD_BITS[:40], dtype=torch.int32, device=dev)
    calls = {}
    for name in ("bls_miller_finalexp", "bls_hard_pow"):
        report[name] = {"by_bucket": {}, "max_abs_err": 0}

    def columns(arr, idx):
        cols = [np.zeros_like(arr[..., 0]) if i == BLS_ZERO
                else arr[..., kind_col.get(i, i)] for i in idx]
        return np.ascontiguousarray(np.stack(cols, -1))

    for bucket in BLS_BUCKETS:
        for batch, idx in enumerate(_bls_lanes(items[:-1], bucket)):
            lines_np = columns(lines_items, idx)
            lines = torch.from_numpy(lines_np).to(dev)
            arr = torch.from_numpy(columns(easy, idx)).to(dev)
            lane_want = [False if i == BLS_ZERO else True if i == BLS_PAD
                         else want[kind_col.get(i, i)] for i in idx]
            zero = [j for j, i in enumerate(idx) if i == BLS_ZERO]
            for name, fn, plain, x in (
                    ("bls_miller_finalexp", pb.bls_miller_finalexp,
                     pb.bls_miller_finalexp_plain, lines),
                    ("bls_hard_pow", pb.bls_hard_pow, pb.bls_hard_pow_plain,
                     arr)):
                out, ok = fn(x, bits)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pout, pok = plain(x, bits)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                err = int((out.long() - pout.long()).abs().max())
                if err or not torch.equal(ok, pok) or \
                        ok.tolist() != lane_want or \
                        (zero and int(out[..., zero].abs().max())):
                    raise AssertionError(
                        f"{name} at bucket {bucket}, lanes {idx}: "
                        f"max_abs_err {err} (plain), verdicts "
                        f"{ok.tolist()}, plain {pok.tolist()}, host "
                        f"oracle {lane_want}")
                r = report[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                lanes = [str(i) for i in idx] if bucket == 4 else \
                    f"items in turn, then {BLS_IDENT}, {BLS_ZERO}, {BLS_PAD}"
                if batch:
                    r["by_bucket"][bucket]["held_lanes"].append(lanes)
                    continue
                r["by_bucket"][bucket] = {
                    "lanes": lanes, "held_lanes": [lanes],
                    "plain_ms": plain_ms,
                    "call_ms": _median_ms(torch, lambda: fn(x, bits), 3),
                    "bound": _bound_ms(
                        _bls_mads(name, pb.HARD_BITS, lines_np),
                        _bls_bytes(name, bucket, len(pb.HARD_BITS)))}
                calls[(name, bucket)] = (fn, x)
        if bucket == 16:
            out, ok = pb.bls_hard_pow(arr, short)
            pout, pok = pb.bls_hard_pow_plain(arr, short)
            if not (torch.equal(out, pout) and torch.equal(ok, pok)):
                raise AssertionError("bls_hard_pow, short exponent")
    # device times: BLS_ROUNDS calls of each (kernel, bucket) a
    # torch.profiler session, two sessions; where the profiler keeps none
    # of the kernel's, `ms` is the CUDA events' time of one call (the
    # kernel and the ctypes enqueue, tens of microseconds, before it)
    for (name, bucket), (fn, x) in calls.items():
        got, tries = [], 0
        for _ in range(2):
            us, t = _bls_device_us(torch, fn, x, bits, _source_fns(name))
            got += us
            tries += t
        ms = float(np.median(got)) / 1e3 if got else None
        f = report[name]["by_bucket"][bucket]
        f.update(profiler_ms=ms, profiled_events=len(got),
                 profile_tries=tries,
                 ms=f["call_ms"] if ms is None else ms,
                 ms_source="cuda events" if ms is None
                 else "torch.profiler")
    for name in ("bls_miller_finalexp", "bls_hard_pow"):
        r = report[name]
        top = r["by_bucket"][BLS_BUCKETS[-1]]
        r.update(ms=top["ms"], ms_source=top["ms_source"],
                 call_ms=top["call_ms"],
                 plain_ms=top["plain_ms"], bound=top["bound"])
        print(f"{name}: " + "; ".join(
            f"B={b} device {v['ms']:.3f} ms ({v['ms_source']}, "
            f"{v['profiled_events']} of {2 * BLS_ROUNDS} profiled), call "
            f"{v['call_ms']:.3f} ms, "
            f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}), plain "
            f"{v['plain_ms']:.1f} ms" for b, v in r["by_bucket"].items()),
            flush=True)


def _bls_device_us(torch, fn, x, bits, fns) -> tuple:
    """The device us of BLS_ROUNDS calls of one BLS kernel under
    torch.profiler (the events named in `fns` that the session kept), and
    the sessions it took: a session that loses events runs again, up to
    PROFILE_TRIES (on the H100 a session alone after the builds kept every
    launch, one long session over every BLS call 20 of 30, and a session
    after the RLC kernels' profiles once none)."""
    from torch.profiler import ProfilerActivity, profile
    us = []
    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(BLS_ROUNDS):
                fn(x, bits)
            torch.cuda.synchronize()
            time.sleep(PROFILE_TAIL_S)
        us = [us for _t, name, us in _cuda_events(torch, prof)
              if name in fns]
        if len(us) == BLS_ROUNDS:
            break
    return us, tries


class CheckerCalls:
    """Counts the PairingChecker and FinalExpChecker calls that had
    pending work while installed: each such call of at most 62 items
    is one kernel launch (its items and the 2 canary items fit bucket
    64), so the BLS launch counts must equal these calls."""

    def __init__(self):
        from cometbft_tpu_torch.aggsig import verify as aggv
        self.classes = (aggv.PairingChecker, aggv.FinalExpChecker)
        self.orig = [c.check for c in self.classes]
        self.calls = {c.__name__: 0 for c in self.classes}
        for cls, orig in zip(self.classes, self.orig):
            def counted(chk, items, _orig=orig, _name=cls.__name__):
                if items:
                    self.calls[_name] += 1
                return _orig(chk, items)
            cls.check = counted

    def close(self) -> None:
        for cls, orig in zip(self.classes, self.orig):
            cls.check = orig


def _agg_chain(seed: int, n_blocks: int, n_validators: int, chain_id: str,
               aggregate: bool = True):
    """A BLS chain through the real executor on the card, and the
    generator's app."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.engine.chain_gen import generate_chain
    apps = []

    def app_factory():
        apps.append(KVStoreApplication())
        return apps[-1]
    t0 = time.perf_counter()
    chain = generate_chain(n_blocks=n_blocks, n_validators=n_validators,
                           txs_per_block=1, chain_id=chain_id, seed=seed,
                           key_type="bls12_381", aggregate=aggregate,
                           app_factory=app_factory, device="cuda")
    return chain, apps[0], time.perf_counter() - t0


def _admit(torch, pops: dict, device=None) -> dict:
    """register_pops_batch from an empty registry, timed and counted:
    on the card (the kernel route), or with device="cpu" (the host RLC
    route)."""
    from cometbft_tpu_torch.aggsig import aggregate as agg
    from cometbft_tpu_torch.ops import bls12 as pb
    agg.reset_pop_registry()
    torch.cuda.synchronize()
    pb.reset_launches()
    t0 = time.perf_counter()
    ok = agg.register_pops_batch(dict(pops), device=device)
    torch.cuda.synchronize()
    return {"ok": ok, "wall_s": time.perf_counter() - t0,
            "admitted": [agg.has_pop(p) for p in pops],
            "launches": dict(pb.LAUNCHES)}


def run_aggsig_genesis(torch, seed: int) -> dict:
    """Pass 1: genesis PoP admission of an AGG_SET-validator BLS set, on
    the host RLC route (`register_pops_batch(device="cpu")`), clean and,
    over the first AGG_BAD_HOST keys, with key AGG_BAD's PoP replaced by
    another key's (a failed RLC round verifies every key alone); then on
    the kernel route (the card, the default: AGG_SET + 2 canary lanes in
    chunks of 64, 3 `bls_miller_finalexp` launches, with no prewarm),
    clean and with the bad PoP, which must be rejected exactly and as
    the host route rejects it. Returns the figures and the set's chain,
    whose height-1 seal pass 2 verifies."""
    from cometbft_tpu_torch.aggsig import aggregate as agg
    from cometbft_tpu_torch.ops import bls12 as pb
    chain, _app, gen_s = _agg_chain(seed, 2, AGG_SET, "aggsig-set")
    pops = dict(chain.genesis.bls_pops)
    pubs = list(pops)
    out = {"set_chain_s": gen_s}
    bad = dict(pops)
    bad[pubs[AGG_BAD]] = pops[pubs[AGG_BAD + 1]]    # another key's PoP
    out["host_clean"] = _admit(torch, pops, device="cpu")
    out["host_bad"] = _admit(torch, {p: bad[p] for p in pubs[:AGG_BAD_HOST]},
                             device="cpu")
    out["kernel_clean"] = _admit(torch, pops)
    out["kernel_bad"] = _admit(torch, bad)
    chunks = -(-(len(pops) + 2) // pb.BUCKETS[-1])
    for k, want_ok, want_l in (("host_clean", True, 0),
                               ("host_bad", False, 0),
                               ("kernel_clean", True, chunks),
                               ("kernel_bad", False, chunks)):
        f = out[k]
        admitted = [i != AGG_BAD or want_ok
                    for i in range(len(f["admitted"]))]
        if f["ok"] != want_ok or f["admitted"] != admitted or \
                f["launches"]["bls_miller_finalexp"] != want_l:
            raise AssertionError(f"PoP admission, {k}: {f}")
    if out["host_bad"]["admitted"] != \
            out["kernel_bad"]["admitted"][:AGG_BAD_HOST]:
        raise AssertionError("the two routes disagree on the bad PoP")
    agg.register_pops_batch(pops)                # the bad key's own PoP
    return out, chain


def _flip(b: bytes, i: int) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


def run_aggsig_commits(torch, seed: int, set_chain) -> dict:
    """Pass 2: `verify_commit` of the AGG_SET-signer aggregated commit on
    the card (one `bls_miller_finalexp` launch at bucket 4), and with a
    flipped aggregate byte (AggregateVerificationError). Pass 3: a
    multi-group aggregate, `from_commit` of a plain commit of AGG_GROUPS
    validators with per-validator timestamps (AGG_GROUPS + 1 pairs: the
    host Miller product, then one `bls_hard_pow` launch), clean and with
    one lane signed over another message (it must fail)."""
    from cometbft_tpu_torch.aggsig import verify as aggv
    from cometbft_tpu_torch.ops import bls12 as pb
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.agg_commit import from_commit

    def verify(chain, h, commit):
        reset_shared_cache()
        torch.cuda.synchronize()
        pb.reset_launches()
        t0 = time.perf_counter()
        err = None
        try:
            validation.verify_commit(chain.chain_id, chain.valsets[h - 1],
                                     chain.block_ids[h - 1], h, commit)
        except validation.CommitVerificationError as e:
            err = type(e).__name__
        torch.cuda.synchronize()
        return {"wall_s": time.perf_counter() - t0, "error": err,
                "launches": dict(pb.LAUNCHES)}
    seal = set_chain.seen_commits[0]
    out = {"set_clean": verify(set_chain, 1, seal),
           "set_flipped": verify(set_chain, 1, dataclasses.replace(
               seal, agg_sig=_flip(seal.agg_sig, 1)))}
    groups, _app, gen_s = _agg_chain(seed, 1, AGG_GROUPS, "aggsig-groups",
                                     aggregate=False)
    plain = groups.seen_commits[0]
    val0 = groups.valsets[0].validators[0]
    wrong = groups.keys[val0.address].sign(b"another message, 32 bytes or more")
    tampered = dataclasses.replace(plain, signatures=[
        dataclasses.replace(cs, signature=wrong) if i == 0 else cs
        for i, cs in enumerate(plain.signatures)])
    out["groups_chain_s"] = gen_s
    out["groups_clean"] = verify(groups, 1, from_commit(plain))
    out["groups_tampered"] = verify(groups, 1, from_commit(tampered))
    for k, err, launches in (
            ("set_clean", None, {"bls_miller_finalexp": 1,
                                 "bls_hard_pow": 0}),
            ("set_flipped", "AggregateVerificationError", None),
            ("groups_clean", None, {"bls_miller_finalexp": 0,
                                    "bls_hard_pow": 1}),
            ("groups_tampered", "AggregateVerificationError",
             {"bls_miller_finalexp": 0, "bls_hard_pow": 1})):
        f = out[k]
        if f["error"] != err or (launches is not None and
                                 f["launches"] != launches):
            raise AssertionError(f"verify_commit, {k}: {f}")
    if aggv.shared_pairing().canary_failures:
        raise AssertionError("a BLS canary failed")
    return out


class KernelClock:
    """CUDA events around every call of the two BLS kernel wrappers while
    installed (ops/bls12 looks them up as module globals, so the entry
    points call the timed ones): each launch's device time (the stream
    runs nothing else between the two events, so the interval is the
    kernel and the ctypes enqueue before it). torch.profiler kept none of
    an aggregated sync's launches in one run on the H100, where it kept every
    launch of the kernel holds."""

    def __init__(self, torch):
        from cometbft_tpu_torch.ops import bls12 as pb
        self.torch, self.pb = torch, pb
        self.orig = {n: getattr(pb, n) for n in BLS_KERNELS}
        self.marks: list = []
        for name, fn in self.orig.items():
            def timed(x, bits, _fn=fn, _name=name):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(x, bits)
                end.record()
                self.marks.append((_name, x.shape[-1], start, end))
                return out
            setattr(pb, name, timed)

    def close(self) -> list:
        """Restore the wrappers -> [(kernel, bucket, device ms)]."""
        for name, fn in self.orig.items():
            setattr(self.pb, name, fn)
        self.torch.cuda.synchronize()
        return [(n, b, s.elapsed_time(e)) for n, b, s, e in self.marks]


def run_aggsig_sync(torch, chain, gen_app, seed: int, depth: int,
                    corrupt=None) -> dict:
    """One catch-up from genesis over the aggregated chain on the card
    through `BlocksyncReactor(tile_size=AGG_TILE)` at `depth`; it must
    reach the generator's state. Every PairingChecker call with pending
    work is one `bls_miller_finalexp` launch, and a pass makes at least
    one. Each launch's device time (KernelClock) gives the card's busy
    time and idle share over the sync."""
    from cometbft_tpu_torch import trace
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.db.kv import MemDB
    from cometbft_tpu_torch.engine.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.engine.chain_gen import LocalChainSource
    from cometbft_tpu_torch.ops import bls12 as pb
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.store.blockstore import BlockStore
    reset_shared_cache()
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    src = LocalChainSource(chain, dict(corrupt or {}))
    reactor = BlocksyncReactor(
        BlockExecutor(app, device="cuda"), BlockStore(MemDB()), src,
        chain.chain_id, tile_size=AGG_TILE, batch_size=64,
        pipeline_depth=depth, device="cuda")
    state0 = State.from_genesis(chain.genesis)
    _, recorder = trace.enable(seed=seed)
    counter = CheckerCalls()
    clock = KernelClock(torch)
    try:
        torch.cuda.synchronize()
        pb.reset_launches()
        t0 = time.perf_counter()
        state = reactor.sync(state0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pb.LAUNCHES)
        spans = recorder.snapshot()
    finally:
        marks = clock.close()
        counter.close()
        trace.disable()
    top = chain.max_height()
    if state.last_block_height != top or \
            state.app_hash != gen_app.last_app_hash or \
            app.state != gen_app.state:
        raise AssertionError(f"aggregated sync, depth {depth}: stopped at "
                             f"{state.last_block_height} or its app state "
                             f"differs from the generator's")
    calls = counter.calls["PairingChecker"]
    if launches["bls_miller_finalexp"] != calls or not calls or \
            launches["bls_hard_pow"] != counter.calls["FinalExpChecker"] \
            or len(marks) != sum(launches.values()):
        raise AssertionError(f"aggregated sync, depth {depth}: launches "
                             f"{launches}, checker calls {counter.calls}, "
                             f"timed {len(marks)}")
    span_s: dict = {}
    for sp in spans:
        span_s[sp["name"]] = span_s.get(sp["name"], 0.0) + \
            (sp["t1"] - sp["t0"]) / 1e9
    busy = sum(ms for _n, _b, ms in marks) / 1e3
    return {"depth": depth, "wall_s": wall, "commits_per_s": top / wall,
            "banned": list(src.banned), "launches": launches,
            "checker_calls": dict(counter.calls),
            "kernel_ms_by_bucket": [(b, ms) for _n, b, ms in marks],
            "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "marshal_s": span_s.get("aggsig.marshal", 0.0),
            "settle_s": span_s.get("aggsig.settle", 0.0),
            "span_s": span_s}


def run_aggsig(torch, seed: int) -> tuple:
    """The aggsig paths on the card (PERF.md §2-§5): genesis admission,
    verify_commit of the AGG_SET-signer and of a multi-group aggregate,
    and aggregated catch-up over an AGG_BLOCKS-block chain of
    AGG_VALIDATORS validators at depth 1 (profiled) and 2, and tampered
    at one height (a ban, then the sync completes). Each pass resets the
    signature cache; the launch counts of the passes are summed. Returns
    the figures, and the aggregated chain and its generator's app (the
    seal-sync phase reuses them)."""
    from cometbft_tpu_torch.aggsig import aggregate as agg
    out: dict = {}
    t0 = time.perf_counter()
    out["genesis"], set_chain = run_aggsig_genesis(torch, seed)
    out["genesis"]["pass_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["commits"] = run_aggsig_commits(torch, seed, set_chain)
    out["commits"]["pass_s"] = time.perf_counter() - t0
    agg.reset_pop_registry()
    chain, gen_app, gen_s = _agg_chain(seed, AGG_BLOCKS, AGG_VALIDATORS,
                                       "aggsig-chain")
    out["chain_s"] = gen_s
    syncs = {}
    t0 = time.perf_counter()
    for name, depth in (("depth1", 1), ("depth2", 2), ("depth2_repeat", 2),
                        ("depth1_repeat", 1)):
        syncs[name] = run_aggsig_sync(torch, chain, gen_app, seed, depth)
    h = AGG_BLOCKS // 2
    syncs["tampered"] = run_aggsig_sync(torch, chain, gen_app, seed, 1,
                                        corrupt={h: "sig"})
    if not syncs["tampered"]["banned"] or \
            any(f["banned"] for k, f in syncs.items() if k != "tampered"):
        raise AssertionError(f"aggregated syncs banned "
                             f"{ {k: f['banned'] for k, f in syncs.items()} }")
    out["sync"] = syncs
    out["sync_pass_s"] = time.perf_counter() - t0
    out["launches"] = {k: sum(f["launches"][k] for f in syncs.values())
                       for k in ("bls_miller_finalexp", "bls_hard_pow")}
    out["launches_commits"] = {
        k: sum(f["launches"][k] for f in out["commits"].values()
               if isinstance(f, dict) and "launches" in f)
        for k in ("bls_miller_finalexp", "bls_hard_pow")}
    return out, chain, gen_app


def print_aggsig(aggsig: dict, gpu: str) -> None:
    gs, cm, sy = aggsig["genesis"], aggsig["commits"], aggsig["sync"]
    print(f"aggsig: genesis admission of {AGG_SET} PoPs "
          f"{gs['host_clean']['wall_s']:.3f} s on the host RLC route, "
          f"{gs['kernel_clean']['wall_s']:.3f} s on the kernel route "
          f"({gs['kernel_clean']['launches']['bls_miller_finalexp']} "
          f"launches), bad PoP rejected on both; verify_commit of the "
          f"{AGG_SET}-signer aggregate {cm['set_clean']['wall_s']:.3f} s, "
          f"multi-group ({AGG_GROUPS + 1} pairs) "
          f"{cm['groups_clean']['wall_s']:.3f} s; {AGG_BLOCKS}-block chain "
          f"of {AGG_VALIDATORS} validators generated in "
          f"{aggsig['chain_s']:.1f} s, synced in "
          f"{sy['depth1']['wall_s']:.3f}, {sy['depth1_repeat']['wall_s']:.3f} "
          f"s at depth 1 ({sy['depth1']['commits_per_s']:.1f} commits/s; "
          f"marshal {sy['depth1']['marshal_s']:.3f} s, settle "
          f"{sy['depth1']['settle_s']:.3f} s; kernel (bucket, device ms) "
          f"{sy['depth1']['kernel_ms_by_bucket']}; card idle "
          f"{sy['depth1']['idle_share']:.3f}), {sy['depth2']['wall_s']:.3f}, "
          f"{sy['depth2_repeat']['wall_s']:.3f} s at depth 2; tampered: "
          f"banned {sy['tampered']['banned']}; passes "
          f"{gs['pass_s']:.1f}, {cm['pass_s']:.1f}, "
          f"{aggsig['sync_pass_s']:.1f} s; {gpu}", flush=True)


def bls_kernel_rows(report: dict, aggsig: dict, seal: dict,
                    p2p: dict) -> list:
    """The kernels line's rows of the two BLS kernels: launches from each
    kernel's own path (the aggregated catch-up for the fused kernel, the
    multi-group verify_commit for the hard chain), times and bounds at
    bucket 64, and every bucket and path beside them (seal sync's passes,
    in memory and over p2p, among them)."""
    gs, cm, sy = aggsig["genesis"], aggsig["commits"], aggsig["sync"]
    rows = []
    paths = {"bls_miller_finalexp": ("aggregated catch-up",
                                     aggsig["launches"]),
             "bls_hard_pow": ("multi-group verify_commit",
                              {k: cm["groups_clean"]["launches"][k] +
                               cm["groups_tampered"]["launches"][k]
                               for k in BLS_KERNELS})}
    for name, (src, line) in BLS_KERNELS.items():
        r = report[name]
        path, counts = paths[name]
        if not counts[name]:
            raise AssertionError(f"{name}: no launch on its path ({path})")
        rows.append({
            "name": name, "route": "cuda",
            "source": f"cometbft_tpu_torch/csrc/{src}",
            "replaces": f"cometbft_tpu/ops/bls12.py:{line}",
            "replaces_kind": "XLA program (jit), not Pallas",
            "launches": counts[name], "launches_path": path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "ms_source": r["ms_source"],
            "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "bucket": BLS_BUCKETS[-1],
            "by_bucket": r["by_bucket"],
            "launches_genesis": {
                k: gs[k]["launches"][name] for k in
                ("host_clean", "host_bad", "kernel_clean", "kernel_bad")},
            "launches_verify_commit": {
                k: cm[k]["launches"][name] for k in
                ("set_clean", "set_flipped", "groups_clean",
                 "groups_tampered")},
            "launches_catchup": {k: f["launches"][name]
                                 for k, f in sy.items()},
            "launches_sealsync": {
                k: seal[k]["launches"][name] for k in
                ("default", "max_skip_1", "forged", "backfill")},
            "launches_p2p_sealsync": {
                k: f["launches"][name] for k, f in p2p["seal"].items()}})
    return rows


# --- seal sync, the light-client farm, tx admission (slice 10) ----------------

def _span_s(spans) -> dict:
    out: dict = {}
    for sp in spans:
        out[sp["name"]] = out.get(sp["name"], 0.0) + \
            (sp["t1"] - sp["t0"]) / 1e9
    return out


def _seal_pass(torch, chain, seed: int, forge=None, source=None,
               **kw) -> tuple:
    """One `SealAdopter.adopt` from genesis over the aggregated chain on
    the card, into a fresh store and signature cache (`kw`: max_skip,
    tile_size; `forge`: the seal source's forgery at the tip until a
    ban; `source`: the seal source, default the in-memory one). Every PairingChecker call with pending work is one
    `bls_miller_finalexp` launch, timed with CUDA events (KernelClock).
    -> (figures, store, cache)."""
    from cometbft_tpu_torch import trace
    from cometbft_tpu_torch.aggsig import verify as aggv
    from cometbft_tpu_torch.db.kv import MemDB
    from cometbft_tpu_torch.engine.chain_gen import ChainSealSource
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.libs.metrics_gen import SealsyncMetrics
    from cometbft_tpu_torch.ops import bls12 as pb
    from cometbft_tpu_torch.pipeline.cache import SigCache
    from cometbft_tpu_torch.sealsync import SealAdopter
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.store.blockstore import BlockStore
    top = chain.max_height()
    src = source or ChainSealSource(chain, {top: forge} if forge else {})
    store, cache = BlockStore(MemDB()), SigCache()
    metrics = SealsyncMetrics(Registry())
    adopter = SealAdopter(chain.chain_id, store, src, cache=cache,
                          metrics=metrics, device="cuda", **kw)
    state = State.from_genesis(chain.genesis)
    canaries0 = aggv.shared_pairing().canary_failures
    _, recorder = trace.enable(seed=seed)
    counter = CheckerCalls()
    clock = KernelClock(torch)
    try:
        torch.cuda.synchronize()
        pb.reset_launches()
        t0 = time.perf_counter()
        tip = adopter.adopt(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pb.LAUNCHES)
        spans = recorder.snapshot()
    finally:
        marks = clock.close()
        counter.close()
        trace.disable()
    span_s = _span_s(spans)
    busy = sum(ms for _n, _b, ms in marks) / 1e3
    fig = {"tip": tip, "adopted_tip": store.adopted_tip(),
           "max_skip": adopter.max_skip, "tile": adopter.tile_size,
           "pivots_settled": int(metrics.pivots_verified.value()),
           "pairings_skipped": int(metrics.pairings_skipped.value()),
           "seals_adopted": int(metrics.seals_adopted.value()),
           "adoptions_rejected": int(metrics.adoptions_rejected.value()),
           "banned": list(getattr(src, "banned", [])), "wall_s": wall,
           "launches": launches, "checker_calls": dict(counter.calls),
           "kernel_ms_by_bucket": [(b, ms) for _n, b, ms in marks],
           "device_busy_s": busy, "idle_share": 1 - busy / wall,
           "settle_s": span_s.get("aggsig.settle", 0.0),
           "marshal_s": span_s.get("aggsig.marshal", 0.0),
           "canary_failures": aggv.shared_pairing().canary_failures
           - canaries0}
    fig["settle_share"] = fig["settle_s"] / wall
    if tip != top or store.adopted_tip() != top or \
            launches["bls_miller_finalexp"] != counter.calls[
                "PairingChecker"] or launches["bls_hard_pow"] or \
            len(marks) != sum(launches.values()) or fig["canary_failures"]:
        raise AssertionError(f"seal sync, {kw} {forge}: {fig}")
    return fig, store, cache


def run_sealsync(torch, chain, gen_app, seed: int) -> dict:
    """Seal sync over the aggregated chain of the aggsig phase (reused:
    host signing is ~27-40 ms a BLS signature), three passes, each into
    a fresh store and signature cache: (a) the defaults, max_skip 64 and
    tile 32 (one pivot, the tip: one launch); (b) max_skip 1, every
    height a pivot: 63 pivots in tiles of 32, each tile and its 2
    canaries in bucket 64 (two launches); (c) the deep forgery at the tip
    ("bitmap": structure and tally pass, only the pivot's pairing on the
    card rejects it): the tip banned, one rejection, the retry adopts
    (two launches). Then the bodies backfill: `BlocksyncReactor.sync` of
    the chain into pass (a)'s store with its signature cache, where every
    seal, checked one height at a time first, is an "ok" cache hit: no
    BLS launch, the generator's app state, every adopted record
    superseded by its body."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.aggsig.verify import prepare_full_commit
    from cometbft_tpu_torch.engine.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.engine.chain_gen import LocalChainSource
    from cometbft_tpu_torch.ops import bls12 as pb
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State
    top = chain.max_height()
    out: dict = {"blocks": top, "validators": len(chain.valsets[0])}
    out["default"], store, cache = _seal_pass(torch, chain, seed)
    out["max_skip_1"], _, _ = _seal_pass(torch, chain, seed, max_skip=1)
    out["forged"], _, _ = _seal_pass(torch, chain, seed, forge="bitmap")
    tiles = -(-top // out["max_skip_1"]["tile"])
    for name, pivots, launches, banned in (
            ("default", 1, 1, []), ("max_skip_1", top, tiles, []),
            ("forged", 2, 2, [top])):
        f = out[name]
        if f["pivots_settled"] != pivots or f["banned"] != banned or \
                f["launches"]["bls_miller_finalexp"] != launches or \
                f["adoptions_rejected"] != len(banned):
            raise AssertionError(f"seal sync, pass {name}: {f}")
    ok = [prepare_full_commit(chain.chain_id, chain.valsets[h - 1],
                              chain.seen_commits[h - 1],
                              chain.valsets[h - 1].total_voting_power()
                              * 2 // 3, cache=cache).status
          for h in range(1, top + 1)]
    if ok != ["ok"] * top:
        raise AssertionError(f"adopted seals that would pair again: "
                             f"{[h + 1 for h, v in enumerate(ok) if v != 'ok']}")
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    reactor = BlocksyncReactor(
        BlockExecutor(app, device="cuda"), store, LocalChainSource(chain),
        chain.chain_id, tile_size=AGG_TILE, batch_size=64, cache=cache,
        device="cuda")
    torch.cuda.synchronize()
    pb.reset_launches()
    t0 = time.perf_counter()
    state = reactor.sync(State.from_genesis(chain.genesis))
    torch.cuda.synchronize()
    out["backfill"] = {"wall_s": time.perf_counter() - t0,
                       "launches": dict(pb.LAUNCHES),
                       "height": state.last_block_height,
                       "store_height": store.height(),
                       "adopted_records_left": len(
                           store.adopted_seal_heights())}
    if state.last_block_height != top or \
            state.app_hash != gen_app.last_app_hash or \
            app.state != gen_app.state or any(pb.LAUNCHES.values()) or \
            store.height() != top or store.adopted_seal_heights():
        raise AssertionError(f"seal-sync backfill: {out['backfill']}")
    return out


def print_sealsync(seal: dict, gpu: str) -> None:
    parts = []
    for name in ("default", "max_skip_1", "forged"):
        f = seal[name]
        parts.append(
            f"{name} (max_skip {f['max_skip']}, tile {f['tile']}): tip "
            f"{f['tip']}, {f['pivots_settled']} pivots settled, "
            f"{f['launches']['bls_miller_finalexp']} bls_miller_finalexp "
            f"launches, {f['pairings_skipped']} pairings skipped, banned "
            f"{f['banned']}, {f['wall_s']:.3f} s (aggsig.settle "
            f"{f['settle_share']:.3f} of it; card idle "
            f"{f['idle_share']:.4f})")
    b = seal["backfill"]
    print(f"seal sync over {seal['blocks']} blocks of {seal['validators']} "
          f"BLS validators: " + "; ".join(parts) + f"; body backfill "
          f"{b['wall_s']:.3f} s to height {b['height']}, BLS launches "
          f"{b['launches']}; {gpu}", flush=True)


def _farm(chain, provider=None):
    from cometbft_tpu_torch.engine.chain_gen import ChainLightProvider
    from cometbft_tpu_torch.farm import VerificationFarm
    from cometbft_tpu_torch.pipeline.cache import SigCache
    from cometbft_tpu_torch.types.proto import Timestamp
    now = Timestamp(1_700_000_000 + chain.max_height() + 5, 0)
    return VerificationFarm(chain.chain_id,
                            provider or ChainLightProvider(chain),
                            cache=SigCache(), now_fn=lambda: now,
                            device="cuda")


def _farm_waves(farm, sessions, heights) -> list:
    """Every session below each height verifies it: one begin_verify a
    session, one flush, one finish_verify a session -> lanes a flush."""
    widths = []
    for h in heights:
        pend = [farm.begin_verify(s.session_id, h) for s in sessions
                if s.latest().height < h]
        widths.append(farm.batcher.flush())
        for p in pend:
            farm.finish_verify(p)
    return widths


def run_farm(torch, pkg, chain, light: dict, per_call: dict) -> dict:
    """The light-client verification farm over the chain on the card:
    FARM_SESSIONS sessions subscribe at trusted heights 1..FARM_ROOTS
    (FARM_SESSIONS / FARM_ROOTS apiece) in one wave (8 root commits x 134
    lanes, past 2/3 of 200: one flush of ~1,070 unique lanes, the kernel
    route at batch 2048); then, one height a wave, every session below a
    height verifies it, one flush a wave, up to the tip (the root
    commits' lanes are cache hits; each later wave is one new commit's
    134 lanes, deduplicated across sessions: the kernel route at 256).
    Every session must end trusted at the tip with the heights the
    sequential light client trusted, through the kernels only
    (lanes_by_backend, `fallbacks` 0, the RLC launches one set per
    flush and canary run). A second farm whose provider serves a copy of
    the chain with a flipped signature byte in commit FARM_FORGED
    rejects a session's verify of that height and trusts nothing past
    FARM_FORGED - 1. Then FARM_PROFILED waves of a third farm (all
    sessions at one root) under torch.profiler: the card's idle share."""
    from cometbft_tpu_torch.engine.chain_gen import ChainLightProvider
    from cometbft_tpu_torch.farm import VerifyRejected
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    top = chain.max_height()
    reset_shared_cache()
    farm = _farm(chain)
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    roots = [1 + i % FARM_ROOTS for i in range(FARM_SESSIONS)]
    pend = [farm.begin_subscribe(r, chain.blocks[r - 1].hash(), 10**9)
            for r in roots]
    widths = [farm.batcher.flush()]
    sessions = [farm.finish_subscribe(p) for p in pend]
    widths += _farm_waves(farm, sessions, range(2, top + 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = farm.status()
    accepted = st["headers_accepted"]
    seq = light["sequential_trusted"]
    wrong = [s.session_id for s, r in zip(sessions, roots)
             if s.latest().height != top
             or s.latest().header.hash() != chain.blocks[-1].hash()
             or [h for h in range(1, top + 1) if s.store.light_block(h)]
             != [h for h in seq if h >= r]]
    lanes = st["lanes_by_backend"]
    flushed = [w for w in widths if w]
    out = {"sessions": FARM_SESSIONS, "roots": FARM_ROOTS,
           "wall_s": wall, "headers_accepted": accepted,
           "headers_per_s": accepted / wall, "flushes": st["batches"],
           "widths": widths, "median_width": float(np.median(flushed)),
           "max_width": st["max_batch_width"],
           "dedup_batch_hits": st["dedup_batch_hits"],
           "cache_hit_rate": st["cache_hit_rate"],
           "lanes_by_backend": lanes, "fallbacks": st["fallbacks"],
           **count.read("farm", want_flushes=sum(
               1 for w in flushed if w >= 128)),
           "wrong_sessions": wrong}
    if wrong or not set(lanes) <= {"kernel", "cpu"} or \
            lanes.get("kernel", 0) <= lanes.get("cpu", 0) or \
            st["fallbacks"] or accepted != sum(top - r for r in roots):
        raise AssertionError(f"farm: {out}")

    forged = dataclasses.replace(chain, seen_commits=list(chain.seen_commits))
    c = forged.seen_commits[FARM_FORGED - 1]
    sigs = list(c.signatures)
    s = sigs[0].signature
    sigs[0] = dataclasses.replace(sigs[0], signature=s[:40]
                                  + bytes([s[40] ^ 1]) + s[41:])
    forged.seen_commits[FARM_FORGED - 1] = dataclasses.replace(
        c, signatures=sigs)
    bad = _farm(chain, ChainLightProvider(forged))
    count = FlushCount(torch, pkg, per_call)
    sess = bad.subscribe(FARM_FORGED - 1,
                         chain.blocks[FARM_FORGED - 2].hash(), 10**9)
    try:
        bad.verify(sess.session_id, FARM_FORGED)
        raise AssertionError("the farm accepted a forged signature")
    except VerifyRejected as e:
        out["forged"] = {
            "error": str(e)[:120], "held_at": sess.latest().height,
            "trusted_past": [h for h in range(FARM_FORGED, top + 1)
                             if sess.store.light_block(h)],
            **count.read("farm, forged", want_flushes=2)}
    if out["forged"]["held_at"] != FARM_FORGED - 1 or \
            out["forged"]["trusted_past"] or \
            out["forged"]["per_lane"] != 1:
        raise AssertionError(f"forged farm: {out['forged']}")

    prof = _farm(chain)
    root = top - FARM_PROFILED
    psess = [prof.subscribe(root, chain.blocks[root - 1].hash(), 10**9)
             for _ in range(FARM_SESSIONS)]
    launches, busy_us, pwall = _device_kernels(
        torch, lambda: _farm_waves(prof, psess, range(root + 1, top + 1)))
    out["profiled"] = {"waves": FARM_PROFILED, "kernel_launches": launches,
                       "device_busy_s": busy_us / 1e6, "wall_s": pwall,
                       "idle_share": 1 - busy_us / 1e6 / pwall}
    return out


def print_farm(farm: dict, gpu: str) -> None:
    print(f"light-client farm: {farm['sessions']} sessions at "
          f"{farm['roots']} roots over {VALIDATORS} validators, "
          f"{farm['headers_accepted']} headers in {farm['wall_s']:.3f} s "
          f"({farm['headers_per_s']:.1f} headers/s); {farm['flushes']} "
          f"flushes, lanes a wave {farm['widths']}, median "
          f"{farm['median_width']:.0f}, largest {farm['max_width']}; dedup "
          f"hits {farm['dedup_batch_hits']}; lanes {farm['lanes_by_backend']}"
          f"; fallbacks {farm['fallbacks']}; forged commit "
          f"{FARM_FORGED}: held at {farm['forged']['held_at']}; card idle "
          f"{farm['profiled']['idle_share']:.3f} over {FARM_PROFILED} "
          f"profiled waves; RLC launches {farm['launches']}; {gpu}",
          flush=True)


def _ingest_keys(seed: int):
    import random
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    rng = random.Random(seed)
    return [Ed25519PrivKey(bytes(rng.randrange(256) for _ in range(32)))
            for _ in range(INGEST_KEYS)]


def _ingest_app():
    """The app's CheckTx: code 0 for a payload with "=", 1 without, 2
    for a key under the banned prefix."""
    from cometbft_tpu_torch.ingest import unwrap_payload

    def check_fn(tx):
        payload = unwrap_payload(tx)
        if b"=" not in payload:
            return 1, 0
        if payload.startswith(INGEST_BANNED):
            return 2, 0
        return 0, 1
    return check_fn


def ingest_mix(seed: int) -> tuple:
    """The burst, signed before any timer: INGEST_MIX's kinds from
    INGEST_KEYS keys, shuffled from `seed` -> ([(kind, tx)], the extra
    valid envelopes of the shed case, signing seconds)."""
    import random
    from cometbft_tpu_torch.ingest import make_signed_tx
    from cometbft_tpu_torch.ingest.tx import MAGIC
    keys = _ingest_keys(seed)
    rng = random.Random(seed + 1)
    t0 = time.perf_counter()
    valid = [make_signed_tx(keys[i % len(keys)], b"tx%d=v%d" % (i, seed))
             for i in range(INGEST_MIX["valid"])]
    txs = [("valid", tx) for tx in valid]
    for i in range(INGEST_MIX["tampered"]):
        tx = bytearray(make_signed_tx(keys[i % len(keys)],
                                      b"bad%d=v" % i))
        tx[len(MAGIC) + 32 + 40] ^= 1          # a byte of s
        txs.append(("tampered", bytes(tx)))
    txs += [("app_invalid", make_signed_tx(keys[i % len(keys)],
                                           INGEST_BANNED + b"%d=v" % i))
            for i in range(INGEST_MIX["app_invalid"])]
    txs += [("malformed", MAGIC + bytes([i]) * 10)
            for i in range(INGEST_MIX["malformed"])]
    rng.shuffle(txs)
    dups = [("duplicate", tx) for tx in rng.sample(valid,
                                                   INGEST_MIX["duplicate"])]
    for d in dups:                # each after its original
        at = next(i for i, (_k, t) in enumerate(txs) if t == d[1])
        txs.insert(rng.randrange(at + 1, len(txs) + 1), d)
    extra = [make_signed_tx(keys[i % len(keys)], b"more%d=v" % i)
             for i in range(INGEST_SHED_EXTRA)]
    return txs, extra, time.perf_counter() - t0


class PrepareClock:
    """Wall time of every `ops.ed25519.prepare_batch` call (the host
    marshal of a flush) while installed."""

    def __init__(self, ped):
        self.ped, self.orig, self.s = ped, ped.prepare_batch, []

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **kw)
            finally:
                self.s.append(time.perf_counter() - t0)
        ped.prepare_batch = timed

    def close(self) -> list:
        self.ped.prepare_batch = self.orig
        return self.s


def _pipeline():
    from cometbft_tpu_torch.ingest import IngestPipeline
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.pipeline.cache import SigCache
    mp = CListMempool(_ingest_app(), size=INGEST_MEMPOOL)
    return IngestPipeline(mp, cache=SigCache(), batch=True,
                          coalesce_window_s=0.0, device="cuda"), mp


def run_ingest(torch, pkg, seed: int, per_call: dict) -> dict:
    """A burst of signed txs at the mempool's front door on the card:
    `IngestPipeline(CListMempool(size=INGEST_MEMPOOL), batch=True,
    coalesce_window_s=0, device="cuda")`, the whole mix submitted, then
    one flush: every ticket's code as the mix made it (valid admitted,
    tampered CODE_BAD_SIGNATURE, app-invalid the app's 2; duplicates
    and malformed envelopes refused at submit, before any lane or app
    call), the mempool's FIFO the valid txs in submission order, and
    the flush one "kernel" batch of the 8,064 unique lanes. Then the
    shed: a fresh pipeline, mempool and cache; the distinct valid
    envelopes (the mix's and INGEST_SHED_EXTRA more) until IngestShed,
    which must come at the 8,193rd and not before; a flush (profiled:
    the card's idle share), and the retry admitted."""
    from cometbft_tpu_torch.ingest import CODE_BAD_SIGNATURE, IngestShed
    from cometbft_tpu_torch.mempool import tx_key
    txs, extra, sign_s = ingest_mix(seed)
    want = {"valid": ("code", 0), "tampered": ("code", CODE_BAD_SIGNATURE),
            "app_invalid": ("code", 2), "duplicate": ("raised", "ValueError"),
            "malformed": ("raised", "MalformedTx")}
    pipe, mp = _pipeline()
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    tickets = []
    for _kind, tx in txs:
        try:
            tickets.append(pipe.submit(tx))
        except ValueError as e:
            tickets.append(type(e).__name__)
    submit_s = time.perf_counter() - t0
    clock = PrepareClock(pkg["ped"])
    try:
        t0 = time.perf_counter()
        width = pipe.flush()
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
    finally:
        prep = clock.close()
    got = [("raised", t) if isinstance(t, str) else
           ("code", t.code) if t.error is None else
           ("error", type(t.error).__name__) for t in tickets]
    wrong = [i for i, ((kind, _), g) in enumerate(zip(txs, got))
             if g != want[kind]]
    fifo = [tx_key(tx) for kind, tx in txs if kind == "valid"]
    st = pipe.stats()
    out = {"txs": len(txs), "mix": dict(INGEST_MIX),
           "mempool_size": INGEST_MEMPOOL, "sign_s": sign_s,
           "submit_s": submit_s, "flush_s": flush_s, "lanes": width,
           "lanes_per_s": width / flush_s, "prepare_batch_ms":
           [x * 1e3 for x in prep], "wrong_codes": wrong[:10],
           "fifo_ok": [tx_key(t) for t in mp.reap_max_txs(-1)] == fifo,
           "lanes_by_backend": st["lanes_by_backend"],
           "batches": st["batches"], "fallbacks": st["fallbacks"],
           **count.read("ingest burst", want_flushes=1)}
    lanes = INGEST_MIX["valid"] + INGEST_MIX["tampered"] + \
        INGEST_MIX["app_invalid"]
    if wrong or not out["fifo_ok"] or width != lanes or \
            st["lanes_by_backend"] != {"kernel": lanes} or \
            st["batches"] != 1 or st["fallbacks"] or out["per_lane"] != 1:
        raise AssertionError(f"ingest burst: {out}")

    pipe, mp = _pipeline()
    valid = [tx for kind, tx in txs if kind == "valid"] + extra
    shed_at = None
    for i, tx in enumerate(valid):
        try:
            pipe.submit(tx)
        except IngestShed:
            shed_at = i + 1
            break
    count = FlushCount(torch, pkg, per_call)
    launches, busy_us, pwall = _device_kernels(torch, pipe.flush)
    out["shed"] = {"max_pending": pipe.max_pending, "shed_at": shed_at,
                   "flush_s": pwall, "kernel_launches": launches,
                   "device_busy_s": busy_us / 1e6,
                   "idle_share": 1 - busy_us / 1e6 / pwall,
                   **count.read("ingest shed flush", want_flushes=1)}
    retry = pipe.submit(valid[shed_at - 1])
    pipe.flush()
    out["shed"]["retry_code"] = retry.code
    out["shed"]["admitted"] = mp.size()
    if shed_at != pipe.max_pending + 1 or retry.code != 0 or \
            mp.size() != shed_at or pipe.stats()["fallbacks"]:
        raise AssertionError(f"ingest shed: {out['shed']}")
    return out


def print_ingest(ing: dict, gpu: str) -> None:
    sh = ing["shed"]
    print(f"tx admission burst: {ing['txs']} txs {ing['mix']} into a "
          f"mempool of {ing['mempool_size']}, signed in {ing['sign_s']:.1f}"
          f" s, submitted in {ing['submit_s']:.3f} s; one flush of "
          f"{ing['lanes']} lanes ({ing['lanes_by_backend']}) in "
          f"{ing['flush_s']:.3f} s ({ing['lanes_per_s']:.1f} lanes/s; "
          f"prepare_batch {', '.join(f'{x:.1f}' for x in ing['prepare_batch_ms'])}"
          f" ms; attributed per lane); every code as made, FIFO kept; shed "
          f"at {sh['shed_at']} of max_pending {sh['max_pending']}, its "
          f"flush {sh['flush_s']:.3f} s profiled (card idle "
          f"{sh['idle_share']:.3f}), retry code {sh['retry_code']}; RLC "
          f"launches {ing['launches']}; {gpu}", flush=True)


# --- catch-up over p2p into FileDB stores (slice 11) --------------------------

P2P_RESTART_AT = 60   # the restart phase stops there, then resumes
P2P_LOOKAHEAD = 32    # node.py:635-636 PooledSource(lookahead, n_workers)
P2P_WORKERS = 4
P2P_PEER_START_S = 300  # the serving peer must print its ports by then


def _write_store(chain, d: str) -> float:
    """The chain's blocks and seen commits into FileDB block store under
    d, through BlockStore.save_block -> seconds."""
    from cometbft_tpu_torch.db.kv import open_db
    from cometbft_tpu_torch.store.blockstore import BlockStore
    db = open_db("filedb", "blockstore", d)
    t0 = time.perf_counter()
    store = BlockStore(db)
    for block, commit in zip(chain.blocks, chain.seen_commits):
        store.save_block(block, block.make_part_set(), commit)
    dt = time.perf_counter() - t0
    db.close()
    return dt


def _native_open(chain, d: str) -> dict:
    """NativeDB (csrc/host/kvlog.cc) opens the FileDB block store under d
    (a v2 log) and sees what FileDB sees: the height and the tip."""
    from cometbft_tpu_torch.db.kv import FileDB
    from cometbft_tpu_torch.db.native import NativeDB
    from cometbft_tpu_torch.store.blockstore import BlockStore
    path = os.path.join(d, "blockstore.db")
    t0 = time.perf_counter()
    native = NativeDB(path)
    open_s = time.perf_counter() - t0
    try:
        store = BlockStore(native)
        top = chain.max_height()
        if store.height() != top or \
                store.load_block(top).hash() != chain.blocks[-1].hash():
            raise AssertionError("NativeDB reads another block store than "
                                 "FileDB wrote")
        keys = len(native)
    finally:
        native.close()
    db = FileDB(path)
    try:
        if len(list(db.iterate())) != keys:
            raise AssertionError("NativeDB and FileDB see other key sets")
    finally:
        db.close()
    return {"open_s": open_s, "keys": keys,
            "bytes": os.path.getsize(path)}


def serve_peer(d: str) -> int:
    """`--serve-peer DIR`: the serving peer of the p2p phase, run in its
    own process on the CPU (its caller hides the card). Each FileDB block
    store under DIR (pipe/, agg/) is served on its own Switch (chain id =
    network) through BlocksyncNetReactor, the aggregated one with a
    SealProvider; prints one JSON line of {name: port}, serves until its
    standard input closes, then prints one JSON line of its AEAD seconds
    and frames and each Switch's P2PMetrics bytes."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.db.kv import open_db
    from cometbft_tpu_torch.engine.reactor import BlocksyncNetReactor
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.libs.metrics_gen import P2PMetrics
    from cometbft_tpu_torch.p2p import conn
    from cometbft_tpu_torch.p2p.switch import Switch
    from cometbft_tpu_torch.sealsync import SealProvider
    from cometbft_tpu_torch.store.blockstore import BlockStore
    with open(os.path.join(d, "chains.json")) as f:
        chains = json.load(f)
    switches, dbs, ports = [], [], {}
    try:
        for name, chain_id in chains.items():
            db = open_db("filedb", "blockstore", os.path.join(d, name))
            dbs.append(db)
            store = BlockStore(db)
            sw = Switch(Ed25519PrivKey.generate(), chain_id, "peer-" + name)
            sw.metrics = P2PMetrics(Registry())
            sw.add_reactor(BlocksyncNetReactor(
                store, seal_provider=SealProvider(store)
                if name == "agg" else None))
            switches.append(sw)
            ports[name] = sw.listen()[1]
        print(json.dumps({"ports": ports}), flush=True)
        sys.stdin.read()
        print(json.dumps({"aead": conn.AEAD_STATS, "bytes": {
            name: {"sent": sw.metrics.message_send_bytes_total.value(
                       ch_id="0x40"),
                   "received": sw.metrics.message_receive_bytes_total.value(
                       ch_id="0x40")}
            for name, sw in zip(chains, switches)}}), flush=True)
    finally:
        for sw in switches:
            sw.stop()
        for db in dbs:
            db.close()
    return 0


class ServingPeer:
    """The child process of `serve_peer`, on the CPU: CUDA_VISIBLE_DEVICES
    is empty, so it never initialises CUDA and its encoding and AEAD work
    does not take this process's interpreter lock. Its stderr goes to a
    file; `check` raises (with it) if the child has died."""

    def __init__(self, d: str, chains: dict):
        import selectors
        with open(os.path.join(d, "chains.json"), "w") as f:
            json.dump(chains, f)
        self.err_path = os.path.join(d, "peer.stderr")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        t0 = time.perf_counter()
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--serve-peer",
                 d], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=err, text=True, env=env)
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        ready = sel.select(timeout=P2P_PEER_START_S)
        sel.close()
        line = self.proc.stdout.readline() if ready else ""
        if not line:
            self.stop()
            raise RuntimeError(f"the serving peer did not start: "
                               f"{self._stderr()}")
        self.ports = json.loads(line)["ports"]
        self.start_s = time.perf_counter() - t0

    def _stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-4000:]

    def check(self) -> None:
        if self.proc.poll() is not None:
            raise RuntimeError(f"the serving peer exited "
                               f"({self.proc.returncode}): {self._stderr()}")

    def stop(self) -> dict:
        """Close its input (it prints its figures and exits), kill it if
        it has not exited within 30 s -> its figures, or {}."""
        import selectors
        figures = {}
        if self.proc.poll() is None:
            self.proc.stdin.close()
            sel = selectors.DefaultSelector()
            sel.register(self.proc.stdout, selectors.EVENT_READ)
            if sel.select(timeout=30):
                line = self.proc.stdout.readline()
                figures = json.loads(line) if line else {}
            sel.close()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        for f in (self.proc.stdin, self.proc.stdout):
            f.close()
        return figures


class P2PNode:
    """The syncing node of the p2p phase, as node.py:591-701 wires its
    catch-up: FileDB stores for BlockStore and StateStore under d, the
    kept kvstore `app`, an executor on the card, and a Switch (with
    P2PMetrics) carrying BlocksyncNetReactor, dialled to the peer
    (`handshake_ms`: TCP connect, SecretConnection handshake and the
    NodeInfo exchange)."""

    def __init__(self, chain, d: str, port: int, app=None):
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
        from cometbft_tpu_torch.db.kv import open_db
        from cometbft_tpu_torch.engine.reactor import BlocksyncNetReactor
        from cometbft_tpu_torch.libs.metrics import Registry
        from cometbft_tpu_torch.libs.metrics_gen import P2PMetrics
        from cometbft_tpu_torch.p2p.switch import Switch
        from cometbft_tpu_torch.state.execution import BlockExecutor
        from cometbft_tpu_torch.state.state import StateStore
        from cometbft_tpu_torch.store.blockstore import BlockStore
        self.dir = d
        t0 = time.perf_counter()
        self.bdb = open_db("filedb", "blockstore", d)
        self.sdb = open_db("filedb", "state", d)
        self.open_s = time.perf_counter() - t0
        self.store, self.state_store = BlockStore(self.bdb), \
            StateStore(self.sdb)
        if app is None:
            app = KVStoreApplication()
            app.init_chain(chain.chain_id, 1, [], b"")
        self.app = app
        self.executor = BlockExecutor(app, state_store=self.state_store,
                                      block_store=self.store, device="cuda")
        self.switch = Switch(Ed25519PrivKey.generate(), chain.chain_id,
                             "syncer")
        self.switch.metrics = P2PMetrics(Registry())
        self.net = BlocksyncNetReactor(self.store)
        self.switch.add_reactor(self.net)
        self.switch.listen()
        t0 = time.perf_counter()
        self.switch.dial("127.0.0.1", port)
        self.handshake_ms = (time.perf_counter() - t0) * 1e3
        deadline = time.monotonic() + 30
        while not self.net._peer_status:
            if time.monotonic() > deadline:
                raise AssertionError("the peer answered no status request")
            time.sleep(0.01)

    def traffic(self) -> dict:
        m = self.switch.metrics
        return {"received_bytes": m.message_receive_bytes_total.value(
                    ch_id="0x40"),
                "sent_bytes": m.message_send_bytes_total.value(ch_id="0x40")}

    def close(self) -> None:
        if self.switch is not None:
            self.switch.stop()
            self.bdb.close()
            self.sdb.close()
            self.switch = None


def _p2p_sync(torch, pkg, node: P2PNode, chain, state, depth: int, seed,
              target=None, profile=False) -> tuple:
    """One catch-up of `node` from `state` over p2p, through
    `PooledSource(NetSource(reactor, switch))` and `BlocksyncReactor`
    (tile 40, batch 8192, a fresh SigCache, the watchdog and the
    supervisor with canaries, as the pipelined phase runs it) on the
    card. -> (state, figures): wall, sigs/s, span seconds (fetch is the
    wait on the pool), AEAD seconds and frames, Block.decode seconds,
    the peer's bytes, and the RLC launches (zeroed just before, read
    just after). `profile` runs it under torch.profiler (idle share)."""
    from cometbft_tpu_torch import trace
    from cometbft_tpu_torch.device.health import DeviceSupervisor
    from cometbft_tpu_torch.engine.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.engine.pool import PooledSource
    from cometbft_tpu_torch.engine.reactor import NetSource
    from cometbft_tpu_torch.p2p import conn
    from cometbft_tpu_torch.pipeline.cache import (SigCache,
                                                   reset_shared_cache)
    from cometbft_tpu_torch.pipeline.watchdog import DeviceWatchdog
    ped, cv = pkg["ped"], pkg["cv"]
    reset_shared_cache()
    # the kernels warm before the pool starts fetching (a no-op once an
    # earlier phase warmed them), so no sync fetches ahead of its wall
    ped.prewarm_verify_kernels(LANES, device="cuda")
    supervisor = DeviceSupervisor(canary=True)
    watchdog = DeviceWatchdog(supervisor=supervisor)
    stats0 = dict(ped.STATS)
    aead0 = dict(conn.AEAD_STATS)
    dec0 = (node.net.decode_s, node.net.blocks_decoded)
    bytes0 = node.traffic()
    h0 = state.last_block_height
    out: dict = {}

    def sync():
        # the pool starts fetching as it is made: inside the wall
        out["pooled"] = PooledSource(
            NetSource(node.net, node.switch), h0 + 1,
            lookahead=P2P_LOOKAHEAD, n_workers=P2P_WORKERS)
        out["reactor"] = BlocksyncReactor(
            node.executor, node.store, out["pooled"], chain.chain_id,
            tile_size=TILE, batch_size=LANES, cache=SigCache(),
            pipeline_depth=depth, watchdog=watchdog, supervisor=supervisor,
            device="cuda")
        out["state"] = out["reactor"].sync(state, target)

    _, recorder = trace.enable(seed=seed)
    try:
        torch.cuda.synchronize()
        cv.reset_launches()
        if profile:
            names: dict = {}
            launches, busy_us, wall = _device_kernels(torch, sync, names)
            out["profiled"] = {"kernel_launches": launches,
                               "device_busy_s": busy_us / 1e6,
                               "idle_share": 1 - busy_us / 1e6 / wall,
                               "launches_by_kernel": {
                                   k: sum(names.get(f, 0)
                                          for f in _source_fns(k))
                                   for k in KERNELS}}
        else:
            t0 = time.perf_counter()
            sync()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counted = dict(cv.LAUNCHES)
        spans = recorder.snapshot()
    finally:
        trace.disable()
        if "pooled" in out:
            out["pooled"].stop()
    state, reactor = out["state"], out["reactor"]
    if profile and any(out["profiled"]["launches_by_kernel"][k]
                       != counted.get(k, 0) for k in KERNELS):
        # the profile lost device events: its busy time undercounts
        out["profiled"]["device_busy_s"] = None
        out["profiled"]["idle_share"] = None
    st = reactor.stats
    bytes1 = node.traffic()
    fig = {"depth": depth, "from": h0, "to": state.last_block_height,
           "wall_s": wall, "sigs_verified": st.sigs_verified,
           "sigs_per_s": st.sigs_verified / wall,
           "tiles_flushed": st.tiles_flushed,
           "respeculations": st.respeculations, "banned": [],
           "rlc_pass": ped.STATS["rlc_pass"] - stats0["rlc_pass"],
           "per_lane": ped.STATS["per_lane"] - stats0["per_lane"],
           "launches": counted, "span_s": _span_s(spans),
           "aead": {k: conn.AEAD_STATS[k] - aead0[k] for k in aead0},
           "decode_s": node.net.decode_s - dec0[0],
           "blocks_decoded": node.net.blocks_decoded - dec0[1],
           "peer_sent_bytes": bytes1["received_bytes"]
           - bytes0["received_bytes"],
           "peer_received_bytes": bytes1["sent_bytes"] - bytes0["sent_bytes"],
           **({"profiled": out["profiled"]} if profile else {})}
    fig["fetch_wait_s"] = fig["span_s"].get(
        "blocksync.fetch", 0.0) + fig["span_s"].get("pipeline.fetch", 0.0)
    fig["guards"] = {
        "watchdog_trips": watchdog.trips,
        "watchdog_fallbacks": watchdog.fallbacks,
        "supervisor": supervisor.state_name(),
        "canary_failures": supervisor.canary_failures,
        "quarantines": supervisor.quarantines,
        "cpu_drains": sum(1 for sp in spans
                          if sp["name"] == "pipeline.cpu_drain")}
    g = fig["guards"]
    if (g["watchdog_trips"] or g["watchdog_fallbacks"]
            or g["supervisor"] != "healthy" or g["canary_failures"]
            or g["quarantines"] or g["cpu_drains"] or fig["per_lane"]):
        raise AssertionError(f"p2p sync, depth {depth}: a drain, trip, "
                             f"canary failure or attributed flush: {fig}")
    want = target or chain.max_height()
    if state.last_block_height != want or node.store.height() != want or \
            st.blocks_applied != want - h0:
        raise AssertionError(f"p2p sync stopped at "
                             f"{state.last_block_height}: {fig}")
    _read_path(counted, f"p2p sync, depth {depth}, {h0} -> {want}",
               ("pt_decompress_tiled", "rlc_window_sums", "rlc_epilogue"))
    return state, fig


def _check_final(state, node, chain, gen_app) -> None:
    if state.app_hash != gen_app.last_app_hash or \
            node.app.state != gen_app.state or \
            state.last_block_id != chain.block_ids[-1] or \
            node.store.load_block(chain.max_height()).hash() != \
            chain.blocks[-1].hash():
        raise AssertionError("the p2p sync did not reach the generator's "
                             "app state and chain")


def run_p2p(torch, pkg, chain, gen_app, agg_chain, seed: int) -> dict:
    """The node's catch-up path over p2p into FileDB stores
    (node.py:591-701 without statesync, consensus and the handshake
    replay): the 121-block chain and the aggsig phase's 63-block
    aggregated chain are written into FileDB block stores through
    `BlockStore.save_block`, served by a child process (`serve_peer`) on
    loopback TCP, each on its own Switch; this process syncs the 121
    blocks at depth 1 and 2 (and once more at depth 1 under
    torch.profiler) into fresh FileDB stores, each to the generator's
    app hash; then the restart: to height 60 at depth 1, stop, close,
    reopen (FileDB replays its logs), the recovery doctor (no repair),
    the state from the StateStore at the kept app's height, and a resume
    over a new connection with a fresh SigCache to 121; then
    `SealAdopter` over `NetSealSource` against the aggregated chain at
    the defaults (one pivot) and at max_skip 1 (63 pivots)."""
    import shutil
    import tempfile
    from cometbft_tpu_torch.engine.reactor import NetSealSource
    from cometbft_tpu_torch.p2p import conn
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.store.recovery import run_doctor
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_p2p_", dir=str(build))
    out: dict = {"blocks": chain.max_height(), "agg_blocks":
                 agg_chain.max_height(), "lookahead": P2P_LOOKAHEAD,
                 "workers": P2P_WORKERS, "tile": TILE, "batch": LANES}
    peer = None
    nodes: list = []

    def node(name, port, app=None):
        nodes.append(P2PNode(chain if name != "seal" else agg_chain,
                             os.path.join(d, name), port, app))
        return nodes[-1]

    try:
        out["store_write_s"] = {
            "pipe": _write_store(chain, os.path.join(d, "pipe")),
            "agg": _write_store(agg_chain, os.path.join(d, "agg"))}
        out["native_open"] = _native_open(chain,
                                          os.path.join(d, "pipe"))
        peer = ServingPeer(d, {"pipe": chain.chain_id,
                               "agg": agg_chain.chain_id})
        out["peer_start_s"] = peer.start_s
        genesis = State.from_genesis(chain.genesis)
        syncs: dict = {}
        for name, depth, profile in (("depth_1", 1, False),
                                     ("depth_2", 2, False),
                                     ("profiled", 1, True)):
            n = node(name, peer.ports["pipe"])
            state, fig = _p2p_sync(torch, pkg, n, chain, genesis, depth,
                                   seed, profile=profile)
            _check_final(state, n, chain, gen_app)
            fig["handshake_ms"] = n.handshake_ms
            fig["store_height"] = n.store.height()
            syncs[name] = fig
            n.close()
            peer.check()
        out["syncs"] = syncs
        # the restart
        n = node("restart", peer.ports["pipe"])
        state, first = _p2p_sync(torch, pkg, n, chain, genesis, 1, seed,
                                 target=P2P_RESTART_AT)
        app = n.app
        n.close()
        t0 = time.perf_counter()
        n = node("restart", peer.ports["pipe"], app=app)
        reopen_s = time.perf_counter() - t0
        report = run_doctor(block_store=n.store, state_store=n.state_store,
                            db_dir=n.dir)
        stored = n.state_store.load()
        if report.count() or stored.last_block_height != P2P_RESTART_AT \
                or app.last_height != stored.last_block_height or \
                report.block_height != P2P_RESTART_AT:
            raise AssertionError(f"restart: doctor {report}, stored state "
                                 f"{stored.last_block_height}, app "
                                 f"{app.last_height}")
        state, resumed = _p2p_sync(torch, pkg, n, chain, stored, 1, seed)
        _check_final(state, n, chain, gen_app)
        resumed["handshake_ms"] = n.handshake_ms
        out["restart"] = {"first": first, "resumed": resumed,
                          "reopen_s": reopen_s, "replay_s": n.open_s,
                          "doctor": {"repairs": report.repairs,
                                     "block_height": report.block_height,
                                     "state_height": report.state_height,
                                     "wal_end_height":
                                     report.wal_end_height}}
        n.close()
        peer.check()
        # seal sync over p2p
        seal: dict = {}
        for name, kw in (("default", {}), ("max_skip_1", {"max_skip": 1})):
            n = node("seal", peer.ports["agg"])
            aead0 = dict(conn.AEAD_STATS)
            fig, _, _ = _seal_pass(torch, agg_chain, seed,
                                   source=NetSealSource(n.net, n.switch),
                                   **kw)
            fig["aead"] = {k: conn.AEAD_STATS[k] - aead0[k] for k in aead0}
            fig["handshake_ms"] = n.handshake_ms
            fig["peer_sent_bytes"] = n.traffic()["received_bytes"]
            seal[name] = fig
            n.close()
            shutil.rmtree(n.dir)
            peer.check()
        tiles = -(-agg_chain.max_height() // seal["max_skip_1"]["tile"])
        for name, pivots, launches in (
                ("default", 1, 1),
                ("max_skip_1", agg_chain.max_height(), tiles)):
            f = seal[name]
            if f["pivots_settled"] != pivots or \
                    f["launches"]["bls_miller_finalexp"] != launches:
                raise AssertionError(f"seal sync over p2p, {name}: {f}")
        out["seal"] = seal
        peer.check()
        for n in nodes:
            n.close()
        out["peer"] = peer.stop()
        peer = None
        if not out["peer"]:
            raise AssertionError("the serving peer printed no figures")
    finally:
        for n in nodes:
            n.close()
        if peer is not None:
            peer.stop()
        shutil.rmtree(d, ignore_errors=True)
    return out


def print_p2p(p2p: dict, gpu: str) -> None:
    for name, f in p2p["syncs"].items():
        prof = f.get("profiled")
        print(f"p2p catch-up ({name}): {p2p['blocks']} blocks from a "
              f"child-process peer over loopback TCP into FileDB stores, "
              f"depth {f['depth']}: {f['wall_s']:.3f} s, "
              f"{f['sigs_per_s']:.1f} sigs/s ({f['sigs_verified']} sigs); "
              f"handshake {f['handshake_ms']:.1f} ms; peer sent "
              f"{f['peer_sent_bytes']:.0f} B, received "
              f"{f['peer_received_bytes']:.0f} B; AEAD open "
              f"{f['aead']['open_s']:.4f} s wall, "
              f"{f['aead']['open_cpu_s']:.4f} s CPU "
              f"({f['aead']['frames_opened']} frames); decode "
              f"{f['decode_s']:.3f} s ({f['blocks_decoded']} blocks); "
              f"fetch wait {f['fetch_wait_s']:.3f} s; RLC launches "
              f"{f['launches']}"
              + (f"; card idle {prof['idle_share']} of this profiled "
                 f"sync" if prof else "") + f"; {gpu}", flush=True)
    r = p2p["restart"]
    print(f"p2p restart: to {r['first']['to']} in "
          f"{r['first']['wall_s']:.3f} s, stores closed and reopened in "
          f"{r['reopen_s']:.3f} s (FileDB replay {r['replay_s']:.3f} s), "
          f"doctor {r['doctor']}, resumed to {r['resumed']['to']} in "
          f"{r['resumed']['wall_s']:.3f} s (launches "
          f"{r['resumed']['launches']}); peer's FileDB stores written in "
          f"{p2p['store_write_s']} s (NativeDB opened the 121-block one: "
          f"{p2p['native_open']}), peer up in {p2p['peer_start_s']:.1f} s;"
          f" {gpu}", flush=True)
    print(f"p2p serving peer (all of its syncs): {p2p['peer']}; {gpu}",
          flush=True)
    for name, f in p2p["seal"].items():
        print(f"seal sync over p2p ({name}, max_skip {f['max_skip']}): tip "
              f"{f['tip']}, {f['pivots_settled']} pivots, "
              f"{f['launches']['bls_miller_finalexp']} bls_miller_finalexp "
              f"launches, {f['wall_s']:.3f} s (card idle "
              f"{f['idle_share']:.4f}); peer sent {f['peer_sent_bytes']:.0f}"
              f" B; {gpu}", flush=True)


# --- consensus (slice 12) ---------------------------------------------------

CS_BLOCKSYNC_TO = 40   # the laggard blocksyncs 1..40, then runs consensus
CS_SEAL_FROM = 60      # the BLS laggard stands at 60 and adopts 61..63
CS_NET_HEIGHTS = 5     # the live 4-validator net commits this many
CS_DEADLINE_S = 120    # each consensus part must end by then
CS_TAMPERED_VOTE = 17  # the add_votes burst's tampered precommit
SIGCACHE_ENV = "COMETBFT_TPU_SIGCACHE_CAPACITY"


def _replay_state(chain, height: int):
    """The chain's state and kvstore app after its blocks 1..height,
    applied without verification (the generator verified them) ->
    (state, app)."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    ex = BlockExecutor(app, device="cuda")
    state = State.from_genesis(chain.genesis)
    for i in range(height):
        state, _ = ex.apply_block(state, chain.block_ids[i],
                                  chain.blocks[i], verified=True)
    return state, app


def _wait(cond, what: str, deadline_s: float = CS_DEADLINE_S) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > deadline_s:
            raise AssertionError(f"consensus: {what} not reached in "
                                 f"{deadline_s} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


class CsNode:
    """A port node of the consensus phase, wired as node.py wires one:
    stores (in memory unless given), a kvstore `app` at `state`, a
    BlockExecutor and a ConsensusState on the card (ConsensusMetrics
    filled), a ConsensusReactor on its own Switch listening on loopback
    TCP. `commits` holds (height, perf_counter) of each commit."""

    def __init__(self, chain_id: str, state, app, store=None, pv=None,
                 wal=None, config=None, name: str = ""):
        from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
        from cometbft_tpu_torch.consensus.state import (ConsensusConfig,
                                                        ConsensusState)
        from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
        from cometbft_tpu_torch.db.kv import MemDB
        from cometbft_tpu_torch.libs.metrics import (ConsensusMetrics,
                                                     Registry)
        from cometbft_tpu_torch.p2p.switch import Switch
        from cometbft_tpu_torch.state.execution import BlockExecutor
        from cometbft_tpu_torch.state.state import StateStore
        from cometbft_tpu_torch.store.blockstore import BlockStore
        self.name = name
        self.store = store if store is not None else BlockStore(MemDB())
        self.state_store = StateStore(MemDB())
        self.state_store.save(state)
        self.app = app
        self.executor = BlockExecutor(app, state_store=self.state_store,
                                      block_store=self.store, device="cuda")
        self.metrics = ConsensusMetrics(Registry())
        self.wal = wal
        self.cs = ConsensusState(
            config or ConsensusConfig(), state, self.executor, self.store,
            priv_validator=pv, wal=wal, name=name, metrics=self.metrics,
            device="cuda")
        self.reactor = ConsensusReactor(self.cs)
        self.switch = Switch(Ed25519PrivKey.generate(), chain_id,
                             "cs-" + name)
        self.switch.add_reactor(self.reactor)
        self.reactor.attach(self.switch)
        self.port = self.switch.listen()[1]
        self.node_id = self.switch.transport.node_id
        self.commits: list = []
        self.cs.on_commit = lambda b, c: self.commits.append(
            (b.header.height, time.perf_counter()))
        self.started = False

    def dial(self, other: "CsNode") -> None:
        n = len(self.switch.peers())
        self.switch.dial("127.0.0.1", other.port)
        _wait(lambda: len(self.switch.peers()) > n,
              f"{self.name} connected to {other.name}", 30)

    def start(self, reconcile: bool = True) -> None:
        self.cs.start()
        if reconcile:
            self.reactor.start_reconciler()
        self.started = True

    def stop(self) -> None:
        self.reactor.stop()
        if self.started:
            self.cs.stop()
        self.switch.stop()
        if self.wal is not None:
            self.wal.close()


class _NoSigCache:
    """The shared signature cache off (COMETBFT_TPU_SIGCACHE_CAPACITY=0,
    the documented switch) for a `with` block: vote intake would
    otherwise record every precommit it verifies, and the next block's
    last commit, the same signatures, would verify from the cache with
    no flush."""

    def __enter__(self):
        from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
        self.old = os.environ.get(SIGCACHE_ENV)
        os.environ[SIGCACHE_ENV] = "0"
        reset_shared_cache()
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
        if self.old is None:
            os.environ.pop(SIGCACHE_ENV, None)
        else:
            os.environ[SIGCACHE_ENV] = self.old
        reset_shared_cache()


class _HeightClock:
    """Per-height seconds of a laggard's vote verification
    (`VoteSet._check_signature`, the native single-signature verify),
    block validation (`validate_block`: the last commit's verify_commit on
    the card) and `apply_block`, and the app hash each apply reached; and,
    on the serving reactor, when a height was first asked for (a round
    state below its own) and when it was served (the catch-up token
    bucket let it through, and how many times in all)."""

    def __init__(self, laggard: CsNode, server=None):
        from cometbft_tpu_torch.types import vote_set
        self.vs_cls = vote_set.VoteSet
        self.orig_check = self.vs_cls._check_signature
        self.vote_s, self.verify_s, self.apply_s = {}, {}, {}
        self.app_hash, self.asked, self.served = {}, {}, {}
        self.serves: dict = {}
        clock = self

        def check(vs, vote, val):
            t0 = time.perf_counter()
            try:
                return clock.orig_check(vs, vote, val)
            finally:
                clock.vote_s[vs.height] = clock.vote_s.get(vs.height, 0.0) \
                    + time.perf_counter() - t0
        self.vs_cls._check_signature = check
        ex = laggard.executor
        validate, apply = ex.validate_block, ex.apply_block

        def timed_validate(state, block, **kw):
            t0 = time.perf_counter()
            try:
                return validate(state, block, **kw)
            finally:
                h = block.header.height
                clock.verify_s[h] = clock.verify_s.get(h, 0.0) + \
                    time.perf_counter() - t0

        def timed_apply(state, block_id, block, verified=False):
            t0 = time.perf_counter()
            new_state, resp = apply(state, block_id, block,
                                    verified=verified)
            h = block.header.height
            clock.apply_s[h] = time.perf_counter() - t0
            clock.app_hash[h] = new_state.app_hash
            return new_state, resp
        ex.validate_block, ex.apply_block = timed_validate, timed_apply
        if server is not None:
            r = server.reactor
            on_rs, serve = r._on_round_state, r._serve_decided_height

            def timed_on_rs(st, peer):
                if st.height < r.cs.rs.height:
                    clock.asked.setdefault(st.height, time.perf_counter())
                on_rs(st, peer)

            def timed_serve(peer, h):
                before = r._catchup_sent.get(peer.id)
                serve(peer, h)
                if r._catchup_sent.get(peer.id) is not before:
                    clock.served.setdefault(h, time.perf_counter())
                    clock.serves[h] = clock.serves.get(h, 0) + 1
            r._on_round_state, r._serve_decided_height = timed_on_rs, \
                timed_serve

    def close(self) -> None:
        self.vs_cls._check_signature = self.orig_check


def _per_height(node: CsNode, clock: _HeightClock, t0: float) -> list:
    rows, prev = [], t0
    for h, t in node.commits:
        served, asked = clock.served.get(h), clock.asked.get(h)
        rows.append({
            "height": h, "wall_s": t - prev,
            "vote_verify_s": clock.vote_s.get(h, 0.0),
            "validate_s": clock.verify_s.get(h, 0.0),
            "apply_s": clock.apply_s.get(h, 0.0),
            "wait_from_commit_to_serve_s":
                None if served is None else served - prev,
            "bucket_wait_s": None if served is None or asked is None
            else served - asked, "serves": clock.serves.get(h, 0)})
        prev = t
    return rows


def run_consensus_catchup(torch, pkg, chain, gen_app, per_call: dict
                          ) -> dict:
    """Part (a): a node that leaves blocksync for consensus at 200
    validators. A serving node holds the 48-block chain in its stores,
    its ConsensusState at 49, behind a ConsensusReactor on its own Switch.
    A laggard blocksyncs 1..40 (`BlocksyncReactor`, one 8,000-lane flush),
    then builds a non-validator ConsensusState over the state and stores
    blocksync left (node.py:591's switch, by hand), dials the server and
    runs its reactor's reconciler: each round state it sends below the
    server's height is served that height's precommits (votes_from_commit)
    and parts, under the server's token bucket (CATCHUP_BURST 4,
    CATCHUP_REFILL_SECS 2.0). Every precommit goes through
    `_check_signature` (native), every block's last commit of 200
    signatures through `verify_commit` on the card: one flush a height
    (the shared signature cache is off, `_NoSigCache`), counted by
    FlushCount. Each height must reach the generator's app hash."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.db.kv import MemDB
    from cometbft_tpu_torch.engine.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.engine.chain_gen import LocalChainSource
    from cometbft_tpu_torch.pipeline.cache import SigCache
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State
    from cometbft_tpu_torch.store.blockstore import BlockStore
    ped = pkg["ped"]
    top = chain.max_height()
    t0 = time.perf_counter()
    srv_state, srv_app = _replay_state(chain, top)
    srv_store = BlockStore(MemDB())
    for b, c in zip(chain.blocks, chain.seen_commits):
        srv_store.save_block(b, b.make_part_set(), c)
    server = CsNode(chain.chain_id, srv_state, srv_app, store=srv_store,
                    name="server")
    setup_s = time.perf_counter() - t0
    nodes = [server]
    try:
        app = KVStoreApplication()
        app.init_chain(chain.chain_id, 1, [], b"")
        store = BlockStore(MemDB())
        bs = BlocksyncReactor(
            BlockExecutor(app, device="cuda"), store,
            LocalChainSource(chain), chain.chain_id, tile_size=TILE,
            batch_size=LANES, cache=SigCache(), device="cuda")
        t0 = time.perf_counter()
        state = bs.sync(State.from_genesis(chain.genesis), CS_BLOCKSYNC_TO)
        torch.cuda.synchronize()
        blocksync_s = time.perf_counter() - t0
        if state.last_block_height != CS_BLOCKSYNC_TO or state.app_hash != \
                chain.blocks[CS_BLOCKSYNC_TO].header.app_hash:
            raise AssertionError(f"consensus: blocksync stopped at "
                                 f"{state.last_block_height}")
        lag = CsNode(chain.chain_id, state, app, store=store, name="laggard")
        nodes.append(lag)
        lag.dial(server)
        clock = _HeightClock(lag, server)
        canary0 = ped.canary_stats()["trips"]
        try:
            server.start(reconcile=False)
            count = FlushCount(torch, pkg, per_call)
            t0 = time.perf_counter()
            lag.start()
            _wait(lambda: lag.cs.state.last_block_height >= top,
                  f"laggard at {top}")
            wall = time.perf_counter() - t0
            flushes = count.read("consensus catch-up",
                                 want_flushes=top - CS_BLOCKSYNC_TO)
        finally:
            clock.close()
        heights = _per_height(lag, clock, t0)
    finally:
        for n in nodes:
            n.stop()
    for h in range(CS_BLOCKSYNC_TO + 1, top + 1):
        want = chain.blocks[h].header.app_hash if h < top \
            else gen_app.last_app_hash
        if clock.app_hash.get(h) != want:
            raise AssertionError(f"consensus catch-up: height {h} reached "
                                 f"another app hash than the generator's")
    if lag.app.state != gen_app.state or \
            lag.store.load_block(top).hash() != chain.blocks[-1].hash() or \
            ped.canary_stats()["trips"] != canary0:
        raise AssertionError("consensus catch-up: final app state, tip "
                             "block or canary differ")
    bucket = sum(r["bucket_wait_s"] or 0.0 for r in heights)
    # a height served again before the laggard finished it (its round
    # state every RECONCILE_SECS) spends a token too: past the burst the
    # bucket alone allows no shorter wall than this
    serves = sum(r["serves"] for r in heights)
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor as R
    bucket_bound = max(0, serves - R.CATCHUP_BURST) * R.CATCHUP_REFILL_SECS
    return {"serves": serves, "bucket_bound_s": bucket_bound,
            "bucket_bound_share": bucket_bound / wall,
            "validators": VALIDATORS, "blocksync_to": CS_BLOCKSYNC_TO,
            "to": top, "setup_s": setup_s, "blocksync_s": blocksync_s,
            "wall_s": wall, "heights": heights,
            "vote_verify_s": sum(r["vote_verify_s"] for r in heights),
            "validate_s": sum(r["validate_s"] for r in heights),
            "apply_s": sum(r["apply_s"] for r in heights),
            "bucket_wait_s": bucket, "bucket_share": bucket / wall,
            "flush_count": flushes, "launches": flushes["launches"],
            "block_processing_s": sum(
                lag.metrics.block_processing._sums.values())}


def run_consensus_seal(torch, agg_chain, agg_app) -> dict:
    """Part (b): seal adoption through the reactor over the 63-block
    aggregated BLS chain. A BLS laggard at CS_SEAL_FROM first dials a
    forging peer, which answers its round state with a seal of n-1
    signatures under a full bitmap ("bitmap"): the laggard reactor's
    pairing (`_on_seal_adopt_wire` -> `settle_seals`, one
    `bls_miller_finalexp` launch) fails and the peer is banned. It then
    dials the honest server (the chain in its stores, its state at 64) and
    adopts 61..63 from served seals, finalizing each block from its parts
    (each block's aggregated last commit verified on the card too)."""
    from cometbft_tpu_torch.consensus import reactor as csr
    from cometbft_tpu_torch.db.kv import MemDB
    from cometbft_tpu_torch.engine.chain_gen import _forge_seal
    from cometbft_tpu_torch.ops import bls12 as pb
    from cometbft_tpu_torch.store.blockstore import BlockStore
    from cometbft_tpu_torch.types import proto
    top = agg_chain.max_height()
    srv_state, srv_app = _replay_state(agg_chain, top)
    srv_store = BlockStore(MemDB())
    for b, c in zip(agg_chain.blocks, agg_chain.seen_commits):
        srv_store.save_block(b, b.make_part_set(), c)
    nodes = []
    out: dict = {}
    try:
        server = CsNode(agg_chain.chain_id, srv_state, srv_app,
                        store=srv_store, name="seal-server")
        forger = CsNode(agg_chain.chain_id, srv_state, srv_app,
                        store=srv_store, name="forger")
        nodes += [server, forger]

        def forged_serve(peer, h):
            commit = _forge_seal(agg_chain, agg_chain.seen_commits[h - 1],
                                 "bitmap")
            body = proto.f_varint(1, h) + proto.f_bytes(2, commit.encode())
            peer.try_send(csr.VOTE_CHANNEL,
                          bytes([csr._SEAL_ADOPT]) + body)
        forger.reactor._serve_decided_height = forged_serve
        state, app = _replay_state(agg_chain, CS_SEAL_FROM)
        lag = CsNode(agg_chain.chain_id, state, app, name="seal-laggard")
        nodes.append(lag)
        clock = _HeightClock(lag, server)
        try:
            lag.dial(forger)
            torch.cuda.synchronize()
            pb.reset_launches()
            t0 = time.perf_counter()
            lag.start()
            _wait(lambda: forger.node_id in lag.switch.banned,
                  "the forger's ban")
            torch.cuda.synchronize()
            out["forged"] = {"ban_s": time.perf_counter() - t0,
                             "launches": dict(pb.LAUNCHES),
                             "height": lag.cs.state.last_block_height}
            lag.dial(server)
            torch.cuda.synchronize()
            pb.reset_launches()
            t0 = time.perf_counter()
            _wait(lambda: lag.cs.state.last_block_height >= top,
                  f"the BLS laggard at {top}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out["adopt"] = {"from": CS_SEAL_FROM, "to": top, "wall_s": wall,
                            "launches": dict(pb.LAUNCHES),
                            "heights": _per_height(lag, clock, t0)}
        finally:
            clock.close()
    finally:
        for n in nodes:
            n.stop()
    f, a = out["forged"], out["adopt"]
    if f["height"] != CS_SEAL_FROM or \
            f["launches"]["bls_miller_finalexp"] < 1:
        raise AssertionError(f"consensus seal: the forgery: {f}")
    for h in range(CS_SEAL_FROM + 1, top + 1):
        want = agg_chain.blocks[h].header.app_hash if h < top \
            else agg_app.last_app_hash
        if clock.app_hash.get(h) != want:
            raise AssertionError(f"consensus seal: height {h} reached "
                                 f"another app hash than the generator's")
    if a["launches"]["bls_miller_finalexp"] < 1 or a["launches"][
            "bls_hard_pow"]:
        raise AssertionError(f"consensus seal: adoption launches {a}")
    out["launches"] = {k: f["launches"][k] + a["launches"][k]
                       for k in a["launches"]}
    return out


def run_consensus_net(torch, seed: int, d: str) -> dict:
    """Part (c): a live net of 4 port validators on loopback TCP, each a
    ConsensusState (FilePV under `d`, the ported WAL, real timeout
    tickers), a ConsensusReactor with its reconciler and a Switch dialled
    to the others; it must commit CS_NET_HEIGHTS heights with the same
    block hashes on every node, its votes on the host (4 signatures stay
    under the batch threshold)."""
    import random
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.state import ConsensusConfig
    from cometbft_tpu_torch.consensus.wal import WAL
    from cometbft_tpu_torch.privval.file import FilePV
    from cometbft_tpu_torch.state.state import GenesisDoc, State
    from cometbft_tpu_torch.types.proto import Timestamp
    from cometbft_tpu_torch.types.validator import Validator
    rng = random.Random(seed)
    pvs = []
    for i in range(4):
        pv = FilePV.generate(os.path.join(d, f"pv{i}.json"), rng)
        pv._save()
        pvs.append(pv)
    pvs.sort(key=lambda pv: pv.address())
    gen = GenesisDoc(chain_id="cs-net", genesis_time=Timestamp.now(),
                     validators=[Validator(pv.get_pub_key(), 10)
                                 for pv in pvs])
    config = ConsensusConfig(
        timeout_propose=400, timeout_propose_delta=200,
        timeout_prevote=200, timeout_prevote_delta=100,
        timeout_precommit=200, timeout_precommit_delta=100,
        timeout_commit=40)
    nodes = []
    try:
        for i, pv in enumerate(pvs):
            app = KVStoreApplication()
            app.init_chain(gen.chain_id, 1, gen.validators, b"")
            os.makedirs(os.path.join(d, f"wal{i}"))
            nodes.append(CsNode(
                gen.chain_id, State.from_genesis(gen), app,
                pv=FilePV.load(pv.state_path),
                wal=WAL(os.path.join(d, f"wal{i}", "wal")), config=config,
                name=f"val{i}"))
        for i, n in enumerate(nodes):
            for other in nodes[:i]:
                n.dial(other)
        t0 = time.perf_counter()
        for n in nodes:
            n.start()
        _wait(lambda: all(n.cs.state.last_block_height >= CS_NET_HEIGHTS
                          for n in nodes), f"the net at {CS_NET_HEIGHTS}")
        wall = time.perf_counter() - t0
    finally:
        for n in nodes:
            n.stop()
    hashes = [[n.store.load_block(h).hash() for h in
               range(1, CS_NET_HEIGHTS + 1)] for n in nodes]
    if any(h != hashes[0] for h in hashes):
        raise AssertionError("consensus net: the nodes hold other blocks")
    wal_bytes = [sum(os.path.getsize(os.path.join(d, f"wal{i}", f))
                     for f in os.listdir(os.path.join(d, f"wal{i}")))
                 for i in range(4)]
    return {"validators": 4, "heights": CS_NET_HEIGHTS, "wall_s": wall,
            "s_per_height": wall / CS_NET_HEIGHTS,
            "tips": [n.cs.state.last_block_height for n in nodes],
            "rounds": [n.metrics.rounds.value(reason="round_skip")
                       for n in nodes],
            "wal_bytes": wal_bytes}


def run_add_votes(torch, pkg, chain, per_call: dict) -> dict:
    """Part (c), second half: `VoteSet.add_votes` of the 200 precommits
    of the chain's last height on the card, precommit CS_TAMPERED_VOTE
    with a flipped s byte: one flush (attributed per lane), and the
    verdicts must equal adding each vote alone (native, per vote)."""
    from cometbft_tpu_torch.consensus.reactor import votes_from_commit
    from cometbft_tpu_torch.types.vote import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.vote_set import VoteError, VoteSet
    h = chain.max_height()
    commit, vals = chain.seen_commits[h - 1], chain.valsets[h - 1]
    votes = votes_from_commit(commit)
    bad = votes[CS_TAMPERED_VOTE]
    bad.signature = bad.signature[:40] + bytes([bad.signature[40] ^ 4]) + \
        bad.signature[41:]
    vs = VoteSet(chain.chain_id, h, commit.round, PRECOMMIT_TYPE, vals)
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    got = vs.add_votes(votes, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fc = count.read("add_votes", want_flushes=1)
    one = VoteSet(chain.chain_id, h, commit.round, PRECOMMIT_TYPE, vals)
    single = []
    t0 = time.perf_counter()
    for v in votes:
        try:
            single.append(one.add_vote(v))
        except VoteError as e:
            single.append(e)
    single_s = time.perf_counter() - t0

    def kind(x):
        return type(x).__name__ if isinstance(x, Exception) else x
    verdicts = [kind(x) for x in got]
    if verdicts != [kind(x) for x in single] or \
            verdicts[CS_TAMPERED_VOTE] != "ErrVoteInvalidSignature" or \
            verdicts.count(True) != len(votes) - 1 or \
            vs.make_commit().encode() != one.make_commit().encode():
        raise AssertionError(f"add_votes: batch {verdicts}, per vote "
                             f"{[kind(x) for x in single]}")
    return {"votes": len(votes), "wall_s": wall, "per_vote_s": single_s,
            "flush_count": fc, "launches": fc["launches"],
            "rejected": [i for i, v in enumerate(verdicts) if v is not True]}


def native_ed25519_ms(ref, reps: int = 200, oracle_reps: int = 5) -> dict:
    """Median host ms of one signature and one verify of a 120-byte
    message, natively (`csrc/host/ed25519.cc` through
    `Ed25519PrivKey.sign` and `Ed25519PubKey.verify_signature`) and
    through the oracle (`ref_ed25519.sign`, `ref_ed25519.verify`), in the
    same run."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    seed, msg = bytes(range(32)), bytes(range(120))
    key = Ed25519PrivKey(seed)
    pub = key.pub_key()

    def med(fn, n):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))
    sig = key.sign(msg)
    if sig != ref.sign(seed, msg) or not pub.verify_signature(msg, sig):
        raise AssertionError("native ed25519 disagrees with the oracle")
    return {"native_sign_ms": med(lambda: key.sign(msg), reps),
            "native_verify_ms": med(
                lambda: pub.verify_signature(msg, sig), reps),
            "oracle_sign_ms": med(lambda: ref.sign(seed, msg), oracle_reps),
            "oracle_verify_ms": med(
                lambda: ref.verify(pub.bytes_(), msg, sig), oracle_reps),
            "reps": reps, "oracle_reps": oracle_reps, "msg_bytes": len(msg)}


def run_consensus(torch, pkg, chain, gen_app, agg_chain, agg_app,
                  seed: int, per_call: dict) -> dict:
    """The consensus phase: parts (a), (b) and (c) with the shared
    signature cache off, the add_votes burst, and the native ed25519's
    host times."""
    import shutil
    import tempfile
    out: dict = {}
    t0 = time.perf_counter()
    out["ed25519_host"] = native_ed25519_ms(pkg["ref"])
    with _NoSigCache():
        out["catchup"] = run_consensus_catchup(torch, pkg, chain, gen_app,
                                               per_call)
        out["seal"] = run_consensus_seal(torch, agg_chain, agg_app)
        d = tempfile.mkdtemp(prefix="chip_smoke_cs_",
                             dir=os.path.join(os.path.dirname(
                                 os.path.abspath(__file__)), "build"))
        try:
            out["net"] = run_consensus_net(torch, seed, d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        out["add_votes"] = run_add_votes(torch, pkg, chain, per_call)
    out["pass_s"] = time.perf_counter() - t0
    return out


def print_consensus(cons: dict, gpu: str) -> None:
    c = cons["catchup"]
    print(f"consensus catch-up: blocksync 1..{c['blocksync_to']} in "
          f"{c['blocksync_s']:.3f} s, then consensus {c['blocksync_to'] + 1}"
          f"..{c['to']} at {c['validators']} validators in {c['wall_s']:.3f}"
          f" s (votes verified {c['vote_verify_s']:.3f} s, blocks validated "
          f"{c['validate_s']:.3f} s, applied {c['apply_s']:.3f} s; token "
          f"bucket wait {c['bucket_wait_s']:.3f} s, "
          f"{c['bucket_share']:.3f} of the wall; {c['serves']} serves, the "
          f"bucket's least wall for them {c['bucket_bound_s']:.1f} s, "
          f"{c['bucket_bound_share']:.3f} of the wall); "
          f"{c['flush_count']['flushes']}"
          f" flushes, {c['flush_count']['canaries']} canary runs, RLC "
          f"launches {c['launches']}; {gpu}", flush=True)
    for r in c["heights"]:
        print(f"  height {r['height']}: wall {r['wall_s']:.3f} s, vote "
              f"verify {r['vote_verify_s']:.3f} s, validate "
              f"{r['validate_s']:.3f} s, apply {r['apply_s']:.4f} s, "
              f"commit->serve {r['wait_from_commit_to_serve_s']}, bucket "
              f"wait {r['bucket_wait_s']}, served {r['serves']}x",
              flush=True)
    s = cons["seal"]
    print(f"consensus seal adoption: forger banned in "
          f"{s['forged']['ban_s']:.3f} s ({s['forged']['launches']}); "
          f"{s['adopt']['from'] + 1}..{s['adopt']['to']} adopted in "
          f"{s['adopt']['wall_s']:.3f} s ({s['adopt']['launches']}); "
          f"{gpu}", flush=True)
    n = cons["net"]
    print(f"consensus net: {n['validators']} port validators over loopback "
          f"TCP committed {n['heights']} equal heights in {n['wall_s']:.3f}"
          f" s ({n['s_per_height']:.3f} s a height; round skips "
          f"{n['rounds']}; WAL bytes {n['wal_bytes']}); {gpu}", flush=True)
    a = cons["add_votes"]
    print(f"consensus add_votes: {a['votes']} precommits on the card in "
          f"{a['wall_s']:.3f} s (one flush, rejected {a['rejected']}), per "
          f"vote natively {a['per_vote_s']:.3f} s; launches "
          f"{a['launches']}; {gpu}", flush=True)
    e = cons["ed25519_host"]
    print(f"ed25519 on the host, ms a signature: native sign "
          f"{e['native_sign_ms']:.4f}, verify {e['native_verify_ms']:.4f}; "
          f"oracle sign {e['oracle_sign_ms']:.3f}, verify "
          f"{e['oracle_verify_ms']:.3f}; {gpu}", flush=True)


NODE_SERVER_START_S = 300  # the serving node must print its start by then
NODE_DEADLINE_S = 300      # each wait of the node-boot phase ends by then
NODE_NET_HEIGHTS = 3       # the live net commits this many before its txs
NODE_NET_TXS = 8           # txs committed through broadcast_tx_commit


def _median_wall_ms(fn, reps: int) -> float:
    """Median host wall of `reps` calls of fn, in ms."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _write_node_home(chain, home: str, p2p: int, rpc: int) -> dict:
    """A node home for the chain, as a node that produced it would hold
    it: config.toml (FileDB, block sync off: it is the tip, listeners on
    the given loopback ports), genesis.json, the FileDB block store of
    every block and seen commit (`_write_store`), and the FileDB state
    store at the tip with each height's FinalizeBlock response and
    validator set (applied without verification: the generator verified
    the chain) -> seconds of each part."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.db.kv import open_db
    from cometbft_tpu_torch.node.node import save_genesis
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.state import State, StateStore
    cfg = Config(root_dir=home)
    cfg.base.chain_id = chain.chain_id
    cfg.base.moniker = "server"
    cfg.base.block_sync = False
    cfg.p2p.laddr = f"127.0.0.1:{p2p}"
    cfg.rpc.laddr = f"127.0.0.1:{rpc}"
    cfg.write()
    save_genesis(chain.genesis, cfg.path(cfg.base.genesis_file))
    ddir = cfg.path(cfg.base.db_dir)
    os.makedirs(ddir, exist_ok=True)
    blocks_s = _write_store(chain, ddir)
    t0 = time.perf_counter()
    db = open_db("filedb", "state", ddir)
    store = StateStore(db)
    app = KVStoreApplication()
    app.init_chain(chain.chain_id, 1, [], b"")
    ex = BlockExecutor(app, state_store=store, device="cuda")
    state = State.from_genesis(chain.genesis)
    store.save(state)
    for i in range(chain.max_height()):
        state, _ = ex.apply_block(state, chain.block_ids[i], chain.blocks[i],
                                  verified=True)
    db.close()
    return {"blocks_s": blocks_s, "state_s": time.perf_counter() - t0}


class ServingNode:
    """`python -m cometbft_tpu_torch.cmd.main start --home DIR --device
    cpu` in a child process with CUDA hidden: the entry point a user runs,
    on the CPU as the p2p phase's peer. Its stdout is read for the
    "node started" line; its stderr goes to a file; `stop` sends SIGTERM
    (the command stops the node and exits 0)."""

    def __init__(self, home: str):
        import selectors
        self.err_path = os.path.join(home, "node.stderr")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        t0 = time.perf_counter()
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cometbft_tpu_torch.cmd.main", "start",
                 "--home", home, "--device", "cpu"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=err, text=True, env=env)
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        line = ""
        while not line.startswith("node started"):
            left = NODE_SERVER_START_S - (time.perf_counter() - t0)
            line = (self.proc.stdout.readline()
                    if left > 0 and sel.select(timeout=left) else "")
            if not line:
                sel.close()
                self.stop()
                raise RuntimeError(f"the serving node did not start: "
                                   f"{self._stderr()}")
        sel.close()
        self.start_s = time.perf_counter() - t0

    def _stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-4000:]

    def stop(self) -> int:
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait(timeout=30)
        self.proc.stdout.close()
        return rc


class SyncClock:
    """Wall of each `BlocksyncReactor.sync` call (the boot sync's) while
    in use: (start, end, error or None)."""

    def __init__(self):
        from cometbft_tpu_torch.engine import blocksync
        self.cls = blocksync.BlocksyncReactor
        self.orig = self.cls.sync
        self.calls: list = []
        clock = self

        def timed(engine, state, target=None):
            t0 = time.perf_counter()
            try:
                out = clock.orig(engine, state, target)
            except BaseException as e:
                clock.calls.append((t0, time.perf_counter(), repr(e)))
                raise
            clock.calls.append((t0, time.perf_counter(), None))
            return out
        self.cls.sync = timed

    def close(self) -> None:
        self.cls.sync = self.orig


def _status_core(st: dict) -> dict:
    """`status` without the node's identity and clock fields."""
    st = {k: v for k, v in st.items()
          if k not in ("node_info", "validator_info")}
    st["sync_info"] = {k: v for k, v in st["sync_info"].items()
                       if "time" not in k}
    return st


def _bls_since(bls0: dict) -> dict:
    """The BLS kernels' launches since `bls0`, a copy of `bls12.LAUNCHES`
    taken where a counted window began."""
    from cometbft_tpu_torch.ops import bls12
    return {k: bls12.LAUNCHES[k] - bls0.get(k, 0) for k in bls12.LAUNCHES}


def run_node_catchup(torch, pkg, chain, gen_app, per_call: dict,
                     root: str, server: "ServingNode", srv_p2p: int,
                     srv_rpc: int) -> tuple:
    """Part (a): node boot through the entry points. A serving node
    (`ServingNode`, `cmd.main start --device cpu`) holds the 121-block,
    200-validator chain in FileDB stores and replays it into a fresh
    kvstore in its handshake. A laggard is made by `cmd.main init`, given
    the chain's genesis and the server as its persistent peer, built as
    `Node(cfg, device="cuda")` (block sync on, `pipeline_depth` 4, its
    batch `_device_batch_size(200)` = 4,096 lanes, a 16-commit tile) and
    started: its boot thread blocksyncs through the RLC kernels, then
    starts consensus. The shared signature cache is reset first (the
    earlier phases verified these signatures); the batch's bucket is
    warmed before the counts are zeroed, so the node's own prewarm finds
    it warm and every counted launch is the sync's (FlushCount).
    -> (figures, the laggard, still running: parts (c)-(e) use its RPC as
    their witness; the caller stops it)."""
    from cometbft_tpu_torch.cmd.main import main as cli
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node.node import BOOT_TILE, Node, save_genesis
    from cometbft_tpu_torch.ops import bls12
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.rpc.client import RPCClient
    ped = pkg["ped"]
    top = chain.max_height()
    lag_home = os.path.join(root, "laggard")
    node = clock = None
    try:
        assert cli(["init", "--home", lag_home, "--chain-id",
                    chain.chain_id]) == 0
        cfg = Config.load(lag_home)
        save_genesis(chain.genesis, cfg.path(cfg.base.genesis_file))
        cfg.base.moniker = "laggard"
        cfg.p2p.laddr = cfg.rpc.laddr = "127.0.0.1:0"
        cfg.p2p.persistent_peers = f"127.0.0.1:{srv_p2p}"
        cfg.write()
        reset_shared_cache()
        t0 = time.perf_counter()
        node = Node(Config.load(lag_home), device="cuda")
        construct_s = time.perf_counter() - t0
        batch = node._device_batch_size(VALIDATORS)
        t0 = time.perf_counter()
        ped.prewarm_verify_kernels(batch, device=node.device)
        torch.cuda.synchronize()
        prewarm_s = time.perf_counter() - t0
        canary0 = ped.canary_stats()
        bls0 = dict(bls12.LAUNCHES)
        clock = SyncClock()
        count = FlushCount(torch, pkg, per_call)
        t0 = time.perf_counter()
        node.start()
        consensus_s = _wait(lambda: node.boot_error is not None or (
            node.consensus._thread is not None and
            node.consensus.rs.height > top), f"the laggard's consensus at "
            f"{top + 1}", NODE_DEADLINE_S)
        if node.boot_error is not None:
            raise AssertionError(f"node boot: {node.boot_error!r}")
        flushes = count.read("node boot")
        bls_launches = _bls_since(bls0)
        clock.close()
        engine = node.boot_engine
        syncs = [{"wall_s": b - a, "error": e} for a, b, e in clock.calls]
        sync_s = sum(x["wall_s"] for x in syncs)
        canary = {k: ped.canary_stats()[k] - canary0[k] for k in canary0}
        drains = node.pipeline_metrics.wedge_fallbacks.value()
        if canary["trips"] or drains or any(x["error"] for x in syncs):
            raise AssertionError(f"node boot: trips {canary['trips']}, "
                                 f"drains {drains}, syncs {syncs}")
        if node.consensus.state.app_hash != gen_app.last_app_hash or \
                node.consensus.state.last_block_height != top or \
                [node.block_store.load_block(h).hash()
                 for h in range(1, top + 1)] != \
                [b.hash() for b in chain.blocks]:
            raise AssertionError("node boot: the laggard's blocks or app "
                                 "hash differ from the generator's")
        lag_rpc = RPCClient(*node.rpc_server.addr, timeout=60)
        srv_rpc_c = RPCClient("127.0.0.1", srv_rpc, timeout=60)
        answers, rpc_ms = {}, {"laggard": {}, "server": {}}
        for name, call in (
                ("status", lambda c: _status_core(c.status())),
                ("block", lambda c: c.call("block", height=top)),
                ("commit", lambda c: c.call("commit", height=top)),
                ("validators", lambda c: c.call(
                    "validators", height=top, per_page=100, page=2))):
            got = {}
            for who, client in (("laggard", lag_rpc),
                                ("server", srv_rpc_c)):
                t0 = time.perf_counter()
                got[who] = call(client)
                rpc_ms[who][name] = (time.perf_counter() - t0) * 1e3
            if got["laggard"] != got["server"]:
                raise AssertionError(f"node boot: {name} at {top} differs "
                                     f"from the server's")
            answers[name] = len(json.dumps(got["laggard"]))
        # the round trip of the smallest answer, health, ten times each
        for who, client in (("laggard", lag_rpc), ("server", srv_rpc_c)):
            rpc_ms[who]["health"] = _median_wall_ms(
                lambda c=client: c.call("health"), 10)
        sigs = engine.stats.sigs_verified
        return {
            "validators": VALIDATORS, "blocks": top, "tile": BOOT_TILE,
            "batch": batch, "depth": engine.pipeline_depth,
            "server_start_s": server.start_s,
            "construct_s": construct_s, "prewarm_s": prewarm_s,
            "sync_s": sync_s, "syncs": syncs,
            "boot_to_consensus_s": consensus_s,
            "sigs_verified": sigs, "sigs_per_s": sigs / sync_s,
            "tiles": engine.stats.tiles_flushed,
            "blocks_applied": engine.stats.blocks_applied,
            "flush_count": flushes, "launches": flushes["launches"],
            "flushes_per_tile": flushes["flushes"] / max(
                engine.stats.tiles_flushed, 1),
            "canary": canary, "drains": drains,
            "bls_launches": bls_launches,
            "rpc_ms": rpc_ms, "rpc_answer_bytes": answers}, node
    except BaseException:
        if node is not None:
            node.stop()
        raise
    finally:
        if clock is not None:
            clock.close()


def run_node_net(torch, root: str) -> dict:
    """Part (b): a live net of 4 validators from `cmd.main testnet` homes,
    each an in-process `Node(cfg, device="cuda")` with its FileDB stores,
    FilePV and WAL, the listeners moved to free loopback ports and dialled
    pairwise. Its boot (each node's boot sync finds no peer ahead, then
    consensus) ends at height 1 everywhere; from there it commits
    NODE_NET_HEIGHTS heights (the wall timed); then NODE_NET_TXS txs
    go in through `broadcast_tx_commit` on node 0, one after another, and
    are read back on node 2 with `abci_query` and `tx_search`."""
    from cometbft_tpu_torch.cmd.main import main as cli
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.rpc.client import RPCClient
    d = os.path.join(root, "net")
    assert cli(["testnet", "--v", "4", "--o", d, "--chain-id", "node-net",
                "--base-port", str(_free_port())]) == 0
    nodes = []
    try:
        for i in range(4):
            cfg = Config.load(os.path.join(d, f"node{i}"))
            cfg.p2p.laddr = cfg.rpc.laddr = "127.0.0.1:0"
            cfg.p2p.persistent_peers = ""
            nodes.append(Node(cfg, device="cuda"))
        for n in nodes:
            n.start()
        for i, n in enumerate(nodes):
            for other in nodes[i + 1:]:
                n.switch.dial(*other.p2p_addr)
        boot_s = _wait(lambda: all(n.consensus.state.last_block_height >= 1
                                   for n in nodes), "the net at 1",
                       NODE_DEADLINE_S)
        wall = _wait(lambda: all(n.consensus.state.last_block_height >=
                                 1 + NODE_NET_HEIGHTS for n in nodes),
                     f"the net at {1 + NODE_NET_HEIGHTS}", NODE_DEADLINE_S)
        rpc0 = RPCClient(*nodes[0].rpc_server.addr, timeout=60)
        rpc2 = RPCClient(*nodes[2].rpc_server.addr, timeout=60)
        h0 = nodes[0].consensus.state.last_block_height
        tx_ms, heights = [], []
        for i in range(NODE_NET_TXS):
            t1 = time.perf_counter()
            r = rpc0.call("broadcast_tx_commit",
                          tx=f"nb{i}=v{i}".encode().hex())
            tx_ms.append((time.perf_counter() - t1) * 1e3)
            if r["check_tx"]["code"] or r["tx_result"]["code"]:
                raise AssertionError(f"node net: tx {i} failed: {r}")
            heights.append(r["height"])
        _wait(lambda: all(bytes.fromhex(rpc2.abci_query(
            "/store", f"nb{i}".encode())["value"]) == f"v{i}".encode()
            for i in range(NODE_NET_TXS)), "the txs on node 2",
            NODE_DEADLINE_S)
        _wait(lambda: rpc2.call("tx_search", query=f"tx.height > {h0}",
                                per_page=100)["total_count"] >=
              NODE_NET_TXS, "the txs indexed on node 2", NODE_DEADLINE_S)
        tips = [n.consensus.state.last_block_height for n in nodes]
        top = min(tips)
        hashes = {n.block_store.load_block(top).hash() for n in nodes}
        if len(hashes) != 1:
            raise AssertionError("node net: the nodes hold other blocks")
    finally:
        for n in nodes:
            n.stop()
    return {"validators": 4, "heights": NODE_NET_HEIGHTS, "boot_s": boot_s,
            "wall_s": wall, "s_per_height": wall / NODE_NET_HEIGHTS,
            "tx_ms": tx_ms,
            "tx_ms_median": float(np.median(tx_ms)), "tx_heights": heights,
            "tips": tips}


SS_SNAPSHOT = 115       # the snapshot (c) restores (120 cannot be anchored)
SS_TRUST_PERIOD_S = 10**9  # the chain's headers are stamped in 2023
PROXY_HEIGHTS = (60, 120)  # (d)'s block, commit and validators reads
PROXY_FORGED_AT = 90     # the stub's forged block


class WsSubscriber:
    """A port `rpc/websocket.WSClient` of a node's RPC: the upgrade and a
    `subscribe` are sent at construction, before the node serves, then a
    reader thread collects every frame's JSON."""

    def __init__(self, addr, query: str):
        import threading
        from cometbft_tpu_torch.rpc.websocket import WSClient
        self.ws = WSClient(addr, timeout=NODE_DEADLINE_S)
        self.ws.send(json.dumps({"jsonrpc": "2.0", "id": 1,
                                 "method": "subscribe",
                                 "params": {"query": query}}).encode())
        self.frames: list = []
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        from cometbft_tpu_torch.rpc.websocket import frame_payload
        try:
            self.ws.handshake()
            while True:
                self.frames.append(json.loads(frame_payload(
                    self.ws.frame())))
        except (OSError, ValueError):
            return

    def heights(self) -> list:
        return [int(f["params"]["attrs"]["block.height"][0])
                for f in self.frames if f.get("method") == "event"]

    def close(self) -> None:
        self.ws.close()
        self.thread.join(timeout=10)


class StatesyncClock:
    """Seconds of the statesync steps of a node's boot while in use:
    `Node._run_statesync` (its start and end, and the canary's dispatches
    and the signatures in the shared signature cache at its end), the
    light client's trust root (`light_provider_from_config`), each
    `Syncer.sync`, and the anchor's provider calls
    (`LightStateProvider.app_hash`, `.state`)."""

    def __init__(self, ped):
        from cometbft_tpu_torch import statesync
        from cometbft_tpu_torch.node.node import Node
        from cometbft_tpu_torch.pipeline.cache import shared_cache
        from cometbft_tpu_torch.statesync.stateprovider import \
            LightStateProvider
        from cometbft_tpu_torch.statesync.syncer import Syncer
        self.t: dict = {"anchor_s": 0.0, "syncs": []}
        self.undo = []
        t = self.t

        def wrap(owner, name, fn):
            orig = getattr(owner, name)
            self.undo.append((owner, name, orig))
            setattr(owner, name, fn(orig))

        def run(orig):
            def timed(node):
                t["start"] = time.perf_counter()
                try:
                    return orig(node)
                finally:
                    t["end"] = time.perf_counter()
                    t["dispatches_at_end"] = ped.canary_stats()
                    t["sigs_at_end"] = len(shared_cache())
            return timed

        def root(orig):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **kw)
                finally:
                    t["trust_root_s"] = time.perf_counter() - t0
            return timed

        def sync(orig):
            def timed(syncer):
                t0 = time.perf_counter()
                try:
                    return orig(syncer)
                finally:
                    t["syncs"].append((t0, time.perf_counter()))
            return timed

        def anchor(orig):
            def timed(provider, height):
                t0 = time.perf_counter()
                try:
                    return orig(provider, height)
                finally:
                    t["anchor_s"] += time.perf_counter() - t0
            return timed
        wrap(Node, "_run_statesync", run)
        wrap(statesync, "light_provider_from_config", root)
        wrap(Syncer, "sync", sync)
        wrap(LightStateProvider, "app_hash", anchor)
        wrap(LightStateProvider, "state", anchor)

    def close(self) -> None:
        for owner, name, orig in reversed(self.undo):
            setattr(owner, name, orig)
        self.undo = []


def _statesync_config(cfg, chain, rpc_servers: str) -> None:
    cfg.statesync.rpc_servers = rpc_servers
    cfg.statesync.trust_height = 1
    cfg.statesync.trust_hash = chain.blocks[0].hash().hex()
    # the generator stamps block h at 1,700,000,000 + h s (Nov. 2023): a
    # trust period long enough for that, as the light phase takes
    cfg.statesync.trust_period_seconds = SS_TRUST_PERIOD_S


def run_node_statesync(torch, pkg, chain, gen_app, per_call: dict,
                       root: str, srv_p2p: int, srv_rpc: int, lag) -> dict:
    """Part (c): a fresh node statesyncs on the card. Made by `cmd.main
    init` with the chain's genesis, the server as its persistent peer,
    `[statesync]` on (rpc_servers: the server, primary, and laggard (a),
    witness; trusting block 1), `[tx_index] indexer = "sqlite"`, and its
    kvstore behind a port `ABCIServer` in this process (`proxy_app =
    tcp://`, a `RecordingApp`). Built as `Node(cfg, device="cuda")`; a
    WebSocket subscriber to NewBlock opens before `start()`. Its boot
    discovers the server's snapshots (120 and 115) on the p2p statesync
    channel, anchors through the light client on the card (120 needs
    header 122, which does not exist: refused), restores 115 over the
    socket, persists the state and seen commit, blocksyncs 116..121
    through the RLC kernels and starts consensus at 122. The shared
    signature cache is reset first (FlushCount)."""
    from cometbft_tpu_torch.abci.grammar import RecordingApp
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.abci.socket import ABCIServer
    from cometbft_tpu_torch.cmd.main import main as cli
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node.node import Node, save_genesis
    from cometbft_tpu_torch.ops import bls12
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.rpc.client import RPCClient
    ped = pkg["ped"]
    top = chain.max_height()
    home = os.path.join(root, "statesync")
    app = RecordingApp(KVStoreApplication())
    abci = ABCIServer(app)
    abci.start()
    node = ws = clock = ss_clock = None
    try:
        assert cli(["init", "--home", home, "--chain-id",
                    chain.chain_id]) == 0
        cfg = Config.load(home)
        save_genesis(chain.genesis, cfg.path(cfg.base.genesis_file))
        cfg.base.moniker = "statesync"
        cfg.base.proxy_app = "tcp://%s:%d" % abci.addr
        cfg.p2p.laddr = cfg.rpc.laddr = "127.0.0.1:0"
        cfg.p2p.persistent_peers = f"127.0.0.1:{srv_p2p}"
        cfg.statesync.enable = True
        _statesync_config(cfg, chain, f"127.0.0.1:{srv_rpc},"
                          "%s:%d" % lag.rpc_server.addr)
        cfg.tx_index.indexer = "sqlite"
        cfg.write()
        reset_shared_cache()
        t0 = time.perf_counter()
        node = Node(Config.load(home), device="cuda")
        construct_s = time.perf_counter() - t0
        ws = WsSubscriber(node.rpc_server.addr, "tm.event = 'NewBlock'")
        canary0 = ped.canary_stats()
        clock, ss_clock = SyncClock(), StatesyncClock(ped)
        bls0 = dict(bls12.LAUNCHES)
        count = FlushCount(torch, pkg, per_call)
        t0 = time.perf_counter()
        node.start()
        consensus_s = _wait(lambda: node.boot_error is not None or (
            node.consensus._thread is not None and
            node.consensus.rs.height > top), f"the statesync node's "
            f"consensus at {top + 1}", NODE_DEADLINE_S)
        if node.boot_error is not None:
            raise AssertionError(f"statesync: {node.boot_error!r}")
        flushes = count.read("statesync")
        bls_launches = _bls_since(bls0)
        t = ss_clock.t
        anchor_flushes = (t["dispatches_at_end"]["dispatches"]
                          - canary0["dispatches"])
        anchor_canaries = t["dispatches_at_end"]["runs"] - canary0["runs"]
        syncs = [{"wall_s": b - a, "error": e} for a, b, e in clock.calls]
        canary = {k: ped.canary_stats()[k] - canary0[k] for k in canary0}
        drains = node.pipeline_metrics.wedge_fallbacks.value()
        if canary["trips"] or drains or any(x["error"] for x in syncs):
            raise AssertionError(f"statesync: trips {canary['trips']}, "
                                 f"drains {drains}, syncs {syncs}")
        refused = node.statesync_syncer.refused
        boot = node.statesync_state
        if boot is None or boot.last_block_height != SS_SNAPSHOT or \
                [h for h, _ in refused] != [SS_SNAPSHOT + 5] or \
                "ErrLightBlockNotFound" not in refused[0][1]:
            raise AssertionError(f"statesync: restored "
                                 f"{boot and boot.last_block_height}, "
                                 f"refused {refused}")
        if app._app.state != gen_app.state or \
                app._app.last_app_hash != gen_app.last_app_hash or \
                node.consensus.state.app_hash != gen_app.last_app_hash or \
                node.consensus.state.last_block_height != top or \
                node.block_store.load_block(SS_SNAPSHOT) is not None or \
                [node.block_store.load_block(h).hash()
                 for h in range(SS_SNAPSHOT + 1, top + 1)] != \
                [b.hash() for b in chain.blocks[SS_SNAPSHOT:top]]:
            raise AssertionError("statesync: the app, app hash or blocks "
                                 "differ from the generator's")
        grammar_ok, grammar_err = app.check()
        calls = list(app.calls)
        if not grammar_ok or calls[:2] != ["init_chain", "offer_snapshot"]:
            raise AssertionError(f"statesync: ABCI calls {calls}: "
                                 f"{grammar_err}")
        _wait(lambda: ws.heights()[-(top - SS_SNAPSHOT):] ==
              list(range(SS_SNAPSHOT + 1, top + 1)), "NewBlock over the "
              "WebSocket", 30)
        if ws.heights() != list(range(SS_SNAPSHOT + 1, top + 1)):
            raise AssertionError(f"statesync: WebSocket NewBlock heights "
                                 f"{ws.heights()}")
        query = f"tx.height = {SS_SNAPSHOT + 3}"
        mine = RPCClient(*node.rpc_server.addr, timeout=60)
        theirs = RPCClient(*lag.rpc_server.addr, timeout=60)
        _wait(lambda: mine.call("tx_search", query=query)["total_count"],
              "the sqlite index", 30)
        found = mine.call("tx_search", query=query)
        if not found["total_count"] or \
                found != theirs.call("tx_search", query=query):
            raise AssertionError(f"statesync: tx_search {query} through "
                                 f"sqlite {found} differs from the kv "
                                 f"indexer's")
        engine = node.boot_engine
        sync_s = sum(x["wall_s"] for x in syncs)
        first, last = t["syncs"][0][0], t["syncs"][-1][1]
        sync_total = sum(b - a for a, b in t["syncs"])
        anchor_s = t["anchor_s"] + t["trust_root_s"]
        return {
            "snapshot": SS_SNAPSHOT, "refused": refused,
            "construct_s": construct_s,
            "statesync_s": t["end"] - t["start"],
            "discovery_s": first - t["start"] - t["trust_root_s"],
            "trust_root_s": t["trust_root_s"], "anchor_s": anchor_s,
            "restore_s": sync_total - t["anchor_s"],
            "syncer_calls": len(t["syncs"]),
            "persist_s": t["end"] - last,
            "blocksync_s": sync_s, "syncs": syncs,
            "boot_to_consensus_s": consensus_s,
            "anchor_flushes": anchor_flushes,
            "anchor_canaries": anchor_canaries,
            "anchor_sigs": t["sigs_at_end"],
            "anchor_sigs_per_s": t["sigs_at_end"] / anchor_s,
            "blocksync_flushes": flushes["flushes"] - anchor_flushes,
            "flush_count": flushes, "launches": flushes["launches"],
            "bls_launches": bls_launches,
            "blocksync_sigs": engine.stats.sigs_verified,
            "blocksync_sigs_per_s": engine.stats.sigs_verified / sync_s,
            "canary": canary, "drains": drains, "abci_calls": len(calls),
            "websocket_heights": ws.heights(), "tx_search": found,
            "state": boot}
    finally:
        for c in (clock, ss_clock):
            if c is not None:
                c.close()
        if ws is not None:
            ws.close()
        if node is not None:
            node.stop()
        abci.stop()


def _verified_reads(proxy, server, chain, gen_app) -> dict:
    """(d)'s reads through the proxy, each held against the server's own
    answer -> ms a read."""
    from cometbft_tpu_torch.light.provider import fetch_all_validators
    from cometbft_tpu_torch.rpc.client import RPCClient
    c = RPCClient(*proxy.addr, timeout=120)
    key = sorted(k for k in gen_app.prev_state
                 if gen_app.prev_state[k])[0].encode()
    reads = [("abci_query", {"path": "/store", "data": key.hex()},
              lambda: server.abci_query_prove("/store", key)),
             ("abci_query_absent", {"path": "/store",
                                    "data": b"no-such-key".hex()},
              lambda: server.abci_query_prove("/store", b"no-such-key"))]
    for h in PROXY_HEIGHTS:
        reads += [("block", {"height": h},
                   lambda h=h: server.call("block", height=h)),
                  ("commit", {"height": h},
                   lambda h=h: server.call("commit", height=h)),
                  ("validators", {"height": h},
                   lambda h=h: fetch_all_validators(server, height=h))]
    ms = {}
    for name, params, want in reads:
        method = name.split("_absent")[0]
        t0 = time.perf_counter()
        got = c.call(method, **params)
        ms[f"{name}@{params.get('height', '')}"] = \
            (time.perf_counter() - t0) * 1e3
        if got != want():
            raise AssertionError(f"light proxy: {name} {params} differs "
                                 f"from the server's")
        if name == "abci_query" and not (got["value"] and got["proof"]):
            raise AssertionError("light proxy: abci_query without proof")
    return ms


def run_light_proxy(torch, pkg, chain, gen_app, per_call: dict,
                    srv_rpc: int, lag) -> dict:
    """Part (d): the verifying light proxy on the card, built by
    `light/rpc.build_light_proxy` (what `cmd.main light` runs) with the
    server as primary and laggard (a) as witness, trusting block 1:
    abci_query (a key with its proof, an absent key), and block, commit
    and validators at two heights, each equal to the server's answer;
    then a proxy over a one-route stub in front of the server (its block
    at PROXY_FORGED_AT with a forged tx) must refuse that block. The
    shared signature cache is reset first (FlushCount)."""
    from cometbft_tpu_torch.light.rpc import build_light_proxy
    from cometbft_tpu_torch.ops import bls12
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.rpc.client import RPCClient, RPCClientError
    from cometbft_tpu_torch.rpc.server import RPCServer
    server = RPCClient("127.0.0.1", srv_rpc, timeout=120)
    witness = "%s:%d" % lag.rpc_server.addr
    root_hash = chain.blocks[0].hash().hex()
    reset_shared_cache()
    bls0 = dict(bls12.LAUNCHES)
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    proxy = build_light_proxy(chain.chain_id, f"127.0.0.1:{srv_rpc}",
                              [witness], trusted_height=1,
                              trusted_hash=root_hash,
                              trust_period=SS_TRUST_PERIOD_S, device="cuda")
    build_s = time.perf_counter() - t0
    proxy.start()
    try:
        ms = _verified_reads(proxy, server, chain, gen_app)
        if proxy.fatal is not None:
            raise AssertionError(f"light proxy: {proxy.fatal!r}")
    finally:
        proxy.stop()
    flushes = count.read("light proxy")
    bls_launches = _bls_since(bls0)

    def forged_block(**kw):
        r = server.call("block", **kw)
        if int(kw.get("height", 0)) == PROXY_FORGED_AT:
            r["block"]["data"]["txs"][0] = b"forged=1".hex()
        return r
    methods = {n: (lambda n=n: lambda **kw: server.call(n, **kw))()
               for n in ("health", "status", "commit", "header",
                         "validators", "abci_query")}
    methods["block"] = forged_block
    stub = RPCServer(None, "127.0.0.1", 0, methods=methods)
    stub.start()
    liar = build_light_proxy(chain.chain_id, "%s:%d" % stub.addr,
                             [witness], trusted_height=1,
                             trusted_hash=root_hash,
                             trust_period=SS_TRUST_PERIOD_S, device="cuda")
    liar.start()
    try:
        RPCClient(*liar.addr, timeout=120).call("block",
                                                height=PROXY_FORGED_AT)
        refused = None
    except RPCClientError as e:
        refused = str(e)
    finally:
        liar.stop()
        stub.stop()
    if refused is None or not refused.startswith("-32001"):
        raise AssertionError(f"light proxy: the forged block at "
                             f"{PROXY_FORGED_AT} was not refused: {refused}")
    return {"build_s": build_s, "read_ms": ms,
            "ms_per_read": float(np.mean(list(ms.values()))),
            "reads": len(ms), "flush_count": flushes,
            "launches": flushes["launches"], "bls_launches": bls_launches,
            "forged_refused": refused}


def run_bootstrap_state(torch, pkg, chain, per_call: dict, root: str,
                        srv_rpc: int, lag, ss_node_state) -> dict:
    """Part (e): `cmd.main bootstrap-state --height 115 --device cuda`
    into a fresh home from `cmd.main init` (the chain's genesis, the
    server and laggard (a) as rpc_servers, trusting block 1): its state
    store must hold the state (c) bootstrapped at 115, byte for byte."""
    from cometbft_tpu_torch.cmd.main import main as cli
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.db.kv import open_db
    from cometbft_tpu_torch.node.node import save_genesis
    from cometbft_tpu_torch.ops import bls12
    from cometbft_tpu_torch.pipeline.cache import reset_shared_cache
    from cometbft_tpu_torch.state.state import StateStore, _state_to_json
    home = os.path.join(root, "bootstrap")
    assert cli(["init", "--home", home, "--chain-id", chain.chain_id]) == 0
    cfg = Config.load(home)
    save_genesis(chain.genesis, cfg.path(cfg.base.genesis_file))
    _statesync_config(cfg, chain, f"127.0.0.1:{srv_rpc},"
                      "%s:%d" % lag.rpc_server.addr)
    cfg.write()
    reset_shared_cache()
    bls0 = dict(bls12.LAUNCHES)
    count = FlushCount(torch, pkg, per_call)
    t0 = time.perf_counter()
    rc = cli(["bootstrap-state", "--home", home, "--height",
              str(SS_SNAPSHOT), "--device", "cuda"])
    wall = time.perf_counter() - t0
    flushes = count.read("bootstrap-state")
    bls_launches = _bls_since(bls0)
    db = open_db(cfg.base.db_backend, "state", cfg.path(cfg.base.db_dir))
    got = StateStore(db).load()
    db.close()
    if rc != 0 or got is None or \
            _state_to_json(got) != _state_to_json(ss_node_state):
        raise AssertionError(f"bootstrap-state: rc {rc}, its state differs "
                             f"from the statesync node's at {SS_SNAPSHOT}")
    return {"wall_s": wall, "flush_count": flushes,
            "launches": flushes["launches"], "bls_launches": bls_launches}


def run_node_boot(torch, pkg, chain, gen_app, per_call: dict,
                  laps) -> dict:
    """The node-boot phase, in a directory under build/ removed after:
    the serving child comes up once; (a) `run_node_catchup`, then, while
    the server and laggard (a) still run, (c) `run_node_statesync`, (d)
    `run_light_proxy`, (e) `run_bootstrap_state`; then (b)
    `run_node_net`."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_node_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    t0 = time.perf_counter()
    try:
        srv_home = os.path.join(root, "server")
        srv_p2p, srv_rpc = _free_port(), _free_port()
        out = {"home_s": _write_node_home(chain, srv_home, srv_p2p,
                                          srv_rpc)}
        server = ServingNode(srv_home)
        lag = None
        try:
            out["catchup"], lag = run_node_catchup(
                torch, pkg, chain, gen_app, per_call, root, server,
                srv_p2p, srv_rpc)
            laps("node boot (a)")
            out["statesync"] = run_node_statesync(
                torch, pkg, chain, gen_app, per_call, root, srv_p2p,
                srv_rpc, lag)
            laps("node boot (c) statesync")
            out["light_proxy"] = run_light_proxy(
                torch, pkg, chain, gen_app, per_call, srv_rpc, lag)
            laps("node boot (d) light proxy")
            out["bootstrap_state"] = run_bootstrap_state(
                torch, pkg, chain, per_call, root, srv_rpc, lag,
                out["statesync"].pop("state"))
            laps("node boot (e) bootstrap-state")
        finally:
            if lag is not None:
                lag.stop()
            rc = server.stop()
            if rc != 0:
                raise RuntimeError(f"the serving node exited {rc}: "
                                   f"{server._stderr()}")
        out["net"] = run_node_net(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["pass_s"] = time.perf_counter() - t0
    return out


def print_node_boot(boot: dict, gpu: str) -> None:
    c, n = boot["catchup"], boot["net"]
    print(f"node boot: a fresh Node(device=cuda) from `cmd init` caught up "
          f"{c['blocks']} blocks x {c['validators']} validators from a "
          f"`cmd start` node (CPU, FileDB, up in {c['server_start_s']:.1f} "
          f"s) through start(): constructed in {c['construct_s']:.3f} s, "
          f"boot sync {c['sync_s']:.3f} s ({c['sigs_verified']} sigs, "
          f"{c['sigs_per_s']:.1f} sigs/s; tile {c['tile']}, batch "
          f"{c['batch']}, depth {c['depth']}; {c['tiles']} tiles, "
          f"{c['flush_count']['flushes']} flushes, "
          f"{c['flushes_per_tile']:.3f} a tile, "
          f"{c['flush_count']['canaries']} canary runs; trips "
          f"{c['canary']['trips']}, drains {c['drains']}), consensus at "
          f"{c['blocks'] + 1} {c['boot_to_consensus_s']:.3f} s after start();"
          f" RLC launches {c['launches']}; RPC status/block/commit/"
          f"validators equal the server's (health round trip "
          f"{c['rpc_ms']['laggard']['health']:.2f} ms the laggard, "
          f"{c['rpc_ms']['server']['health']:.2f} ms the server; ms a call "
          f"{c['rpc_ms']}); live net of 4 from `cmd testnet`: at height 1 "
          f"{n['boot_s']:.3f} s after start(), then {n['heights']} heights "
          f"in {n['wall_s']:.3f} s ({n['s_per_height']:.3f} s a height), "
          f"{len(n['tx_ms'])} broadcast_tx_commit "
          f"{n['tx_ms_median']:.1f} ms median a tx; {gpu}", flush=True)
    ss, lp, bs = boot["statesync"], boot["light_proxy"], \
        boot["bootstrap_state"]
    print(f"statesync: a fresh Node(device=cuda) from `cmd init` "
          f"([statesync] on, proxy_app tcp:// to a RecordingApp, sqlite "
          f"indexer) restored snapshot {ss['snapshot']} (refused "
          f"{[h for h, _ in ss['refused']]}) and blocksynced to the tip: "
          f"discovery {ss['discovery_s']:.3f} s, anchor "
          f"{ss['anchor_s']:.3f} s (trust root {ss['trust_root_s']:.3f} s; "
          f"{ss['anchor_flushes']} flushes, {ss['anchor_canaries']} canary "
          f"runs, {ss['anchor_sigs']} sigs, {ss['anchor_sigs_per_s']:.1f} "
          f"sigs/s), restore {ss['restore_s']:.3f} s, persist "
          f"{ss['persist_s']:.3f} s, blocksync {ss['blocksync_s']:.3f} s "
          f"({ss['blocksync_flushes']} flushes, {ss['blocksync_sigs']} "
          f"sigs, {ss['blocksync_sigs_per_s']:.1f} sigs/s), consensus at "
          f"the next height {ss['boot_to_consensus_s']:.3f} s after "
          f"start(); RLC launches {ss['launches']}; {ss['abci_calls']} "
          f"ABCI calls pass check_sequence; WebSocket NewBlock "
          f"{ss['websocket_heights']}; trips {ss['canary']['trips']}, "
          f"drains {ss['drains']}; {gpu}", flush=True)
    print(f"light proxy: build_light_proxy on cuda (trust root "
          f"{lp['build_s']:.3f} s), {lp['reads']} verified reads equal to "
          f"the server's, {lp['ms_per_read']:.1f} ms a read ({lp['read_ms']}"
          f"), {lp['flush_count']['flushes']} flushes, "
          f"{lp['flush_count']['canaries']} canary runs; forged block "
          f"refused ({lp['forged_refused']}); bootstrap-state --device cuda "
          f"at {ss['snapshot']} in {bs['wall_s']:.3f} s "
          f"({bs['flush_count']['flushes']} flushes), its state equal to "
          f"the statesync node's; {gpu}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # generate_chain's own default; with it, the signature tampered at
    # height 7 keeps a decodable R, so the RLC equation fails and the
    # tile is attributed per lane
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--bls-cycles", action="store_true",
                    help="only build BLS_MICRO_CU and print its cycles")
    ap.add_argument("--serve-peer", metavar="DIR",
                    help="serve the FileDB block stores under DIR over p2p "
                         "on the CPU (the p2p phase's child process)")
    args = ap.parse_args(argv)
    if args.serve_peer:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return serve_peer(args.serve_peer)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cometbft_tpu_torch.crypto import ref_ed25519 as ref
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import cuda_verify as cv
    from cometbft_tpu_torch.ops import ed25519 as ped
    from cometbft_tpu_torch.ops import edwards as ed
    from cometbft_tpu_torch.ops import field as fe
    from cometbft_tpu_torch.ops import scalar as sc
    pkg = dict(ref=ref, cv=cv, ped=ped, ed=ed, fe=fe, sc=sc)
    dev = torch.device("cuda")
    gpu = _gpu_line()
    if args.bls_cycles:
        cycles, text = bls_cycles(torch, _build, 9)
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill")):
                print(f"ptxas bls_micro: {line.strip()}")
        print(f"gpu: {gpu}")
        print(json.dumps({"bls_cycles": cycles, "gpu": gpu}), flush=True)
        return 0

    # phase 1: build
    laps = Laps()
    t0 = time.perf_counter()
    log = _build.build_all(verbose=True)
    for name in ("kvlog", "aead", "ed25519"):  # host C++, with g++
        _build.host_lib(name)
        log[f"host/{name}"] = _build.BUILD_LOG[f"host/{name}"]
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f}s wall, " + ", ".join(
        f"{k} {v['seconds']:.1f}s" for k, v in log.items()), flush=True)
    for name, v in log.items():
        for line in v["output"].splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                print(f"ptxas {name}: {line.strip()}")
    print(f"gpu: {gpu}", flush=True)
    # whether the gRPC transports (ROADMAP.md Queue 1 items 11.2, 11.4)
    # could run on this host: the port does not import grpc
    import importlib.util
    print(f"grpc_importable: {importlib.util.find_spec('grpc') is not None}",
          flush=True)
    laps("build")

    # phase 2: the chains, from --seed, and the seam's tile
    t0 = time.perf_counter()
    pipe_chain, pipe_app = make_chain(args.seed, PIPE_BLOCKS)
    pipe_gen_s = time.perf_counter() - t0
    print(f"pipeline chain: {PIPE_BLOCKS} blocks x {VALIDATORS} validators, "
          f"{pipe_gen_s:.1f}s to generate", flush=True)
    t0 = time.perf_counter()
    chain, gen_app = chain_prefix(pipe_chain, BLOCKS)
    gen_s = time.perf_counter() - t0
    tile, marshal_s = tile_from_chain(ref, chain, LANES)
    print(f"chain: its first {BLOCKS} blocks, the generator's app replayed "
          f"in {gen_s:.1f}s; tile: their first {LANES} lanes", flush=True)
    laps("chains")

    # phase 3: kernels against their plain versions
    report: dict = {}
    add_args = check_kernels(torch, pkg, tile, dev, report)
    print(f"kernels match their plain versions at N={LANES} (decompression "
          f"at 2N={2 * LANES}, A and R in one call, and at N; N={RAGGED} "
          f"for decompression, window sums and additions, N={CHUNKS} for "
          f"window sums; epilogue at M = {report['rlc_epilogue']['m_held']})",
          flush=True)
    where = breakdown(torch, pkg, tile, dev)
    laps("kernel holds")
    check_bls_kernels(torch, dev, report)
    print(f"bls kernels match their plain versions "
          f"at B = {', '.join(map(str, BLS_BUCKETS))} (final Fq12 limbs and "
          f"verdicts, max_abs_err 0; lanes against the host oracle, the "
          f"1-pair, all-identity, zero and pad lanes among them; "
          f"bls_hard_pow also at a 40-bit exponent)", flush=True)
    laps("bls holds")

    # phase 4: the paths, counts zeroed just before each, read just after
    rlc = ("pt_decompress_tiled", "rlc_window_sums", "rlc_epilogue")
    e2e: dict = {}
    cv.reset_launches()
    run_main_path(torch, pkg, tile, e2e)
    seam = _read_path(cv.LAUNCHES, "seam", rlc)
    laps("main path")

    sync = run_blocksync(torch, pkg, chain, gen_app, args.seed)
    launches = _read_path(sync["launches"], "blocksync", rlc)
    if sync["tiles_flushed"] != 2 or sync["banned"] or not sync["rlc_pass"]:
        raise AssertionError(f"clean sync: {sync}")
    # the same sync again: twice more timed (the spread within one call),
    # once under the profiler (the card's idle share over a sync)
    sync["repeat_wall_s"] = [
        run_blocksync(torch, pkg, chain, gen_app, args.seed)["wall_s"]
        for _ in range(2)]
    prof = run_blocksync(torch, pkg, chain, gen_app, args.seed, profile=True)
    sync["profiled"] = prof["profiled"]
    counted = {k: prof["launches"][k] for k in rlc}
    profiled = {k: sync["profiled"]["launches_by_kernel"][k] for k in rlc}
    if counted != profiled or counted != {k: launches[k] for k in rlc}:
        raise AssertionError(f"sync launches: counted {counted}, profiled "
                             f"{profiled}, first sync {launches}")

    s = chain.blocks[6].last_commit.signatures[0].signature
    r_decodes = ref.pt_decompress(bytes([s[0] ^ 1]) + s[1:32]) is not None
    bad = run_blocksync(torch, pkg, chain, gen_app, args.seed, {7: "sig"})
    bad_launches = _read_path(bad["launches"], "blocksync, tampered", rlc)
    if not bad["banned"] or bad["banned"][0] not in (6, 7):
        raise AssertionError(f"tampered sync banned {bad['banned']}")
    if r_decodes and not bad["per_lane"]:
        raise AssertionError("the tampered tile was not attributed per lane")
    laps("blocksync")

    pipe = run_pipeline(torch, pkg, pipe_chain, pipe_app, args.seed)
    for d, f in pipe["depths"].items():
        idle = f["profiled"]["idle_share"]
        print(f"pipelined catch-up, depth {d}: "
              f"{f['sigs_per_s']['median']:.1f} sigs/s median "
              f"({f['sigs_verified']} sigs; wall "
              f"{', '.join(f'{w:.3f}' for w in f['wall_s']['runs'])} s; "
              f"card idle "
              f"{'not measured' if idle is None else f'{idle:.3f}'} of a "
              f"profiled sync)", flush=True)
    laps("pipelined")
    server = run_device_server(torch, pkg, tile, chain, gen_app, args.seed)
    print(f"device server: {server['stats']}; two clients of "
          f"{SERVER_LANES} lanes in {server['two_clients_s']:.3f} s "
          f"({server['two_clients_flushes']} flush(es)); 48-block sync at "
          f"depth 2 through it {server['sync']['wall_s']:.3f} s", flush=True)
    laps("device server")

    per_call = {k: report[k]["launches_per_call"] for k in rlc}
    light = run_light_client(torch, pkg, chain, per_call)
    seq = light["sequential"]
    print(f"light client: {seq['headers_per_s']:.1f} headers/s sequential "
          f"({seq['ms_per_header']:.2f} ms a header, {seq['flushes']} "
          f"flushes, {seq['canaries']} canary runs; card idle "
          f"{seq['profiled']['idle_share']:.3f} of a profiled pass); "
          f"forged witness: "
          f"{light['forged_witness']['error']}; tampered commit: "
          f"{light['tampered_commit']['error']}; launches "
          f"{light['launches']}", flush=True)
    laps("light client")
    mixed = run_mixed_set(torch, pkg, chain, args.seed, per_call)
    print(f"mixed set {MIXED_SET}: seam flush "
          f"{mixed['seam_clean']['wall_s']:.3f} s clean, "
          f"{mixed['seam_one_bad_per_curve']['wall_s']:.3f} s with one bad "
          f"lane per curve; verify_commit "
          f"{mixed['verify_commit_clean']['wall_s']:.3f} s; tile of "
          f"{mixed['tile']['commits']} commits "
          f"{mixed['tile']['wall_s']:.3f} s; its chain of "
          f"{MIXED_BLOCKS} blocks x {mixed['sync']['validators']} "
          f"validators synced at depth 2 in "
          f"{mixed['sync']['clean']['wall_s']:.3f} s "
          f"({mixed['sync']['clean']['flush_count']['flushes']} flushes), "
          f"tampered: banned {mixed['sync']['tampered']['banned']}; "
          f"launches {mixed['launches']}; "
          f"host ms a signature {mixed['host_ms']}", flush=True)
    laps("mixed set")

    aggsig, agg_chain, agg_app = run_aggsig(torch, args.seed)
    print_aggsig(aggsig, gpu)
    laps("aggsig")
    t0 = time.perf_counter()
    seal = run_sealsync(torch, agg_chain, agg_app, args.seed)
    seal["pass_s"] = time.perf_counter() - t0
    print_sealsync(seal, gpu)
    laps("seal sync")
    t0 = time.perf_counter()
    p2p = run_p2p(torch, pkg, pipe_chain, pipe_app, agg_chain, args.seed)
    p2p["pass_s"] = time.perf_counter() - t0
    print_p2p(p2p, gpu)
    laps("p2p")
    t0 = time.perf_counter()
    farm = run_farm(torch, pkg, chain, light, per_call)
    farm["pass_s"] = time.perf_counter() - t0
    print_farm(farm, gpu)
    laps("farm")
    t0 = time.perf_counter()
    ingest = run_ingest(torch, pkg, args.seed, per_call)
    ingest["pass_s"] = time.perf_counter() - t0
    print_ingest(ingest, gpu)
    laps("tx admission")

    cons = run_consensus(torch, pkg, chain, gen_app, agg_chain, agg_app,
                         args.seed, per_call)
    print_consensus(cons, gpu)
    laps("consensus")
    boot = run_node_boot(torch, pkg, pipe_chain, pipe_app, per_call, laps)
    print_node_boot(boot, gpu)
    laps("node boot (b)")

    cv.reset_launches()
    run_pt_add_ab(torch, pkg, add_args, report)
    ab = _read_path(cv.LAUNCHES, "pt_add_tiled A/B", ("pt_add_tiled",))
    laps("pt_add A/B")

    # phase 5: report
    kernels = []
    for name, (src, line) in KERNELS.items():
        r = report[name]
        row = {
            "name": name, "route": "cuda",
            "source": f"cometbft_tpu_torch/csrc/{src}",
            "replaces": f"cometbft_tpu/ops/pallas_verify.py:{line}",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "on_node_path": name in rlc,
            "launches_seam": seam[name],
            "launches_tampered_sync": bad_launches[name],
            "launches_profiled_sync": profiled.get(name),
            "launches_pipelined_sync": {
                d: f["launches"][name] for d, f in pipe["depths"].items()},
            "launches_device_server": server["launches"][name],
            "launches_server_sync": server["sync"]["launches"][name],
            "launches_light_client": light["launches"][name],
            "launches_mixed_set": mixed["launches"][name],
            "launches_farm": farm["launches"][name] +
            farm["forged"]["launches"][name],
            "launches_ingest": ingest["launches"][name] +
            ingest["shed"]["launches"][name],
            "launches_p2p_sync": {
                **{k: f["launches"][name] for k, f in p2p["syncs"].items()},
                **{f"restart_{k}": p2p["restart"][k]["launches"][name]
                   for k in ("first", "resumed")}},
            "launches_consensus": {
                "catchup": cons["catchup"]["launches"][name],
                "add_votes": cons["add_votes"]["launches"][name]},
            "launches_node_boot": boot["catchup"]["launches"][name],
            **{f"launches_{part}": boot[part]["launches"][name]
               for part in ("statesync", "light_proxy", "bootstrap_state")},
            **{k: r[k] for k in ("launches_per_call",
                                 "launches_per_call_profiled", "lanes", "m")
               if k in r}}
        if name == "rlc_epilogue":
            row["m128"] = {**r["m128"], "ms": r["m128_ms"]}
        if name == "pt_decompress_tiled":
            row["at_n"] = {"lanes": LANES, "ms": r["n_ms"]}
        if name == "pt_add_tiled":
            row["at_8_lanes"] = {"ms": r["lanes8_ms"]}
        if name == "pt_add_tiled":
            row["launches"] = ab[name]      # its own phase: the A/B
        kernels.append(row)
    kernels += bls_kernel_rows(report, aggsig, seal, p2p)
    for row in kernels[-len(BLS_KERNELS):]:
        row["launches_consensus_seal"] = {
            k: cons["seal"][k]["launches"][row["name"]]
            for k in ("forged", "adopt")}
        row["launches_node_boot"] = \
            boot["catchup"]["bls_launches"].get(row["name"], 0)
        for part in ("statesync", "light_proxy", "bootstrap_state"):
            row[f"launches_{part}"] = boot[part]["bls_launches"][row["name"]]
    for fig in (sync, bad):
        fig["verify_s"] = fig["span_s"].get("blocksync.verify", 0.0)
        fig["fetch_s"] = fig["span_s"].get("blocksync.fetch", 0.0)
        fig["apply_s"] = fig["span_s"].get("blocksync.apply", 0.0)
    print(json.dumps({"timing": {
        "kernels": {k: {"ms": report[k]["ms"],
                        "call_ms": report[k]["call_ms"],
                        "plain_ms": report[k]["plain_ms"]} for k in KERNELS},
        "profile_tries": report["profile_tries"],
        "blocksync": {"clean": sync, "tampered": bad,
                      "tampered_r_decodes": r_decodes},
        "pipeline": pipe, "device_server": server,
        "light_client": light, "mixed_set": mixed, "aggsig": aggsig,
        "sealsync": seal, "p2p": p2p, "farm": farm, "ingest": ingest,
        "consensus": cons, "node_boot": boot,
        "bls_kernels": {k: report[k] for k in BLS_KERNELS},
        "pipe_chain_s": pipe_gen_s,
        "chain_s": gen_s, "commit_marshal_s": marshal_s, "e2e": e2e,
        "breakdown": where, "lanes": LANES,
        "build_s": build_s, "phase_s": laps.took,
        "canary": ped.canary_stats(), "gpu": gpu}}),
        flush=True)
    print(f"blocksync: {sync['sigs_per_s']:.1f} sigs/s catch-up "
          f"({sync['sigs_verified']} sigs in {sync['wall_s']:.3f} s; "
          f"verify_tile {sync['verify_s']:.3f} s, fetch "
          f"{sync['fetch_s']:.3f} s, apply {sync['apply_s']:.3f} s; "
          f"repeats {', '.join(f'{w:.3f}' for w in sync['repeat_wall_s'])}"
          f" s; card idle "
          f"{sync['profiled']['idle_share']:.3f} of a profiled sync), "
          f"{gpu}")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
