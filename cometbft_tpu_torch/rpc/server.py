"""JSON-RPC 2.0 server over HTTP with the core route table
(reference rpc/jsonrpc/server/http_server.go:56, rpc/core/routes.go,
rpc/core/env.go).

Both calling conventions the reference supports:
  POST /            {"jsonrpc":"2.0","method":...,"params":{...},"id":...}
  GET  /<method>?param=value          (URI convention)
Binary params are hex strings (the reference uses 0x-hex/base64 per
field; here hex uniformly). Event subscriptions are pushed over a
WebSocket (GET /websocket with an Upgrade, `rpc/websocket.py`) or
long-polled (`wait_event`) — same pubsub semantics behind the node's
event bus.

Copy of `cometbft_tpu/rpc/server.py` in the port, every route and the
WebSocket endpoint kept. `stop()` also closes every live WebSocket
session before it joins the handler threads.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from ..pubsub.query import Query, QueryError
from ..trace import shared_tracer
from ..types.block import tx_hash


class RPCError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class RPCEnvironment:
    """Handles the route table reads from (reference rpc/core/env.go)."""

    def __init__(self, chain_id: str, block_store=None, state_store=None,
                 mempool=None, consensus=None, event_bus=None,
                 tx_indexer=None, block_indexer=None, app_query=None,
                 genesis=None, switch=None, state_getter=None,
                 evidence_pool=None, unsafe=False, farm=None,
                 ingest=None, sealsync=None):
        self.chain_id = chain_id
        # farm/service.VerificationFarm when the node serves light
        # verification as a product; None leaves the light_* routes
        # unmounted
        self.farm = farm
        # sealsync/provider.SealProvider when the node serves aggregate
        # seals for catch-up (docs/SEALSYNC.md); None leaves the seal_*
        # routes unmounted
        self.sealsync = sealsync
        # ingest/admission.IngestPipeline when [mempool] ingest_batch
        # is on: broadcast_tx_* then park on a batch ticket instead of
        # walking a synchronous check_tx (docs/INGEST.md)
        self.ingest = ingest
        self.block_store = block_store
        self.state_store = state_store
        self.mempool = mempool
        self.consensus = consensus
        self.event_bus = event_bus
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.app_query = app_query
        self.genesis = genesis
        self.switch = switch
        self.evidence_pool = evidence_pool
        self.unsafe = unsafe
        self.state_getter = state_getter or (
            (lambda: consensus.state) if consensus else (lambda: None))


from .codec import (block_id_json as _block_id_json,
                    header_json as _header_json, commit_json,
                    proof_json, validator_set_json)


class Routes:
    """reference rpc/core/routes.go — each method maps 1:1."""

    def __init__(self, env: RPCEnvironment):
        self.env = env

    # --- info ----------------------------------------------------------------

    def health(self) -> dict:
        return {}

    def status(self) -> dict:
        env = self.env
        st = env.state_getter()
        h = env.block_store.height() if env.block_store else 0
        meta = env.block_store.load_block_meta(h) if h else None
        return {
            "node_info": {"network": env.chain_id},
            "sync_info": {
                "latest_block_height": h,
                "latest_block_hash": (meta[0].hash.hex() if meta else ""),
                "latest_app_hash": (st.app_hash.hex() if st else ""),
                "catching_up": False,
            },
        }

    def net_info(self) -> dict:
        peers = self.env.switch.peers() if self.env.switch else []
        return {"n_peers": len(peers),
                "peers": [{"node_id": p.id,
                           "moniker": p.node_info.moniker} for p in peers]}

    def genesis(self) -> dict:
        g = self.env.genesis
        if g is None:
            raise RPCError(-32603, "genesis not available")
        return {"chain_id": g.chain_id,
                "initial_height": g.initial_height,
                "validators": [
                    {"pub_key": v.pub_key.bytes_().hex(),
                     "power": v.voting_power} for v in g.validators]}

    # --- blocks --------------------------------------------------------------

    def _height_or_latest(self, height) -> int:
        h = int(height) if height is not None else \
            self.env.block_store.height()
        if not (self.env.block_store.base() <= h
                <= self.env.block_store.height()):
            raise RPCError(-32603, f"height {h} not available")
        return h

    def block(self, height=None) -> dict:
        h = self._height_or_latest(height)
        blk = self.env.block_store.load_block(h)
        meta = self.env.block_store.load_block_meta(h)
        return {"block_id": _block_id_json(meta[0]),
                "block": {
                    "header": _header_json(blk.header),
                    "data": {"txs": [t.hex() for t in blk.data.txs]},
                    "evidence": len(blk.evidence),
                }}

    def blockchain(self, min_height=None, max_height=None) -> dict:
        top = self.env.block_store.height()
        lo = int(min_height) if min_height is not None else max(1, top - 19)
        hi = min(int(max_height) if max_height is not None else top, top)
        metas = []
        for h in range(hi, max(lo, self.env.block_store.base()) - 1, -1):
            m = self.env.block_store.load_block_meta(h)
            if m is not None:
                metas.append({"height": h,
                              "block_id": _block_id_json(m[0])})
        return {"last_height": top, "block_metas": metas}

    def commit(self, height=None) -> dict:
        """Full signed header (reference rpc/core/blocks.go Commit):
        the canonical commit when block h+1 is stored, else the seen
        commit — enough for a light client to reconstruct and verify."""
        h = self._height_or_latest(height)
        # one meta key read — this is the light provider's hot path
        # (one /commit per verified height); reassembling the block from
        # its parts just to read the header would cost O(block size)
        hdr = self.env.block_store.load_block_meta(h)[1]
        c = self.env.block_store.load_block_commit(h)
        canonical = c is not None
        if c is None:
            c = self.env.block_store.load_seen_commit(h)
        if c is None:
            raise RPCError(-32603, f"no commit for height {h}")
        return {"signed_header": {"header": _header_json(hdr),
                                  "commit": commit_json(c)},
                "canonical": canonical}

    def header(self, height=None) -> dict:
        h = self._height_or_latest(height)
        hdr = self.env.block_store.load_block_meta(h)[1]
        return {"header": _header_json(hdr)}

    def block_results(self, height=None) -> dict:
        """reference rpc/core/blocks.go BlockResults, served from the
        retained FinalizeBlock responses (state/store.go)."""
        h = self._height_or_latest(height)
        raw = (self.env.state_store.load_finalize_block_response(h)
               if self.env.state_store else None)
        if raw is None:
            raise RPCError(
                -32603, f"no results for height {h} (pruned, or "
                        f"[storage] discard_abci_responses is set)")
        from ..abci.application import ResponseFinalizeBlock
        resp = ResponseFinalizeBlock.decode(raw)
        return {
            "height": h,
            "txs_results": [
                {"code": r.code, "data": r.data.hex(), "log": r.log,
                 "gas_wanted": r.gas_wanted, "gas_used": r.gas_used}
                for r in resp.tx_results],
            "validator_updates": [
                {"pub_key_type": u.pub_key_type,
                 "pub_key_bytes": u.pub_key_bytes.hex(),
                 "power": u.power}
                for u in resp.validator_updates],
            "consensus_param_updates": resp.consensus_param_updates,
            "app_hash": resp.app_hash.hex(),
        }

    def broadcast_evidence(self, evidence="") -> dict:
        """reference rpc/core/evidence.go BroadcastEvidence: verify +
        admit into the pool (whence the gossip reactor floods it)."""
        if self.env.evidence_pool is None:
            raise RPCError(-32603, "evidence pool not available")
        from ..types.evidence import EvidenceError, decode_evidence
        try:
            ev = decode_evidence(bytes.fromhex(evidence))
        except (ValueError, KeyError, IndexError) as e:
            raise RPCError(-32602, f"malformed evidence: {e}")
        try:
            self.env.evidence_pool.add_evidence(
                ev, self.env.state_getter())
        except EvidenceError as e:
            raise RPCError(-32603, f"evidence rejected: {e}")
        return {"hash": ev.hash().hex().upper()}

    def _dial(self, csv: str, persistent: bool) -> dict:
        if self.env.switch is None:
            raise RPCError(-32603, "p2p switch not available")
        if not csv:
            raise RPCError(-32602, "no addresses provided")
        dialed = []
        for addr in csv.split(","):
            host, _, port = addr.strip().rpartition(":")
            try:
                if persistent:
                    self.env.switch.add_persistent_peer(host, int(port))
                else:
                    self.env.switch.dial(host, int(port))
                dialed.append(addr.strip())
            except (OSError, ValueError):
                continue  # reference logs and moves on
        return {"log": f"dialed {len(dialed)} addresses"}

    def dial_seeds(self, seeds="") -> dict:
        """reference rpc/core/net.go UnsafeDialSeeds (one-shot dials)."""
        return self._dial(seeds, persistent=False)

    def dial_peers(self, peers="", persistent=False) -> dict:
        """reference rpc/core/net.go UnsafeDialPeers."""
        if isinstance(persistent, str):
            persistent = persistent.lower() in ("1", "true", "yes")
        return self._dial(peers, persistent=persistent)

    def unsafe_flush_mempool(self) -> dict:
        """reference rpc/core/mempool.go UnsafeFlushMempool."""
        if self.env.mempool is None:
            raise RPCError(-32603, "mempool not available")
        self.env.mempool.flush()
        return {}

    def validators(self, height=None, page=1, per_page=30) -> dict:
        """reference rpc/core/consensus.go Validators (paginated — a
        200-validator set exceeds sane single responses)."""
        h = self._height_or_latest(height)
        vals = (self.env.state_store.load_validators(h)
                if self.env.state_store else None)
        if vals is None:
            raise RPCError(-32603, f"no validator set at height {h}")
        js = validator_set_json(vals)
        window, total = self._paginate(js["validators"], page,
                                       per_page, "asc")
        return {"block_height": h, "validators": window,
                "proposer": js["proposer"],
                "count": len(window), "total": total}

    # --- ABCI ----------------------------------------------------------------

    def abci_info(self) -> dict:
        info = self.env.app_query.info()
        return {"data": info.data, "version": info.version,
                "last_block_height": info.last_block_height,
                "last_block_app_hash": info.last_block_app_hash.hex()}

    def abci_query(self, path="", data="", prove=False) -> dict:
        if isinstance(prove, str):  # GET query-string form
            prove = prove.lower() in ("1", "true", "yes")
        if prove:
            code, value, height, pf = self.env.app_query.query_prove(
                path, bytes.fromhex(data))
            out = {"code": code, "value": value.hex(), "height": height}
            if pf is not None:
                out["proof"] = proof_json(pf)
            return out
        code, value = self.env.app_query.query(path, bytes.fromhex(data))
        return {"code": code, "value": value.hex()}

    # --- txs -----------------------------------------------------------------

    def broadcast_tx_sync(self, tx="") -> dict:
        """Admit a tx. With the ingest pipeline mounted, the request
        PARKS on a future until its coalesced signature batch settles
        (the async ingest seam — docs/INGEST.md); a full admission
        queue sheds with the retryable -32005 overload code. Without
        it, the original synchronous check_tx path."""
        raw = bytes.fromhex(tx)
        ing = self.env.ingest
        if ing is not None:
            from ..ingest import IngestShed
            # trace root for the whole admission chain: rpc root ->
            # ingest.admit (child, rides the ticket) -> the coalesced
            # flush links back here — the causal chain the flight
            # recorder reconstructs after a shed/quarantine event
            with shared_tracer().start("rpc.broadcast_tx",
                                       route="sync") as span:
                try:
                    ticket = ing.submit(raw, ctx=span)
                except IngestShed as e:
                    raise RPCError(-32005, f"ingest overloaded: {e}")
                except ValueError as e:
                    raise RPCError(-32603, str(e)) from e
                ing.wait([ticket])
                if ticket.error is not None:
                    raise RPCError(-32603, str(ticket.error))
                span.set_attr("code", ticket.code)
                return {"code": ticket.code,
                        "hash": tx_hash(raw).hex().upper()}
        try:
            code = self.env.mempool.check_tx(raw)
        except ValueError as e:
            raise RPCError(-32603, str(e)) from e
        return {"code": code, "hash": tx_hash(raw).hex().upper()}

    def broadcast_tx_async(self, tx="") -> dict:
        import threading as _t
        raw = bytes.fromhex(tx)
        _t.Thread(target=lambda: self._checked(raw), daemon=True).start()
        return {"hash": tx_hash(raw).hex().upper()}

    def _checked(self, raw: bytes) -> None:
        ing = self.env.ingest
        if ing is not None:
            # fire-and-forget through the batch path: the waiter's
            # cooperative flush (or the background flusher) settles it
            with shared_tracer().start("rpc.broadcast_tx",
                                       route="async") as span:
                ticket = ing.submit_nowait(raw, ctx=span)
                if ticket is not None:
                    try:
                        ing.wait([ticket])
                    except RuntimeError:
                        pass
            return
        try:
            self.env.mempool.check_tx(raw)
        except ValueError:
            pass

    def unconfirmed_txs(self, limit=None) -> dict:
        n = int(limit) if limit is not None else 30
        txs = self.env.mempool.reap_max_txs(n)
        return {"n_txs": len(txs), "total": self.env.mempool.size(),
                "total_bytes": self.env.mempool.size_bytes(),
                "txs": [t.hex() for t in txs]}

    def tx(self, hash="", prove=False) -> dict:
        got = self.env.tx_indexer.get(bytes.fromhex(hash))
        if got is None:
            raise RPCError(-32603, f"tx {hash} not found")
        height, index, raw, code = got
        out = {"hash": hash, "height": height, "index": index,
               "tx": raw.hex(), "tx_result": {"code": code}}
        if isinstance(prove, str):  # GET query-string form
            prove = prove.lower() in ("1", "true", "yes")
        if prove:
            # inclusion proof against the block's data_hash (reference
            # rpc/core/tx.go Tx w/ prove → types.Tx.Proof): data_hash =
            # merkle over the tx list, so the proof binds the tx to the
            # (light-verifiable) header
            blk = self.env.block_store.load_block(height)
            if blk is None:
                raise RPCError(-32603, f"block {height} pruned")
            from ..crypto.merkle import proofs_from_byte_slices
            # Data.hash leaves are sha256(tx) (types/block.py:344), so
            # the proof's leaf is the tx HASH; a verifier checks
            # proof.verify(header.data_hash, sha256(raw_tx))
            root, proofs = proofs_from_byte_slices(
                [tx_hash(t) for t in blk.data.txs])
            out["proof"] = {"root_hash": root.hex(),
                            "data": raw.hex(),
                            "proof": proof_json(proofs[index])}
        return out

    @staticmethod
    def _paginate(items, page, per_page, order_by):
        """reference rpc search pagination: 1-based pages, desc option;
        total_count is the FULL match count, not the window size."""
        if str(order_by).lower() == "desc":
            items = list(reversed(items))
        page = max(1, int(page))
        per_page = min(max(1, int(per_page)), 100)
        lo = (page - 1) * per_page
        return items[lo:lo + per_page], len(items)

    # search results beyond this many matches are not reachable by any
    # page (an unbounded walk over the postings would let one query pin
    # the node); total_count saturates at the cap
    SEARCH_CAP = 10_000

    def tx_search(self, query="", page=1, per_page=30,
                  order_by="asc", limit=None) -> dict:
        try:
            q = Query(query)
        except QueryError as e:
            raise RPCError(-32602, f"bad query: {e}") from e
        hashes = self.env.tx_indexer.search(
            q, int(limit) if limit else self.SEARCH_CAP)
        # the indexer returns an unordered match SET: resolve and sort
        # by (height, index) BEFORE paginating, or page windows would be
        # hash-seed-dependent (duplicates/gaps across pages)
        resolved = []
        for hsh in hashes:
            got = self.env.tx_indexer.get(hsh)
            if got:
                resolved.append((got[0], got[1], hsh, got[2]))
        resolved.sort(key=lambda r: (r[0], r[1]))
        window, total = self._paginate(resolved, page, per_page, order_by)
        return {"txs": [{"hash": h.hex().upper(), "height": ht,
                         "index": ix, "tx": raw.hex()}
                        for ht, ix, h, raw in window],
                "total_count": total}

    def block_search(self, query="", page=1, per_page=30,
                     order_by="asc", limit=None) -> dict:
        try:
            q = Query(query)
        except QueryError as e:
            raise RPCError(-32602, f"bad query: {e}") from e
        heights = self.env.block_indexer.search(
            q, int(limit) if limit else self.SEARCH_CAP)
        window, total = self._paginate(heights, page, per_page, order_by)
        return {"blocks": [self.block(h) for h in window],
                "total_count": total}

    # --- consensus introspection (rpc/core/consensus.go) ----------------------

    def consensus_state(self) -> dict:
        """Compact round-state summary (reference /consensus_state)."""
        cs = self.env.consensus
        if cs is None:
            raise RPCError(-32603, "no consensus engine")
        rs = cs.rs
        return {"round_state": {
            "height": rs.height, "round": rs.round, "step": rs.step,
            "proposal": rs.proposal is not None,
            "proposal_block": rs.proposal_block is not None,
            "locked_round": rs.locked_round,
            "valid_round": rs.valid_round}}

    def dump_consensus_state(self) -> dict:
        """Verbose round state incl. vote bitmaps (reference
        /dump_consensus_state)."""
        cs = self.env.consensus
        if cs is None:
            raise RPCError(-32603, "no consensus engine")
        rs = cs.rs
        votes = []
        if rs.votes is not None:
            from ..types.vote import PREVOTE_TYPE, PRECOMMIT_TYPE
            for r in range(rs.round + 1):
                # read-only: create=False — lazily creating a VoteSet
                # from the RPC thread would race the consensus writer's
                # own lazy creation and could drop a just-added vote
                pv = rs.votes._get(r, PREVOTE_TYPE, create=False)
                pc = rs.votes._get(r, PRECOMMIT_TYPE, create=False)
                votes.append({
                    "round": r,
                    "prevotes_bits": repr(pv.votes_bit_array)
                    if pv else "",
                    "precommits_bits": repr(pc.votes_bit_array)
                    if pc else ""})
        out = self.consensus_state()
        out["round_state"]["height_vote_set"] = votes
        peers = self.env.switch.peers() if self.env.switch else []
        out["peers"] = [p.id for p in peers]
        return out

    def consensus_params(self, height=None) -> dict:
        st = self.env.state_getter()
        if st is None:
            raise RPCError(-32603, "no state")
        if height is not None and int(height) != st.last_block_height:
            # params are not retained per height in this store; answer
            # honestly rather than mislabeling current params
            raise RPCError(
                -32603, "historical consensus_params not retained; "
                "omit height for the current params")
        p = st.consensus_params
        return {"block_height": st.last_block_height,
                "consensus_params": {
                    "block": {"max_bytes": p.max_block_bytes,
                              "max_gas": p.max_gas},
                    "evidence": {
                        "max_age_num_blocks":
                            p.evidence_max_age_num_blocks,
                        "max_age_seconds": p.evidence_max_age_seconds,
                        "max_bytes": p.evidence_max_bytes},
                    "feature": {"vote_extensions_enable_height":
                                p.vote_extensions_enable_height,
                                "pbts_enable_height":
                                p.pbts_enable_height}}}

    # --- more block/tx conveniences (rpc/core/blocks.go) ----------------------

    def block_by_hash(self, hash="") -> dict:
        want = bytes.fromhex(hash)
        store = self.env.block_store
        h = store.height_by_hash(want)
        if h is None:
            # stores written before the BH: index: bounded recent scan
            top = store.height()
            for hh in range(top, max(store.base(), top - 1000) - 1, -1):
                meta = store.load_block_meta(hh)
                if meta is not None and meta[0].hash == want:
                    h = hh
                    break
        if h is None or not (store.base() <= h <= store.height()):
            raise RPCError(-32603, f"block {hash} not found")
        return self.block(h)

    def header_by_hash(self, hash="") -> dict:
        return {"header": self.block_by_hash(hash)["block"]["header"]}

    def num_unconfirmed_txs(self) -> dict:
        return {"n_txs": self.env.mempool.size(),
                "total": self.env.mempool.size(),
                "total_bytes": self.env.mempool.size_bytes()}

    def check_tx(self, tx="") -> dict:
        """Run CheckTx without adding to the mempool (reference
        /check_tx → app CheckTx on the query path). With the ingest
        pipeline mounted, the tx-hash duplicate filter and the
        SigCache are consulted FIRST: a tx the admission path already
        knows answers without an app round trip, and a signed
        envelope's verdict rides the cache — `cached` reports when
        either shortcut fired."""
        raw = bytes.fromhex(tx)
        ing = self.env.ingest
        cached = False
        if ing is not None:
            from ..ingest import CODE_BAD_SIGNATURE
            known, sig_ok, sig_cached = ing.query_cached(raw)
            if known:
                return {"code": 0, "log": "tx already known to the "
                        "admission filter", "gas_wanted": 0,
                        "cached": True}
            if sig_ok is False:
                return {"code": CODE_BAD_SIGNATURE,
                        "log": "invalid envelope signature",
                        "gas_wanted": 0, "cached": sig_cached}
            cached = sig_cached
        r = self.env.app_query.check_tx(raw)
        return {"code": r.code, "log": r.log,
                "gas_wanted": r.gas_wanted, "cached": cached}

    def genesis_chunked(self, chunk=None) -> dict:
        import base64
        import json as _json
        chunks = getattr(self, "_genesis_chunks", None)
        if chunks is None:  # serialize once; genesis never changes
            blob = _json.dumps(self.genesis(), sort_keys=True).encode()
            size = 16 * 1024
            chunks = [blob[i:i + size]
                      for i in range(0, len(blob), size)] or [b""]
            self._genesis_chunks = chunks
        i = int(chunk) if chunk is not None else 0
        if not (0 <= i < len(chunks)):
            raise RPCError(-32603, f"chunk {i} out of range")
        return {"chunk": i, "total": len(chunks),
                "data": base64.b64encode(chunks[i]).decode()}

    def broadcast_tx_commit(self, tx="") -> dict:
        """Submit and wait for the tx to be committed (reference
        /broadcast_tx_commit — documented there as a dev tool, same
        here; waits on the indexer rather than the event bus so it also
        works when the node indexes in batch)."""
        import time as _time
        raw = bytes.fromhex(tx)
        r = self.broadcast_tx_sync(tx)
        if r["code"] != 0:
            return {"check_tx": r, "hash": r["hash"]}
        want = bytes.fromhex(r["hash"])
        # deliberately wall clock: sleep-polls the indexer from an RPC
        # worker thread — a virtual clock cannot advance a poll loop
        # (same hazard as engine/reactor.max_height)
        deadline = _time.monotonic() + 30.0  # staticcheck: allow(wallclock)
        while _time.monotonic() < deadline:  # staticcheck: allow(wallclock)
            got = self.env.tx_indexer.get(want)
            if got is not None:
                height, _index, _raw, code = got
                return {"check_tx": r, "hash": r["hash"],
                        "height": height,
                        "tx_result": {"code": code}}
            _time.sleep(0.05)
        raise RPCError(-32603, "timed out waiting for commit")

    # --- light-client verification farm (farm/service.py) ---------------------

    def _farm(self):
        if self.env.farm is None:
            raise RPCError(-32603, "light farm not enabled")
        return self.env.farm

    @staticmethod
    def _farm_call(fn):
        """Map farm errors onto JSON-RPC codes: shed (-32005) is the
        retryable overload signal, acceptance-rule rejections reuse the
        light proxy's verification-failed code (-32001)."""
        from ..farm import FarmOverloaded, UnknownSession, VerifyRejected
        try:
            return fn()
        except FarmOverloaded as e:
            raise RPCError(-32005, f"farm overloaded: {e}")
        except UnknownSession as e:
            raise RPCError(-32602, str(e))
        except VerifyRejected as e:
            raise RPCError(-32001, f"verification rejected: {e}")

    def light_subscribe(self, height=None, hash="",
                        trusting_period=None) -> dict:
        """Open a session pinned at the CLIENT'S chosen trust root
        (height + 32-byte header hash, hex) with its trusting period
        in seconds."""
        farm = self._farm()
        if height is None or trusting_period is None:
            raise RPCError(-32602, "height and trusting_period required")
        try:
            root_hash = bytes.fromhex(hash)
        except ValueError:
            raise RPCError(-32602, "hash must be hex")
        session = self._farm_call(lambda: farm.subscribe(
            int(height), root_hash, int(trusting_period)))
        return session.status()

    def light_verify(self, session="", height=None) -> dict:
        """Verify the chain tip (or `height`) for a session; the
        pending checks coalesce with every other in-flight request."""
        farm = self._farm()
        return self._farm_call(lambda: farm.verify(
            str(session), int(height) if height is not None else 0))

    def light_status(self, session=None) -> dict:
        """Farm-wide counters, or one session's trust state."""
        farm = self._farm()
        return self._farm_call(lambda: farm.status(
            str(session) if session is not None else None))

    def light_unsubscribe(self, session="") -> dict:
        farm = self._farm()
        return {"dropped": farm.unsubscribe(str(session))}

    # --- aggregate-seal catch-up (sealsync/provider.py) -----------------------

    def _sealsync(self):
        if self.env.sealsync is None:
            raise RPCError(-32603, "sealsync provider not enabled")
        return self.env.sealsync

    def seal_status(self) -> dict:
        """The height span this node can serve seals for."""
        base, sealable = self._sealsync().status()
        return {"base": str(base), "sealable_height": str(sealable)}

    def seal_range(self, start=None, count=None) -> dict:
        """Seal tuples [start, start+count): hex-encoded SealTuple wire
        records (sealsync/chain.py). Truncation is honest — a shorter
        prefix means the provider hit its batch cap or its sealable
        tip; backpressure sheds with the retryable -32005."""
        from ..sealsync import SealsyncOverloaded
        if start is None:
            raise RPCError(-32602, "start required")
        prov = self._sealsync()
        try:
            tuples = prov.serve(int(start),
                                int(count) if count is not None else 1)
        except SealsyncOverloaded as e:
            raise RPCError(-32005, f"sealsync overloaded: {e}")
        except ValueError as e:
            raise RPCError(-32602, str(e))
        return {"start": str(int(start)),
                "seals": [t.encode().hex() for t in tuples]}

    # --- events (long-poll stand-in for the WS subscription) ------------------

    def wait_event(self, query="", timeout=None) -> dict:
        try:
            q = Query(query)
        except QueryError as e:
            raise RPCError(-32602, f"bad query: {e}") from e
        sub = self.env.event_bus.subscribe(f"rpc-{id(q)}", q)
        try:
            got = sub.next(float(timeout) if timeout else 10.0)
            if got is None:
                return {"event": None}
            event, attrs = got
            return {"event": {"kind": event.kind, "attrs": attrs}}
        finally:
            self.env.event_bus.unsubscribe_all(f"rpc-{id(q)}")


class RPCServer:
    def __init__(self, env: Optional[RPCEnvironment],
                 host: str = "127.0.0.1", port: int = 0,
                 methods: Optional[Dict[str, Callable]] = None,
                 max_body_bytes: int = 1_000_000,
                 timeout_s: float = 10.0,
                 cors_origins: str = "",
                 cors_methods: str = "HEAD,GET,POST",
                 cors_headers: str = "Origin,Accept,Content-Type,"
                                     "X-Requested-With,X-Server-Time",
                 tls_cert_file: str = "", tls_key_file: str = ""):
        """Default: the full route map over `env`. A custom `methods`
        dict serves the same JSON-RPC conventions over other backends
        (the light proxy reuses this server with verified routes).

        Hardening knobs mirror the reference's jsonrpc server config
        (rpc/jsonrpc/server/http_server.go:56 + config.go RPCConfig):
        request bodies over `max_body_bytes` are rejected before
        reading; `timeout_s` bounds each connection's socket reads and
        writes; CORS headers are emitted (and OPTIONS preflights
        answered) only when `cors_origins` is configured; TLS serves
        https when a cert/key pair is given."""
        allowed_origins = [o.strip() for o in cors_origins.split(",")
                           if o.strip()]
        from .websocket import Sessions
        self._ws_sessions = sessions = Sessions()
        if methods is None:
            routes = Routes(env)
            names = ["health", "status", "net_info", "genesis",
                     "genesis_chunked", "block", "block_by_hash",
                     "blockchain", "commit", "header", "header_by_hash",
                     "validators", "consensus_state",
                     "dump_consensus_state", "consensus_params",
                     "abci_info", "abci_query", "broadcast_tx_sync",
                     "broadcast_tx_async", "broadcast_tx_commit",
                     "check_tx", "unconfirmed_txs",
                     "num_unconfirmed_txs", "tx", "tx_search",
                     "block_search", "wait_event", "block_results",
                     "broadcast_evidence"]
            if env is not None and env.unsafe:
                # reference routes.go:56-62: only with rpc.unsafe=true
                names += ["dial_seeds", "dial_peers",
                          "unsafe_flush_mempool"]
            if env is not None and env.farm is not None:
                # verification-farm routes (docs/FARM.md) — mounted
                # only when the node carries a farm
                names += ["light_subscribe", "light_verify",
                          "light_status", "light_unsubscribe"]
            if env is not None and env.sealsync is not None:
                # aggregate-seal catch-up routes (docs/SEALSYNC.md)
                names += ["seal_status", "seal_range"]
            methods = {name: getattr(routes, name) for name in names}

        class Handler(BaseHTTPRequestHandler):
            # RFC 6455 requires the 101 on HTTP/1.1 (clients reject a
            # 1.0 status line); every JSON response sets Content-Length
            # so 1.1 keep-alive is safe
            protocol_version = "HTTP/1.1"
            # socket read/write deadline: a client that stalls
            # mid-request (slowloris) is disconnected, not held open
            # (reference ReadTimeout/WriteTimeout)
            timeout = timeout_s

            def log_message(self, *args):  # silence
                pass

            def setup(self):
                # TLS: the listening socket wraps with
                # do_handshake_on_connect=False so accept() never
                # handshakes — a client that connects and stalls must
                # not block the accept loop (reference uses net/http,
                # whose TLS handshake runs per-connection). The
                # handshake happens HERE, in this connection's handler
                # thread, bounded by the socket timeout setup() just
                # applied.
                super().setup()
                if hasattr(self.connection, "do_handshake"):
                    self.connection.do_handshake()

            def _cors_origin(self) -> Optional[str]:
                origin = self.headers.get("Origin")
                if not origin or not allowed_origins:
                    return None
                if "*" in allowed_origins or origin in allowed_origins:
                    return origin
                return None

            def _reply(self, payload: dict, rid=None, status=200):
                body = json.dumps({"jsonrpc": "2.0", "id": rid,
                                   **payload}).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                origin = self._cors_origin()
                if origin is not None:
                    self.send_header("Access-Control-Allow-Origin",
                                     origin)
                    self.send_header("Vary", "Origin")
                self.end_headers()
                self.wfile.write(body)

            def do_OPTIONS(self):
                # CORS preflight (reference wraps the mux in
                # github.com/rs/cors when CORSAllowedOrigins is set)
                origin = self._cors_origin()
                self.send_response(204 if origin else 403)
                if origin is not None:
                    self.send_header("Access-Control-Allow-Origin",
                                     origin)
                    self.send_header("Access-Control-Allow-Methods",
                                     cors_methods)
                    self.send_header("Access-Control-Allow-Headers",
                                     cors_headers)
                    self.send_header("Vary", "Origin")
                self.send_header("Content-Length", "0")
                self.end_headers()

            def _run(self, method: str, params: dict, rid):
                fn = methods.get(method)
                if fn is None:
                    self._reply({"error": {"code": -32601,
                                           "message": f"unknown method "
                                           f"{method}"}}, rid)
                    return
                try:
                    self._reply({"result": fn(**params)}, rid)
                except RPCError as e:
                    self._reply({"error": {"code": e.code,
                                           "message": e.message}}, rid)
                except Exception as e:  # noqa: BLE001
                    self._reply({"error": {"code": -32603,
                                           "message": str(e)}}, rid)

            def do_POST(self):
                try:
                    ln = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    ln = -1
                if ln < 0 or ln > max_body_bytes:
                    # cap BEFORE reading (reference MaxBytesReader via
                    # maxBytesHandler, http_server.go:256): a declared
                    # oversize/bogus length never allocates
                    self._reply({"error": {
                        "code": -32600,
                        "message": f"request body exceeds "
                                   f"{max_body_bytes} bytes"}},
                        status=413)
                    self.close_connection = True
                    return
                try:
                    req = json.loads(self.rfile.read(ln) or b"{}")
                except json.JSONDecodeError:
                    self._reply({"error": {"code": -32700,
                                           "message": "parse error"}})
                    return
                if not isinstance(req, dict):
                    self._reply({"error": {"code": -32600,
                                           "message": "invalid request"}})
                    return
                params = req.get("params") or {}
                if not isinstance(params, dict):
                    self._reply({"error": {"code": -32602,
                                           "message": "params must be "
                                           "an object"}}, req.get("id"))
                    return
                self._run(str(req.get("method", "")), params,
                          req.get("id"))

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                method = parsed.path.strip("/")
                if method == "websocket":
                    from .websocket import (is_websocket_upgrade,
                                            serve_websocket)
                    if is_websocket_upgrade(self.headers) and \
                            env is not None and \
                            env.event_bus is not None:
                        serve_websocket(self, env.event_bus, sessions)
                        self.close_connection = True
                        return
                params = {k: v[0] for k, v in
                          urllib.parse.parse_qs(parsed.query).items()}
                self._run(method or "health", params, -1)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.tls = bool(tls_cert_file and tls_key_file)
        if self.tls:
            # https (reference http_server.go ServeTLS): wrap the
            # listening socket; accepted conns handshake before HTTP
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert_file, tls_key_file)
            # handshake deferred to the per-connection handler thread
            # (Handler.setup) — never in the accept loop
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.addr = self._httpd.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="rpc-server",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._ws_sessions.close_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
