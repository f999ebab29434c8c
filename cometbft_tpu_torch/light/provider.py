"""Light-block providers (reference light/provider/provider.go interface,
light/provider/http, light/provider/mock).

`BlockStoreProvider` serves light blocks straight from a full node's
BlockStore + StateStore — the in-process analog of the RPC provider, and
what the `light/client_benchmark_test.go:24` mock provider does with its
1000-block chain.

Copy of `cometbft_tpu/light/provider.py` (the port keeps its own). The
HTTP provider decodes with the port's copies of `rpc/codec.py` and
`rpc/client.RPCClientError`; its `rpc_client` is any object with the
`commit(height)` and `call(method, **params)` of the JAX package's
`rpc/client.RPCClient` (not ported yet).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Protocol, Tuple

from ..libs import timesource
from ..libs.env import env_float, env_int
from .types import LightBlock, SignedHeader

# transient-fetch retry knobs (HTTPProvider): one flaky socket must not
# fail a whole multi-step verification — the reference http provider
# retries with backoff the same way (light/provider/http http.go
# maxRetryAttempts). Transient = OSError family ONLY (refused /reset /
# timeout); an RPC-level error answer is a deterministic response and
# retrying it would just triple every byzantine rejection.
ENV_RETRIES = "COMETBFT_TPU_LIGHT_PROVIDER_RETRIES"
ENV_RETRY_BASE = "COMETBFT_TPU_LIGHT_PROVIDER_RETRY_BASE"  # seconds
DEFAULT_RETRIES = 2
DEFAULT_RETRY_BASE_S = 0.05
_JITTER_FRACTION = 0.25


class ProviderError(Exception):
    pass


def retry_transient(fn: Callable, rng: random.Random,
                    retries: Optional[int] = None,
                    base_s: Optional[float] = None,
                    transient: Tuple = (OSError,),
                    sleep: Optional[Callable[[float], None]] = None):
    """Run `fn()` with jittered-exponential-backoff retries on
    `transient` errors; the final failure re-raises. The jitter comes
    from the caller's SEEDED rng (staticcheck's global-rng rule: every
    draw must replay), and the sleep is suppressed while a virtual
    clock is installed — under simnet a wall sleep would stall the
    sim thread without advancing virtual time, and the retry sequence
    must stay byte-identical per seed."""
    if retries is None:
        retries = env_int(ENV_RETRIES, DEFAULT_RETRIES, minimum=0)
    if base_s is None:
        base_s = env_float(ENV_RETRY_BASE, DEFAULT_RETRY_BASE_S,
                           minimum=0.0)
    for attempt in range(retries + 1):
        try:
            return fn()
        except transient:
            if attempt == retries:
                raise
            delay = base_s * (2.0 ** attempt) \
                * (1.0 + _JITTER_FRACTION * rng.random())
            if sleep is not None:
                sleep(delay)
            elif not timesource.installed():
                time.sleep(delay)


class ErrLightBlockNotFound(ProviderError):
    pass


class Provider(Protocol):
    """reference light/provider/provider.go:9-32."""

    def chain_id(self) -> str: ...
    def light_block(self, height: int) -> LightBlock:
        """height 0 means latest. Raises ProviderError."""


class BlockStoreProvider:
    def __init__(self, chain_id: str, block_store, state_store):
        self._chain_id = chain_id
        self._blocks = block_store
        self._states = state_store

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self._blocks.height()
        meta = self._blocks.load_block_meta(height)
        blk = self._blocks.load_block(height)
        commit = self._blocks.load_block_commit(height)
        vals = self._states.load_validators(height)
        if blk is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(
                f"no light block at height {height}")
        return LightBlock(SignedHeader(blk.header, commit), vals)


def fetch_all_validators(rpc_client, height=None, max_pages=64):
    """Merge the paginated /validators pages into one response dict.

    Hardened for the light client's adversary model: later pages are
    PINNED to page 1's block_height (unpinned 'latest' pages could
    straddle a height change and merge two sets — a spurious hash
    failure against an honest primary), an empty page stops the walk
    (no progress), and max_pages bounds it (a byzantine primary
    advertising total=10^9 must not hang the caller; 64 pages × 100 =
    6400 validators, far above any real set). 'count' reflects the
    merged list."""
    merged = None
    page = 1
    while page <= max_pages:
        kw = {"page": page, "per_page": 100}
        if height is not None:
            kw["height"] = height
        r = rpc_client.call("validators", **kw)
        if merged is None:
            merged = r
            height = r.get("block_height", height)  # pin later pages
        else:
            if not r.get("validators"):
                break
            merged["validators"].extend(r["validators"])
        if len(merged["validators"]) >= r.get(
                "total", len(merged["validators"])):
            break
        page += 1
    merged["count"] = len(merged["validators"])
    return merged


class HTTPProvider:
    """Light blocks over a full node's JSON-RPC (reference
    light/provider/http/http.go): /commit gives the signed header,
    /validators the matching set; LightBlock.validate_basic binds them
    via the header's validators_hash."""

    def __init__(self, chain_id: str, rpc_client):
        self._chain_id = chain_id
        self._rpc = rpc_client
        # deterministic backoff jitter (global-rng rule: seeded draws
        # replay; the chain id de-phases providers without entropy)
        self._rng = random.Random(f"light-provider:{chain_id}")

    def chain_id(self) -> str:
        return self._chain_id

    def light_block(self, height: int) -> LightBlock:
        from ..rpc.client import RPCClientError
        from ..rpc.codec import (commit_from_json, header_from_json,
                                 validator_set_from_json)
        try:
            # each fetch retries transient socket failures with
            # jittered backoff BEFORE the whole verify gives up: a
            # bisection is many fetches, and one flaky one must not
            # void the verified prefix
            c = retry_transient(
                lambda: self._rpc.commit(height if height else None),
                self._rng)
            sh = SignedHeader(
                header_from_json(c["signed_header"]["header"]),
                commit_from_json(c["signed_header"]["commit"]))
            # the route is paginated (reference http provider walks
            # pages the same way); the FULL set is needed — a truncated
            # one can never match the header's validators_hash
            vals = validator_set_from_json(retry_transient(
                lambda: fetch_all_validators(self._rpc,
                                             height=sh.height),
                self._rng))
        except (RPCClientError, OSError, KeyError, ValueError) as e:
            raise ErrLightBlockNotFound(
                f"height {height}: {e}") from e
        return LightBlock(sh, vals)

    def report_evidence(self, ev) -> None:
        """reference light/provider/http ReportEvidence: hand detector
        evidence to the full node's /broadcast_evidence route, whence
        the evidence reactor gossips it to every proposer. Failures
        surface as ProviderError — the detector's _report treats that
        as best-effort (light/client.py), while direct callers see the
        actual rejection. ValueError covers a byzantine endpoint
        answering 200 with a non-JSON body (same defense as
        light_block above)."""
        from ..rpc.client import RPCClientError
        try:
            self._rpc.call("broadcast_evidence",
                           evidence=ev.encode().hex())
        except (RPCClientError, OSError, KeyError, ValueError) as e:
            raise ProviderError(f"report_evidence: {e}") from e
