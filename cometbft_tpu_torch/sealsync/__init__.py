"""sealsync/ — aggregate-seal catch-up: finalize decided heights from
seals, not signature replay (the JAX package's docs/SEALSYNC.md).

A BLS aggregate seal is a constant-size, O(1)-verifiable finality
proof; per-lane signatures are folded away, so a laggard cannot
reconstruct votes from it — but it never needed to. This package lets
a laggard ADOPT decided heights from `(height, header,
AggregatedCommit)` tuples alone:

  chain.py     SealTuple wire form + the host-side trust rule
               (hash-chain continuity, valset-hash epochs, pivot/skip
               schedule — all decided before any pairing runs)
  provider.py  serves seal tuples out of the blockstore, bounded +
               shed (over p2p through engine/reactor; its RPC routes
               come with the RPC server)
  adopter.py   settles pivot seals in tiled canary-gated
               PairingChecker calls and installs adopted finality;
               block bodies backfill lazily through blocksync with
               every adopted commit a SigCache hit (no double pairing)

Port of `cometbft_tpu/sealsync/`: pivot pairings run on the adopter's
device (default cuda) through the `bls_miller_finalexp` kernel.
"""

from .adopter import (AdoptionError, SealAdopter, SealRejected,
                      SealSource)
from .chain import (DEFAULT_MAX_SKIP, AdoptionPlan, SealChainError,
                    SealTuple, plan_adoption)
from .provider import SealProvider, SealsyncOverloaded

__all__ = [
    "AdoptionError", "AdoptionPlan", "DEFAULT_MAX_SKIP", "SealAdopter",
    "SealChainError", "SealProvider", "SealRejected", "SealSource",
    "SealTuple", "SealsyncOverloaded", "plan_adoption",
]
