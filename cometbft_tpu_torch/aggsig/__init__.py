"""aggsig/ — BLS12-381 aggregate-commit fast path (port of
`cometbft_tpu/aggsig/`).

Turns the n per-validator precommit verifications of a commit into ONE
multi-pairing check (shared Miller loops, a single final
exponentiation) when the validator set is uniformly BLS.

Layout:
  aggregate.py — G2 signature aggregation, the signer-bitmap codec,
                 proof-of-possession (rogue-key defense) and its
                 process registry, and the BlsBatchVerifier plugged
                 into crypto/batch's dispatch seam.
  verify.py    — aggregated-commit verification (one pairing equation
                 per commit), the batched pairing checkers on the
                 ops/bls12 kernels (`bls_miller_finalexp`, `bls_hard_pow`)
                 gated by known-answer canary items, and the SigCache
                 keying of whole-aggregate verdicts.

The AggregatedCommit seal itself lives in types/agg_commit.py.
"""

from .aggregate import (  # noqa: F401
    BlsBatchVerifier, aggregate_signatures, bitmap_decode, bitmap_encode,
    has_pop, pop_prove, pop_verify, register_pop, reset_pop_registry,
    valset_pops_ok)
from .verify import (  # noqa: F401
    AggregateVerificationError, shared_finalexp, shared_pairing,
    verify_aggregated_commit)
