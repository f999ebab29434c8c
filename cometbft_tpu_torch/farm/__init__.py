"""farm/ — light-client verification farm.

Serves verification *as the product* (ROADMAP item 4): many thin
clients outsource their skipping-verification checks to one service,
which coalesces the pending VerifyCommitLight /
VerifyCommitLightTrusting work across ALL sessions into shared device
batches. The shape is PAPERS.md's verification-outsourcing line — 2G2T
constant-size MSM outsourcing (arXiv 2602.23464) and TS-Verkle's
on-chain verifier (arXiv 2605.08682) both centralize many clients'
checks on one prover/verifier — applied to CometBFT light clients on
the batch-shaped commit-verify kernel PRs 2-3 built.

Pieces:

  session.py   per-client trust state: a LightStore-backed session
               pinned at subscribe time, bounded by a shed limit
  planner.py   each client's bisection schedule (the light/verifier.py
               adjacent / non-adjacent rules) expanded HOST-SIDE into
               signature-lane work items — threshold tallies never
               need the device, so bisection decisions cost no round
               trips
  batcher.py   coalesces pending lanes across every session into one
               shared batch: SigCache + intra-batch dedup, dispatch
               in process on the batcher's device (the RLC kernels
               for a wide batch) or through the DeviceClient.submit()
               seam with canary lanes, bounded queue with an explicit
               shed path
  service.py   VerificationFarm: subscribe / verify / status, the
               object the JAX package's light_* RPC endpoints call

The spec/LightClient.tla acceptance rules are the oracle: every
accepted header's decision record is checkable by
tools/check_light_spec.check_decisions.

Port of `cometbft_tpu/farm/`: `VerificationFarm(device=)` and
`FarmBatcher(device=)` default to cuda. The RPC routes and the
light-farm simnet scenario are not ported yet (ROADMAP.md Queue 1).
"""

from .service import (FarmError, FarmOverloaded, UnknownSession,
                      VerificationFarm, VerifyRejected)
from .session import FarmSession, SessionManager

__all__ = ["VerificationFarm", "FarmError", "FarmOverloaded",
           "UnknownSession", "VerifyRejected", "FarmSession",
           "SessionManager"]
