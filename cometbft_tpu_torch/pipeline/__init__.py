"""pipeline/ — the verified-signature cache (`cache.py`) of the JAX
package's pipeline/. The asynchronous multi-tile scheduler and its
watchdog (`pipeline_depth > 1`) are not ported yet (ROADMAP.md Queue 1:
pipelined blocksync)."""

from .cache import SigCache, shared_cache  # noqa: F401
