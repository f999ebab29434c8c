"""pipeline/ — the asynchronous multi-tile verification data plane of
the JAX package's pipeline/, ported:

- `scheduler.py` — bounded-queue staged scheduler (fetch → marshal →
  async device dispatch → sequential apply) plus the verify backends
  (in-process dispatch thread, device-server futures, test stubs);
- `watchdog.py`  — per-dispatch deadlines draining a wedged device's
  tiles to a CPU fallback;
- `cache.py`     — bounded verified-signature cache keyed by
  (pubkey, sign_bytes, sig).

Only `cache` is imported eagerly; import `scheduler`/`watchdog`
explicitly — they pull in the engine layer."""

from .cache import SigCache, shared_cache  # noqa: F401
