"""State rollback: revert the latest state one height, keeping the block
store's copy of the block so it can be re-executed (reference
state/rollback.go:16-126 — the `cometbft rollback` repair path for apps
that diverged at the tip).

Copy of `cometbft_tpu/state/rollback.py` in the port.
"""

from __future__ import annotations

from dataclasses import replace

from ..types.block import BlockID


class RollbackError(Exception):
    pass


def rollback_state(state_store, block_store, remove_block: bool = False):
    """Roll the stored state back from height H to H-1
    (reference rollback.go Rollback). Returns the new State."""
    state = state_store.load()
    if state is None:
        raise RollbackError("no state to roll back")
    h = state.last_block_height
    if h <= 0:
        raise RollbackError("already at genesis")
    # crash-repair case (reference rollback.go:35-47): blocksync saves
    # the block BEFORE applying it, so a crash can leave the block store
    # one height ahead of state — remove the extra block first
    if block_store.height() == h + 1:
        if not remove_block:
            raise RollbackError(
                f"block store ({block_store.height()}) is ahead of "
                f"state ({h}); rerun with remove_block/--hard to drop "
                f"the unapplied block")
        block_store.delete_block(h + 1)
        return state  # stores consistent again; state untouched
    if block_store.height() != h:
        raise RollbackError(
            f"block store at {block_store.height()}, state at {h}: "
            f"cannot roll back")
    rolled_back = block_store.load_block(h)
    prev = block_store.load_block(h - 1) if h > 1 else None
    if rolled_back is None:
        raise RollbackError(f"block {h} not in store")

    vals = state_store.load_validators(h)
    next_vals = state_store.load_validators(h + 1)
    last_vals = state_store.load_validators(h - 1)
    if vals is None or next_vals is None:
        raise RollbackError(f"validator sets for {h}/{h + 1} missing")

    hdr = rolled_back.header
    new_state = replace(
        state,
        last_block_height=h - 1,
        last_block_id=hdr.last_block_id,
        last_block_time=(prev.header.time if prev is not None
                         else state.last_block_time),
        # header H commits to the sets/results that close height H-1
        validators=vals,
        next_validators=next_vals,
        last_validators=last_vals if last_vals is not None else vals,
        app_hash=hdr.app_hash,
        last_results_hash=hdr.last_results_hash,
    )
    state_store.save(new_state)
    if remove_block:
        block_store.delete_block(h)
    return new_state
