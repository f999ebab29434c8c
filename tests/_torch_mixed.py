"""Mixed-curve validator sets for the port's tests, built the same way with
either package: seeded ed25519, sr25519 and secp256k1 keys, a set of them,
and a chain of blocks whose commits they sign. Neither package's chain
generator makes such a set (`make_genesis` signs with ed25519 or BLS), so
the chain here runs the generator's loop by hand over a hand-made genesis;
`chain_gen.sign_commit` signs with any key type. A chain's set holds no
sr25519 key: the validator-set hash encodes each key as a
cometbft.crypto.v1.PublicKey, which has no sr25519 field, in either
package (`types/proto.public_key_proto`); commits over a set with sr25519
keys are signed over the block ids of another chain.

The default set holds 65 ed25519 keys: a commit's ed25519 bucket then
pads to 128 lanes, so the JAX package's `Ed25519BatchVerifier` verifies
it per signature on the CPU (a bucket of 64 or fewer lanes would jit its
RLC kernel on XLA:CPU, which its rules confine to `slow`), and the port's
verifier runs its torch RLC path.
"""

import random

from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.engine import chain_gen as jcg
from cometbft_tpu.state import execution as jexec
from cometbft_tpu.state import state as jstate
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import proto as jproto
from cometbft_tpu.types import validator as jval

from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.crypto import keys as pkeys
from cometbft_tpu_torch.crypto import secp256k1 as psecp
from cometbft_tpu_torch.crypto import sr25519 as psr
from cometbft_tpu_torch.engine import chain_gen as pcg
from cometbft_tpu_torch.state import execution as pexec
from cometbft_tpu_torch.state import state as pstate
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import proto as pproto
from cometbft_tpu_torch.types import validator as pval

MODS = {
    "jax": dict(keys=jkeys, secp=jsecp, sr=jsr, cg=jcg, exec=jexec,
                state=jstate, block=jblock, proto=jproto, val=jval,
                kv=jkv),
    "port": dict(keys=pkeys, secp=psecp, sr=psr, cg=pcg, exec=pexec,
                 state=pstate, block=pblock, proto=pproto, val=pval,
                 kv=pkv),
}
CHAIN_ID = "tpu-chain"   # generate_chain's, so its tiles can mix in
N_ED, N_SR, N_SECP = 65, 2, 2


def key_specs(seed: int, n_ed: int = N_ED, n_sr: int = N_SR,
              n_secp: int = N_SECP):
    """[(key type, raw private bytes)] in a seeded, interleaved order."""
    rng = random.Random(seed)

    def raw(n):
        return bytes(rng.randrange(256) for _ in range(n))

    specs = [("ed25519", raw(32)) for _ in range(n_ed)]
    specs += [("sr25519", raw(64)) for _ in range(n_sr)]
    for _ in range(n_secp):
        while True:
            r = raw(32)
            if 1 <= int.from_bytes(r, "big") < jsecp.N:
                break
        specs.append(("secp256k1", r))
    rng.shuffle(specs)
    return specs


def make_key(side: str, key_type: str, raw: bytes):
    m = MODS[side]
    if key_type == "ed25519":
        return m["keys"].Ed25519PrivKey(raw)
    if key_type == "sr25519":
        return m["sr"].Sr25519PrivKey(raw[:32], raw[32:])
    return m["secp"].Secp256k1PrivKey(raw)


def valset(side: str, specs, power: int = 10):
    m = MODS[side]
    return m["val"].ValidatorSet([
        m["val"].Validator(make_key(side, t, r).pub_key(), power)
        for t, r in specs])


def mixed_chain(side: str, n_blocks: int, specs, device=None):
    """A `GeneratedChain` of `n_blocks` blocks over the set of `specs`,
    built as `generate_chain` builds one (the executor on the port side
    runs on `device`): the same bytes with either package."""
    assert all(t != "sr25519" for t, _r in specs), "sr25519 does not hash"
    m = MODS[side]
    privs = [make_key(side, t, r) for t, r in specs]
    keys = {k.pub_key().address(): k for k in privs}
    Timestamp = m["proto"].Timestamp
    gen = m["state"].GenesisDoc(
        chain_id=CHAIN_ID,
        validators=[m["val"].Validator(k.pub_key(), 10) for k in privs],
        genesis_time=Timestamp(1_700_000_000, 0))
    state = m["state"].State.from_genesis(gen)
    app = m["kv"].KVStoreApplication()
    app.init_chain(CHAIN_ID, gen.initial_height, [], b"")
    kw = {} if side == "jax" else {"device": device}
    executor = m["exec"].BlockExecutor(app, **kw)
    blocks, block_ids, commits, valsets = [], [], [], []
    last_commit = m["block"].Commit()
    for h in range(1, n_blocks + 1):
        block = state.make_block(
            h, [f"k{h}=v{h}".encode()], last_commit,
            state.validators.get_proposer().address,
            timestamp=Timestamp(1_700_000_000 + h, 0))
        block_id = m["block"].BlockID(block.hash(),
                                      block.make_part_set().header)
        commit = m["cg"].sign_commit(CHAIN_ID, h, 0, block_id,
                                     state.validators, keys)
        valsets.append(state.validators.copy())
        state, _ = executor.apply_block(state, block_id, block)
        blocks.append(block)
        block_ids.append(block_id)
        commits.append(commit)
        last_commit = commit
    return m["cg"].GeneratedChain(
        chain_id=CHAIN_ID, genesis=gen, blocks=blocks, block_ids=block_ids,
        seen_commits=commits, keys=keys, valsets=valsets), app


def tamper(commit_sig_cls, commit, idxs):
    """`commit` with a bit of s flipped in the signatures at `idxs`
    (byte 40: inside s for every type, clear of sr25519's marker bit and
    of ed25519's s < L check)."""
    import dataclasses
    sigs = list(commit.signatures)
    for i in idxs:
        s = sigs[i]
        sig = s.signature[:40] + bytes([s.signature[40] ^ 1]) \
            + s.signature[41:]
        sigs[i] = commit_sig_cls(s.block_id_flag, s.validator_address,
                                 s.timestamp, sig)
    return dataclasses.replace(commit, signatures=sigs)


def first_of_each(specs):
    """The index of the first key of each type in `specs`."""
    out = {}
    for i, (t, _r) in enumerate(specs):
        out.setdefault(t, i)
    return out
