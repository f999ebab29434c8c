"""The port's ed25519 batch verify (cometbft_tpu_torch/ops/ed25519.py and
the crypto seam) on the CPU.

- The RLC path (`verify_rlc_core_cuda`, whose kernel wrappers run their
  plain versions on the CPU) and the per-lane `verify_core` are held
  against the JAX package's
  `verify_rlc_core_pallas` and `verify_core`, run on the exact-integer
  shadow backend of tools/interval_fuzz.py in a subprocess, on the same
  prepared batches (carried across by `convert.batch_from_numpy`): same
  batch_ok, struct_ok and per-lane verdicts.
- The five cases of tests/test_ed25519_verify.py run against the port.
- `Ed25519PrivKey`, which keeps its expanded key, signs byte for byte as
  `ref_ed25519.sign` does.
- The package, blocksync and its host modules included, imports neither
  jax nor cometbft_tpu, and device="cuda" raises where there is no card.
"""

import ast
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import _shadow_jax
from cometbft_tpu.ops import ed25519 as jed25519
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto.batch import (create_batch_verifier,
                                             supports_batch_verifier)
from cometbft_tpu_torch.crypto.keys import (Ed25519BatchVerifier,
                                            Ed25519PrivKey, Ed25519PubKey)
from cometbft_tpu_torch.device import resolve_device
from cometbft_tpu_torch.ops import ed25519 as ped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8


def _signed(seed, n, msg_len=100):
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for _ in range(n):
        sk = rng.bytes(32)
        m = rng.bytes(msg_len)
        pubs.append(ref.pubkey_from_seed(sk))
        msgs.append(m)
        sigs.append(ref.sign(sk, m))
    return pubs, msgs, sigs


def _batches():
    """A: lane 5 has an undecodable R (struct-masked; the equation holds).
    B: lane 3 has a tampered s (the equation fails), lane 6 has s + L
    (struct-masked). Prepared by the JAX package's own prepare_batch."""
    pubs, msgs, sigs = _signed(31, N)
    sigs_a = list(sigs)
    sigs_a[5] = (2**255 - 2).to_bytes(32, "little") + sigs[5][32:]
    sigs_b = list(sigs)
    sigs_b[3] = sigs[3][:40] + bytes([sigs[3][40] ^ 1]) + sigs[3][41:]
    s6 = int.from_bytes(sigs[6][32:], "little") + ref.L
    sigs_b[6] = sigs[6][:32] + s6.to_bytes(32, "little")
    z = ped.make_rlc_coefficients(N, np.random.default_rng(32))
    out = {}
    for tag, sg in (("A", sigs_a), ("B", sigs_b)):
        pub, sig, hb, hn, ok = jed25519.prepare_batch(pubs, msgs, sg, N, 128)
        out[tag] = dict(pub=pub, sig=sig, hblocks=hb, hnblocks=hn, z=z,
                        ok=ok)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch at a few lanes is launch-bound on the CPU; one thread
    runs it faster than a pool contended by the shadow subprocesses."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def shadow():
    """The JAX side; autouse, so its subprocesses start with the module's
    first test and run while the port-side tests compute."""
    b = _batches()
    groups = []
    for job, tag, names in (
            ("verify_rlc_core_pallas@A", "A",
             ("pub", "sig", "hblocks", "hnblocks", "z")),
            ("verify_rlc_core_pallas@B", "B",
             ("pub", "sig", "hblocks", "hnblocks", "z")),
            ("verify_core@B", "B", ("pub", "sig", "hblocks", "hnblocks"))):
        groups.append(({f"{job}.{n}": b[tag][n] for n in names}, [job]))
    sh = _shadow_jax.start_many(groups)   # one subprocess a job
    yield sh
    sh.close()


# --- the five cases of tests/test_ed25519_verify.py --------------------------

RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def test_rfc8032_vectors():
    pubs, msgs, sigs = [], [], []
    for seed_h, pub_h, msg_h, sig_h in RFC8032:
        seed, pub = bytes.fromhex(seed_h), bytes.fromhex(pub_h)
        msg, sig = bytes.fromhex(msg_h), bytes.fromhex(sig_h)
        assert ref.pubkey_from_seed(seed) == pub
        assert Ed25519PrivKey(seed).sign(msg) == sig
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
    assert ped.verify_batch(pubs, msgs, sigs, device="cpu").all()


def test_batch_attribution_and_rejections():
    rng = random.Random(11)
    pubs, msgs, sigs, expect = [], [], [], []
    for i in range(8):
        seed = bytes([rng.randrange(256) for _ in range(32)])
        msg = bytes([rng.randrange(256) for _ in range(rng.randrange(1, 150))])
        pub, sig = ref.pubkey_from_seed(seed), ref.sign(seed, msg)
        kind = i % 4
        if kind == 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif kind == 2:
            msg = msg + b"x"
        elif kind == 3:
            s = int.from_bytes(sig[32:], "little") + ref.L
            sig = sig[:32] + (s.to_bytes(32, "little") if s < 2**256
                              else bytes(32))
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(sig)
        expect.append(ref.verify(pub, msg, sig))
    assert expect == [i % 4 == 0 for i in range(8)]
    before = dict(ped.STATS)
    assert list(ped.verify_batch(pubs, msgs, sigs, device="cpu")) == expect
    assert ped.STATS["per_lane"] == before["per_lane"] + 1


def test_malformed_inputs():
    seed, msg = b"\x01" * 32, b"hello"
    pub, sig = ref.pubkey_from_seed(seed), ref.sign(seed, msg)
    got = ped.verify_batch([pub, pub[:31], pub], [msg, msg, msg],
                           [sig[:63], sig, sig], device="cpu")
    assert list(got) == [False, False, True]


def test_zip215_small_order_and_noncanonical():
    ident = (1).to_bytes(32, "little")
    sig = ident + bytes(32)
    msg = b"anything"
    ident_nc = (ref.P + 1).to_bytes(32, "little")
    sig_nc = ident_nc + bytes(32)
    got = ped.verify_batch([ident, ident_nc], [msg, msg], [sig, sig_nc],
                           device="cpu")
    assert list(got) == [True, True]
    got = ped.verify_batch([ident, ident_nc], [msg, msg], [sig, sig_nc],
                           zip215=False, device="cpu")
    assert list(got) == [True, False]


def test_oversized_batch_chunks_and_empty():
    seed = b"\x05" * 32
    pub = ref.pubkey_from_seed(seed)
    msgs = [bytes([i]) for i in range(5)]
    sigs = [ref.sign(seed, m) for m in msgs]
    sigs[3] = bytes(64)
    got = ped.verify_batch([pub] * 5, msgs, sigs, batch_size=2, device="cpu")
    assert list(got) == [True, True, True, False, True]
    assert ped.verify_batch([], [], [], device="cpu").shape == (0,)


def test_batch_verifier_seam():
    pubs, msgs, sigs = _signed(41, 5, msg_len=122)
    sigs[2] = sigs[2][:33] + bytes([sigs[2][33] ^ 4]) + sigs[2][34:]
    pk = Ed25519PubKey(pubs[0])
    assert supports_batch_verifier(pk)
    bv, ok = create_batch_verifier(pk, device="cpu")
    assert ok and isinstance(bv, Ed25519BatchVerifier)
    assert bv.verify() == (False, [])
    for p, m, s in zip(pubs, msgs, sigs):
        bv.add(Ed25519PubKey(p), m, s)
    assert bv.verify() == (False, [True, True, False, True, True])
    assert pk.verify_signature(msgs[0], sigs[0])


def test_cached_key_signer_matches_ref_sign():
    """Ed25519PrivKey keeps its public key and signs natively; its
    signatures and public key stay byte-identical with the oracle's, for
    the RFC 8032 vectors and for random seeds and messages, on the first
    call and later."""
    rng = np.random.default_rng(43)
    cases = [(bytes.fromhex(sk), bytes.fromhex(m))
             for sk, _pk, m, _sig in RFC8032]
    cases += [(rng.bytes(32), rng.bytes(int(n)))
              for n in rng.integers(0, 300, 6)]
    for seed, msg in cases:
        key = Ed25519PrivKey(seed)
        for _ in range(2):
            assert key.sign(msg) == ref.sign(seed, msg)
        assert key.pub_key().bytes_() == ref.pubkey_from_seed(seed)
        assert key == Ed25519PrivKey(seed)
        assert hash(key) == hash(Ed25519PrivKey(seed))


# --- isolation and device rules -----------------------------------------------

def test_import_leaves_jax_and_reference_unloaded():
    """Every module of the package, imported in a fresh interpreter,
    loads neither jax nor the JAX package, nor the `cryptography` wheel
    (the card's machine has none) nor `grpc` (the gRPC transports are
    not ported yet)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cometbft_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'cometbft_tpu_torch.light.client' in names, names\n"
        "assert 'cometbft_tpu_torch.crypto.sr25519' in names, names\n"
        "assert 'cometbft_tpu_torch.aggsig.verify' in names, names\n"
        "assert 'cometbft_tpu_torch.ops.bls12' in names, names\n"
        "for new in ('db.kv', 'db.native.wrapper', 'libs.faultio',\n"
        "            'consensus.wal', 'store.recovery', 'p2p.conn',\n"
        "            'p2p.mconn', 'p2p.transport', 'p2p.switch',\n"
        "            'engine.pool', 'engine.reactor', 'libs.bits',\n"
        "            'types.vote_set', 'types.extended_commit',\n"
        "            'privval.file', 'evidence.pool', 'consensus.state',\n"
        "            'consensus.reactor', 'consensus.height_vote_set',\n"
        "            'consensus.ticker', 'config', 'pubsub.query',\n"
        "            'pubsub.events', 'indexer.kv', 'proxy.multi_app_conn',\n"
        "            'state.pruner', 'state.rollback', 'mempool.reactor',\n"
        "            'evidence.reactor', 'statesync.reactor', 'rpc.server',\n"
        "            'rpc.client', 'node.node', 'cmd.main',\n"
        "            'statesync.syncer', 'statesync.stateprovider',\n"
        "            'abci.socket', 'abci.grammar', 'light.rpc',\n"
        "            'rpc.websocket', 'indexer.sqlite', 'privval.remote',\n"
        "            'p2p.pex'):\n"
        "    assert 'cometbft_tpu_torch.' + new in names, (new, names)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cometbft_tpu' or m.startswith('cometbft_tpu.')\n"
        "       or m == 'cryptography' or m.startswith('cryptography.')\n"
        "       or m == 'grpc' or m.startswith('grpc.')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_jax_or_reference_import_in_package():
    """No import of jax, the JAX package or `cryptography` anywhere in
    the package (the last: the card's machine has no such wheel)."""
    pkg = os.path.join(ROOT, "cometbft_tpu_torch")
    found = []
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                for name in names:
                    top = name.split(".")[0]
                    if top in ("jax", "jaxlib", "cometbft_tpu",
                               "cryptography", "grpc"):
                        found.append(f"{path}:{node.lineno} {name}")
    assert not found, found


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Ed25519BatchVerifier()
    with pytest.raises(RuntimeError):
        ped.verify_batch([b"\x00" * 32], [b""], [b"\x00" * 64])
    with pytest.raises(RuntimeError):
        convert.batch_from_numpy(*(np.zeros(1),) * 5)


def test_canary_trip_raises(monkeypatch):
    """A kernel that accepts the tampered canary batch raises
    KernelCanaryError; it does not degrade silently."""
    monkeypatch.setitem(ped._canary, "dispatches", 0)
    monkeypatch.setattr(ped, "verify_rlc_core_cuda",
                        lambda *a: (torch.tensor(True), None))
    pubs, msgs, sigs = _signed(51, 2)
    with pytest.raises(ped.KernelCanaryError):
        ped.verify_batch(pubs, msgs, sigs, device="cpu")


# --- against the JAX package on the shadow backend ----------------------------

def test_rlc_and_per_lane_match_jax(shadow):
    b = _batches()
    got = {}
    for tag in ("A", "B"):
        t = convert.batch_from_numpy(
            b[tag]["pub"], b[tag]["sig"], b[tag]["hblocks"],
            b[tag]["hnblocks"], b[tag]["z"], device="cpu")
        args = (t["pub"], t["sig"], t["hblocks"], t["hnblocks"])
        got[tag] = (ped.verify_rlc_core_cuda(*args, t["z"]),
                    ped.verify_core(*args) if tag == "B" else None)
    out = shadow.result()
    for tag, want_ok in (("A", True), ("B", False)):
        jok = bool(out[f"verify_rlc_core_pallas@{tag}.out0"])
        jstruct = out[f"verify_rlc_core_pallas@{tag}.out1"]
        assert jok == want_ok
        bok, sok = got[tag][0]
        assert bool(bok) == jok
        assert np.array_equal(sok.numpy(), jstruct)
    assert list(out["verify_rlc_core_pallas@A.out1"]) == \
        [i != 5 for i in range(N)]
    lanes = got["B"][1].numpy()
    assert np.array_equal(lanes, out["verify_core@B.out0"])
    assert list(lanes) == [i not in (3, 6) for i in range(N)]
