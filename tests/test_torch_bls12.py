"""The port's BLS12-381 device module (cometbft_tpu_torch/ops/bls12.py)
held against the JAX package's ops/bls12.py, run eagerly on the CPU, and
against the host oracle crypto/bls12381.py.

Every result is an integer, so the tolerance is none: limbs equal, verdicts
equal.

- `mont_mul`, `add_mod` and `sub_mod` on edge values (0, 1, p - 1,
  R mod p, values just under p) and seeded random ones, against Python
  integers and the JAX package's functions on the same limbs.
- `f12_mul`, `f12_mul_sparse`, `f12_conj`, `f12_frob2` and `f12_inv`
  against the JAX package's eager functions (one call each) and the
  oracle's `f12_mul`, `f12_mul_sparse035`, `f12_conj`, `f12_frobenius`
  squared and `f12_inv`.
- `_pack` and `_pack_miller_lines` array-equal to the JAX package's numpy
  output (a None pair, a 1-pair item, pad lanes of identity lines).
- The plain hard chain with short exponents against the oracle's
  `f12_pow`, and the full plain verdicts at bucket 4
  (`final_exp_is_one_batch`, `miller_finalexp_is_one_batch` on
  `device="cpu"`): a canary, a clean 2-pair commit item, a tampered
  aggregate and a pad lane, verdicts against the oracle's
  `final_exponentiation(miller_product(...)) == 1` and the returned
  Fq12 limbs against the oracle's value in Montgomery form.
- A chunked batch of 66 items (buckets 64 and 4) with a short exponent.
- The dispatch rules: a CPU tensor runs the plain version and launches
  nothing; an unsupported device, a too-wide batch or item, and cuda
  without a card raise.
- Under `slow` only: the JAX package's jitted `_compiled` and
  `_compiled_miller` on XLA:CPU (minutes of compile) against the port's
  verdicts. The kernels themselves are held on the card by
  tests/test_torch_kernels.py (`cuda` marker) and chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cometbft_tpu.ops import bls12 as jb

from cometbft_tpu_torch.crypto import bls12381 as bls
from cometbft_tpu_torch.ops import bls12 as pb

P = bls.P
R = pb.R_INT
RINV = pow(R, -1, P)
ONE = bls.F12_ONE
EDGES = [0, 1, P - 1, R % P, P - 2, P - (1 << 16) - 1, P - (1 << 200)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Eager torch on a few lanes is launch-bound on the CPU; one thread
    runs it faster than a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(vals) -> np.ndarray:
    """Python ints -> (24, N) int32 limbs (the values as given)."""
    return np.stack([pb.limbs_from_int(v) for v in vals], -1)


def _ints(arr) -> list:
    arr = np.asarray(arr)
    return [pb.int_from_limbs(arr[:, n]) for n in range(arr.shape[1])]


def _rand_f12(rng):
    return tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))


def _tree(arr, mod):
    """(6, 2, 24, B) numpy -> a tree of the package `mod` (torch or jnp)."""
    t = torch.from_numpy(arr) if mod == "port" else jnp.asarray(arr)
    return tuple((t[i, 0], t[i, 1]) for i in range(6))


def _stack(tree) -> np.ndarray:
    return np.stack([np.stack([np.asarray(tree[i][0]), np.asarray(tree[i][1])])
                     for i in range(6)])


# --- Fq -------------------------------------------------------------------------

def _fq_inputs():
    rng = random.Random(5)
    vals = EDGES + [rng.randrange(P) for _ in range(5)]
    pairs = [(a, b) for a in vals for b in vals]
    return _limbs([a for a, _ in pairs]), _limbs([b for _, b in pairs]), pairs


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_fq_op_matches_integers_and_jax(op):
    a, b, pairs = _fq_inputs()
    want = {"mont_mul": lambda x, y: x * y * RINV % P,
            "add_mod": lambda x, y: (x + y) % P,
            "sub_mod": lambda x, y: (x - y) % P}[op]
    got = getattr(pb, op)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert _ints(got.numpy()) == [want(x, y) for x, y in pairs]
    jgot = np.asarray(getattr(jb, op)(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got.numpy(), jgot)


def test_fq_inv_matches_integers():
    vals = EDGES[:4] + [12345, P - 12345]
    got = _ints(pb.fq_inv(torch.from_numpy(_limbs(vals))).numpy())
    # limbs v are the Montgomery form of v/R: the inverse's form is
    # (v/R)^(p-2) R, and 0 stays 0
    want = [pow(v * RINV, P - 2, P) * R % P for v in vals]
    assert got == want


# --- Fq12 -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def f12_inputs():
    rng = random.Random(6)
    xs = [_rand_f12(rng), tuple((P - 1, P - 1) for _ in range(6))]
    ys = [_rand_f12(rng), _rand_f12(rng)]
    lines = [tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
             for _ in range(2)]
    return xs, ys, lines


def _line_arr(lines) -> np.ndarray:
    """(3, 2, 24, B) Montgomery limbs of sparse lines (c0, c3, c5)."""
    return pb._pack([tuple(ln) + ((0, 0),) * 3 for ln in lines])[:3]


F12_OPS = {
    "f12_mul": lambda x, y, ln: bls.f12_mul(x, y),
    "f12_mul_sparse": lambda x, y, ln: bls.f12_mul_sparse035(x, *ln),
    "f12_conj": lambda x, y, ln: bls.f12_conj(x),
    "f12_frob2": lambda x, y, ln: bls.f12_frobenius(bls.f12_frobenius(x)),
    "f12_inv": lambda x, y, ln: bls.f12_inv(x),
}


@pytest.mark.parametrize("op", sorted(F12_OPS))
def test_f12_op_matches_jax_and_oracle(f12_inputs, op):
    xs, ys, lines = f12_inputs
    xa, ya, la = pb._pack(xs), pb._pack(ys), _line_arr(lines)

    def call(mod, pkg):
        x, y = _tree(xa, mod), _tree(ya, mod)
        lt = torch.from_numpy(la) if mod == "port" else jnp.asarray(la)
        ln = tuple((lt[c, 0], lt[c, 1]) for c in range(3))
        if op == "f12_mul":
            return getattr(pkg, op)(x, y)
        if op == "f12_mul_sparse":
            return getattr(pkg, op)(x, ln)
        return getattr(pkg, op)(x)
    got = _stack(call("port", pb))
    assert got.dtype == np.int32
    want = pb._pack([F12_OPS[op](x, y, ln)
                     for x, y, ln in zip(xs, ys, lines)])
    assert np.array_equal(got, want)
    assert np.array_equal(got, _stack(call("jax", jb)))


# --- packing --------------------------------------------------------------------

@pytest.fixture(scope="module")
def items():
    """A BLS key's clean 2-pair commit item, a tampered one (the
    signature of another message), the canary items and a 1-pair and a
    None-pair item."""
    key = bls.Bls12381PrivKey.generate(seed=b"torch-bls12-test")
    pk = key.pub_key()
    msg = b"a canonical precommit sign-bytes stand-in, over 32 bytes"
    h = bls.hash_to_g2_cached(bls._fixed_msg(msg))
    s = bls.g2_decompress(key.sign(msg))
    s_other = bls.g2_decompress(key.sign(msg + b"!"))
    q = bls.G2_GEN
    return {"clean": [(bls.G1_NEG, s), (pk.point, h)],
            "tampered": [(bls.G1_NEG, s_other), (pk.point, h)],
            "good": [(bls.G1_NEG, q), (bls.G1_GEN, q)],
            "bad": [(bls.G1_GEN, q), (bls.G1_GEN, q)],
            "one_pair": [(bls.G1_GEN, q)],
            "none_pair": [(None, q), (bls.G1_GEN, None)]}


def test_pack_matches_jax():
    rng = random.Random(7)
    elems = [_rand_f12(rng), ONE, tuple((P - 1, 0) for _ in range(6))]
    got = pb._pack(elems)
    assert got.dtype == np.int32 and got.shape == (6, 2, 24, 3)
    assert np.array_equal(got, jb._pack(elems))
    assert np.array_equal(pb._identity_line(), jb._identity_line())


def test_pack_miller_lines_matches_jax(items):
    batch = [items["clean"], items["none_pair"], items["one_pair"]]
    got = pb._pack_miller_lines(batch, 4)
    assert got.shape == (pb.MILLER_STEPS, 2, 2, 3, 2, 24, 4)
    assert np.array_equal(got, jb._pack_miller_lines(batch, 4))
    # the None-pair item and the pad lane hold identity lines only
    ident = np.broadcast_to(pb._identity_line()[None, None, None],
                            (pb.MILLER_STEPS, 2, 2, 3, 2, 24))
    assert np.array_equal(got[..., 1], ident)
    assert np.array_equal(got[..., 3], ident)
    with pytest.raises(ValueError):
        pb._pack_miller_lines([items["clean"] + items["one_pair"]], 4)
    with pytest.raises(ValueError):
        pb._pack_miller_lines([items["clean"]] * 5, 4)


# --- the plain kernels ----------------------------------------------------------

def test_hard_pow_plain_short_exponents():
    rng = random.Random(8)
    elems = [_rand_f12(rng), ONE, _rand_f12(rng)]
    arr = torch.from_numpy(pb._pack(elems))
    for e in (1, 2, 0b1011, 0b110010111):
        bits = tuple(int(b) for b in bin(e)[2:])
        out, ok = pb.bls_hard_pow_plain(arr, torch.tensor(bits,
                                                          dtype=torch.int32))
        want = [bls.f12_pow(m, e) for m in elems]
        assert np.array_equal(out.numpy(), pb._pack(want))
        assert ok.tolist() == [w == ONE for w in want]
    assert pb.pow_is_one_batch(elems, (1, 0, 1), 4, device="cpu") == \
        [False, True, False]


def _spy(monkeypatch, name):
    calls = []
    real = getattr(pb, name)

    def spy(*args):
        got = real(*args)
        calls.append((args, got))
        return got
    monkeypatch.setattr(pb, name, spy)
    return calls


def test_final_exp_is_one_batch_plain(items, monkeypatch):
    """The canary's known-not-one product, a clean and a tampered commit
    product, and a pad lane, through the full plain hard chain."""
    prods = [bls.miller_product(items[k])
             for k in ("bad", "clean", "tampered")]
    calls = _spy(monkeypatch, "bls_hard_pow")
    got = pb.final_exp_is_one_batch(prods, device="cpu")
    finals = [bls.final_exponentiation(m) for m in prods]
    assert got == [f == ONE for f in finals] == [False, True, False]
    (args, (out, ok)), = calls
    assert args[0].shape == (6, 2, 24, 4) and args[1].shape == (1268,)
    assert np.array_equal(out.numpy(), pb._pack(finals + [ONE]))
    assert ok.tolist() == [False, True, False, True]
    assert pb.LAUNCHES == {"bls_hard_pow": 0, "bls_miller_finalexp": 0}


def test_miller_finalexp_is_one_batch_plain(items, monkeypatch):
    """The canary's known-one item, a clean and a tampered commit item,
    and a pad lane, through the plain Miller scan, easy part and hard
    chain."""
    batch = [items[k] for k in ("good", "clean", "tampered")]
    calls = _spy(monkeypatch, "bls_miller_finalexp")
    got = pb.miller_finalexp_is_one_batch(batch, device="cpu")
    finals = [bls.final_exponentiation(bls.miller_product(it))
              for it in batch]
    assert got == [f == ONE for f in finals] == [True, True, False]
    (args, (out, ok)), = calls
    assert args[0].shape == (pb.MILLER_STEPS, 2, 2, 3, 2, 24, 4)
    assert np.array_equal(out.numpy(), pb._pack(finals + [ONE]))
    assert ok.tolist() == [True, True, False, True]
    assert pb.LAUNCHES["bls_miller_finalexp"] == 0   # the plain version


def test_chunked_batch_over_64(monkeypatch):
    """66 products: one chunk at bucket 64, one at bucket 4. A short
    exponent stands in for the hard one (the chunking is what is held);
    the verdicts against the oracle's easy part and `f12_pow`."""
    rng = random.Random(9)
    prods = [ONE if i % 5 == 0 else _rand_f12(rng) for i in range(66)]
    monkeypatch.setattr(pb, "HARD_BITS", (1, 1))
    calls = _spy(monkeypatch, "bls_hard_pow")
    got = pb.final_exp_is_one_batch(prods, device="cpu")
    assert [c[0][0].shape[-1] for c in calls] == [64, 4]
    want = [bls.f12_pow(bls.final_exp_easy(m), 3) == ONE for m in prods]
    assert got == want and sum(got) == 14


def test_dispatch_rules():
    arr = torch.from_numpy(pb._pack([ONE]))
    bits = torch.tensor((1, 0, 1), dtype=torch.int32)
    before = dict(pb.LAUNCHES)
    out, ok = pb.bls_hard_pow(arr, bits)
    assert ok.tolist() == [True] and pb.LAUNCHES == before
    with pytest.raises(ValueError):
        pb.bls_hard_pow(arr.to("meta"), bits.to("meta"))
    with pytest.raises(ValueError):
        pb.bls_miller_finalexp(torch.zeros((1,), device="meta"), bits)
    with pytest.raises(ValueError):
        pb.pow_is_one_batch([ONE] * 5, (1,), 4, device="cpu")
    with pytest.raises(ValueError):
        pb.bls_hard_pow_plain(arr, torch.tensor((0, 1), dtype=torch.int32))
    assert [pb.bucket_for(n) for n in (0, 4, 5, 16, 17, 64, 65)] == \
        [4, 4, 16, 16, 64, 64, 64]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pb.pow_is_one_batch([ONE], (1,), 4)
        with pytest.raises(RuntimeError):
            pb.miller_finalexp_is_one_batch([[]])


# --- the JAX programs, under slow -------------------------------------------------

@pytest.mark.slow
def test_port_verdicts_match_jitted_jax_programs(items):
    """The JAX package's jitted programs on XLA:CPU (a multi-minute
    compile each) against the port's plain verdicts and limbs."""
    batch = [items[k] for k in ("good", "clean", "tampered")]
    lines = pb._pack_miller_lines(batch, 4)
    jok = np.asarray(jb._compiled_miller(4)(jnp.asarray(lines)))
    _, ok = pb.bls_miller_finalexp_plain(
        torch.from_numpy(lines), torch.tensor(pb.HARD_BITS, dtype=torch.int32))
    assert jok.tolist() == ok.tolist() == [True, True, False, True]
    easy = [bls.final_exp_easy(bls.miller_product(it)) for it in batch]
    arr = pb._pack(easy + [ONE])
    jok = np.asarray(jb._compiled(4, jb.HARD_BITS)(jnp.asarray(arr)))
    _, ok = pb.bls_hard_pow_plain(
        torch.from_numpy(arr), torch.tensor(pb.HARD_BITS, dtype=torch.int32))
    assert jok.tolist() == ok.tolist() == [True, True, False, True]


# --- the lane shapes the kernels treat apart ------------------------------------

LANE_SHAPES = ("one_pair", "all_identity", "pad", "zero")


@pytest.fixture(scope="module")
def lane_shapes(items):
    """One bucket-4 batch holding each lane shape the kernels treat apart:
    a 1-pair item, an item whose pairs are all absent (identity lines
    only), a pad lane, and a lane whose lines are all zero (f = 0). The
    JAX package's `miller_scan` (over the first step, eagerly: its jit
    takes minutes on XLA:CPU) and `pow_bits` (at a 2-bit exponent) against
    the port's plain versions on the same limbs; the plain fused kernel at
    a short exponent against the oracle."""
    import jax
    lines = pb._pack_miller_lines([items["one_pair"], items["none_pair"]], 4)
    lines[..., 3] = 0
    step = lines[:1]
    with jax.disable_jit():
        jm = np.asarray(jb.miller_scan(jnp.asarray(step)))
    pm = pb.miller_scan(torch.from_numpy(step)).numpy()
    easy = [bls.final_exp_easy(bls.miller_product(items["one_pair"])),
            ONE, ONE, tuple((0, 0) for _ in range(6))]
    arr = pb._pack(easy)
    with jax.disable_jit():
        jp = _stack(jb.pow_bits(_tree(arr, "jax"), (1, 1)))
    pp, _ = pb.bls_hard_pow_plain(torch.from_numpy(arr),
                                  torch.tensor((1, 1), dtype=torch.int32))
    short = pb.HARD_BITS[:12]
    out, ok = pb.bls_miller_finalexp_plain(
        torch.from_numpy(lines), torch.tensor(short, dtype=torch.int32))
    e = int("".join(map(str, short)), 2)
    want = [bls.f12_pow(bls.final_exp_easy(bls.miller_product(it)), e)
            for it in (items["one_pair"], [], [])] + \
        [tuple((0, 0) for _ in range(6))]
    return {"jax_miller": jm, "port_miller": pm, "jax_pow": jp,
            "port_pow": pp.numpy(), "fused": out.numpy(), "ok": ok.tolist(),
            "want": want}


@pytest.mark.parametrize("lane", range(len(LANE_SHAPES)), ids=LANE_SHAPES)
def test_lane_shape_matches_jax_and_oracle(lane_shapes, lane):
    r = lane_shapes
    assert np.array_equal(r["port_miller"][..., lane],
                          r["jax_miller"][..., lane])
    assert np.array_equal(r["port_pow"][..., lane], r["jax_pow"][..., lane])
    want = r["want"][lane]
    assert np.array_equal(r["fused"][..., lane], pb._pack([want])[..., 0])
    assert r["ok"][lane] == (want == ONE)
    if LANE_SHAPES[lane] == "zero":
        assert not r["fused"][..., lane].any()
