"""The port's four kernel wrappers (cometbft_tpu_torch/ops/cuda_verify.py)
held against the Pallas kernels they replace.

On the CPU each wrapper runs its plain torch version. The JAX side runs
the real Pallas kernel bodies (`pt_decompress_tiled_impl`,
`rlc_window_sums_impl`, `rlc_epilogue_impl`, `pt_add_tiled`) on the
exact-integer shadow backend of tools/interval_fuzz.py in subprocesses,
at TILE=8, started together by a module fixture so they run while the
port side computes. Comparison is exact: validity flags, points mod p, window sums
and sums of points as group elements, verdicts.

`test_kernels_match_plain_on_card` and `test_bls_kernels_match_plain_on_card`
need a CUDA card and skip without one; on the card they hold each CUDA
kernel (the four point kernels, and the two BLS kernels of ops/bls12.py)
against its plain version.
"""

import numpy as np
import pytest
import torch

import _shadow_jax
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.ops import cuda_verify as cv
from cometbft_tpu_torch.ops import ed25519 as ped
from cometbft_tpu_torch.ops import edwards as ted
from cometbft_tpu_torch.ops.field import fe_canonical, limbs_from_int

P = ref.P
N_DEC = 16
N_WS = 16
M_EP = 8
N_ADD = 16     # as tools/interval_fuzz.py runs pt_add_tiled (N % TILE == 0)


def _enc_inputs():
    rng = np.random.default_rng(21)
    encs = [ref.pubkey_from_seed(rng.bytes(32)) for _ in range(N_DEC - 8)]
    encs += [b"\xff" * 32, (2**255 - 2).to_bytes(32, "little"),
             (1).to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
             (1 | (1 << 255)).to_bytes(32, "little"),
             (P - 1).to_bytes(32, "little"), rng.bytes(32), rng.bytes(32)]
    return np.stack([np.frombuffer(e, np.uint8) for e in encs],
                    axis=-1).astype(np.int32)


def _rand_packed(rng, n):
    cs = [[], [], [], []]
    for _ in range(n):
        x, y, z, _t = ref.pt_mul(int(rng.integers(1, 2**60)), ref.BASE)
        zi = pow(z, P - 2, P)
        xa, ya = x * zi % P, y * zi % P
        for c, v in zip(cs, (xa, ya, 1, xa * ya % P)):
            c.append(limbs_from_int(v))
    return np.stack([np.stack(c, axis=-1) for c in cs]).astype(np.int32)


def _add_inputs(n=N_ADD, seed=22):
    """(p, q) packed (4, 16, n): random multiples of B, with lane 0 the
    identity plus a point, lane 1 a point plus its negation, lane 2 a
    point plus itself, and lane 3 an x limb-encoded as x + p (limbs in
    [0, 2^16) may hold any value below 2^256)."""
    rng = np.random.default_rng(seed)
    p, q = _rand_packed(rng, n), _rand_packed(rng, n)
    p[:, :, 0] = 0
    p[1, 0, 0] = p[2, 0, 0] = 1                       # identity
    q[:, :, 1] = p[:, :, 1]
    for c in (0, 3):                                  # -P: negate x and t
        v = sum(int(l) << (16 * k) for k, l in enumerate(p[c, :, 1]))
        q[c, :, 1] = limbs_from_int((P - v) % P)
    q[:, :, 2] = p[:, :, 2]
    x = sum(int(l) << (16 * k) for k, l in enumerate(p[0, :, 3]))
    if x + P < 2**256:
        p[0, :, 3] = limbs_from_int(x + P)
    return p, q


def _ws_inputs():
    rng = np.random.default_rng(12)
    return {"a_pt": _rand_packed(rng, N_WS), "r_pt": _rand_packed(rng, N_WS),
            "t_dig": rng.integers(0, 16, (64, N_WS)).astype(np.int32),
            "z_dig": rng.integers(0, 16, (32, N_WS)).astype(np.int32)}


def _affine_point(pt):
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def _horner_case(bad=False):
    """64 seeded nonzero digits d_i as s_dig, so every window picks up a
    non-identity [d_i]B, and -[S]B in window 0's last partial, S =
    sum 16^i d_i mod L: the points cancel only through the whole radix-16
    Horner (True). `bad` changes digit 40, and nothing cancels (False)."""
    d = np.random.default_rng(31).integers(1, 16, 64).astype(np.int32)
    s = sum(int(x) << (4 * i) for i, x in enumerate(d)) % ref.L
    xa, ya = _affine_point(ref.pt_mul(s, ref.BASE))
    folded = np.zeros((4, 16, 96, M_EP), np.int32)
    folded[1, 0] = 1
    folded[2, 0] = 1
    for ci, v in enumerate((P - xa, ya, 1, (P - xa) * ya % P)):
        folded[ci, :, 0, M_EP - 1] = limbs_from_int(v)
    if bad:
        d[40] = d[40] % 15 + 1
    return ("horner_bad" if bad else "horner"), folded, d, not bad


def _epilogue_cases():
    """(name, folded, s_dig, expected verdict), built as
    tests/test_pallas.py builds them: P and -P cancelling inside the
    fold, an uncancelled point, and [S]B cancelled by an -R window; and
    the all-window Horner case."""
    ident = np.zeros((4, 16, 96, M_EP), np.int32)
    ident[1, 0] = 1
    ident[2, 0] = 1
    xa, ya = _affine_point(ref.pt_mul(12345, ref.BASE))
    cancel = ident.copy()
    for ci, v in enumerate((xa, ya, 1, xa * ya % P)):
        cancel[ci, :, 5, 0] = limbs_from_int(v)
    for ci, v in enumerate((P - xa, ya, 1, (P - xa) * ya % P)):
        cancel[ci, :, 5, 3] = limbs_from_int(v)
    loose = ident.copy()
    for ci, v in enumerate((xa, ya, 1, xa * ya % P)):
        loose[ci, :, 7, 1] = limbs_from_int(v)
    x3, y3 = _affine_point(ref.pt_mul(3, ref.BASE))
    sb = ident.copy()
    for ci, v in enumerate((P - x3, y3, 1, (P - x3) * y3 % P)):
        sb[ci, :, 64, 2] = limbs_from_int(v)    # R window 0 -> window 0
    s3 = np.zeros((64,), np.int32)
    s3[0] = 3
    return [("cancel", cancel, np.zeros((64,), np.int32), True),
            ("loose", loose, np.zeros((64,), np.int32), False),
            ("sb", sb, s3, True), _horner_case()]


@pytest.fixture(scope="module")
def shadow():
    """The JAX side, one subprocess per job group so they run in
    parallel (an epilogue case alone takes about 25 s on the shadow
    backend)."""
    inputs = {"pt_decompress_tiled.enc": _enc_inputs()}
    inputs.update({f"rlc_window_sums.{k}": v
                   for k, v in _ws_inputs().items()})
    groups = [(inputs, ["pt_decompress_tiled", "rlc_window_sums"])]
    p, q = _add_inputs()
    groups.append(({"pt_add_tiled.p": p, "pt_add_tiled.q": q},
                   ["pt_add_tiled"]))
    for name, folded, sdig, _ in _epilogue_cases():
        job = f"rlc_epilogue@{name}"
        groups.append(({f"{job}.folded": folded,
                        f"{job}.b_tab": ted.small_base_table(),
                        f"{job}.s_dig": sdig}, [job]))
    sh = _shadow_jax.start_many(groups)
    yield sh
    sh.close()


def _canon(x):
    return fe_canonical(torch.as_tensor(x)).numpy()


def test_decompress_plain_matches_pallas(shadow):
    enc = torch.as_tensor(_enc_inputs())
    pt, ok = cv.pt_decompress_tiled(enc)
    assert pt.dtype == torch.int32 and pt.shape == (4, 16, N_DEC)
    assert int(pt.min()) >= 0 and int(pt.max()) < 2**16
    out = shadow.result()
    jpt, jok = out["pt_decompress_tiled.out0"], out["pt_decompress_tiled.out1"]
    assert np.array_equal(ok.numpy(), jok)
    assert 0 < jok.sum() < N_DEC
    for c in range(4):
        assert np.array_equal(_canon(pt[c])[:, jok], _canon(jpt[c])[:, jok])
    assert np.array_equal(pt[1].numpy(), jpt[1])   # y unreduced, as bytes


def test_window_sums_plain_matches_pallas(shadow):
    ins = {k: torch.as_tensor(v) for k, v in _ws_inputs().items()}
    got = cv.rlc_window_sums(ins["a_pt"], ins["r_pt"], ins["t_dig"],
                             ins["z_dig"])
    assert got.shape == (cv.n_tiles(N_WS), 96, 4, 16, cv.TAIL)
    want = shadow.result()["rlc_window_sums.out0"]   # (G, 96, 4, 16, 8)

    def per_window(parts):       # (G, 96, 4, 16, T) -> coords (16, 96)
        t = torch.as_tensor(parts).permute(2, 3, 1, 0, 4)
        return ted.pt_tree_sum(tuple(t[c].reshape(16, 96, -1)
                                     for c in range(4)))

    assert ted.pt_eq(per_window(got.numpy()), per_window(want)).all()


def test_window_sums_ragged_edge_plain():
    """A lane count that does not divide the LANE_TILE-lane chunk: the
    last chunk holds 6 lanes, and the chunks' partials sum to the plain
    per-window lane sums over the real lanes."""
    rng = np.random.default_rng(13)
    n = cv.LANE_TILE + 6
    a, r = _rand_packed(rng, n), _rand_packed(rng, n)
    td = rng.integers(0, 16, (64, n)).astype(np.int32)
    zd = rng.integers(0, 16, (32, n)).astype(np.int32)
    got = cv.rlc_window_sums(*map(torch.as_tensor, (a, r, td, zd)))
    assert got.shape[0] == 2
    folded = cv.fold_partials(got)                    # M padded to 2
    assert folded.shape == (4, 16, 96, 2)
    tot = ted.pt_tree_sum(cv.unpack_point(folded.long()))
    sel_a = ted.lookup_windows(
        ted.window_table(cv.unpack_point(torch.as_tensor(a))),
        torch.as_tensor(td))
    sel_r = ted.lookup_windows(
        ted.window_table(cv.unpack_point(torch.as_tensor(r))),
        torch.as_tensor(zd))
    want = tuple(torch.cat([x, y], dim=1)
                 for x, y in zip(ted.pt_tree_sum(sel_a),
                                 ted.pt_tree_sum(sel_r)))
    assert ted.pt_eq(tot, want).all()


def test_epilogue_plain_matches_pallas(shadow):
    b_tab = torch.as_tensor(ted.small_base_table())
    out = shadow.result()
    for name, folded, sdig, expect in _epilogue_cases():
        got = cv.rlc_epilogue(torch.as_tensor(folded), b_tab,
                              torch.as_tensor(sdig))
        assert got.shape == () and got.dtype == torch.bool
        assert bool(got) == bool(out[f"rlc_epilogue@{name}.out0"]) == \
            expect, name
    # the Horner case with one digit changed, plain only: the shadow
    # backend would pay another 25 s for it
    _, folded, sdig, expect = _horner_case(bad=True)
    assert expect is False
    assert not bool(cv.rlc_epilogue(torch.as_tensor(folded), b_tab,
                                    torch.as_tensor(sdig)))
    with pytest.raises(ValueError):
        cv.rlc_epilogue(torch.zeros((4, 16, 96, 3), dtype=torch.int32),
                        b_tab, torch.zeros((64,), dtype=torch.int32))


def test_pt_add_plain_matches_pallas(shadow):
    p, q = _add_inputs()
    got = cv.pt_add_tiled(torch.as_tensor(p), torch.as_tensor(q))
    assert got.dtype == torch.int32 and got.shape == (4, 16, N_ADD)
    assert int(got.min()) >= 0 and int(got.max()) < 2**16
    want = shadow.result()["pt_add_tiled.out0"]
    g, w = cv.unpack_point(got.long()), cv.unpack_point(torch.as_tensor(want))
    assert ted.pt_eq(g, w).all()
    assert bool(ted.pt_is_identity(g)[1])             # P + (-P)
    for i in (0, 2, 3):                               # against the oracle
        def pt(a):
            return tuple(sum(int(l) << (16 * k) for k, l in
                             enumerate(a[c, :, i])) % P for c in range(4))
        assert ref.pt_eq(pt(got.numpy()), ref.pt_add(pt(p), pt(q)))


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor; any other
    device launches the kernel or raises, never falls back."""
    enc = torch.zeros((32, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cv.pt_decompress_tiled(enc)
    pt = torch.zeros((4, 16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cv.pt_add_tiled(pt, pt)


def _rlc_core_two_calls(pub, sig, hblocks, hnblocks, z):
    """`verify_rlc_core_cuda` as it was with one decompression call for
    A and one for R."""
    r_enc, s = ped._split_sig(sig)
    a_pt, a_ok = cv.pt_decompress_tiled(
        pub.movedim(-1, 0).to(torch.int32).contiguous())
    r_pt, r_ok = cv.pt_decompress_tiled(r_enc.to(torch.int32).contiguous())
    k = ped._challenge(hblocks, hnblocks)
    struct_ok, s_sum, z16, t = ped._scalar_side(s, ped.sc_lt_l(s), a_ok,
                                                r_ok, k, z)
    out = cv.rlc_window_sums(
        ped._neg_packed(a_pt), ped._neg_packed(r_pt),
        ped.sc_nibbles(t).to(torch.int32).contiguous(),
        ped.sc_nibbles(z16)[:ped.ZWIN].to(torch.int32).contiguous())
    b_tab = torch.as_tensor(ted.small_base_table())
    return cv.rlc_epilogue(
        cv.fold_partials(out), b_tab,
        ped.sc_nibbles(s_sum).to(torch.int32).contiguous()), struct_ok


def test_rlc_core_one_decompress_call(monkeypatch):
    """The RLC verify decodes A and R in one call of 2N lanes, and gives
    the (batch_ok, struct_ok) of the two-call version on a tile with an
    undecodable A lane and an undecodable R lane: True while only those
    are bad, False once a signature's s is tampered."""
    rng = np.random.default_rng(23)
    n = 8
    seeds = [rng.bytes(32) for _ in range(n)]
    msgs = [b"vote %d" % i for i in range(n)]
    pubs = [ref.pubkey_from_seed(sd) for sd in seeds]
    sigs = [ref.sign(sd, m) for sd, m in zip(seeds, msgs)]
    bad = next(e for e in (rng.bytes(32) for _ in range(64))
               if ref.pt_decompress(e) is None)
    pubs[2] = bad
    sigs[5] = bad + sigs[5][32:]
    calls = []
    real = cv.pt_decompress_tiled

    def counted(enc):
        calls.append(enc.shape[-1])
        return real(enc)
    monkeypatch.setattr(cv, "pt_decompress_tiled", counted)
    for tamper in (False, True):
        if tamper:
            sigs[6] = sigs[6][:40] + bytes([sigs[6][40] ^ 1]) + sigs[6][41:]
        pub, sig, hb, hn, _ = ped.prepare_batch(pubs, msgs, sigs, n, 128)
        args = [torch.as_tensor(x) for x in
                (pub, sig, hb, hn, ped.make_rlc_coefficients(n, rng))]
        del calls[:]
        ok, struct = ped.verify_rlc_core_cuda(*args)
        assert calls == [2 * n]
        ok2, struct2 = _rlc_core_two_calls(*args)
        assert calls == [2 * n, n, n]
        assert bool(ok) == bool(ok2) == (not tamper)
        assert torch.equal(struct, struct2)
        assert struct.tolist() == [i not in (2, 5) for i in range(n)]


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    # the edge encodings first; 512 lanes: the RLC verify's one call for
    # A and R of a 256-lane bucket; 8 and 200 lanes leave the last warp
    # and the last block part empty
    for n in (8, 200, 512):
        enc = np.concatenate([_enc_inputs()[:, ::-1], rng.integers(
            0, 256, (32, max(n - N_DEC, 0))).astype(np.int32)], -1)[:, :n]
        enc = torch.as_tensor(enc, device=dev).contiguous()
        pt, ok = cv.pt_decompress_tiled(enc)
        ppt, pok = cv.pt_decompress_plain(enc)
        assert torch.equal(ok, pok) and 0 < int(ok.sum()) < n
        assert torch.equal(pt[1], ppt[1])         # y as the bytes give it
        for c in range(4):
            assert torch.equal(fe_canonical(pt[c])[:, ok],
                               fe_canonical(ppt[c])[:, ok])
    for n in (8, 200, 3000):      # 3000: three chunks, the last part empty
        a, r = _rand_packed(rng, n), _rand_packed(rng, n)
        td = rng.integers(0, 16, (64, n)).astype(np.int32)
        zd = rng.integers(0, 16, (32, n)).astype(np.int32)
        args = [torch.as_tensor(x, device=dev) for x in (a, r, td, zd)]
        got = cv.rlc_window_sums(*args)
        want = cv.rlc_window_sums_plain(*args)
        assert ted.pt_eq(ted.pt_tree_sum(cv.unpack_point(
                             cv.fold_partials(got).long())),
                         ted.pt_tree_sum(cv.unpack_point(
                             cv.fold_partials(want).long()))).all()
    b_tab = torch.as_tensor(ted.small_base_table(), device=dev)
    for name, folded, sdig, expect in (*_epilogue_cases(),
                                       _horner_case(bad=True)):
        args = (torch.as_tensor(folded, device=dev), b_tab,
                torch.as_tensor(sdig, device=dev))
        assert bool(cv.rlc_epilogue(*args)) == \
            bool(cv.rlc_epilogue_plain(*args)) == expect, name
    for n in (8, 200):
        p, q = (torch.as_tensor(x, device=dev) for x in _add_inputs(n, n))
        got = cv.pt_add_tiled(p, q)
        assert int(got.min()) >= 0 and int(got.max()) < 2**16
        assert ted.pt_eq(cv.unpack_point(got.long()),
                         cv.unpack_point(cv.pt_add_tiled_plain(p, q)
                                         .long())).all()


@pytest.mark.cuda
def test_bls_kernels_match_plain_on_card():
    """`bls_miller_finalexp` and `bls_hard_pow` (ops/bls12.py) against
    their plain versions on the card at buckets 4 and 16: the final Fq12
    limbs and the verdicts exactly, the verdicts also against the host
    oracle (canaries, a clean and a tampered 2-pair item, a 1-pair item,
    pad lanes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    from cometbft_tpu_torch.crypto import bls12381 as bls
    from cometbft_tpu_torch.ops import bls12 as pb
    dev = torch.device("cuda")
    key = bls.Bls12381PrivKey.generate(seed=b"kernels-bls")
    msg = b"a canonical precommit sign-bytes stand-in, over 32 bytes"
    h = bls.hash_to_g2_cached(bls._fixed_msg(msg))
    pk, q = key.pub_key().point, bls.G2_GEN
    items = [[(bls.G1_NEG, q), (bls.G1_GEN, q)],
             [(bls.G1_NEG, bls.g2_decompress(key.sign(msg))), (pk, h)],
             [(bls.G1_NEG, bls.g2_decompress(key.sign(msg + b"!"))), (pk, h)],
             [(bls.G1_GEN, q), (bls.G1_GEN, q)], [(bls.G1_GEN, q)]]
    want = [True, True, False, False, False]
    bits = torch.tensor(pb.HARD_BITS, dtype=torch.int32, device=dev)
    for bucket in (4, 16):
        batch = items[:bucket - 1]
        lanes = want[:bucket - 1] + [True] * (bucket - len(batch))
        lines = torch.from_numpy(pb._pack_miller_lines(batch, bucket)).to(dev)
        out, ok = pb.bls_miller_finalexp(lines, bits)
        pout, pok = pb.bls_miller_finalexp_plain(lines, bits)
        assert torch.equal(out, pout) and torch.equal(ok, pok)
        assert ok.tolist() == lanes
        easy = [bls.final_exp_easy(bls.miller_product(it)) for it in batch]
        arr = torch.from_numpy(pb._pack(
            easy + [bls.F12_ONE] * (bucket - len(batch)))).to(dev)
        out, ok = pb.bls_hard_pow(arr, bits)
        pout, pok = pb.bls_hard_pow_plain(arr, bits)
        assert torch.equal(out, pout) and torch.equal(ok, pok)
        assert ok.tolist() == lanes
