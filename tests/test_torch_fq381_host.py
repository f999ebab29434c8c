"""The BLS kernels' field and tower arithmetic (`csrc/fq381.cuh`) built for
the host with g++ and held against Python integers and the oracle
`crypto/bls12381.py`.

The header's functions above its block section are host-callable, so a
small C++ program, compiled under the test's temporary directory, reads
operations on stdin and writes 12-word Montgomery results back. Inputs
are the edge values 0, 1, p - 1, R mod p and values just under p, and
seeded random ones; every result must be canonical (< p) and equal to the
integers' answer exactly. The header's constants (p, -p^-1 mod 2^32, ONE,
the p^2-Frobenius scalars) are checked against the integers they stand
for. The test skips when there is no g++.
"""

import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from cometbft_tpu_torch.crypto import bls12381 as bls

P = bls.P
R = 1 << 384
RINV = pow(R, -1, P)
CSRC = Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
EDGES = [0, 1, P - 1, R % P, P - 2, P - (1 << 32), P - (1 << 200)]

PROGRAM = r"""
#include <stdio.h>
#include <string.h>
#include "fq381.cuh"

static bls_smem S;

static fq rd(void) {
  fq a;
  for (int k = 0; k < FQ_WORDS; k++) scanf("%x", &a.w[k]);
  return a;
}
static fq2 rd2(void) { fq2 a; a.c0 = rd(); a.c1 = rd(); return a; }
static void rd12(fq2* a) { for (int i = 0; i < 6; i++) a[i] = rd2(); }
static void wr(const fq& a) {
  for (int k = 0; k < FQ_WORDS; k++)
    printf("%08x%c", a.w[k], k == FQ_WORDS - 1 ? '\n' : ' ');
}
static void wr2(const fq2& a) { wr(a.c0); wr(a.c1); }
static void wr12(const fq2* a) { for (int i = 0; i < 6; i++) wr2(a[i]); }
static int rdbits(int32_t* bits) {
  int n;
  scanf("%d", &n);
  for (int i = 0; i < n; i++) scanf("%d", &bits[i]);
  return n;
}

int main(void) {
  char op[16];
  static int32_t bits[2048], arr[6 * 2 * 24], lines[63 * 4 * 144], out[288];
  uint8_t ok;
  while (scanf("%15s", op) == 1) {
    if (!strcmp(op, "mul")) { fq a = rd(), b = rd(); wr(fq_mul(a, b)); }
    else if (!strcmp(op, "sq")) wr(fq_sq(rd()));
    else if (!strcmp(op, "add")) { fq a = rd(), b = rd(); wr(fq_add(a, b)); }
    else if (!strcmp(op, "sub")) { fq a = rd(), b = rd(); wr(fq_sub(a, b)); }
    else if (!strcmp(op, "red")) {
      uint32_t v[13];
      for (int k = 0; k < 13; k++) scanf("%x", &v[k]);
      wr(fq_reduce13(v));
    }
    else if (!strcmp(op, "inv")) wr(fq_inv(rd()));
    else if (!strcmp(op, "mul2")) {   // one group: a * b
      S.u[0] = rd2(); S.u[1] = rd2();
      const bls_small q = {1, 1, 1, {S.u}, {XF_ID}, {S.u + 1}, {S.u + 2},
                           {{0}}};
      bls_small_block(&S, q);
      wr2(S.u[2]);
    }
    else if (!strcmp(op, "xi")) {     // a * (1 + u)
      S.u[0] = rd2(); S.u[1].c0 = S.u[1].c1 = fq_one();
      const bls_small q = {1, 1, 1, {S.u}, {XF_ID}, {S.u + 1}, {S.u + 2},
                           {{0}}};
      bls_small_block(&S, q);
      wr2(S.u[2]);
    }
    else if (!strcmp(op, "inv2")) {
      S.u[0] = rd2();
      bls_f2_inv_block(&S, S.u + 1, S.u);
      wr2(S.u[1]);
    }
    else if (!strcmp(op, "inv12")) {
      rd12(S.f);
      f12_inv_block(&S, S.m, S.f);
      wr12(S.m);
    }
    else if (!strcmp(op, "mul12")) {
      rd12(S.f); rd12(S.m);
      f12_mul_block(&S, S.f, S.f, S.m, false);
      wr12(S.f);
    }
    else if (!strcmp(op, "sq12")) {
      rd12(S.f);
      f12_sq_block(&S, S.f, S.f);
      wr12(S.f);
    }
    else if (!strcmp(op, "cyc12")) {
      rd12(S.f);
      f12_cyc_block(&S, S.f, S.f);
      wr12(S.f);
    }
    else if (!strcmp(op, "easy12")) {   // s->f = the Miller product
      rd12(S.f);
      for (int i = 0; i < 6; i++) {
        S.gam[i].c0 = fq_gamma2(i);
        S.gam[i].c1 = fq_zero();
      }
      bls_easy_part(&S);
      wr12(S.m);
    }
    else if (!strcmp(op, "hard")) {     // one lane, (6, 2, 24, 1) limbs
      for (int k = 0; k < 288; k++) scanf("%d", &arr[k]);
      const int n = rdbits(bits);
      bls_hard_pow_lane(&S, arr, bits, n, out, &ok, 0, 1);
      for (int k = 0; k < 288; k++) printf("%d ", out[k]);
      printf("%d\n", ok);
    }
    else if (!strcmp(op, "miller")) {   // one lane of lines, B = 1
      for (int k = 0; k < 63 * 4 * 144; k++) scanf("%d", &lines[k]);
      const int n = rdbits(bits);
      bls_miller_lane(&S, lines, bits, n, out, &ok, 0, 1);
      for (int k = 0; k < 288; k++) printf("%d ", out[k]);
      printf("%d\n", ok);
    }
    else if (!strcmp(op, "consts")) {
      wr(fq_one());
      for (int i = 0; i < 6; i++) wr(fq_gamma2(i));
      printf("%08x\n", FQ_N0);
    }
    else return 1;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def fq_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/fq381.cuh for the host")
    d = tmp_path_factory.mktemp("fq381_host")
    (d / "fq_host.cc").write_text(PROGRAM)
    exe = d / "fq_host"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", str(CSRC), "-o", str(exe),
                    str(d / "fq_host.cc")], check=True, capture_output=True)

    def run(lines):
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n",
                             capture_output=True, text=True, check=True)
        return [sum(int(w, 16) << (32 * k) for k, w in enumerate(ln.split()))
                for ln in out.stdout.splitlines()]
    run.exe = exe
    return run


def _w(v: int) -> str:
    return " ".join(f"{(v >> (32 * k)) & 0xffffffff:x}" for k in range(12))


def _values():
    rng = random.Random(51)
    return EDGES + [rng.randrange(P) for _ in range(6)]


FQ_OPS = {
    "mul": lambda a, b: a * b * RINV % P,     # Montgomery product
    "add": lambda a, b: (a + b) % P,
    "sub": lambda a, b: (a - b) % P,
}


@pytest.mark.parametrize("op", sorted(FQ_OPS))
def test_fq_op_matches_integers(fq_host, op):
    vals = _values()
    args = [(a, b) for a in vals for b in vals]
    got = fq_host([f"{op} {_w(a)} {_w(b)}" for a, b in args])
    assert got == [FQ_OPS[op](a, b) for a, b in args]


def test_fq_inv_matches_integers(fq_host):
    vals = _values()
    got = fq_host([f"inv {_w(a)}" for a in vals])
    # Montgomery limbs a stand for a/R: the inverse's form is (a/R)^-1 R
    assert got == [pow(a * RINV, P - 2, P) * R % P for a in vals]
    assert got[0] == 0


def _mont2(x):
    return (x[0] * R % P, x[1] * R % P)


def test_fq2_ops_match_oracle(fq_host):
    rng = random.Random(52)
    vals = [(rng.randrange(P), rng.randrange(P)) for _ in range(6)] + \
        [(P - 1, P - 1), (1, 0), (0, 1)]
    lines, want = [], []
    for a in vals:
        for b in vals[:4]:
            lines.append(f"mul2 {_w(_mont2(a)[0])} {_w(_mont2(a)[1])} "
                         f"{_w(_mont2(b)[0])} {_w(_mont2(b)[1])}")
            want.extend(_mont2(bls.f2_mul(a, b)))
        lines.append(f"xi {_w(_mont2(a)[0])} {_w(_mont2(a)[1])}")
        want.extend(_mont2(bls.f2_mul(a, bls.XI)))
        lines.append(f"inv2 {_w(_mont2(a)[0])} {_w(_mont2(a)[1])}")
        want.extend(_mont2(bls.f2_inv(a)))
    assert fq_host(lines) == want


def test_f12_inv_serial_matches_oracle(fq_host):
    rng = random.Random(53)
    elems = [tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6)),
             bls.miller_loop(bls.G1_GEN, bls.G2_GEN)]
    for a in elems:
        got = fq_host(["inv12 " + " ".join(
            _w(v * R % P) for c in a for v in c)])
        want = [v * R % P for c in bls.f12_inv(a) for v in c]
        assert got == want


def test_header_constants(fq_host):
    from cometbft_tpu_torch.ops import bls12 as pb
    got = fq_host(["consts"])
    assert got[0] == R % P
    assert got[1:7] == [g[0] * R % P for g in pb._GAMMA2]
    assert got[7] == (-pow(P, -1, 1 << 32)) % (1 << 32)
    text = (CSRC / "fq381.cuh").read_text()
    body = text[text.index("fq_p_word(int i)"):]
    words = re.findall(r"0x([0-9a-f]{8})u", body)[:12]
    assert sum(int(w, 16) << (32 * k) for k, w in enumerate(words)) == P


# --- the new field routines and the block code (one lane, run phase by
# phase on the host) -------------------------------------------------------

def _lazy_values():
    """Factors of fq_mul may be lazy sums below 2p."""
    rng = random.Random(54)
    return [P, P + 1, 2 * P - 1, 2 * P - (1 << 100)] + \
        [rng.randrange(P, 2 * P) for _ in range(4)]


def test_fq_mul_lazy_and_sq_match_integers(fq_host):
    vals = _values()
    lazy = _lazy_values()
    args = [(a, b) for a in vals + lazy for b in vals + lazy]
    got = fq_host([f"mul {_w(a)} {_w(b)}" for a, b in args])
    assert got == [a * b * RINV % P for a, b in args]
    got = fq_host([f"sq {_w(a)}" for a in vals])
    assert got == [a * a * RINV % P for a in vals]


def test_fq_reduce13_matches_integers(fq_host):
    """The fold's one reduction: 13-word values below 64p, among them
    multiples of p and values next to them."""
    rng = random.Random(55)
    vals = [k * P + d for k in (0, 1, 2, 17, 63) for d in (0, 1)] + \
        [(k + 1) * P - 1 for k in (0, 5, 62)] + \
        [rng.randrange(64 * P) for _ in range(40)]
    got = fq_host([f"red {_w(v)} {(v >> 384):x}" for v in vals])
    assert got == [v % P for v in vals]


def _m12(a):
    return " ".join(_w(v * R % P) for c in a for v in c)


def _from_m12(words):
    return [v * R % P for c in words for v in c]


def _f12_inputs():
    rng = random.Random(56)
    elems = [tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))
             for _ in range(3)]
    elems += [tuple((P - 1, P - 1) for _ in range(6)), bls.F12_ONE,
              tuple((0, 0) for _ in range(6))]
    return elems


def test_f12_mul_and_squarings_match_oracle(fq_host):
    """The block's general product and squaring on any element; the
    cyclotomic squaring on elements the easy part produced, and on 0."""
    elems = _f12_inputs()
    lines, want = [], []
    for a in elems:
        for b in elems[:2]:
            lines.append(f"mul12 {_m12(a)} {_m12(b)}")
            want += _from_m12(bls.f12_mul(a, b))
        lines.append(f"sq12 {_m12(a)}")
        want += _from_m12(bls.f12_mul(a, a))
    cyc = [bls.final_exp_easy(a) for a in elems[:3]] + \
        [bls.final_exp_easy(bls.miller_loop(bls.G1_GEN, bls.G2_GEN)),
         tuple((0, 0) for _ in range(6))]
    for a in cyc:
        lines.append(f"cyc12 {_m12(a)}")
        want += _from_m12(bls.f12_mul(a, a))
    assert fq_host(lines) == want


def test_easy_part_matches_oracle(fq_host):
    """The spread inversion inside the easy part: f is the Miller product
    before its conjugation, the oracle's easy part takes conj(f)."""
    elems = _f12_inputs()
    elems = elems[:3] + [elems[4], elems[5],
                         bls.miller_loop(bls.G1_GEN, bls.G2_GEN)]
    got = fq_host([f"easy12 {_m12(a)}" for a in elems])
    want = []
    for a in elems:
        want += _from_m12(bls.final_exp_easy(bls.f12_conj(a)))
    assert got == want


def _lane_out(line):
    nums = [int(x) for x in line.split()]
    arr = np.array(nums[:288], np.int32).reshape(6, 2, 24, 1)
    return arr, bool(nums[288])


@pytest.fixture(scope="module")
def lane_host(fq_host, tmp_path_factory):
    """Runs the kernels' lanes on the host: text lines in, the raw output
    lines back (limbs and verdict)."""
    exe = fq_host.exe

    def run(lines):
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n",
                             capture_output=True, text=True, check=True)
        return [_lane_out(ln) for ln in out.stdout.splitlines()]
    return run


def _bits_text(bits):
    return f"{len(bits)} " + " ".join(str(b) for b in bits)


def test_hard_pow_lane_matches_oracle(lane_host):
    """bls_hard_pow's lane (general squarings) at the full hard exponent
    on an easy-part element and on a random one (not cyclotomic), and at a
    short exponent on ONE and on 0."""
    from cometbft_tpu_torch.ops import bls12 as pb
    rng = random.Random(57)
    m1 = bls.final_exp_easy(bls.miller_product(
        [(bls.G1_NEG, bls.G2_GEN), (bls.G1_GEN, bls.G2_GEN)]))
    m2 = tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))
    short = pb.HARD_BITS[:40]
    e_short = int("".join(map(str, short)), 2)
    cases = [(m1, pb.HARD_BITS, bls._HARD_EXP), (m2, pb.HARD_BITS,
                                                  bls._HARD_EXP),
             (bls.F12_ONE, short, e_short),
             (tuple((0, 0) for _ in range(6)), short, e_short)]
    lines = [f"hard {' '.join(map(str, pb._pack([m]).ravel()))} "
             f"{_bits_text(bits)}" for m, bits, _ in cases]
    for (arr, ok), (m, _, e) in zip(lane_host(lines), cases):
        want = bls.f12_pow(m, e)
        assert np.array_equal(arr, pb._pack([want]))
        assert ok == (want == bls.F12_ONE)


def test_miller_lane_matches_oracle(lane_host):
    """The fused lane on each kind of lane the kernel treats apart: a clean
    2-pair commit item, a 1-pair item, a pad lane (identity lines only,
    absent pairs), and a lane whose lines are all zero (f = 0), at the full
    hard exponent for the first and a short one for the rest."""
    from cometbft_tpu_torch.ops import bls12 as pb
    key = bls.Bls12381PrivKey.generate(seed=b"fq381-host-lane")
    msg = b"a precommit stand-in for the host lane, over 32 bytes"
    h = bls.hash_to_g2_cached(bls._fixed_msg(msg))
    clean = [(bls.G1_NEG, bls.g2_decompress(key.sign(msg))),
             (key.pub_key().point, h)]
    one_pair = [(bls.G1_GEN, bls.G2_GEN)]
    packed = pb._pack_miller_lines([clean, one_pair], 3)   # lane 2: pad
    short = pb.HARD_BITS[:24]
    e_short = int("".join(map(str, short)), 2)
    zero = np.zeros_like(packed[..., 0])
    cases = [(packed[..., 0], pb.HARD_BITS, clean),
             (packed[..., 1], short, one_pair),
             (packed[..., 2], short, []),
             (zero, short, None)]
    lines = [f"miller {' '.join(map(str, ln.ravel()))} {_bits_text(bits)}"
             for ln, bits, _ in cases]
    got = lane_host(lines)
    assert [ok for _, ok in got] == [True, False, True, False]
    for (arr, ok), (_, bits, item) in zip(got, cases):
        e = bls._HARD_EXP if bits is pb.HARD_BITS else e_short
        if item is None:
            want = tuple((0, 0) for _ in range(6))
        else:
            want = bls.f12_pow(bls.final_exp_easy(
                bls.miller_product(item)), e)
        assert np.array_equal(arr, pb._pack([want]))
        assert ok == (want == bls.F12_ONE)


@pytest.mark.parametrize("e", [1, 2, 3, 0b10001, 0b111111, 0b1000001,
                               0b11111011111, 0b100000100001,
                               0b101010101011])
def test_hard_pow_lane_window_exponents(lane_host, e):
    """The hard chain's sliding window (up to 5 bits ending on a one) at
    short exponents: a lone bit, windows cut by the end of the bits, runs
    of ones longer than a window, zeros between windows."""
    from cometbft_tpu_torch.ops import bls12 as pb
    rng = random.Random(58 + e)
    m = tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))
    bits = [int(b) for b in bin(e)[2:]]
    (arr, ok), = lane_host([f"hard {' '.join(map(str, pb._pack([m]).ravel()))}"
                            f" {_bits_text(bits)}"])
    assert np.array_equal(arr, pb._pack([bls.f12_pow(m, e)]))
