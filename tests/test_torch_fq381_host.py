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

static fq rd(void) {
  fq a;
  for (int k = 0; k < FQ_WORDS; k++) scanf("%x", &a.w[k]);
  return a;
}
static fq2 rd2(void) { fq2 a; a.c0 = rd(); a.c1 = rd(); return a; }
static void wr(const fq& a) {
  for (int k = 0; k < FQ_WORDS; k++)
    printf("%08x%c", a.w[k], k == FQ_WORDS - 1 ? '\n' : ' ');
}
static void wr2(const fq2& a) { wr(a.c0); wr(a.c1); }

int main(void) {
  char op[16];
  while (scanf("%15s", op) == 1) {
    if (!strcmp(op, "mul")) { fq a = rd(), b = rd(); wr(fq_mul(a, b)); }
    else if (!strcmp(op, "add")) { fq a = rd(), b = rd(); wr(fq_add(a, b)); }
    else if (!strcmp(op, "sub")) { fq a = rd(), b = rd(); wr(fq_sub(a, b)); }
    else if (!strcmp(op, "inv")) wr(fq_inv(rd()));
    else if (!strcmp(op, "mul2")) { fq2 a = rd2(), b = rd2(); wr2(fq2_mul(a, b)); }
    else if (!strcmp(op, "xi")) wr2(fq2_mul_xi(rd2()));
    else if (!strcmp(op, "inv2")) wr2(fq2_inv(rd2()));
    else if (!strcmp(op, "inv12")) {
      fq2 a[6], o[6];
      for (int i = 0; i < 6; i++) a[i] = rd2();
      f12_inv_serial(a, o);
      for (int i = 0; i < 6; i++) wr2(o[i]);
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
