"""The port's CUDA field and group arithmetic (`csrc/fe25519.cuh`) built
for the host with g++ and held against Python integers and the oracle
`crypto/ref_ed25519.py`.

The header is host-callable by design, so a small C++ program, compiled
under the test's temporary directory, reads operations on stdin and
writes the 8-word results back. Inputs are the edge values 0, 1, p - 1,
p, 2p + 37, 2^256 - 38 and 2^256 - 1 (any value below 2^256 stands for
its residue) and seeded random ones. Results must be below 2^256 by
construction and equal mod p. The test skips when there is no g++.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from cometbft_tpu_torch.crypto import ref_ed25519 as ref

P = ref.P
CSRC = Path(__file__).resolve().parents[1] / "cometbft_tpu_torch" / "csrc"
EDGES = [0, 1, P - 1, P, 2 * P + 37, 2**256 - 38, 2**256 - 1]

PROGRAM = r"""
#include <stdio.h>
#include <string.h>
#include "fe25519.cuh"

static fe rd(void) {
  fe a;
  for (int k = 0; k < 8; k++) scanf("%x", &a.w[k]);
  return a;
}
static void wr(const fe& a) {
  for (int k = 0; k < 8; k++) printf("%08x%c", a.w[k], k == 7 ? '\n' : ' ');
}
static ge rdp(void) {
  ge p;
  p.x = rd(); p.y = rd(); p.z = rd(); p.t = rd();
  return p;
}
static void wrp(const ge& p) { wr(p.x); wr(p.y); wr(p.z); wr(p.t); }

int main(void) {
  char op[8];
  while (scanf("%7s", op) == 1) {
    if (!strcmp(op, "mul")) { fe a = rd(), b = rd(); wr(fe_mul(a, b)); }
    else if (!strcmp(op, "sq")) wr(fe_sq(rd()));
    else if (!strcmp(op, "add")) { fe a = rd(), b = rd(); wr(fe_add(a, b)); }
    else if (!strcmp(op, "sub")) { fe a = rd(), b = rd(); wr(fe_sub(a, b)); }
    else if (!strcmp(op, "gadd")) { ge p = rdp(), q = rdp(); wrp(ge_add(p, q)); }
    else if (!strcmp(op, "gdbl")) wrp(ge_dbl(rdp()));
    else if (!strcmp(op, "gid")) printf("%d\n", ge_is_identity(rdp()) ? 1 : 0);
    else return 1;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def fe_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/fe25519.cuh for the host")
    d = tmp_path_factory.mktemp("fe25519_host")
    (d / "fe_host.cc").write_text(PROGRAM)
    exe = d / "fe_host"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", str(CSRC), "-o", str(exe),
                    str(d / "fe_host.cc")], check=True, capture_output=True)

    def run(lines):
        out = subprocess.run([str(exe)], input="\n".join(lines) + "\n",
                             capture_output=True, text=True, check=True)
        return [_from_words(ln.split()) for ln in out.stdout.splitlines()]
    return run


def _words(v: int) -> str:
    return " ".join(f"{(v >> (32 * k)) & 0xffffffff:x}" for k in range(8))


def _from_words(ws) -> int:
    return sum(int(w, 16) << (32 * k) for k, w in enumerate(ws))


def _values():
    rng = np.random.default_rng(41)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(9)]
    return EDGES + rand


FIELD_OPS = {
    "mul": (2, lambda a, b: a * b),
    "sq": (1, lambda a: a * a),
    "add": (2, lambda a, b: a + b),
    "sub": (2, lambda a, b: a - b),
}


@pytest.mark.parametrize("op", sorted(FIELD_OPS))
def test_field_op_matches_integers(fe_host, op):
    arity, want = FIELD_OPS[op]
    vals = _values()
    args = [(a,) for a in vals] if arity == 1 else \
        [(a, b) for a in vals for b in vals]
    got = fe_host([f"{op} " + " ".join(_words(v) for v in a) for a in args])
    assert len(got) == len(args)
    for a, g in zip(args, got):
        assert 0 <= g < 2**256
        assert g % P == want(*a) % P, (op, a)


def test_sq_agrees_with_mul(fe_host):
    """The 36-product squaring against the 64-product multiplication on
    the same words (equal mod p)."""
    vals = _values()
    got = fe_host([f"sq {_words(a)}" for a in vals] +
                 [f"mul {_words(a)} {_words(a)}" for a in vals])
    n = len(vals)
    assert all(s % P == m % P for s, m in zip(got[:n], got[n:]))


def _points():
    """Projective points of the curve: the identity, random multiples of
    B scaled by random Z, and one whose x is written as x + p."""
    rng = np.random.default_rng(42)
    pts = [(0, 1, 1, 0)]
    for _ in range(6):
        x, y, z, _t = ref.pt_mul(int(rng.integers(1, 2**62)), ref.BASE)
        zi = pow(z, P - 2, P)
        xa, ya = x * zi % P, y * zi % P
        lam = int.from_bytes(rng.bytes(32), "little") % P or 1
        pts.append((xa * lam % P, ya * lam % P, lam, xa * ya % P * lam % P))
    x, y, z, t = pts[1]
    pts.append((x + P if x + P < 2**256 else x, y, z, t))
    return pts


def _as_points(flat):
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


def _check_point(g, want):
    assert all(0 <= c < 2**256 for c in g)
    x, y, z, t = (c % P for c in g)
    assert z != 0 and x * y % P == t * z % P      # T = XY/Z holds
    assert ref.pt_eq((x, y, z, t), want)


def test_ge_add_matches_oracle(fe_host):
    """Complete addition over all pairs, P + (-P) and P + P included."""
    pts = _points()
    neg = ref.pt_neg(pts[2])
    pairs = [(p, q) for p in pts for q in pts] + [(pts[2], neg)]
    got = _as_points(fe_host([
        "gadd " + " ".join(_words(c) for c in (*p, *q)) for p, q in pairs]))
    for (p, q), g in zip(pairs, got):
        _check_point(g, ref.pt_add(tuple(c % P for c in p),
                                   tuple(c % P for c in q)))
    assert len(got) == len(pairs)
    assert ref.pt_is_identity(tuple(c % P for c in got[-1]))


def test_ge_dbl_matches_oracle(fe_host):
    pts = _points()
    got = _as_points(fe_host(
        ["gdbl " + " ".join(_words(c) for c in p) for p in pts]))
    assert len(got) == len(pts)
    for p, g in zip(pts, got):
        _check_point(g, ref.pt_double(tuple(c % P for c in p)))


def test_ge_is_identity_matches_oracle(fe_host):
    """The identity at any Z and written with y + p is the identity; a
    point with X = 0 but Y = -Z (the point of order 2) and the curve
    points are not."""
    pts = _points()
    lam = 0x1234567 % P
    cands = [(0, 1, 1, 0), (0, lam, lam, 0), (0, 1 + P, 1, 0),
             (0, P - lam, lam, 0), *pts[1:]]
    got = fe_host(["gid " + " ".join(_words(c) for c in p) for p in cands])
    assert got == [int(ref.pt_is_identity(tuple(c % P for c in p)))
                   for p in cands]
    assert got[:3] == [1, 1, 1] and not any(got[3:])
