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


# --- the group arithmetic of csrc/fe25519_group.cuh -----------------------

GROUP_PROGRAM = r"""
#include <ucontext.h>
#include <vector>
#include <stdio.h>
#include <string.h>
#include <stdint.h>

// The group's 4 threads as 4 execution contexts of one host thread, run
// in lockstep: at each exchange a thread writes its value and passes
// control to the next; when control comes back round, every thread has
// written, and it reads. Two slot banks alternate, so the next
// exchange's writes never meet this one's reads. (4 std::threads behind
// a barrier ran 5-10x slower when the machine was loaded.)
static ucontext_t g_main, g_ctx[4];
static int g_rank, g_done;
static int g_bank[4];
static uint32_t g_slot[2][4];

static void pass_on(void) {
  const int r = g_rank;
  g_rank = (r + 1) & 3;
  swapcontext(&g_ctx[r], &g_ctx[g_rank]);
  g_rank = r;
}

static uint32_t* exchange(uint32_t v) {
  uint32_t* bank = g_slot[g_bank[g_rank]];
  g_bank[g_rank] ^= 1;
  bank[g_rank] = v;
  pass_on();
  return bank;
}

static uint32_t host_shfl(uint32_t v, int src) { return exchange(v)[src & 3]; }

static uint32_t host_ballot(bool p) {
  const uint32_t* bank = exchange(p ? 1u : 0u);
  uint32_t m = 0;
  for (int q = 0; q < 4; q++) m |= bank[q] << q;
  return m;
}

#define CBT_GROUP_SHFL(v, src) host_shfl((v), (src))
#define CBT_GROUP_BALLOT(p) host_ballot((p))
#include "fe25519_group.cuh"

struct Op {
  char name[8];
  uint32_t a[8], b[8];
};
struct Res {
  uint64_t v[3][4];
  int flag[4];
};

static uint64_t pair(const uint32_t* w, int r) {
  return (uint64_t)w[2 * r + 1] << 32 | w[2 * r];
}

static std::vector<Op> g_ops;
static std::vector<Res> g_res;

static void run(void) {
  const int r = g_rank;
  const std::vector<Op>* ops = &g_ops;
  std::vector<Res>* res = &g_res;
  for (size_t i = 0; i < ops->size(); i++) {
    const Op& op = (*ops)[i];
    Res& o = (*res)[i];
    uint64_t a = pair(op.a, r), b = pair(op.b, r);
    uint64_t* v = o.v[0];
    int f = 0;
    if (!strcmp(op.name, "mul")) v[r] = grp_mul(a, b, r);
    else if (!strcmp(op.name, "sq")) v[r] = grp_sq(a, r);
    else if (!strcmp(op.name, "add")) v[r] = grp_add(a, b, r);
    else if (!strcmp(op.name, "sub")) v[r] = grp_sub(a, b, r);
    else if (!strcmp(op.name, "neg")) v[r] = grp_neg(a, r);
    else if (!strcmp(op.name, "canon")) v[r] = grp_canon(a, r);
    else if (!strcmp(op.name, "zero")) f = grp_is_zero(a, r);
    else if (!strcmp(op.name, "eq")) f = grp_eq(a, b, r);
    else if (!strcmp(op.name, "par")) f = (int)grp_parity(a, r);
    else if (!strcmp(op.name, "dec"))
      f = grp_decompress(a, r, &o.v[0][r], &o.v[1][r], &o.v[2][r]);
    o.flag[r] = f;
  }
  if (++g_done == 4) swapcontext(&g_ctx[r], &g_main);
  pass_on();                        // the others finish their last op
}

static void wr(const uint64_t* v) {
  for (int q = 0; q < 4; q++)
    printf(" %08x %08x", (uint32_t)v[q], (uint32_t)(v[q] >> 32));
}

int main(void) {
  Op op;
  while (scanf("%7s", op.name) == 1) {
    for (int k = 0; k < 8; k++) scanf("%x", &op.a[k]);
    for (int k = 0; k < 8; k++) scanf("%x", &op.b[k]);
    g_ops.push_back(op);
  }
  g_res.resize(g_ops.size());
  static char stacks[4][1 << 16];
  for (int r = 0; r < 4; r++) {
    getcontext(&g_ctx[r]);
    g_ctx[r].uc_stack.ss_sp = stacks[r];
    g_ctx[r].uc_stack.ss_size = sizeof stacks[r];
    g_ctx[r].uc_link = &g_main;
    makecontext(&g_ctx[r], run, 0);
  }
  g_rank = 0;
  swapcontext(&g_main, &g_ctx[0]);
  for (const Res& o : g_res) {
    printf("%d %d %d %d", o.flag[0], o.flag[1], o.flag[2], o.flag[3]);
    for (int k = 0; k < 3; k++) wr(o.v[k]);
    printf("\n");
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def grp_host(tmp_path_factory):
    """Runs ops through the group header on 4 lockstep host threads ->
    per op (the 4 threads' flags, [value, y, t] as integers)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/fe25519_group.cuh for the host")
    d = tmp_path_factory.mktemp("fe25519_group_host")
    (d / "grp_host.cc").write_text(GROUP_PROGRAM)
    exe = d / "grp_host"
    subprocess.run([gxx, "-O1", "-std=c++17", "-I", str(CSRC),
                    "-o", str(exe), str(d / "grp_host.cc")], check=True,
                   capture_output=True)

    def run(ops):
        text = "\n".join(f"{name} {_words(a)} {_words(b)}"
                         for name, a, b in ops) + "\n"
        out = subprocess.run([str(exe)], input=text, capture_output=True,
                             text=True, check=True)
        rows = []
        for ln in out.stdout.splitlines():
            f = ln.split()
            rows.append(([int(x) for x in f[:4]],
                         [_from_words(f[4 + 8 * k:12 + 8 * k])
                          for k in range(3)]))
        assert len(rows) == len(ops)
        return rows
    return run


GROUP_OPS = {
    "mul": (2, lambda a, b: a * b),
    "sq": (1, lambda a: a * a),
    "add": (2, lambda a, b: a + b),
    "sub": (2, lambda a, b: a - b),
    "neg": (1, lambda a: -a),
}


def test_group_field_ops_match_integers(grp_host):
    """mul, sq, add, sub and neg of the 4-thread group on the edge values
    and seeded ones, every pair of them: results below 2^256 and equal
    mod p."""
    vals = _values()
    ops, want = [], []
    for name, (arity, fn) in sorted(GROUP_OPS.items()):
        args = [(a, 0) for a in vals] if arity == 1 else \
            [(a, b) for a in vals for b in vals]
        ops += [(name, a, b) for a, b in args]
        want += [fn(a) if arity == 1 else fn(a, b) for a, b in args]
    for (name, a, b), w, (_f, (g, _y, _t)) in zip(ops, want, grp_host(ops)):
        assert 0 <= g < 2**256, (name, a, b)
        assert g % P == w % P, (name, a, b)


def test_group_decisions_match_integers(grp_host):
    """The canonical form, equality with zero, equality and parity, each
    the same verdict on all 4 threads of the group."""
    vals = _values() + [P + 1, 2 * P, 2 * P - 1, 2**255, 2**64 - 1,
                        (2**192 - 1) << 64]
    ops = [("canon", a, 0) for a in vals] + [("zero", a, 0) for a in vals]
    ops += [("par", a, 0) for a in vals]
    ops += [("eq", a, b) for a in vals for b in vals]
    got = grp_host(ops)
    for (name, a, b), (flags, (g, _y, _t)) in zip(ops, got):
        assert len(set(flags)) == 1, (name, a, b, flags)
        f = flags[0]
        if name == "canon":
            assert g == a % P, a
        elif name == "zero":
            assert f == int(a % P == 0), a
        elif name == "par":
            assert f == (a % P) & 1, a
        else:
            assert f == int(a % P == b % P), (a, b)


def _dec_encodings():
    """The edge encodings of chip_smoke.py plus non-canonical and
    undecodable y, x = 0 with the sign bit set, real public keys and
    seeded random bytes."""
    rng = np.random.default_rng(43)
    encs = [b"\xff" * 32, (2**255 - 2).to_bytes(32, "little"),
            (1).to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
            (1 | (1 << 255)).to_bytes(32, "little"),
            (P - 1).to_bytes(32, "little"),
            ((P - 1) | (1 << 255)).to_bytes(32, "little"),
            (P).to_bytes(32, "little"), (P + 3).to_bytes(32, "little"),
            (2**255 - 1).to_bytes(32, "little"), bytes(32)]
    undecodable = 0
    while undecodable < 3:
        e = rng.bytes(32)
        if ref.pt_decompress(e) is None:
            encs.append(e)
            undecodable += 1
    encs += [ref.pubkey_from_seed(rng.bytes(32)) for _ in range(4)]
    encs += [rng.bytes(32) for _ in range(4)]
    return encs


def test_group_decompress_matches_oracle(grp_host):
    """The whole group decompression against ref_ed25519.pt_decompress
    (ZIP-215): validity on all 4 threads, x and T mod p on valid lanes,
    and y exactly as the bytes give it (sign bit cleared, unreduced)."""
    encs = _dec_encodings()
    got = grp_host([("dec", int.from_bytes(e, "little"), 0) for e in encs])
    seen_valid = seen_invalid = 0
    for e, (flags, (x, y, t)) in zip(encs, got):
        assert len(set(flags)) == 1, e.hex()
        want = ref.pt_decompress(e, zip215=True)
        assert flags[0] == int(want is not None), e.hex()
        assert y == int.from_bytes(e, "little") & (2**255 - 1)
        if want is None:
            seen_invalid += 1
            continue
        seen_valid += 1
        assert all(0 <= c < 2**256 for c in (x, y, t))
        assert x % P == want[0] and y % P == want[1], e.hex()
        assert t % P == want[3], e.hex()
    assert seen_valid >= 10 and seen_invalid >= 4
