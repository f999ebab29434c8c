"""BLS12-381 Fq/Fq2/Fq12 arithmetic in torch and the two aggregate-commit
kernels, `bls_hard_pow` and `bls_miller_finalexp` (port of
`cometbft_tpu/ops/bls12.py`).

An aggregated commit verifies as `final_exp(prod miller(P_i, Q_i)) == 1`.
The JAX package runs two jitted programs for it, and this module replaces
each with a CUDA kernel written by hand (`csrc/bls_hard_pow.cu`,
`csrc/bls_miller_finalexp.cu`, on `csrc/fq381.cuh`):
- `bls_hard_pow` (JAX `_compiled`): the final exponentiation's hard part,
  a fixed square-and-multiply chain over Fq12 whose MSB-first exponent
  bits are a device tensor (HARD_BITS: 1,267 squarings, 632 multiplies);
- `bls_miller_finalexp` (JAX `_compiled_miller`): the shared-squaring
  Miller scan over line coefficients the host evaluated
  (`_pack_miller_lines`), the conjugation, the easy part and the same
  hard chain.
Each takes the JAX package's layout, int32 16-bit Montgomery limbs with
R = 2^384 (elements (6, 2, 24, B), lines (63, 2, 2, 3, 2, 24, B)), and
returns the final Fq12 element in canonical limbs with the verdict
`== 1` per lane, so the kernel and its plain version can be held exactly
on 288 integers a lane. The entry points return the verdicts only, as in
the JAX package.

Dispatch is by the tensor's device, as in `cuda_verify.py`: a CPU tensor
runs the plain torch version (`bls_hard_pow_plain`,
`bls_miller_finalexp_plain`), a CUDA tensor launches the kernel or
raises. `LAUNCHES` counts the launches.

The plain versions compute what the JAX functions compute, with another
inner form: an Fq element is 16 int64 limbs of 24 bits (the Montgomery
radix stays 2^384), products are column sums of a 16 x 16 outer product,
and an Fq12 product folds its 36 (or, for a sparse line, 18) Fq2 products
by degree and by xi = 1 + u in the column form before ONE Montgomery
reduction per coefficient. The JAX package reduces every Fq2 product and
every addition; that is ~10^4 torch operations an Fq12 product here,
against ~250. Results are canonical (< p), as the JAX package's are, so
the two are compared limb for limb.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .cuda_verify import _check, _launch, _require_cuda
# one canary error for every kernel of the port: the BLS checkers
# (aggsig/verify) raise it when a kernel batch answers a known-one or
# known-not-one canary item wrong
from .ed25519 import KernelCanaryError  # noqa: F401
from ..crypto.bls12381 import (P as P_INT, _HARD_EXP, X_ABS, XI, f2_pow,
                               prepare_pair_lines)
from ..device import resolve_device

NLIMBS = 24
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
R_INT = 1 << (NLIMBS * LIMB_BITS)            # Montgomery radix 2^384
ONE_MONT_INT = R_INT % P_INT

# final-exp hard-part bits, MSB-first (the leading 1 seeds the chain)
HARD_BITS = tuple(int(b) for b in bin(_HARD_EXP)[2:])

BUCKETS = (4, 16, 64)  # batch shapes of the kernels (aggsig tile widths)

MILLER_STEPS = X_ABS.bit_length() - 1  # Miller steps: |x|'s bits after the first
MILLER_PAIRS = 2            # the commit equation's fixed pair count

_P_M2_BITS = tuple(int(b) for b in bin(P_INT - 2)[2:])
_GAMMA2 = tuple(f2_pow(XI, i * (P_INT * P_INT - 1) // 6) for i in range(6))
assert all(g[1] == 0 for g in _GAMMA2)


# --- launch counts -------------------------------------------------------------

LAUNCHES = {"bls_hard_pow": 0, "bls_miller_finalexp": 0}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _launches_lock:
        LAUNCHES[name] += 1


# --- host limbs ---------------------------------------------------------------

def limbs_from_int(x: int) -> np.ndarray:
    x %= 1 << (NLIMBS * LIMB_BITS)
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMBS)],
                    dtype=np.int32)


def int_from_limbs(limbs) -> int:
    arr = np.asarray(limbs)
    return sum(int(arr[i]) << (LIMB_BITS * i) for i in range(NLIMBS))


def _mont_limbs(values: Sequence[int]) -> np.ndarray:
    """Python ints (each in [0, p)) -> (len, 24) int32 Montgomery limbs:
    `limbs_from_int(v * R % P)` for each, through one byte buffer."""
    raw = b"".join((v * R_INT % P_INT).to_bytes(48, "little")
                   for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, NLIMBS) \
        .astype(np.int32)


# --- the plain versions' inner form: 16 int64 limbs of 24 bits, leading ------
# An Fq element is (16, *batch) int64, limb axis FIRST (slices of the
# limb axis are then plain contiguous views); an Fq2 (16, *batch, 2); an
# Fq12 (16, *batch, 6, 2); Fq6 (16, *batch, 3, 2).

WB = 24
WMASK = (1 << WB) - 1
NW = 16
_NINV_W = (-pow(P_INT, -1, 1 << WB)) % (1 << WB)


def _w_list(x: int, n: int = NW) -> List[int]:
    return [(x >> (WB * k)) & WMASK for k in range(n)]


_CONSTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _const(name: str, device) -> torch.Tensor:
    """Constants in the inner form, limb axis first, cached per device."""
    key = (name, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        if name == "p":
            vals = _w_list(P_INT)
        elif name.startswith("comp"):      # 2^384 - m*p, m = name[4:]
            vals = _w_list((1 << (WB * NW)) - int(name[4:]) * P_INT)
        elif name == "bias12":             # 16 p^2 over 32 columns
            vals = _w_list(16 * P_INT * P_INT, 2 * NW)
        elif name == "bias2":              # p^2 over 32 columns
            vals = _w_list(P_INT * P_INT, 2 * NW)
        elif name == "one12":              # (16, 6, 2) Montgomery ONE
            vals = [[[_w_list(ONE_MONT_INT if (i, c) == (0, 0) else 0)[k]
                      for c in range(2)] for i in range(6)]
                    for k in range(NW)]
        elif name == "gamma2":             # (16, 6, 1) Montgomery γ2_i
            vals = [[[_w_list(g[0] * R_INT % P_INT)[k]] for g in _GAMMA2]
                    for k in range(NW)]
        else:
            raise KeyError(name)
        t = torch.tensor(vals, dtype=torch.int64, device=key[1])
        _CONSTS[key] = t
    return t


def _col(name: str, like: torch.Tensor) -> torch.Tensor:
    """A (n,) column constant shaped to broadcast against `like`."""
    c = _const(name, like.device)
    return c.view((c.shape[0],) + (1,) * (like.dim() - 1))


def _to_w(x: torch.Tensor) -> torch.Tensor:
    """(..., 24) 16-bit limbs -> (16, ...) int64 24-bit limbs."""
    x = x.to(torch.int64).reshape(x.shape[:-1] + (8, 3))
    v = x[..., 0] | (x[..., 1] << 16) | (x[..., 2] << 32)
    w = torch.stack([v & WMASK, v >> WB], -1).reshape(x.shape[:-2] + (NW,))
    return torch.movedim(w, -1, 0).contiguous()


def _to_16(w: torch.Tensor) -> torch.Tensor:
    """(16, ...) canonical 24-bit limbs -> (..., 24) int32 16-bit limbs."""
    w = torch.movedim(w, 0, -1)
    w = w.reshape(w.shape[:-1] + (8, 2))
    v = w[..., 0] | (w[..., 1] << WB)
    return torch.stack([v & MASK, (v >> 16) & MASK, v >> 32], -1).reshape(
        w.shape[:-2] + (NLIMBS,)).to(torch.int32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Columns (n, ...) of a value in [0, 2^(24n)) -> canonical limbs.
    Columns may be negative or wide; every pass moves each column's
    carry one column up, until no carry is left (the top column keeps
    whatever reaches it, which the value's bound keeps below 2^24)."""
    x = x.clone()
    while True:
        c = x[:-1] >> WB
        if not bool(c.any()):
            return x
        x[:-1] &= WMASK
        x[1:] += c


def _csub(r: torch.Tensor, m: int) -> torch.Tensor:
    """Canonical r < 2^384 -> r - m*p where r >= m*p, else r: r + (2^384 -
    m*p) carries out of the top limb exactly when r >= m*p."""
    d = _norm(torch.cat([r + _col(f"comp{m}", r), torch.zeros_like(r[:1])]))
    return torch.where(d[NW] != 0, d[:NW], r)


def _redc(t: torch.Tensor, mults: Tuple[int, ...]) -> torch.Tensor:
    """Montgomery reduction of 32 columns T (value in [0, p*R) times the
    bound the caller states) -> T * 2^-384 mod p, canonical. Word-serial
    over 16 limbs of 24 bits; `mults` are the conditional subtractions
    that bring (T + m*p) / R below p."""
    t = t.clone()
    p = _col("p", t)
    for i in range(NW):
        m = (t[i] & WMASK).mul_(_NINV_W).bitwise_and_(WMASK)
        t[i:i + NW].addcmul_(p, m)
        t[i + 1].add_(t[i] >> WB)
    r = _norm(t[NW:])
    for m in mults:
        r = _csub(r, m)
    return r


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limb products of (16, ...) a and b (trailing axes broadcast) as
    32 column sums, each < 16 * 2^48."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    out = torch.zeros((2 * NW,) + shape, dtype=torch.int64, device=a.device)
    a = a.expand((NW,) + shape).contiguous()     # same-shape operands
    b = b.expand((NW,) + shape).contiguous()     # keep addcmul_ vectorised
    for i in range(NW):
        out[i:i + NW].addcmul_(b, a[i])
    return out


def _fq_mul(a, b):
    return _redc(_conv(a, b), (1,))          # a*b < p^2: result < 1.11p


def _fq_add(a, b):
    return _csub(_norm(a + b), 1)


def _fq_sub(a, b):
    return _csub(_norm(a - b + _col("p", a)), 1)


def _fq_neg(a):
    return _fq_sub(torch.zeros_like(a), a)


def _fq_inv(a):
    """a^(p-2) (Fermat): 0 maps to 0, as in the JAX package."""
    acc = a
    for bit in _P_M2_BITS[1:]:
        acc = _fq_mul(acc, acc)
        if bit:
            acc = _fq_mul(acc, a)
    return acc


# Fq2 elements are (16, ..., 2): (c0, c1) with u^2 = -1.

def _f2_mul(a, b):
    pr = _conv(a[..., [0, 1, 0, 1]], b[..., [0, 1, 1, 0]])
    re = pr[..., 0] - pr[..., 1] + _col("bias2", pr[..., 0])
    im = pr[..., 2] + pr[..., 3]
    return _redc(torch.stack([re, im], -1), (1,))   # < 2p^2: < 1.21p


def _f2_mul_xi(a):
    """times xi = 1 + u: (a0 - a1, a0 + a1)."""
    return torch.stack([_fq_sub(a[..., 0], a[..., 1]),
                        _fq_add(a[..., 0], a[..., 1])], -1)


def _f2_inv(a):
    sq = _fq_mul(a, a)
    ni = _fq_inv(_fq_add(sq[..., 0], sq[..., 1]))
    conj = torch.stack([a[..., 0], _fq_neg(a[..., 1])], -1)
    return _fq_mul(conj, ni.unsqueeze(-1))


# Fq6 elements are (16, ..., 3, 2) over v (v^3 = xi): only the inversion
# of the easy part uses them. Coefficient-wise sums are _fq_add/_fq_sub.

def _f6_mul(a, b):
    idx = [(i, j) for i in range(3) for j in range(3)]
    pr = _f2_mul(a[..., [i for i, _ in idx], :], b[..., [j for _, j in idx], :])
    c = [None] * 5
    for n, (i, j) in enumerate(idx):
        v = pr[..., n, :]
        c[i + j] = v if c[i + j] is None else _fq_add(c[i + j], v)
    return torch.stack([_fq_add(c[0], _f2_mul_xi(c[3])),
                        _fq_add(c[1], _f2_mul_xi(c[4])), c[2]], -2)


def _f6_mul_v(a):
    return torch.stack([_f2_mul_xi(a[..., 2, :]), a[..., 0, :],
                        a[..., 1, :]], -2)


def _f6_inv(a):
    c0, c1, c2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    pr = _f2_mul(torch.stack([c0, c2, c1, c1, c0, c0], -2),
                 torch.stack([c0, c2, c1, c2, c1, c2], -2))
    sq0, sq2, sq1, m12, m01, m02 = (pr[..., n, :] for n in range(6))
    big_a = _fq_sub(sq0, _f2_mul_xi(m12))
    big_b = _fq_sub(_f2_mul_xi(sq2), m01)
    big_c = _fq_sub(sq1, m02)
    t = _f2_mul(torch.stack([c0, c1, c2], -2),
                torch.stack([big_a, big_c, big_b], -2))
    f = _fq_add(t[..., 0, :], _f2_mul_xi(_fq_add(t[..., 1, :], t[..., 2, :])))
    fi = _f2_inv(f)
    return _f2_mul(torch.stack([big_a, big_b, big_c], -2), fi.unsqueeze(-2))


# Fq12 elements are (16, ..., 6, 2) over the flat w-basis (w^6 = xi).

def _pairs(js):
    pairs = [(i, j) for i in range(6) for j in js]
    return (torch.tensor([i for i, _ in pairs]),
            torch.tensor([js.index(j) for _, j in pairs]),
            torch.tensor([i + j for i, j in pairs]))


_PAIRS = {"full": _pairs((0, 1, 2, 3, 4, 5)), "sparse": _pairs((0, 3, 5))}
_PAIRS_ON: Dict[Tuple[str, torch.device], tuple] = {}


def _pairs_on(kind: str, device) -> tuple:
    key = (kind, torch.device(device))
    got = _PAIRS_ON.get(key)
    if got is None:
        got = _PAIRS_ON[key] = tuple(t.to(key[1]) for t in _PAIRS[kind])
    return got


def _f12_mul_pairs(x, y, kind: str):
    """Coefficient products x_i * y_j over the pairs of `kind`, summed by
    degree k = i + j in the column form, degrees 6..10 folded down by xi,
    then one reduction per coefficient. Every coefficient of the sum lies
    in (-16p^2, 17p^2); 16p^2 is added before the reduction, so the
    reduction's input is in [0, 33p^2) and its result below 4.4p."""
    ii, jj, kk = _pairs_on(kind, x.device)
    # the four component products a0b0, a0b1, a1b0, a1b1 of every pair
    a = x[..., ii, :][..., [0, 0, 1, 1]]              # (16, ..., P, 4)
    b = y[..., jj, :][..., [0, 1, 0, 1]]
    pr = _conv(a, b)                                   # (32, ..., P, 4)
    s = torch.zeros(pr.shape[:-2] + (11, 4), dtype=torch.int64,
                    device=x.device)
    s.index_add_(pr.dim() - 2, kk, pr)
    re = s[..., 0] - s[..., 3]                          # (32, ..., 11)
    im = s[..., 1] + s[..., 2]
    lo_re = re[..., :6].clone()
    lo_im = im[..., :6].clone()
    lo_re[..., :5] += re[..., 6:] - im[..., 6:]
    lo_im[..., :5] += re[..., 6:] + im[..., 6:]
    t = torch.stack([lo_re, lo_im], -1)
    return _redc(t + _col("bias12", t), (4, 2, 1))


def _f12_mul(x, y):
    return _f12_mul_pairs(x, y, "full")


def _f12_mul_sparse(x, line):
    """x * (c0 + c3 w^3 + c5 w^5), line (16, ..., 3, 2)."""
    return _f12_mul_pairs(x, line, "sparse")


def _f12_conj(a):
    """a^(p^6): negate the odd-w coefficients."""
    odd = _fq_neg(a[..., 1::2, :])
    return torch.stack([a[..., 0, :], odd[..., 0, :], a[..., 2, :],
                        odd[..., 1, :], a[..., 4, :], odd[..., 2, :]], -2)


def _f12_frob2(a):
    """a^(p^2): coefficient i times γ2_i, which lies in Fq."""
    g = _const("gamma2", a.device)
    return _fq_mul(a, g.view((NW,) + (1,) * (a.dim() - 3) + g.shape[1:]))


def _f12_inv(a):
    big_a = a[..., 0::2, :]
    big_b = a[..., 1::2, :]
    den = _fq_sub(_f6_mul(big_a, big_a), _f6_mul_v(_f6_mul(big_b, big_b)))
    di = _f6_inv(den)
    ia = _f6_mul(big_a, di)
    ib = _f6_mul(_fq_neg(big_b), di)
    return torch.stack([ia[..., 0, :], ib[..., 0, :], ia[..., 1, :],
                        ib[..., 1, :], ia[..., 2, :], ib[..., 2, :]], -2)


def _final_exp_easy(f):
    """(p^6 - 1)(p^2 + 1): conj * inverse, then one p^2-Frobenius
    multiply (crypto/bls12381.final_exp_easy)."""
    m = _f12_mul(_f12_conj(f), _f12_inv(f))
    return _f12_mul(_f12_frob2(m), m)


def _pow_bits(m, bits: Sequence[int]):
    """m^e for MSB-first bits (bits[0] must be 1). A zero bit skips its
    multiply: the bits are public and the same for every lane."""
    if not bits or bits[0] != 1:
        raise ValueError("exponent bits must start with 1")
    acc = m
    for bit in bits[1:]:
        acc = _f12_mul(acc, acc)
        if bit:
            acc = _f12_mul(acc, m)
    return acc


def _is_one(x) -> torch.Tensor:
    """(16, ..., 6, 2) -> (...) bool, x == ONE."""
    one = _const("one12", x.device)
    one = one.view((NW,) + (1,) * (x.dim() - 3) + (6, 2))
    return (x == one).movedim(0, -1).flatten(-3).all(-1)


def _miller(lines):
    """lines (16, ..., STEPS, PAIRS, 2, 3, 2) -> conj of the
    shared-squaring Miller product, (16, ..., 6, 2)."""
    one = _const("one12", lines.device)
    lead = lines.shape[1:-5]
    f = one.view((NW,) + (1,) * len(lead) + (6, 2)).expand(
        (NW,) + lead + (6, 2))
    for s in range(lines.shape[-5]):
        f = _f12_mul(f, f)
        for pi in range(lines.shape[-4]):
            for phase in range(2):
                f = _f12_mul_sparse(f, lines[..., s, pi, phase, :, :])
    return _f12_conj(f)


# --- layouts ------------------------------------------------------------------

def _from_layout(arr: torch.Tensor) -> torch.Tensor:
    """(6, 2, 24, B) int32 -> (16, B, 6, 2) inner form."""
    return _to_w(arr.permute(3, 0, 1, 2))


def _to_layout(x: torch.Tensor) -> torch.Tensor:
    """(16, B, 6, 2) inner form -> (6, 2, 24, B) int32."""
    return _to_16(x).permute(1, 2, 3, 0).contiguous()


def _lines_inner(lines: torch.Tensor) -> torch.Tensor:
    """(STEPS, PAIRS, 2, 3, 2, 24, B) -> (16, B, STEPS, PAIRS, 2, 3, 2)."""
    return _to_w(torch.movedim(lines, -1, 0))


def _tree_to_t(x) -> torch.Tensor:
    """JAX-style tree (6 tuples of (24, ...) limbs) -> (16, ..., 6, 2)."""
    arr = torch.stack([torch.stack([torch.as_tensor(x[i][0]),
                                    torch.as_tensor(x[i][1])], -1)
                       for i in range(6)], -2)       # (24, ..., 6, 2)
    return _to_w(torch.movedim(arr, 0, -1))


def _t_to_tree(t: torch.Tensor):
    arr = torch.movedim(_to_16(t), -1, 0)           # (24, ..., 6, 2)
    return tuple((arr[..., i, 0], arr[..., i, 1]) for i in range(6))


def _limbs_last(a) -> torch.Tensor:
    """(24, ...) limbs -> inner (16, ...)."""
    return _to_w(torch.movedim(torch.as_tensor(a), 0, -1))


def _limbs_first(w: torch.Tensor) -> torch.Tensor:
    return torch.movedim(_to_16(w), -1, 0)


# --- the JAX package's functions, on its layout -------------------------------
# Fq: (24, ...) limbs. Fq12: a tree, 6 tuples (c0, c1) of (24, ...) limbs.

def mont_mul(a, b) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod P of canonical limbs."""
    return _limbs_first(_fq_mul(_limbs_last(a), _limbs_last(b)))


def add_mod(a, b) -> torch.Tensor:
    return _limbs_first(_fq_add(_limbs_last(a), _limbs_last(b)))


def sub_mod(a, b) -> torch.Tensor:
    return _limbs_first(_fq_sub(_limbs_last(a), _limbs_last(b)))


def fq_inv(a) -> torch.Tensor:
    return _limbs_first(_fq_inv(_limbs_last(a)))


def f12_mul(x, y):
    return _t_to_tree(_f12_mul(_tree_to_t(x), _tree_to_t(y)))


def f12_mul_sparse(x, line):
    """x * (c0 + c3 w^3 + c5 w^5), line = ((c0), (c3), (c5)) Fq2 pairs."""
    lt = torch.stack([torch.stack([torch.as_tensor(c[0]),
                                   torch.as_tensor(c[1])], -1)
                      for c in line], -2)            # (24, ..., 3, 2)
    lt = _to_w(torch.movedim(lt, 0, -1))
    return _t_to_tree(_f12_mul_sparse(_tree_to_t(x), lt))


def f12_conj(a):
    return _t_to_tree(_f12_conj(_tree_to_t(a)))


def f12_frob2(a):
    return _t_to_tree(_f12_frob2(_tree_to_t(a)))


def f12_inv(a):
    return _t_to_tree(_f12_inv(_tree_to_t(a)))


def final_exp_easy_j(f):
    return _t_to_tree(_final_exp_easy(_tree_to_t(f)))


def pow_bits(m, bits: Sequence[int]):
    return _t_to_tree(_pow_bits(_tree_to_t(m), bits))


def _is_one_mont(x) -> torch.Tensor:
    return _is_one(_tree_to_t(x))


def miller_scan(lines: torch.Tensor) -> torch.Tensor:
    """(STEPS, PAIRS, 2, 3, 2, 24, B) lines -> conj(f) packed
    (6, 2, 24, B), as the JAX package's `miller_scan`."""
    return _to_layout(_miller(_lines_inner(lines)))


# --- the kernels and their plain versions -------------------------------------

def bls_hard_pow_plain(arr: torch.Tensor, bits: torch.Tensor):
    """(6, 2, 24, B) int32 elements, (n,) int32 MSB-first bits ->
    (m^e as (6, 2, 24, B) int32 canonical limbs, (B,) bool m^e == 1)."""
    acc = _pow_bits(_from_layout(arr), [int(b) for b in bits.tolist()])
    return _to_layout(acc), _is_one(acc)


def bls_hard_pow(arr: torch.Tensor, bits: torch.Tensor):
    """The hard-part chain per lane: (m^e, m^e == 1). A CUDA tensor
    launches `csrc/bls_hard_pow.cu` (one block a lane); `bits[0]` must
    be 1."""
    if not _require_cuda(arr, "bls_hard_pow"):
        return bls_hard_pow_plain(arr, bits)
    b = arr.shape[-1]
    _check("arr", arr, (6, 2, NLIMBS, b), torch.int32, arr.device)
    _check("bits", bits, (bits.shape[0],), torch.int32, arr.device)
    out = torch.empty_like(arr)
    ok = torch.empty((b,), dtype=torch.bool, device=arr.device)
    if b:
        _launch("bls_hard_pow", arr.data_ptr(), bits.data_ptr(),
                bits.shape[0], out.data_ptr(), ok.data_ptr(), b)
        _count("bls_hard_pow")
    return out, ok


def bls_miller_finalexp_plain(lines: torch.Tensor, bits: torch.Tensor):
    """(STEPS, PAIRS, 2, 3, 2, 24, B) int32 lines, (n,) int32 hard bits
    -> (final_exp of the Miller product as (6, 2, 24, B) int32, (B,)
    bool == 1)."""
    f = _miller(_lines_inner(lines))
    acc = _pow_bits(_final_exp_easy(f), [int(b) for b in bits.tolist()])
    return _to_layout(acc), _is_one(acc)


def bls_miller_finalexp(lines: torch.Tensor, bits: torch.Tensor):
    """The fused aggregate-commit check per lane: Miller scan, conj,
    easy part, hard chain. A CUDA tensor launches
    `csrc/bls_miller_finalexp.cu` (one block a lane)."""
    if not _require_cuda(lines, "bls_miller_finalexp"):
        return bls_miller_finalexp_plain(lines, bits)
    b = lines.shape[-1]
    _check("lines", lines, (MILLER_STEPS, MILLER_PAIRS, 2, 3, 2, NLIMBS, b),
           torch.int32, lines.device)
    _check("bits", bits, (bits.shape[0],), torch.int32, lines.device)
    out = torch.empty((6, 2, NLIMBS, b), dtype=torch.int32,
                      device=lines.device)
    ok = torch.empty((b,), dtype=torch.bool, device=lines.device)
    if b:
        _launch("bls_miller_finalexp", lines.data_ptr(), bits.data_ptr(),
                bits.shape[0], out.data_ptr(), ok.data_ptr(), b)
        _count("bls_miller_finalexp")
    return out, ok


# --- host packing and the entry points ----------------------------------------

def _pack(elems) -> np.ndarray:
    """python F12 tuples -> (6, 2, NLIMBS, B) int32 Montgomery limbs."""
    vals = [f[i][c] for f in elems for i in range(6) for c in range(2)]
    if not vals:
        return np.zeros((6, 2, NLIMBS, 0), np.int32)
    limbs = _mont_limbs(vals).reshape(len(elems), 6, 2, NLIMBS)
    return np.ascontiguousarray(limbs.transpose(1, 2, 3, 0))


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


_BITS: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _bits_tensor(bits: Tuple[int, ...], device) -> torch.Tensor:
    key = (tuple(bits), torch.device(device))
    t = _BITS.get(key)
    if t is None:
        t = torch.tensor(list(bits), dtype=torch.int32, device=key[1])
        _BITS[key] = t
    return t


def pow_is_one_batch(elems, bits: Tuple[int, ...], bucket: int,
                     device=None) -> List[bool]:
    """`m^e == 1` per lane for python-int F12 elements on `device`
    (default cuda); pads the batch to the bucket with ONE (1^e == 1,
    sliced off)."""
    dev = resolve_device(device)
    if len(elems) > bucket:
        raise ValueError(f"batch {len(elems)} exceeds bucket {bucket}")
    identity = tuple(((1, 0) if i == 0 else (0, 0)) for i in range(6))
    batch = list(elems) + [identity] * (bucket - len(elems))
    arr = torch.from_numpy(_pack(batch)).to(dev)
    _, ok = bls_hard_pow(arr, _bits_tensor(bits, dev))
    return [bool(v) for v in ok[:len(elems)].tolist()]


def final_exp_is_one_batch(products, device=None) -> List[bool]:
    """Batched `final_exponentiation(m) == 1` verdicts for Miller
    products: the easy part on the host per element, the hard chain on
    `device` (default cuda), chunks of the largest bucket."""
    from ..crypto.bls12381 import final_exp_easy
    verdicts: List[bool] = []
    products = list(products)
    i = 0
    while i < len(products):
        chunk = products[i:i + BUCKETS[-1]]
        easied = [final_exp_easy(f) for f in chunk]
        verdicts.extend(pow_is_one_batch(easied, HARD_BITS,
                                         bucket_for(len(easied)), device))
        i += len(chunk)
    return verdicts


_IDENTITY_LINE_MONT = None


def _identity_line() -> np.ndarray:
    """(3, 2, NLIMBS) Montgomery limbs of the identity line 1 + 0*w^3 +
    0*w^5: the filler of zero-bit addition steps, absent pairs and pad
    lanes."""
    global _IDENTITY_LINE_MONT
    if _IDENTITY_LINE_MONT is None:
        arr = np.zeros((3, 2, NLIMBS), np.int32)
        arr[0, 0] = limbs_from_int(ONE_MONT_INT)
        _IDENTITY_LINE_MONT = arr
    return _IDENTITY_LINE_MONT


def _pack_miller_lines(items, bucket: int) -> np.ndarray:
    """Every pair's evaluated line coefficients in Montgomery limbs:
    items are lists of at most MILLER_PAIRS (P_g1, Q_g2) pairs (pairs
    with a None skipped); out is (STEPS, MILLER_PAIRS, 2, 3, 2, NLIMBS,
    bucket) int32. Pad lanes and absent slots carry identity lines, so
    a pad lane's product is ONE and its (sliced-off) verdict True."""
    if len(items) > bucket:
        raise ValueError(f"batch {len(items)} exceeds bucket {bucket}")
    out = np.zeros((MILLER_STEPS, MILLER_PAIRS, 2, 3, 2, NLIMBS, bucket),
                   np.int32)
    out[:, :, :, 0, 0, :, :] = _identity_line()[0, 0][None, None, None,
                                                      :, None]
    for b, pairs in enumerate(items):
        live = [(p, q) for p, q in pairs
                if p is not None and q is not None]
        if len(live) > MILLER_PAIRS:
            raise ValueError(
                f"item has {len(live)} pairs > {MILLER_PAIRS}")
        for pi, (p, q) in enumerate(live):
            slots, vals = [], []
            for s, (dbl, add) in enumerate(prepare_pair_lines(p, q)):
                for phase, ln in ((0, dbl), (1, add)):
                    if ln is None:
                        continue
                    slots.append((s, phase))
                    vals.extend(ln[c][comp] for c in range(3)
                                for comp in range(2))
            limbs = _mont_limbs(vals).reshape(len(slots), 3, 2, NLIMBS)
            for (s, phase), lm in zip(slots, limbs):
                out[s, pi, phase, :, :, :, b] = lm
    return out


def miller_finalexp_is_one_batch(items, device=None) -> List[bool]:
    """Fused `final_exp(prod miller(P_i, Q_i)) == 1` verdicts, one kernel
    call a chunk of the largest bucket on `device` (default cuda): the
    host evaluates the line coefficients, the kernel runs the Miller
    scan, the easy part and the hard chain. The caller (aggsig/verify)
    counts the Miller loops into crypto OP_COUNTERS."""
    dev = resolve_device(device)
    verdicts: List[bool] = []
    items = list(items)
    i = 0
    while i < len(items):
        chunk = items[i:i + BUCKETS[-1]]
        bucket = bucket_for(len(chunk))
        lines = torch.from_numpy(_pack_miller_lines(chunk, bucket)).to(dev)
        _, ok = bls_miller_finalexp(lines, _bits_tensor(HARD_BITS, dev))
        verdicts.extend(bool(v) for v in ok[:len(chunk)].tolist())
        i += len(chunk)
    return verdicts
