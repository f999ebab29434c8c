"""The RLC batch-verify point kernels, written in CUDA for Hopper (port of
`cometbft_tpu/ops/pallas_verify.py`).

Each wrapper keeps the name of the Pallas entry it replaces and its
boundary layout: limb axis leading, lanes minor, int32 limbs in
[0, 2^16). Beside each wrapper is its plain torch version.

Dispatch is by the device of the input and nothing else:
- a CPU tensor runs the plain version (the tests' path);
- a CUDA tensor launches the kernel, built from `csrc/` at first use;
  a failed build or launch raises. There is no fallback from the kernel
  to the plain version.

`LAUNCHES` counts kernel launches per wrapper (one per launch, nowhere
else), so a run can show that its main path went through the kernels.
The count is taken under a lock: the pipelined blocksync and the device
server launch from threads of their own.

Kernels (sources in cometbft_tpu_torch/csrc/):
- `pt_decompress_tiled` (pt_decompress.cu): ZIP-215 decode, a lane's
  field arithmetic on a group of 4 threads (fe25519_group.cuh). The
  RLC verify decodes A and R in one call of 2N lanes.
- `rlc_window_sums` (rlc_window_sums.cu): two launches per call, so it
  counts 2. The first builds the per-lane tables of -A and -R; the second
  selects by digit and sums each 1024-lane chunk over a (chunk, window)
  grid; one partial point per (chunk, window).
- `rlc_epilogue` (rlc_epilogue.cu): fold, combine, [S]B, a Horner whose
  point operations are spread over a 4-lane group, cofactor, identity
  test; one verdict.
- `pt_add_tiled` (pt_add.cu): complete point addition per lane. Off the
  node path, as in the JAX package (its callers there are the op-level
  A/B and profiling tools); `chip_smoke.py` holds and times it.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from . import edwards as ed
from .field import fe_carry

LANE_TILE = 1024  # lanes per partial of rlc_window_sums (WS_CHUNK in the .cu)
TAIL = 1          # partials left per (chunk, window): the chunk sums to 1
A_WINDOWS = 64   # radix-16 digits of t_i = z_i * k_i (256-bit)
R_WINDOWS = 32   # radix-16 digits of the 128-bit z_i
N_WINDOWS = A_WINDOWS + R_WINDOWS

LAUNCHES = {"pt_decompress_tiled": 0, "rlc_window_sums": 0,
            "rlc_epilogue": 0, "pt_add_tiled": 0}
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str, n: int = 1) -> None:
    with _launches_lock:
        LAUNCHES[name] += n


def pack_point(p) -> torch.Tensor:
    """edwards 4-tuple (each (16, N)) -> packed (4, 16, N) int32, every
    limb strictly in [0, 2^16) (the kernel boundary contract)."""
    return torch.stack([fe_carry(c) for c in p]).to(torch.int32)


def unpack_point(a: torch.Tensor):
    return (a[0], a[1], a[2], a[3])


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _build.kernel_fn(kernel)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def _require_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one, raise otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


# --- kernel 1: ZIP-215 decompression ----------------------------------------

def pt_decompress_plain(enc: torch.Tensor):
    """(32, N) int32 bytes -> (packed (4, 16, N) int32, valid (N,) bool)."""
    pt, ok = ed.pt_decompress(enc, zip215=True)
    return pack_point(pt), ok


def pt_decompress_tiled(enc: torch.Tensor):
    """ZIP-215 decompression of (32, N) byte-leading encodings (int32
    0..255). Returns (packed (4, 16, N) int32, valid (N,) bool)."""
    if not _require_cuda(enc, "pt_decompress_tiled"):
        return pt_decompress_plain(enc)
    n = enc.shape[-1]
    _check("enc", enc, (32, n), torch.int32, enc.device)
    pt = torch.empty((4, 16, n), dtype=torch.int32, device=enc.device)
    ok = torch.empty((n,), dtype=torch.bool, device=enc.device)
    _launch("pt_decompress", enc.data_ptr(), pt.data_ptr(), ok.data_ptr(), n)
    _count("pt_decompress_tiled")
    return pt, ok


# --- kernel 2: window tables + digit select + lane tree ---------------------

def n_tiles(n: int) -> int:
    return (n + LANE_TILE - 1) // LANE_TILE


def rlc_window_sums_plain(a_pt: torch.Tensor, r_pt: torch.Tensor,
                          t_dig: torch.Tensor, z_dig: torch.Tensor
                          ) -> torch.Tensor:
    """Same contract as `rlc_window_sums`: each LANE_TILE-lane chunk's
    lanes are summed per window. The last chunk sums only the lanes it
    has, which is what the kernel's identity points past N come to."""
    n = a_pt.shape[-1]
    sel_a = ed.lookup_windows(ed.window_table(unpack_point(a_pt.long())),
                              t_dig.long())
    sel_r = ed.lookup_windows(ed.window_table(unpack_point(r_pt.long())),
                              z_dig.long())
    sel = tuple(torch.cat([ca, cr], dim=1) for ca, cr in zip(sel_a, sel_r))
    full = n // LANE_TILE * LANE_TILE
    parts = []                                        # coords (16, 96, *)
    if full:
        parts.append(ed.pt_tree_sum(tuple(
            c[..., :full].reshape(16, N_WINDOWS, -1, LANE_TILE)
            for c in sel)))
    if n > full:
        parts.append(tuple(c[..., None] for c in ed.pt_tree_sum(
            tuple(c[..., full:] for c in sel))))
    if not parts:
        return torch.empty((0, N_WINDOWS, 4, 16, TAIL), dtype=torch.int32,
                           device=a_pt.device)
    w = pack_point(tuple(torch.cat(cs, dim=-1) for cs in zip(*parts)))
    return w.permute(3, 2, 0, 1).contiguous()[..., None]  # (G, 96, 4, 16, 1)


def rlc_window_sums(a_pt: torch.Tensor, r_pt: torch.Tensor,
                    t_dig: torch.Tensor, z_dig: torch.Tensor) -> torch.Tensor:
    """Per-tile window partial sums for the RLC equation.

    a_pt, r_pt: (4, 16, N) packed -A / -R points; t_dig: (64, N) radix-16
    digits of t_i = z_i*k_i; z_dig: (32, N) digits of z_i.
    Returns (G, 96, 4, 16, TAIL) with G = ceil(N / LANE_TILE): windows
    0..63 are the -A windows, 64..95 the -R windows."""
    if not _require_cuda(a_pt, "rlc_window_sums"):
        return rlc_window_sums_plain(a_pt, r_pt, t_dig, z_dig)
    n = a_pt.shape[-1]
    dev = a_pt.device
    _check("a_pt", a_pt, (4, 16, n), torch.int32, dev)
    _check("r_pt", r_pt, (4, 16, n), torch.int32, dev)
    _check("t_dig", t_dig, (A_WINDOWS, n), torch.int32, dev)
    _check("z_dig", z_dig, (R_WINDOWS, n), torch.int32, dev)
    out = torch.empty((n_tiles(n), N_WINDOWS, 4, 16, TAIL),
                      dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # the tables, [table][lane][entry][32 words of X Y Z T]
    scratch = torch.empty((2, n, 16, 32), dtype=torch.int32, device=dev)
    _launch("rlc_window_sums", a_pt.data_ptr(), r_pt.data_ptr(),
            t_dig.data_ptr(), z_dig.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n)
    _count("rlc_window_sums", 2)    # the tables, then the window sums
    return out


# --- kernel 3: the epilogue -------------------------------------------------

def rlc_epilogue_plain(folded: torch.Tensor, b_tab: torch.Tensor,
                       s_dig: torch.Tensor) -> torch.Tensor:
    """Same contract as `rlc_epilogue`."""
    w = ed.pt_tree_sum(unpack_point(folded.to(torch.int64)))  # (16, 96)
    lo = ed.pt_add(tuple(c[:, :R_WINDOWS] for c in w),
                   tuple(c[:, A_WINDOWS:] for c in w))
    w = tuple(torch.cat([cl, c[:, R_WINDOWS:A_WINDOWS]], dim=1)
              for cl, c in zip(lo, w))
    w = ed.pt_add(w, ed._lookup_shared(b_tab, s_dig))
    acc = ed.horner_windows(w)
    acc = ed.pt_double(ed.pt_double(ed.pt_double(acc)))
    return ed.pt_is_identity(acc)


def rlc_epilogue(folded: torch.Tensor, b_tab: torch.Tensor,
                 s_dig: torch.Tensor) -> torch.Tensor:
    """folded: (4, 16, 96, M) window partials, M a power of two;
    b_tab: (16, 4, 16) shared [j]B table; s_dig: (64,) radix-16 digits of
    S = sum(z_i s_i). Returns the batch verdict as a 0-d bool tensor."""
    m = folded.shape[-1]
    if m < 1 or m & (m - 1):
        raise ValueError(f"rlc_epilogue: M={m} is not a power of two")
    if not _require_cuda(folded, "rlc_epilogue"):
        return rlc_epilogue_plain(folded, b_tab, s_dig)
    dev = folded.device
    _check("folded", folded, (4, 16, N_WINDOWS, m), torch.int32, dev)
    _check("b_tab", b_tab, (16, 4, 16), torch.int32, dev)
    _check("s_dig", s_dig, (A_WINDOWS,), torch.int32, dev)
    ok = torch.empty((1,), dtype=torch.bool, device=dev)
    _launch("rlc_epilogue", folded.data_ptr(), b_tab.data_ptr(),
            s_dig.data_ptr(), ok.data_ptr(), m)
    _count("rlc_epilogue")
    return ok[0]


def fold_partials(out: torch.Tensor) -> torch.Tensor:
    """(G, 96, 4, 16, TAIL) partials -> (4, 16, 96, M) with M = G*TAIL
    padded to a power of two with identity points (x=0, y=1, z=1, t=0),
    the epilogue's contract."""
    g, nwin = out.shape[0], out.shape[1]
    folded = out.permute(2, 3, 1, 0, 4).reshape(4, 16, nwin, g * TAIL)
    m = folded.shape[-1]
    m2 = 1 << (m - 1).bit_length()
    if m2 != m:
        ident = torch.zeros((4, 16, nwin, m2 - m), dtype=folded.dtype,
                            device=folded.device)
        ident[1, 0] = 1
        ident[2, 0] = 1
        folded = torch.cat([folded, ident], dim=-1)
    return folded.contiguous()


# --- kernel 4: lane-wise complete addition ----------------------------------

def pt_add_tiled_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Same contract as `pt_add_tiled`."""
    return pack_point(ed.pt_add(unpack_point(p.to(torch.int64)),
                                unpack_point(q.to(torch.int64))))


def pt_add_tiled(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition (add-2008-hwcd-3) of (4, 16, N) packed points,
    int32 limbs in [0, 2^16); any N. Returns (4, 16, N) int32 in the
    same layout."""
    if not _require_cuda(p, "pt_add_tiled"):
        return pt_add_tiled_plain(p, q)
    n = p.shape[-1]
    _check("p", p, (4, 16, n), torch.int32, p.device)
    _check("q", q, (4, 16, n), torch.int32, p.device)
    out = torch.empty((4, 16, n), dtype=torch.int32, device=p.device)
    _launch("pt_add", p.data_ptr(), q.data_ptr(), out.data_ptr(), n)
    _count("pt_add_tiled")
    return out
