"""Builds the port's CUDA kernels from `cometbft_tpu_torch/csrc/` with
nvcc into shared libraries with a plain C interface, loaded with ctypes.

Each source is one `nvcc` process, and all of them start together at the
first use of any kernel, so `python3 chip_smoke.py` alone builds
everything. The output goes to `build/cometbft_tpu_torch/` under the
checkout (listed in .gitignore), named by a digest of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused
within a checkout. A failed build raises with the compiler's output:
there is no fallback behind it.

The port's host C++ sources (`csrc/host/*.cc`: the native log DB, the
ChaCha20-Poly1305 of the p2p link and the single-signature ed25519) are
built the same way by g++ into the same directory (`host_lib`), each at
its first use, named by a digest of its source, the `csrc/` headers it
includes and its flags. nvcc never sees them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cometbft_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# source name -> (exported function, argtypes)
KERNELS = {
    "pt_decompress": ("cbt_pt_decompress", (_P, _P, _P, _I, _P)),
    "rlc_window_sums": ("cbt_rlc_window_sums",
                        (_P, _P, _P, _P, _P, _P, _I, _P)),
    "rlc_epilogue": ("cbt_rlc_epilogue", (_P, _P, _P, _P, _I, _P)),
    "pt_add": ("cbt_pt_add", (_P, _P, _P, _I, _P)),
    "bls_hard_pow": ("cbt_bls_hard_pow", (_P, _P, _I, _P, _P, _I, _P)),
    "bls_miller_finalexp": ("cbt_bls_miller_finalexp",
                            (_P, _P, _I, _P, _P, _I, _P)),
}

_LOCK = threading.Lock()
_FNS: dict = {}
_LIBS: list = []          # keeps the CDLL handles alive
BUILD_LOG: dict = {}      # name -> {"seconds": s, "output": compiler text}

HOST_SRC = CSRC / "host"
# -O3: the ed25519 field products want the loops of fe25519.cuh
# unrolled, which -O3 does and -O2 does not
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_HOST_LIBS: dict = {}     # host source name -> ctypes.CDLL


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.suffix == ".cuh"
                                              or src.stem == name):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source that has no up-to-date library, one
    nvcc process per source, all started together. `verbose` adds
    `-Xptxas -v` (registers, spills) to the recorded output. Returns
    BUILD_LOG."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in KERNELS:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS,
                   *(("-Xptxas", "-v") if verbose else ()),
                   "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.monotonic())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            text, _ = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.monotonic() - t0,
                               "output": text}
            if proc.returncode != 0:
                failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return BUILD_LOG


def kernel_fn(name: str):
    """The ctypes function of kernel source `name`, built on first use."""
    fn = _FNS.get(name)
    if fn is None:
        build_all()
        with _LOCK:
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS.append(lib)
            sym, argtypes = KERNELS[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return fn


def _host_target(name: str) -> Path:
    src = (HOST_SRC / f"{name}.cc").read_bytes()
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src)
    for line in src.decode().splitlines():
        if line.startswith('#include "../'):
            h.update((CSRC / line.split('"')[1][3:]).read_bytes())
    return BUILD_DIR / f"host-{name}-{h.hexdigest()[:16]}.so"


def host_lib(name: str) -> ctypes.CDLL:
    """The library of host source `csrc/host/{name}.cc`, built by g++
    into BUILD_DIR on first use (raises with the compiler's output when
    the build fails). The caller declares argtypes and restype. ctypes
    releases the interpreter lock for the length of each call."""
    with _LOCK:
        lib = _HOST_LIBS.get(name)
        if lib is not None:
            return lib
        out = _host_target(name)
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found on PATH")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.monotonic()
            proc = subprocess.run(
                [gxx, *GXX_FLAGS, "-o", str(tmp),
                 str(HOST_SRC / f"{name}.cc")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            BUILD_LOG[f"host/{name}"] = {
                "seconds": time.monotonic() - t0, "output": proc.stdout}
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for host/{name}.cc "
                                   f"(rc {proc.returncode}):\n{proc.stdout}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _HOST_LIBS[name] = lib
        return lib
