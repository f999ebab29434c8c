"""Runs JAX reference functions on the exact-integer shadow backend of
`tools/interval_fuzz.py`, in a fresh interpreter.

The shadow backend executes the real Pallas kernel bodies and the real
`ops/ed25519.py` functions on numpy object arrays of Python ints, with no
XLA compile, so the port's tests can hold their plain versions against
the JAX package at a few lanes in seconds. It must own the `jax` module,
so it runs as a subprocess:

    python tests/_shadow_jax.py IN.npz OUT.npz job [job ...]

A job is a JOBS key, optionally tagged as "key@tag" to run one function
on several inputs. Each job reads its inputs from IN.npz under
"<job>.<arg>" and writes "<job>.out<i>" to OUT.npz. `start_many(...)`
launches one subprocess per group of jobs from a test, so slow jobs run
in parallel, and returns a handle whose `result()` waits and loads the
outputs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# job -> (module, function, argument names)
JOBS = {
    "pt_decompress_tiled": ("pallas_verify", "pt_decompress_tiled_impl",
                            ("enc",)),
    "rlc_window_sums": ("pallas_verify", "rlc_window_sums_impl",
                        ("a_pt", "r_pt", "t_dig", "z_dig")),
    "rlc_epilogue": ("pallas_verify", "rlc_epilogue_impl",
                     ("folded", "b_tab", "s_dig")),
    "pt_add_tiled": ("pallas_verify", "pt_add_tiled", ("p", "q")),
    "verify_rlc_core_pallas": ("ed25519", "verify_rlc_core_pallas",
                               ("pub", "sig", "hblocks", "hnblocks", "z")),
    "verify_core": ("ed25519", "verify_core",
                    ("pub", "sig", "hblocks", "hnblocks")),
}

_DTYPES = {"uint8": np.uint8, "int32": np.int64, "uint32": np.int64,
           "bool": np.bool_}


def _to_numpy(v):
    if isinstance(v, (tuple, list)):
        return [_to_numpy(e) for e in v]
    return np.asarray(v.a.astype(_DTYPES[v.dtype]))


def _flatten(v, out):
    if isinstance(v, list):
        for e in v:
            _flatten(e, out)
    else:
        out.append(v)
    return out


def _main(argv) -> int:
    src, dst, *jobs = argv
    os.environ["COMETBFT_TPU_PALLAS_TILE"] = "8"
    sys.path.insert(0, ROOT)
    from tools import interval_fuzz as fz
    fz._install_shim()
    import importlib

    inputs = np.load(src)
    results = {}
    for job in jobs:
        mod, fn_name, names = JOBS[job.split("@")[0]]
        fn = getattr(importlib.import_module(f"cometbft_tpu.ops.{mod}"),
                     fn_name)
        args = [fz.as_sa(inputs[f"{job}.{n}"]) for n in names]
        outs = _flatten(_to_numpy(fn(*args)), [])
        for i, o in enumerate(outs):
            results[f"{job}.out{i}"] = o
    np.savez(dst, **results)
    return 0


class Shadow:
    """A running shadow subprocess; `result()` waits for its outputs."""

    def __init__(self, inputs: dict, jobs):
        self._dir = tempfile.TemporaryDirectory()
        src = os.path.join(self._dir.name, "in.npz")
        self._dst = os.path.join(self._dir.name, "out.npz")
        np.savez(src, **inputs)
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH",)}
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), src, self._dst,
             *jobs], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._out = None

    def result(self, timeout: float = 600) -> dict:
        if self._out is None:
            try:
                so, se = self._proc.communicate(timeout=timeout)
            finally:
                if self._proc.poll() is None:
                    self._proc.kill()
                    self._proc.communicate()
            if self._proc.returncode != 0:
                self._dir.cleanup()
                raise RuntimeError(f"shadow jax rc={self._proc.returncode}"
                                   f"\n{so[-2000:]}\n{se[-4000:]}")
            with np.load(self._dst) as f:
                self._out = {k: f[k] for k in f.files}
            self._dir.cleanup()
        return self._out

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()
        self._dir.cleanup()


class Shadows:
    """Several shadow subprocesses, started together so they run in
    parallel; `result()` merges their outputs."""

    def __init__(self, groups):
        self._handles = [Shadow(inputs, jobs) for inputs, jobs in groups]

    def result(self, timeout: float = 600) -> dict:
        out = {}
        for h in self._handles:
            out.update(h.result(timeout))
        return out

    def close(self) -> None:
        for h in self._handles:
            h.close()


def start_many(groups) -> Shadows:
    """`groups`: (inputs, jobs) pairs, one subprocess each."""
    return Shadows(groups)


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
