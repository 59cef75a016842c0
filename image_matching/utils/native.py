"""ctypes bindings for the native host runtime (native/imtpu_native.cpp).

The library is built in-tree with `make -C native` (lazily on first use).
Callers fall back to pure-Python implementations when it cannot be built
or loaded; that is reported on stderr, never silently."""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_SRC_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                        "native"))
_SO_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "_native.so"))


def build(force: bool = False) -> None:
    """Compile the library from native/imtpu_native.cpp (`-B` rebuilds even
    when the .so looks fresh).  Raises RuntimeError with the compiler's
    output when the build fails."""
    cmd = ["make", "-C", _SRC_DIR] + (["-B"] if force else [])
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (rc {r.returncode}):\n"
                           f"{r.stdout}{r.stderr}")


def _ensure_built(path: str):
    """Build the shared library when missing or older than its source."""
    src = os.path.join(_SRC_DIR, "imtpu_native.cpp")
    if not os.path.exists(src):
        return
    if os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(src):
        return
    try:
        build()
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        print(f"# native library build failed, using the Python fallbacks: "
              f"{e}", file=sys.stderr)


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _SO_PATH
    _ensure_built(path)
    try:
        lib = ctypes.CDLL(path)
        lib.imtpu_parse_dat.restype = ctypes.c_long
        lib.imtpu_parse_dat.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_long,
        ]
        lib.imtpu_crt_compose_centered.restype = None
        lib.imtpu_crt_compose_centered.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_long,
            ctypes.c_long,
            np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.imtpu_enroll_group.restype = None
        lib.imtpu_enroll_group.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_uint32, ctypes.c_uint32,
            np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
        ]
        _LIB = lib
    except OSError as e:
        print(f"# native library not loaded, using the Python fallbacks: {e}",
              file=sys.stderr)
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def parse_dat(path: str, max_vals: int) -> np.ndarray | None:
    lib = _lib()
    if lib is None:
        return None
    out = np.empty(max_vals, dtype=np.float64)
    n = lib.imtpu_parse_dat(path.encode(), out, max_vals)
    if n < 0:
        return None
    return out[:n]


def enroll_group(m_plus_e: np.ndarray, primes: np.ndarray, psis: np.ndarray,
                 s_eval: np.ndarray, seed: int, group: int,
                 n_threads: int = 0) -> np.ndarray | None:
    """Host-side seeded symmetric encryption of one DB group (see
    native/imtpu_native.cpp imtpu_enroll_group): [B, N] int64 coeffs ->
    c0 [B, L, N] uint32 Montgomery/eval."""
    lib = _lib()
    if lib is None:
        return None
    if not n_threads:
        n_threads = os.cpu_count() or 1
    m_plus_e = np.ascontiguousarray(m_plus_e, dtype=np.int64)
    B, N = m_plus_e.shape
    primes = np.ascontiguousarray(primes, dtype=np.uint32)
    L = primes.shape[0]
    psis = np.ascontiguousarray(psis[:L], dtype=np.uint32)
    s_eval = np.ascontiguousarray(s_eval[:L], dtype=np.uint32)
    out = np.empty((B, L, N), dtype=np.uint32)
    lib.imtpu_enroll_group(m_plus_e, B, N, L, primes, psis, s_eval,
                           seed & 0xFFFFFFFF, group & 0xFFFFFFFF, out,
                           n_threads)
    return out


def crt_compose_centered(res: np.ndarray, primes) -> np.ndarray | None:
    """res: uint32 [..., L, n] standard residues -> centered float64 [..., n]."""
    lib = _lib()
    if lib is None:
        return None
    res = np.ascontiguousarray(res, dtype=np.uint32)
    shape = res.shape
    L, n = shape[-2], shape[-1]
    flat = res.reshape(-1, L, n)
    pr = np.asarray([int(p) for p in primes], dtype=np.uint64)
    out = np.empty((flat.shape[0], n), dtype=np.float64)
    for b in range(flat.shape[0]):
        lib.imtpu_crt_compose_centered(flat[b], L, n, pr, out[b])
    return out.reshape(shape[:-2] + (n,))
