"""Build and load the CUDA kernels of ``simd_dct_tpu_torch/csrc``.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each source
to an object; one more links them into a shared library with a plain C
interface, which ``ctypes`` loads (a few seconds; no PyTorch headers).
The library goes to ``simd_dct_tpu_torch/_build/<hash>/``, keyed by a hash
of the sources and flags, at first use; where the package directory cannot
be written (an installed package), to ``simd_dct_tpu_torch/<hash>/`` under
the user's cache directory (``$XDG_CACHE_HOME``, else ``~/.cache``).  It is
compiled to a temporary path and renamed into place, so a concurrent build
never sees a partial file.  A missing ``nvcc`` or a failed build raises
``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libsimd_dct_cuda.so"

# No --use_fast_math: the 'scalar' rounding mode divides by 255 and needs
# IEEE division.  -Xptxas -v writes registers and spills to build.log.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, then ``PATH``, then the default
    CUDA install; ``RuntimeError`` when none has it."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc not found (looked in "
        "$CUDA_HOME/bin, PATH and " + DEFAULT_CUDA_HOME + "/bin)")


def _writable(path: str) -> bool:
    """Whether ``path``, or the nearest directory above it that exists, can
    be written."""
    while not os.path.exists(path):
        parent = os.path.dirname(path)
        if parent == path:
            return False
        path = parent
    return os.access(path, os.W_OK | os.X_OK)


def build_root() -> str:
    """``BUILD_ROOT`` inside the package where it can be written, else the
    user's cache directory."""
    if _writable(BUILD_ROOT):
        return BUILD_ROOT
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(cache, "simd_dct_tpu_torch")


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if this exact set has not been built yet;
    return the library's path."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = os.path.join(build_root(), _digest(srcs))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cu = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in cu]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cu, objs)]
    tmp = f"{lib}.{tag}"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append((c, p.returncode, out + err))
    if all(rc == 0 for _, rc, _ in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.returncode, proc.stdout + proc.stderr))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        for c, _, text in logs:
            f.write(" ".join(c) + "\n" + text)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c, rc, text) for c, rc, text in logs if rc != 0]
    if failed:
        c, rc, text = failed[0]
        raise RuntimeError(f"nvcc failed (exit {rc}) on {c[-1]}:\n"
                           f"{text[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sdct_enc32.argtypes = [p, p, p, i, i, i, ll, i, i, i, p]
    lib.sdct_enc32.restype = i
    lib.sdct_dec32.argtypes = [p, p, p, i, i, i, p]
    lib.sdct_dec32.restype = i
    lib.sdct_roundtrip32.argtypes = [p, p, p, p, i, i, i, ll, p]
    lib.sdct_roundtrip32.restype = i
    lib.sdct_encq.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, i, p]
    lib.sdct_encq.restype = i
    lib.sdct_decq.argtypes = [p, p, p, i, i, i, i, p]
    lib.sdct_decq.restype = i
    lib.sdct_enc_stereo.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.sdct_enc_stereo.restype = i
    lib.sdct_dec_stereo.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.sdct_dec_stereo.restype = i
    lib.sdct_enc32_rgb.argtypes = [p, p, p, p, p, i, i, i, ll, i, p]
    lib.sdct_enc32_rgb.restype = i
    lib.sdct_dec32_rgb.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.sdct_dec32_rgb.restype = i
    lib.sdct_roundtrip32_rgb.argtypes = [p, p, p, p, p, p, p, i, i, i, ll, p]
    lib.sdct_roundtrip32_rgb.restype = i
    lib.sdct_enc420_rgb.argtypes = [p, p, p, p, p, i, i, i, ll, i, p]
    lib.sdct_enc420_rgb.restype = i
    lib.sdct_dec420_rgb.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.sdct_dec420_rgb.restype = i
    lib.sdct_tiles.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.sdct_tiles.restype = i
    lib.sdct_detile.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.sdct_detile.restype = i
    lib.sdct_probe.argtypes = [p, p, i, p]
    lib.sdct_probe.restype = i
    lib.sdct_error_string.argtypes = [i]
    lib.sdct_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The bound library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.sdct_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
