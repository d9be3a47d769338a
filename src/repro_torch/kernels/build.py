"""Build and load the CUDA kernels (plain C interface, bound with ctypes).

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library under ``build/repro_torch/<hash>/`` at the root of the
checkout, keyed by a hash of every source and the flags, at first use.
The sources build in parallel, one ``nvcc`` each.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# K1-K4: one pointer to 20 int64 launch words (csrc/spgemm_entry.cuh)
_WORDS_ARGS = [_P]
# (route, elem_bytes, x, bits, cond, counts, n, c, h, w, x's four
#  strides, stream)
_ENCODE_ARGS = [_I, _I] + [_P] * 4 + [_I] * 4 + [_LL] * 4 + [_P]
# K6, K7: (route, piece, elem_bytes, cond, bits, out_bits, out_vals, n,
#  c, h, w, kh, kw, stride, stream)
_IM2COL_ARGS = [_I, _I, _I] + [_P] * 4 + [_I] * 7 + [_P]

# source → (exported C function, its argument types); every pointer and
# the stream is a c_void_p, so ctypes never cuts one to 32 bits
KERNELS = {
    "bitmap_spgemm.cu": ("repro_bitmap_spgemm", _WORDS_ARGS),
    "bitmap_spgemm_kfused.cu": ("repro_bitmap_spgemm_kfused", _WORDS_ARGS),
    "grouped_spgemm.cu": ("repro_grouped_spgemm", _WORDS_ARGS),
    "grouped_spgemm_kfused.cu": ("repro_grouped_spgemm_kfused",
                                 _WORDS_ARGS),
    "bitmap_encode.cu": ("repro_bitmap_encode", _ENCODE_ARGS),
    "sparse_im2col.cu": ("repro_sparse_im2col", _IM2COL_ARGS),
    "sparse_im2col_strided.cu": ("repro_sparse_im2col_strided",
                                 _IM2COL_ARGS),
}

_FUNCS: Dict[str, object] = {}
_LIBS = []            # keeps the loaded libraries alive


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns the paths.

    Libraries are written under a temporary name and renamed, so a
    concurrent or interrupted build never leaves a half-written file.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<name>.log``.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / f"lib{Path(src).stem}.so" for src in KERNELS}
    todo = [src for src, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = libs[src].with_suffix(f".so.tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{Path(src).stem}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[src])
    if failed:
        raise RuntimeError("repro_torch: nvcc failed for "
                           + "\n".join(failed))
    return libs


def function(src: str):
    """The ctypes entry point of ``csrc/<src>``, building on first use."""
    if src not in _FUNCS:
        for name, path in build().items():
            lib = ctypes.CDLL(str(path))
            symbol, argtypes = KERNELS[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS.append(lib)
            _FUNCS[name] = fn
    return _FUNCS[src]
