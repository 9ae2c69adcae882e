"""Build of the CUDA kernels at first use.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for sm_90a into an object file; one more `nvcc` links them into a
shared library with a plain C interface, which ctypes loads. The library
lands in `build/kernels/<key>/` at the root of the checkout (git-ignored),
keyed on a hash of the sources, the flags and the compiler's path, so a
changed source or flag builds anew and an unchanged one is reused.
`-Xptxas -v` reports each kernel's registers, shared memory and spills;
the report is kept beside the library and returned by `build()`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
LIB_NAME = "libceres_tpu_torch_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # wall time of this call's build; 0.0 when reused
    reused: bool
    ptxas: Dict[str, str]  # source name -> nvcc's -Xptxas -v report


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _key(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:20]


def _read_reports(out_dir: Path) -> Dict[str, str]:
    return {p.stem: p.read_text() for p in sorted(out_dir.glob("*.ptxas"))}


def build() -> BuildInfo:
    """Compile and link the kernels, or reuse an identical earlier build."""
    nvcc = find_nvcc()
    key = _key(nvcc)
    out_dir = BUILD_ROOT / key
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0, True, _read_reports(out_dir))
    t0 = time.monotonic()
    tmp = BUILD_ROOT / f"{key}.tmp{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    try:
        _compile_and_link(nvcc, tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    try:
        tmp.rename(out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return BuildInfo(lib, time.monotonic() - t0, False, _read_reports(out_dir))


def _compile_and_link(nvcc: str, out: Path) -> None:
    """One nvcc per source, all at once, then one link."""
    procs = []
    for src in _sources():
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, proc in procs:
        report, _ = proc.communicate()
        (out / (src.stem + ".ptxas")).write_text(report)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{report}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(out / LIB_NAME),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)


class LossDesc(ctypes.Structure):
    """csrc/eval_fused.cu's CtLoss, passed by value: a loss.LossChain of n
    ops (code, a, b)."""

    _fields_ = [("n", ctypes.c_int), ("code", ctypes.c_int * 4),
                ("a", ctypes.c_double * 4), ("b", ctypes.c_double * 4)]


_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of every C entry point, by kernel
_SIGNATURES = {
    "ct_eval_fused": [_P, _P, _P, _P, _P, _I, _I, LossDesc, _P, _P, _P, _P, _P, _P],
    "ct_eval_fused_occupancy": [_I, _I, _I, _P],
    "ct_post_eval_fused": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                           _P, _P, _P, _P, _P, _P],
    "ct_schur_assembly": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                          _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P],
    "ct_normal_matvec": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P],
    "ct_isc_matvec": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P,
                      _P, _P, _P, _P, _P, _P],
    "ct_schur_jacobi": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                        _P, _P, _P, _P, _P, _P],
    "ct_segment_block_sum": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P,
                             _I, _P, _P, _P],
    "ct_segment_block_sum_resident": [_I, _I, _P],
    "ct_unsorted_segment_sum": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P],
    "ct_segment_block_expand": [_P, _I, _I, _P, _I, _P, _P],
    "ct_segment_spread_sum": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "ct_segment_spread_ftf": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                              _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
}

_LIB: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes and restype of every entry point."""
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f64", "f32"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library of this process, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build().path)))
    return _LIB
