"""The memory check of the kernels at constant-camera inputs without a
card: compute-sanitizer does not take the card of the chip machine
("Device not supported"), so the CUDA sources are compiled for the host
with g++ and AddressSanitizer against the stand-in CUDA runtime of
tests/cuda_emulation/ (as tests/test_torch_kernels_emulated.py compiles
them), and every case of chip_smoke.sentinel_cases (rows 1, 2, 3, 3b, 4,
4b at the sentinel camera, 6, 7 and 9 at the sentinel key; both dtypes;
one and two constant cameras) runs through the wrappers' kernel path. A
read or write outside a tensor the emulated kernels were given stops the
run with AddressSanitizer's report (a guard taken out of normal_matvec.cu
is caught: a heap-buffer-overflow in NormalMatvec::load). Each case is
also held against its plain version.

    python scripts/sentinel_asan.py

Needs g++ and its libasan; re-runs itself with libasan preloaded. Prints
one line per case and "sentinel_asan ok"; takes about a minute.
"""
import ctypes
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIMIT = {"float64": 1e-12, "float32": 1e-5}


def _asan_runtime() -> str:
    return subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main():
    if "libasan" not in os.environ.get("LD_PRELOAD", ""):
        env = dict(os.environ, LD_PRELOAD=_asan_runtime(),
                   ASAN_OPTIONS="detect_leaks=0:abort_on_error=1")
        return subprocess.run([sys.executable, __file__], env=env).returncode
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from ceres_tpu_torch.ops import build
    from ceres_tpu_torch.ops import kernels as kn

    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "libemu_asan.so")
        cmd = ["g++", "-std=c++20", "-O1", "-g", "-fsanitize=address",
               "-fno-omit-frame-pointer", "-fPIC", "-shared", "-pthread", "-x", "c++",
               "-I", str(ROOT / "tests" / "cuda_emulation"), "-I", str(build.CSRC),
               *map(str, sorted(build.CSRC.glob("*.cu"))), "-o", lib]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        build._LIB = build.bind(ctypes.CDLL(lib))
    # the emulated kernels' stream and resident blocks, as the emulated tests
    kn._stream = lambda dev: ctypes.c_void_p(0)
    kn._resident_blocks = lambda dev, dt, w: 1 << 20
    bad = 0
    for dtype in ("float64", "float32"):
        for constant in ((0,), (2, 5)):
            for name, args in chip_smoke.sentinel_cases(dtype, "cpu", constant).items():
                wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
                kn._on_cpu = lambda ref: False  # the kernel path on CPU tensors
                out = chip_smoke.as_tuple(wrapper(*args))
                kn._on_cpu = lambda ref: True
                ref = chip_smoke.as_tuple(plain(*args))
                err = max((o.double() - r.double()).abs().max().item()
                          / max(r.double().abs().max().item(), 1e-300)
                          for o, r in zip(out, ref) if r is not None)
                limit = 0.0 if name == "segment_block_expand" else LIMIT[dtype]
                bad += err > limit
                print(f"{name} {dtype} constant={constant}: relative error {err:.3e} "
                      f"(limit {limit:.0e}), no AddressSanitizer report", flush=True)
    if bad:
        print(f"sentinel_asan: {bad} cases disagree", file=sys.stderr)
        return 1
    print("sentinel_asan ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
