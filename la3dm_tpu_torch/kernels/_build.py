"""Build the port's CUDA kernels: every ``csrc/*.cu`` into one shared library
with a plain C interface, loaded with ctypes.

Each source is compiled by its own ``nvcc`` process, all started together,
then linked into ``build/libla3dm_kernels.so`` (git-ignored).  The library
is built at first use and rebuilt when a source or a shared header
(``csrc/*.cuh``) is newer than it.  Flags:

* ``-gencode arch=compute_90a,code=sm_90a`` — Hopper (H100);
* ``--fmad=false`` — no a·b + c contraction into FMA: the kernels must round
  every expression as the plain PyTorch versions' separate ops round, since
  the k̄ > 0 update gate sits on the sparse kernel's clamp boundary;
* never ``--use_fast_math``, which would swap in ``__sinf``/``__cosf`` and
  approximate division and square root.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SO = os.path.join(BUILD_DIR, "libla3dm_kernels.so")
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()
#: compiler output of this process's build (ptxas registers / shared
#: memory per kernel); empty when the library was already up to date
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc") or _NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile and link the kernels if any source is newer; return the .so."""
    global build_log
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = srcs + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= max(os.path.getmtime(s) for s in deps)):
        return _SO
    nvcc = _nvcc()
    obj_dir = os.path.join(BUILD_DIR, f"obj.{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    jobs = []
    for src in srcs:
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = f"{_SO}.build.{os.getpid()}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *(o for _, o, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(tmp, _SO)  # atomic: a concurrent process never loads half a file
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_log = "\n".join(logs)
    return _SO


def _bind(lib):
    vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.la3dm_bgk_heavy.restype = ci
    lib.la3dm_bgk_heavy.argtypes = [vp] * 11 + [ci] * 4 + [cf] * 3 + [vp, vp]
    lib.la3dm_sparse_kernel_scan.restype = ci
    lib.la3dm_sparse_kernel_scan.argtypes = [vp, vp, cl, cf, vp]
    lib.la3dm_bgk_light.restype = ci
    lib.la3dm_bgk_light.argtypes = [vp] * 7 + [ci] * 6 + [cf, ci, cf, cf, cf] + [vp] * 5
    lib.la3dm_lv_rows.restype = ci
    lib.la3dm_lv_rows.argtypes = [vp] * 19 + [cl] * 4 + [ci] * 3 + [cf] * 4 + [vp]
    lib.la3dm_lv_prune.restype = ci
    lib.la3dm_lv_prune.argtypes = [vp] * 9 + [ci] * 4 + [cf] * 4 + [vp]
    lib.la3dm_gp_heavy.restype = ci
    lib.la3dm_gp_heavy.argtypes = [vp] * 10 + [ci] + [vp] * 11 + [ci] * 9 + [cf] * 3 + [vp]
    lib.la3dm_gp_light.restype = ci
    lib.la3dm_gp_light.argtypes = [vp] * 9 + [ci] * 7 + [cf] * 6 + [vp] * 5
    lib.la3dm_ingest_points.restype = ci
    lib.la3dm_ingest_points.argtypes = [vp] * 4 + [cl, cf, cf, vp, vp]
    lib.la3dm_ingest_beams.restype = ci
    lib.la3dm_ingest_beams.argtypes = ([vp] * 4 + [cl, ci, ci] + [cf] * 3 + [ci] + [vp] * 5
                                      + [ctypes.c_uint, vp])
    lib.la3dm_ingest_downsample.restype = ci
    lib.la3dm_ingest_downsample.argtypes = [vp] * 6 + [cl, cf, vp, vp]
    lib.la3dm_ingest_sort_workspace.restype = cl
    lib.la3dm_ingest_sort_workspace.argtypes = [cl, ci, ci, ci]
    lib.la3dm_ingest_sort.restype = ci
    lib.la3dm_ingest_sort.argtypes = [vp, cl] + [ci] * 6 + [vp, cl] + [vp] * 4
    lib.la3dm_ingest_bucket.restype = ci
    lib.la3dm_ingest_bucket.argtypes = [vp] * 11 + [cl] * 3 + [ci, ci, cf] + [vp] * 6
    lib.la3dm_ingest_members.restype = ci
    lib.la3dm_ingest_members.argtypes = ([vp] * 4 + [cl, cf, cf, ci] + [vp] * 5
                                         + [ctypes.c_uint, vp])
    lib.la3dm_ingest_rays_workspace.restype = cl
    lib.la3dm_ingest_rays_workspace.argtypes = [cl, ci]
    lib.la3dm_ingest_rays_count.restype = ci
    lib.la3dm_ingest_rays_count.argtypes = [vp] * 4 + [cl, ci] + [cf] * 4 + [vp, cl] + [vp] * 6
    lib.la3dm_ingest_rays_write.restype = ci
    lib.la3dm_ingest_rays_write.argtypes = ([vp] * 4 + [cl, ci] + [cf] * 4 + [vp, cl, ci, cl]
                                            + [vp] * 3)
    lib.la3dm_ingest_slots_world.restype = ci
    lib.la3dm_ingest_slots_world.argtypes = [vp, vp, cl] + [ci] * 4 + [vp] * 3
    lib.la3dm_ingest_slots_gather.restype = ci
    lib.la3dm_ingest_slots_gather.argtypes = [vp] * 4 + [cl] + [ci] * 3 + [cf] + [vp] * 3
    lib.la3dm_raycast.restype = ci
    lib.la3dm_raycast.argtypes = [vp] * 6 + [cl] + [ci] * 6 + [cf] * 3 + [vp] * 6
    lib.la3dm_bgk_aligned_heavy.restype = ci
    lib.la3dm_bgk_aligned_heavy.argtypes = [vp] * 8 + [cl, cl, ci, ci, ci] + [cf] * 3 + [vp, vp]
    return lib


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
