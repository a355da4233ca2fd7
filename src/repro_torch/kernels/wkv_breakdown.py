"""Where the WKV kernel's chunked body spends its device time, phase by phase.

    PYTHONPATH=src python -m repro_torch.kernels.wkv_breakdown

Runs on a CUDA card.  Builds variants of ``csrc/linear_scan.cu`` whose
output kernel (``wkv_out_kernel``) returns after one of its phases -- at
once, after its loads, after the cumulative decay sums, after A's tiles --
times each variant and the full kernel with ``torch.profiler`` at the
rwkv6-1.6b prefill, paged chunk-round and odd-length shapes, and prints one
JSON line per shape: the device time of every kernel of the body per
variant, and the output kernel's time split into phases (each the
difference between two successive variants).  A variant's outputs are
wrong by construction; only its times are read.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels import linear_scan as ls

SHAPES = {"rwkv6_prefill": (1, 1000, 32, 64), "chunk_round": (8, 64, 32, 64),
          "odd_97": (1, 97, 32, 64)}
_RETURN = "  if (a.S > 0) return;\n"  # taken at run time, so nothing is pruned
_DRAIN = "  cp_async_wait_all();\n  __syncthreads();\n" + _RETURN
#: variant -> (source text the early return follows, text inserted after it)
STOPS = {
    "empty": ("  OutSmem<N>& sm = *reinterpret_cast<OutSmem<N>*>(smem_raw);\n", _RETURN),
    "loads": ("  cp_async_wait_one();\n  if (threadIdx.x < N) sm.pp[0][threadIdx.x] = 0.f;\n"
              "  __syncthreads();\n", _DRAIN),
    "cumsum": ("  cumsum_log2<N>(&sm.pp[1][0], Ld<N>::kRow);\n", _DRAIN),
    "tiles": ("  cp_async_wait_all();  // v and the start state\n  __syncthreads();\n", _RETURN),
}
PHASES = [("launch", None, "empty"), ("loads", "empty", "loads"),
          ("cumsum", "loads", "cumsum"), ("A tiles", "cumsum", "tiles"),
          ("y and state", "tiles", "full")]


def build_variants() -> dict[str, ctypes.CDLL]:
    """One library per variant, all compiled at once."""
    src = (build.CSRC / "linear_scan.cu").read_text()
    out_dir = build.BUILD_DIR / "wkv_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (anchor, stop) in STOPS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"variant {name}: its anchor is not once in the source")
        cu = out_dir / f"{name}.cu"
        cu.write_text(src.replace(anchor, anchor + stop))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"{name}.so"))
    return libs


def _caller(lib: ctypes.CDLL, args: list[torch.Tensor]):
    fn = lib.repro_linear_scan_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    B, S, H, N = args[0].shape
    y, s_fin = torch.empty_like(args[0]), torch.empty_like(args[5])
    n = ls.scratch_floats(B, S, H, N)
    scratch = torch.empty(n, device="cuda") if n else None

    def call():
        err = fn(*(t.data_ptr() for t in args), y.data_ptr(), s_fin.data_ptr(),
                 scratch.data_ptr() if scratch is not None else None, B, S, H, N,
                 ls.BODIES["chunked"], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def device_ms_by_kernel(fn, reps: int = 20, tries: int = 3) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                m = re.search(r"wkv_\w+_kernel", e.name)
                key = m.group(0) if m else e.name[:40]
                by[key] = by.get(key, 0.0) + e.device_time / reps / 1e3
        if by:
            return by
    raise RuntimeError(f"{tries} profiler traces held no device time")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("wkv_breakdown: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build_variants()
    for shape_name, (B, S, H, N) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(0)
        args = [torch.randn((B, S, H, N), generator=g, device="cuda") for _ in range(3)]
        w_raw = torch.rand((B, S, H, N), generator=g, device="cuda") * 6.0 - 6.0
        args += [-torch.exp(w_raw), torch.randn((H, N), generator=g, device="cuda") * 0.1,
                 torch.randn((B, H, N, N), generator=g, device="cuda") * 0.5]
        times = {"full": device_ms_by_kernel(lambda: ls.linear_scan(*args))}
        for name, lib in libs.items():
            times[name] = device_ms_by_kernel(_caller(lib, args))
        out = {name: t.get("wkv_out_kernel", 0.0) for name, t in times.items()}
        phases = {label: out[end] - (out[start] if start else 0.0)
                  for label, start, end in PHASES}
        print(json.dumps({"shape": shape_name, "B_S_H_N": [B, S, H, N], "card": card,
                          "device_ms": times, "out_kernel_phases_ms": phases}),
              flush=True)


if __name__ == "__main__":
    main()
