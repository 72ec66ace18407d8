#!/usr/bin/env python3
"""Where one warp of the port's SPD kernels spends its cycles.

    python3 scripts/profile_torch_spd.py          # on the card

Builds copies of `dyobav_tpu_torch/csrc/spd_cholesky.cu` and `spd_lanes.cu`
with `clock64()` reads at the phase boundaries that their comments mark
(after the early exit, before the factorization, the forward and the back
substitution, and before the final stores), runs each at the shapes that
`chip_smoke.py` times (n = 40, every system SPD), and prints, per kernel
and shape, one JSON line with the cycles that the first warp of the first
block spent staging its system, factoring it and in each substitution.
At small batches that warp's chain is the kernel's time; at large ones
the other warps of its SM stretch it.  The copies are built into
`dyobav_tpu_torch/_build/` under their own names; the kernels that the
port loads are not touched.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {"spd_cholesky": [(2048, 4), (128, 4), (1280, 4), (640, 4),
                           (256, 4)],
          "spd_lanes": [(8192,), (512,), (200,)]}
PHASES = ("stage", "factor", "forward", "back")


def instrumented(name: str) -> str:
    """The kernel's source with clock64() reads at its phase boundaries."""
    from dyobav_tpu_torch.kernels import build

    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    mark = ("  if (blockIdx.x == 0 && threadIdx.x == 0) "
            "phase_clk[{}] = clock64();\n")
    exit_line = ("  if (s >= batch) return;   // the whole warp: the ragged "
                 "last block\n")
    factor = ("  // Right-looking Cholesky" if name == "spd_cholesky"
              else "  // Left-looking Cholesky")
    stores = ("#pragma unroll\n  for (int r = 0; r < kRows; ++r) {\n"
              "    if (row[r] < n)")
    for needle in (exit_line, factor, "  // Forward substitution",
                   "  // Back substitution", stores, "namespace {"):
        if src.count(needle) < 1:
            raise RuntimeError(f"{name}.cu: phase marker {needle!r} not found")
    src = src.replace(exit_line, exit_line + mark.format(0), 1)
    for k, needle in ((1, factor), (2, "  // Forward substitution"),
                      (3, "  // Back substitution")):
        i = src.index(needle)
        src = src[:i] + mark.format(k) + src[i:]
    i = src.rindex(stores)
    src = src[:i] + mark.format(4) + src[i:]
    i = src.index("namespace {")
    src = src[:i] + "__device__ unsigned long long phase_clk[5];\n\n" + src[i:]
    return src + ('\nextern "C" int read_phase_clk(unsigned long long* out) '
                  '{\n  return static_cast<int>(cudaMemcpyFromSymbol(out, '
                  'phase_clk, sizeof(phase_clk)));\n}\n')


def load(name: str):
    from dyobav_tpu_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"{name}_phases.cu"
    lib = build.BUILD_DIR / f"lib{name}_phases.so"
    src.write_text(instrumented(name))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    fn = getattr(so, f"{name}_solve")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, so.read_phase_clk


def main() -> int:
    import torch

    from chip_smoke import card_line, cold_ms, l2_flush_buffer, spd_inputs

    if not torch.cuda.is_available():
        print("profile_torch_spd: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    flush = l2_flush_buffer(dev)
    for name, shapes in SHAPES.items():
        fn, read = load(name)

        def call(A, g):
            n = A.shape[-1]
            A2, g2 = A.reshape(-1, n, n), g.reshape(-1, n)
            d = torch.empty_like(g2)
            rc = fn(A2.data_ptr(), g2.data_ptr(), d.data_ptr(), n,
                    A2.shape[0], torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return d

        for lead in shapes:
            A, g = spd_inputs(lead, 40, 0, dev)
            for _ in range(3):
                call(A, g)
            torch.cuda.synchronize()
            clk = (ctypes.c_ulonglong * 5)()
            if read(clk) != 0:
                raise RuntimeError(f"{name}: reading the clocks failed")
            cycles = {p: clk[k + 1] - clk[k] for k, p in enumerate(PHASES)}
            print(json.dumps({
                "card": card, "kernel": name, "shape": list(lead) + [40, 40],
                "cycles_first_warp": cycles,
                "cycles_total": clk[4] - clk[0],
                "ms_cold_instrumented": cold_ms(lambda: call(A, g), 10,
                                                flush)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
