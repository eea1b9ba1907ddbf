"""Timing ablations of the sm90 attention backward, on the card.

A one-off measurement, not a test (pytest does not collect it):

    python -m tests.torch_sm90_ablate

Writes patched copies of ``csrc/attention_sm90_bwd.cu`` into
``build/sm90_ablate/`` and builds them there (headers from ``csrc/``),
each with one piece of the kernels' work taken out or changed, and times
dq and dk/dv of each from CUDA graphs at the flagship's 6 x 1400 x 1400 and
the video step's 12 x 1400 x 2800 (C = 320, 8 heads), ``REPEATS`` rounds
over the variants.  The variants compute wrong gradients on purpose: they say what
each piece costs, not what the kernels return.  ``copy_only`` drops every
product, so the compiler drops the arithmetic that feeds them too: what is
left is the TMA ring, the barriers and the stores.  Prints one JSON line
per shape, round and variant, after the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.ops import cuda_lib

SOURCE = "attention_sm90_bwd.cu"
# register-A K-major product: S (or S^T) from A fragments held in
# registers instead of shared memory (timing only: the fragments are the
# previous tile's dS / P^T, not Q, dO, K or V)
_RK = r'''
__device__ __forceinline__ void wgmma_rk(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}
template <int KSTEPS>
__device__ __forceinline__ void issue_rk(float (&acc)[32],
                                         const uint32_t (&a)[4][4],
                                         uint64_t db, uint64_t, uint64_t) {
#pragma unroll
  for (int kt = 0; kt < (KSTEPS < 4 ? KSTEPS : 4); ++kt)
    wgmma_rk(acc, a[kt], db + 2 * kt, kt);
}
'''
_DQ = "// " + "-" * 70 + " dq"  # the source's dq section rule
_NO_PRODUCTS = [("issue_ss<KSTEPS>(", "if (0) issue_ss<KSTEPS>("),
                ("issue_rs<kWide>(a", "if (0) issue_rs<kWide>(a")]
# variant -> (old, new) replacements in the source
VARIANTS = {
    "base": [],
    "no_pingpong": [("bar_sync<kConsumers>(my_bar);", ";"),
                    ("bar_arrive<kConsumers>(other_bar);", ";")],
    "no_exp": [("const float p = ex2(fmaf(", "const float p = (fmaf(")],
    # P / dS never packed: the arithmetic that computes them goes too
    "no_p_ds": [("        pack_a(ds, s);\n        prev = st;",
                 "        prev = st;"),
                ("        pack_a(pa, s);\n        pack_a(dsa, dp);\n"
                 "        prev = st;", "        prev = st;")],
    "no_rs": [("issue_rs<kWide>(a", "if (0) issue_rs<kWide>(a")],
    "no_ss": [("issue_ss<KSTEPS>(", "if (0) issue_ss<KSTEPS>(")],
    "register_a": [(_DQ, _RK + _DQ),
                   ("issue_ss<KSTEPS>(s, dqa,", "issue_rk<KSTEPS>(s, ds,"),
                   ("issue_ss<KSTEPS>(dp, doa,", "issue_rk<KSTEPS>(dp, ds,"),
                   ("issue_ss<KSTEPS>(s, ka,", "issue_rk<KSTEPS>(s, pa,"),
                   ("issue_ss<KSTEPS>(dp, va,", "issue_rk<KSTEPS>(dp, dsa,")],
    "copy_only": _NO_PRODUCTS,
    "stages2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages8": [("constexpr int kStages = 4;", "constexpr int kStages = 8;")],
}
SHAPES = [(6, 1400, 1400, 320, 8), (12, 1400, 2800, 320, 8)]
REPEATS = 3


def variant_source(reps) -> str:
    with open(os.path.join(cuda_lib.CSRC, SOURCE)) as f:
        src = f.read()
    for old, new in reps:
        if old not in src:
            raise ValueError(f"{old!r} is not in {SOURCE}")
        src = src.replace(old, new)
    return src


def build_variants(out_dir: str) -> dict:
    """One library per variant in ``out_dir``, all nvcc runs at once."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    procs = {}
    for name, reps in VARIANTS.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(reps))
        procs[name] = subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib.CSRC,
             "-o", os.path.join(out_dir, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        for fn, argtypes in cuda_lib._SIGNATURES["attention_sm90_bwd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build_variants(os.path.join(os.path.dirname(cuda_lib.BUILD_DIR),
                                       "sm90_ablate"))
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, lq, lk, c, heads in SHAPES:
        q, k, v, do = (torch.randn(b, n, c, generator=g, device="cuda")
                       .bfloat16() for n in (lq, lk, lk, lq))
        o, lse = A.packed_attention_lse_fwd(q, k, v, heads)
        delta = A.attention_delta(o, do, heads)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        d = c // heads
        ins = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
        for rep in range(REPEATS):
            for name, lib in libs.items():
                stream = lambda: ctypes.c_void_p(  # noqa: E731
                    torch.cuda.current_stream().cuda_stream)
                runs = {
                    "dq_ms": lambda: lib.dd_sm90_attention_bwd_dq(
                        *ins, dq.data_ptr(), b, lq, lk, heads, d, d ** -0.5,
                        stream()),
                    "dkv_ms": lambda: lib.dd_sm90_attention_bwd_dkv(
                        *ins, dk.data_ptr(), dv.data_ptr(), b, lq, lk, heads,
                        d, d ** -0.5, stream())}
                row = {"shape": [b, lq, lk, c, heads], "round": rep,
                       "variant": name}
                for key, run in runs.items():
                    if run():
                        raise RuntimeError(f"{name} {key} failed to launch")
                    row[key] = chip_smoke.graph_ms(run)
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    main()
