#!/usr/bin/env python3
"""The f32 decode kernel's ring depth and split cap, swept on one CUDA card.

Run from the root of a checkout:  python3 decode_f32_probe.py

Builds two forms of csrc/ragged_decode_attention_f32.cu into
build/decode_f32_probe/ (nvcc, the package's flags): the source as it
stands, and the same source with the deep rings it was first written with
(f32: 3 stages at head_dim 128 and 256, 6/4 at 64; int8: 8/6 at 128, 5/3
at 256, 8 at 64: one or two blocks an SM, 100 KB or more in flight). Then,
for each form and each cap on the tiles a split walks
(DECODE_F32_MAX_SPLIT_TILES 2, 4, 8, 16), it times the kernel (CUDA
events, L2 flushed, as chip_smoke.py does) on f32 queries over an f32 and
an int8 pool: llama-3-8b's heads (32/8, hd 128) at B=8 over a 1024-token
context, B=1 over 2048 and B=8 with 4-query chunks; gemma-2-9b's (16/8,
hd 256) at B=8 over 1024 and B=1 over 2048. Each form runs twice, in the
order source, deep, deep, source, and each result is held against the
plain version (1e-4). The card's name and power limit come first; a
ptxas line of each form that spills is printed. Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

DEEP_RINGS = ("  if (INT8) return HD == 256 ? (RMAX == 8 ? 5 : 3) : HD == 128 ? "
              "(RMAX == 8 ? 8 : 6) : 8;\n"
              "  return HD == 64 ? (RMAX == 8 ? 6 : 4) : (RMAX == 8 ? 3 : 2);")
CAPS = (2, 4, 8, 16)


def build_forms(root: Path) -> dict:
    """{form: the C entry point of its library}, both built at once."""
    from bee2bee_tpu_torch.ops import _build

    src = (_build.CSRC / "ragged_decode_attention_f32.cu").read_text()
    body = re.search(r"constexpr int stages\(\) \{\n(.*?)\n\}", src, re.S).group(1)
    out = root / "build" / "decode_f32_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for form, text in (("source", src), ("deep", src.replace(body, DEEP_RINGS))):
        path = out / f"{form}.cu"
        path.write_text(text)
        procs[form] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{form}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for form, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {form} form:\n{log}")
        for ln in log.splitlines():
            if "spill" in ln and "0 bytes spill" not in ln:
                print(f"{form}: ptxas: {ln.strip()}")
        fn = ctypes.CDLL(str(out / f"{form}.so")).b2b_ragged_decode_attention_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fns[form] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_f32_probe: no CUDA device available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from bee2bee_tpu_torch.ops import ragged as R

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card {smi.stdout.strip()}", flush=True)
    fns = build_forms(root)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    shapes = (("llama B=8 ctx 1024", dict(offs=[1023] * 8, T=1), {}),
              ("llama B=1 ctx 2048", dict(offs=[2047], T=1), {}),
              ("llama B=8 T=4", dict(offs=[1000] * 8, T=4), {}),
              ("gemma B=8 ctx 1024", dict(offs=[1023] * 8, T=1), cs.GEMMA),
              ("gemma B=1 ctx 2048", dict(offs=[2047], T=1), cs.GEMMA))
    decode_f32_fn, cap0 = R._decode_f32_fn, R.DECODE_F32_MAX_SPLIT_TILES
    try:
        for label, geo, heads in shapes:
            for int8 in (False, True):
                q, kp, vp, tb, off = cs.make_case(gen, dtype=torch.float32, **geo, **heads)
                sc = (None, None)
                if int8:
                    kp, vp, *sc = cs.int8_pools(gen, kp.shape[1], Hkv=kp.shape[0],
                                                hd=kp.shape[3])
                want = R.ragged_paged_attention_ref(q, kp, vp, tb, off, k_scale=sc[0],
                                                    v_scale=sc[1])
                rows = R.row_offsets(off, q.shape[0], q.device)

                def run():
                    return R._launch_kernel(q, kp, vp, tb, rows, 0,
                                            1.0 / math.sqrt(q.shape[3]), 0.0, *sc,
                                            kernel="decode_f32")

                times: dict = {}
                for form in ("source", "deep", "deep", "source"):
                    R._decode_f32_fn = lambda fn=fns[form]: fn
                    for cap in CAPS:
                        R.DECODE_F32_MAX_SPLIT_TILES = cap
                        R.decode_f32_splits.cache_clear()
                        err = (run() - want).abs().max().item()
                        if not err <= 1e-4:
                            raise AssertionError(f"{label}: {form} cap {cap}: err {err}")
                        times.setdefault((form, cap), []).append(
                            cs.cuda_time_ms(run, flush=flush))
                print(f"{label} {'int8' if int8 else 'f32'} pool (ms, two runs): " + ", ".join(
                    f"{form}/cap{cap} {t[0]:.4f}/{t[1]:.4f}"
                    for (form, cap), t in times.items()), flush=True)
    finally:
        R._decode_f32_fn, R.DECODE_F32_MAX_SPLIT_TILES = decode_f32_fn, cap0
        R.decode_f32_splits.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
