#!/usr/bin/env python3
"""Where the f32 triangular lifted forward (K6, ``lifted_tri_tc``) spends
its time, on one NVIDIA GPU.

    python3 scripts/k6_probe.py

Builds five copies of ``multimodal_similarity_tpu_torch/csrc/lifted.cu``
into ``multimodal_similarity_tpu_torch/_build/k6_probe/``: the kernel as it
is; "products_only", whose MMA warpgroup skips the row side and whose
column warpgroup skips its reduction (the loads, the in-kernel TF32 split
and the products remain); "no_products", where no slice is split or
multiplied (the loads and both epilogue sides remain); and "no_split",
which multiplies the f32 tiles as they arrive (the products without the
split's shared-memory passes); and "split_in_mma", the first design, whose
MMA warpgroup splits each slice itself before its products.  Each is timed on the
same card, in turns, at N=512, 8192 and 16384 (d=128, clustered unit
rows): the device time of one call of both launches (tile walk and
combine) from CUDA-graph replay.  The kernel's outputs are held to the
plain version first.  Prints one
JSON line per N and the card line.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

ROW_SIDE = ("    for (int g = 0; g < BN / 8; ++g) {\n      float sv[2][2];",
            "    for (int g = 0; g < 0; ++g) {\n      float sv[2][2];")
COL_SIDE = ("  for (int r = part * RP; r < (part + 1) * RP; ++r) {",
            "  for (int r = 0; r < 0; ++r) {")
SPLIT = ("    split_tile<A_ROWS>(at(a(s)), at(a_lo(s)), t, sq_a);\n"
         "    split_tile<B_ROWS>(at(b(s)), at(b_lo(s)), t, sq_b);\n", "")
PRODUCTS = (
    "      tf32_step(acc, smem_desc(ah + o), smem_desc(bl + o));\n"
    "      tf32_step(acc, smem_desc(al + o), smem_desc(bh + o));\n"
    "      tf32_step(acc, smem_desc(ah + o), smem_desc(bh + o));\n", "")
# the first design: the MMA warpgroup splits each slice before its products
SPLIT_IN_MMA = [
    ("lifted.cu", "    ring.product_split(acc, it, k_slices);",
     "    float sq_a[TRI_ROWS / 16] = {}, sq_b[BN / 16] = {};\n"
     "    ring.product(acc, it, k_slices, t, 1, sq_a, sq_b);"),
    ("lifted.cu", "      ring.split(it, k_slices, t);\n", "")]
VARIANTS = {"kernel": [], "split_in_mma": SPLIT_IN_MMA,
            "products_only": [("lifted.cu",) + ROW_SIDE,
                              ("lifted.cu",) + COL_SIDE],
            "no_products": [("wgmma_split.cuh",) + SPLIT,
                            ("wgmma_split.cuh",) + PRODUCTS],
            "no_split": [("wgmma_split.cuh",) + SPLIT]}
MARGIN = 0.2


def build(_build):
    """One nvcc per variant, all started together; returns each variant's
    library."""
    out_dir = _build.BUILD_DIR / "k6_probe"
    procs = {}
    for name, edits in VARIANTS.items():
        src = out_dir / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, src)
        for fname, old, new in edits:
            path = src / fname
            text = path.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edit of {fname} no longer "
                                 "matches the source")
            path.write_text(text.replace(old, new))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(src / "lib.so"),
               str(src / "lifted.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        if name == "kernel":
            for line in log.splitlines():
                if "lifted_tri_tc" in line or "registers" in line \
                        or "spill" in line:
                    print(f"[build] {line.strip()}")
        libs[name] = ctypes.CDLL(str(out_dir / name / "lib.so"))
    return libs


def bound_fn(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from multimodal_similarity_tpu_torch.ops.kernels import _build
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        prep_operands, sm_count)
    from multimodal_similarity_tpu_torch.ops.kernels.distance import (
        tma_depth)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted_tri import (
        _TF32_ARGTYPES, lifted_fwd_tri_plain, tri_cols)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(_build)
    fns = {name: bound_fn(lib, "lifted_fwd_tri_tf32", _TF32_ARGTYPES)
           for name, lib in libs.items()}
    gen = torch.Generator().manual_seed(3)
    for n in (512, 8192, 16384):
        emb, labels, valid = chip_smoke.make_case(n, 128, "float", gen,
                                                  n_classes=64)
        ops = prep_operands(emb, labels, valid, "f32")
        opd = tma_depth(ops.opd)
        sms = sm_count(ops.opd.device)
        cols = tri_cols(n, sms)
        partial = torch.empty(3 * -(-n // cols) * n, device="cuda")
        out = [torch.empty(n, device="cuda") for _ in range(3)]
        side = (ops.sq.data_ptr(), ops.labels.data_ptr(),
                ops.valid.data_ptr(), MARGIN)

        def call(fn):
            rc = fn(opd.data_ptr(), n, opd.shape[1], cols, *side,
                    partial.data_ptr(), *(t.data_ptr() for t in out),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"lifted_fwd_tri_tf32: CUDA error {rc}")

        call(fns["kernel"])
        want = lifted_fwd_tri_plain(ops, MARGIN)
        err = max(float((a - b).abs().max()) for a, b in zip(out[:2], want[:2]))
        if not (err <= 1e-4 and torch.equal(out[2], want[2])):
            raise SystemExit(f"N={n}: the kernel is off by {err} or its "
                             "negative counts differ")
        calls = {name: (lambda fn=fn: call(fn)) for name, fn in fns.items()}
        ms = {}
        for name in list(calls) + list(calls)[::-1]:   # in turns
            t = chip_smoke.device_ms(calls[name])
            ms[name] = min(ms.get(name, t), t)
        print(json.dumps({"N": n, "d": 128, "cols": cols,
                          "max_abs_err": err, "ms": ms}), flush=True)
        del ops, opd, partial, out
        torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
