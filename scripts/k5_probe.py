#!/usr/bin/env python3
"""Where the f32 lifted recompute backward (K5, ``lifted_bwd_tc``) spends
its time, on one NVIDIA GPU.

    python3 scripts/k5_probe.py

Builds copies of ``multimodal_similarity_tpu_torch/csrc/lifted.cu`` into
``multimodal_similarity_tpu_torch/_build/k5_probe/``: the kernel as it is;
"products_only", whose coefficient tile is the distance products
themselves (no masks, no exponentials); "no_products", which waits for
every TMA load and writes its tiles but issues neither product.  Each is
timed on
the same card, in turns, at N=512, 8192 and 16384 (d=128) and at N=1000
with d=1536 (clustered unit rows, 10% of them invalid at d=1536): the
device time of one call of its launches (tile walk, and the combine where
there are several column ranges) from CUDA-graph replay, with the two TF32
splits done once outside the timed call.  The kernel's gradient is held
to the plain version first (chip_smoke.py's tolerance).  Prints one JSON line per shape and the card
line.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NO_EPILOGUE = ("      c[x] = (ca.w > 0.f && iin[h]) ? c1 + c2 : 0.f;",
               "      c[x] = s[x];")
S_PRODUCTS = (
    "        tf32_step(acc, smem_desc(ah + o), smem_desc(bl + o));\n"
    "        tf32_step(acc, smem_desc(al + o), smem_desc(bh + o));\n"
    "        tf32_step(acc, smem_desc(ah + o), smem_desc(bh + o));",
    "")
G_PRODUCTS = (
    "        msim::tf32_step(g, msim::smem_desc(c_hi + a),\n"
    "                        msim::smem_desc(e_lo + bo));\n"
    "        msim::tf32_step(g, msim::smem_desc(c_lo + a),\n"
    "                        msim::smem_desc(e_hi + bo));\n"
    "        msim::tf32_step(g, msim::smem_desc(c_hi + a),\n"
    "                        msim::smem_desc(e_hi + bo));",
    "")
VARIANTS = {"kernel": [],
            "products_only": [("lifted.cu",) + NO_EPILOGUE],
            "no_products": [("wgmma_tf32.cuh",) + S_PRODUCTS,
                            ("lifted.cu",) + G_PRODUCTS]}
SHAPES = ((512, 128), (8192, 128), (16384, 128), (1000, 1536))
MARGIN = 0.2


def build(_build):
    """One nvcc per variant, all started together; returns the bound
    lifted_bwd_tf32 of each."""
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        _BWD_TF32_ARGTYPES)
    out_dir = _build.BUILD_DIR / "k5_probe"
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
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "lifted_bwd_tc" in line and k + 2 < len(lines):
                print(f"[build] {name}: {lines[k + 1].strip()}; "
                      f"{lines[k + 2].strip()}", flush=True)
        fn = ctypes.CDLL(str(out_dir / name / "lib.so")).lifted_bwd_tf32
        fn.argtypes = _BWD_TF32_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        print("k5_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from multimodal_similarity_tpu_torch.ops.kernels import _build
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        pad_depth, prep_operands, sm_count)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        BWD_CHUNK, BWD_TILE, bwd_grid, lifted_bwd_plain, lifted_fwd_plain,
        tf32_split, tf32_split_t)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(_build)
    gen = torch.Generator().manual_seed(3)
    for n, d in SHAPES:
        emb, labels, valid = chip_smoke.make_case(
            n, d, "float", gen, n_classes=64,
            invalid_frac=0.1 if d > 128 else 0.0)
        ops = prep_operands(emb, labels, valid, "f32")
        fp, cn, _ = lifted_fwd_plain(ops, MARGIN)
        g_fp = torch.rand(n, device="cuda") - 0.3
        g_cn = torch.rand(n, device="cuda") - 0.3
        hi, lo = tf32_split(pad_depth(ops.opd, 4))
        ranges, chunks = bwd_grid(n, d, sm_count(ops.opd.device))
        hi_t, lo_t = tf32_split_t(ops.opd, chunks * BWD_CHUNK,
                                  -(-n // BWD_TILE) * BWD_TILE)
        partial = torch.empty(ranges * n * d if ranges > 1 else 0,
                              device="cuda")
        rowsum = torch.empty(ranges * n, device="cuda")
        grad = torch.empty(n, d, device="cuda")

        def call(fn):
            rc = fn(hi.data_ptr(), lo.data_ptr(), hi_t.data_ptr(),
                    lo_t.data_ptr(), ops.opd.data_ptr(), n, d, hi.shape[1],
                    ranges, ops.sq.data_ptr(), ops.sq_pen.data_ptr(),
                    ops.labels.data_ptr(), ops.valid.data_ptr(),
                    fp.data_ptr(), cn.data_ptr(), g_fp.data_ptr(),
                    g_cn.data_ptr(), MARGIN, partial.data_ptr(),
                    rowsum.data_ptr(), grad.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"lifted_bwd_tf32: CUDA error {rc}")

        want = lifted_bwd_plain(ops, fp, cn, g_fp, g_cn, MARGIN)
        call(fns["kernel"])
        torch.cuda.synchronize()
        err = float((grad - want).abs().max())
        tol = 1e-4 * max(1.0, d / 128) * max(float(want.abs().max()), 1.0)
        if not err <= tol:
            raise SystemExit(f"N={n} d={d}: the kernel is off by {err} "
                             f"(tol {tol})")
        ms = {}
        for name in list(fns) + list(fns)[::-1]:   # in turns
            t = chip_smoke.device_ms(lambda: call(fns[name]))
            ms[name] = min(ms.get(name, t), t)
        print(json.dumps({"N": n, "d": d, "ranges": ranges,
                          "chunks": chunks, "max_abs_err": err, "ms": ms}),
              flush=True)
        del ops, hi, lo, hi_t, lo_t, partial, rowsum, grad, want
        torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
