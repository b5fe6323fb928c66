#!/usr/bin/env python3
"""Where the f32 lifted row forward (K4, ``lifted_fwd_tc``) spends its
time, on one NVIDIA GPU.

    python3 scripts/k4_probe.py

Builds three copies of ``multimodal_similarity_tpu_torch/csrc/lifted.cu``
into ``multimodal_similarity_tpu_torch/_build/k4_probe/``: the kernel as it
is; "products_only", whose epilogue warpgroups take each product tile and
release it without the logsumexps; and "no_products", whose MMA warpgroup
waits for every TMA load and stores its tiles without issuing the
products.  Each is timed on the same card, in turns, at N=512, 8192 and
16384 (d=128, clustered unit rows): the device time of one call of both
launches (tile walk and combine) from CUDA-graph replay, with the TF32
split done once outside the timed call.  The kernel's outputs are held to
the plain version first.  Prints one JSON line per N and the card line.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NO_EPILOGUE = (
    "    row.tile(prod, sh.info[b], sh.lab[b], c, i, t * FWD_BN + c, sqa, la,\n"
    "             margin);",
    "    row.nc += prod[0] + prod[FWD_COLS - 1];")
PRODUCTS = (
    "        tf32_step(acc, smem_desc(ah + o), smem_desc(bl + o));\n"
    "        tf32_step(acc, smem_desc(al + o), smem_desc(bh + o));\n"
    "        tf32_step(acc, smem_desc(ah + o), smem_desc(bh + o));",
    "")
VARIANTS = {"kernel": [],
            "products_only": [("lifted.cu",) + NO_EPILOGUE],
            "no_products": [("wgmma_tf32.cuh",) + PRODUCTS]}
MARGIN = 0.2


def build(_build):
    """One nvcc per variant, all started together; returns the bound
    lifted_fwd_tf32 of each."""
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        _TF32_ARGTYPES)
    out_dir = _build.BUILD_DIR / "k4_probe"
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
        fn = ctypes.CDLL(str(out_dir / name / "lib.so")).lifted_fwd_tf32
        fn.argtypes = _TF32_ARGTYPES
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    import torch
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from multimodal_similarity_tpu_torch.ops.kernels import _build
    from multimodal_similarity_tpu_torch.ops.kernels.batch_hard import (
        pad_depth, prep_operands, sm_count)
    from multimodal_similarity_tpu_torch.ops.kernels.lifted import (
        fwd_split, lifted_fwd_plain, tf32_split)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(_build)
    gen = torch.Generator().manual_seed(3)
    for n in (512, 8192, 16384):
        emb, labels, valid = chip_smoke.make_case(n, 128, "float", gen,
                                                  n_classes=64)
        ops = prep_operands(emb, labels, valid, "f32")
        hi, lo = tf32_split(pad_depth(ops.opd, 4))
        split = fwd_split(n, sm_count(ops.opd.device))
        partial = torch.empty(split * 5 * n, device="cuda")
        out = [torch.empty(n, device="cuda") for _ in range(3)]

        def call(fn):
            rc = fn(hi.data_ptr(), lo.data_ptr(), n, hi.shape[1], split,
                    ops.sq.data_ptr(), ops.sq_pen.data_ptr(),
                    ops.labels.data_ptr(), ops.valid.data_ptr(), MARGIN,
                    partial.data_ptr(), *(t.data_ptr() for t in out),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"lifted_fwd_tf32: CUDA error {rc}")

        call(fns["kernel"])
        want = lifted_fwd_plain(ops, MARGIN)
        err = max(float((a - b).abs().max()) for a, b in zip(out, want))
        if not err <= 1e-4:
            raise SystemExit(f"N={n}: the kernel is off by {err}")
        ms = {}
        for name in list(fns) + list(fns)[::-1]:   # in turns
            t = chip_smoke.device_ms(lambda: call(fns[name]))
            ms[name] = min(ms.get(name, t), t)
        print(json.dumps({"N": n, "d": 128, "split": split,
                          "max_abs_err": err, "ms": ms}), flush=True)
        del ops, hi, lo, partial, out
        torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
