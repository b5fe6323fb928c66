#!/usr/bin/env python3
"""What the semi-hard miner's label ranking costs a step, on one NVIDIA
GPU: two trees of this repository compared in turns.

    python3 scripts/f3_probe.py <tree> [<tree> ...]

Runs one process a tree argument, in the order given (for example parent,
change, change, parent).  Each imports that tree's
``multimodal_similarity_tpu_torch`` and ``chip_smoke.py``, with TF32 off
as ``chip_smoke.py`` sets it, and measures:

* ``base_model_CUB``'s steady step through that tree's ``cub_steady``
  (step, device busy time, idle share, CUDA-event span): the fused
  semi-hard step on a ``CUBLayer`` over 1024-d features at
  scripts/train_base_CUB.sh's width (emb 64, batch 64, 64 triplets, Adam
  1e-3), random weights from seed 12345, on synthetic features of 100
  classes x 59 rows from the same seed;
* the fused semi-hard step at bench.py's shape through that tree's
  ``fused_step_rates`` (events a second in f32, bf16 and int8).

Builds no kernel: neither path launches one.  Prints one JSON line a run
and the card line.
"""

import json
import os
import subprocess
import sys
import tempfile


def one(tree):
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from multimodal_similarity_tpu_torch.data.cub import (
        generate_synthetic_cub, sample_cub_batch)
    from multimodal_similarity_tpu_torch.models import CUBLayer
    from multimodal_similarity_tpu_torch.train.state import build_optimizer
    from multimodal_similarity_tpu_torch.train.steps import (
        make_triplet_train_step)
    from multimodal_similarity_tpu_torch.train.trainers._cub import (
        class_index)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    scratch = os.path.join(tree, "_build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as root:
        feats = generate_synthetic_cub(
            root, n_classes=cs.CUB_CLASSES, per_class=cs.CUB_PER_CLASS,
            feat_dim=1024, att_dim=312, seed=cs.CUB_SEED)
    model = CUBLayer(1024, 64, 1.0,
                     generator=torch.Generator().manual_seed(cs.CUB_SEED),
                     dropout_generator=torch.Generator(device=cuda)
                     .manual_seed(cs.CUB_SEED + 1)).to(cuda)
    step = make_triplet_train_step(
        model, build_optimizer("ADAM", model, 1e-3), triplet_per_batch=64,
        alpha=0.2, generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(1)
    classes = class_index(feats["label_train"])

    def feature_batch():
        idx = sample_cub_batch(classes, 64, rng)
        return (torch.from_numpy(feats["feat_train"][idx]).to(cuda),
                torch.from_numpy(feats["label_train"][idx] + 1).to(cuda),
                torch.ones(len(idx), device=cuda), 1e-3)

    cub = cs.cub_steady("base_model_CUB", step, feature_batch)
    rates = cs.fused_step_rates()
    print(json.dumps({"tree": tree, "base_model_CUB": cub,
                      "fused_events_per_s": rates}), flush=True)


def main(argv):
    if argv[:1] == ["--one"]:
        one(os.path.abspath(argv[1]))
        return 0
    for tree in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
