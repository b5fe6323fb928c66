"""Package CLI: list and dispatch the trainers, the evaluation CLIs, the
preprocessing CLIs and the tools.

    python -m multimodal_similarity_tpu_torch                  # list commands
    python -m multimodal_similarity_tpu_torch train.base_model --DATA_ROOT ...
    python -m multimodal_similarity_tpu_torch eval.evaluate_model --model_path ...
    python -m multimodal_similarity_tpu_torch preprocess.features --frame_root ...
    python -m multimodal_similarity_tpu_torch tools.import_tf1 --ckpt ...

The command lists are the JAX package's.
"""

from __future__ import annotations

import importlib
import sys

TRAINERS = [
    "base_model", "base_model_tf", "base_model_batchhard",
    "base_model_lifted", "base_model_classifier", "multitask_model",
    "pairsim_model", "pddm_model", "multimodal_model",
    "multimodal_model_hardonly", "multimodal_model_weak",
    "modality_hallucination", "modality_hallucination_weak",
    "multitask_dcca", "multitask_cross_prediction", "cross_prediction",
    "unimodal_pretrain_sae", "unimodal_pretrain_cluster",
    "unimodal_pretrain_pairsim", "base_model_CUB", "base_CUB", "pddm_CUB",
    "debug_CUB",
]
EVALS = [
    "evaluate_model", "evaluate_baseline", "evaluate_late_fusion",
    "evaluate_hallucination", "evaluate_pairsim", "check_inconsistent",
    "analysis", "export_index",
]
PREPROCESS = ["frames", "features", "annotations", "sensors",
              "segmentation"]
TOOLS = ["import_tf1"]


def _usage() -> None:
    print(__doc__)
    for title, group, names in (("trainers", "train", TRAINERS),
                                ("evaluation", "eval", EVALS),
                                ("preprocessing", "preprocess", PREPROCESS),
                                ("tools", "tools", TOOLS)):
        print(f"{title} ({group}.<name>):")
        for name in names:
            print(f"  {name}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        _usage()
        return 0
    cmd = argv[0]
    group, _, name = cmd.partition(".")
    module_map = {
        "train": ("multimodal_similarity_tpu_torch.train.trainers.",
                  TRAINERS),
        "eval": ("multimodal_similarity_tpu_torch.eval.", EVALS),
        "preprocess": ("multimodal_similarity_tpu_torch.preprocess.",
                       PREPROCESS),
        "tools": ("multimodal_similarity_tpu_torch.tools.", TOOLS),
    }
    if group not in module_map or name not in module_map[group][1]:
        print(f"unknown command: {cmd}\n")
        _usage()
        return 2
    importlib.import_module(module_map[group][0] + name).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
