"""Import a trained TF1 reference checkpoint into a port checkpoint.

    python -m multimodal_similarity_tpu_torch tools.import_tf1 \
        --ckpt /path/to/reference_model.ckpt --model convrtsn \
        --output /path/to/model.ckpt-0

The port of the JAX package's ``tools/import_tf1.py``.  The output is a
port checkpoint (``train/checkpoints.save_checkpoint``: the module's
``state_dict``, no optimizer state, step 0) that the eval CLIs and the
trainers' ``--model_path`` restore, and that ``train.multimodal_model
--sensors_path/--segment_path`` takes as a pretrained branch.  Model
dimensions come from the checkpoint's own variable shapes; only the
spatial grid (``--n_h/--n_w``) and sequence lengths, which leave no trace
in the parameter shapes, are flags.

``--print_vars`` lists the checkpoint's variables (name, shape) without
converting, for diagnosing an unexpected layout.
"""

from __future__ import annotations

import argparse

from torch import nn

from multimodal_similarity_tpu_torch.models import encoders, heads
from multimodal_similarity_tpu_torch.train.checkpoints import save_checkpoint
from multimodal_similarity_tpu_torch.utils.tf1_import import (
    _conv_filter, _find, convert_tf1_variables, read_tf1_checkpoint)


def _build(model: str, variables, n_seg: int, n_h: int, n_w: int,
           max_time: int) -> nn.Module:
    """The port module for ``model`` with its widths read from the
    checkpoint variables."""
    key = model.lower()
    if key in ("tsn", "rtsn"):
        n_input, emb = _find(variables, "W_1").shape
        cls = encoders.TSN if key == "tsn" else encoders.RTSN
        return cls(n_seg=n_seg, emb_dim=int(emb), n_input=int(n_input))
    if key in ("convtsn", "convtsnclassifier", "convrtsn", "convbirtsn",
               "convlstm"):
        n_input, n_c = _conv_filter(_find(variables, "W_emb")).shape
        n_input, n_c = int(n_input), int(n_c)
        if key in ("convtsn", "convtsnclassifier"):
            hwc, emb = _find(variables, "W").shape
            if hwc != n_h * n_w * n_c:
                raise ValueError(
                    f"checkpoint fc input dim {hwc} != n_h*n_w*n_C = "
                    f"{n_h}*{n_w}*{n_c}; pass the run's --n_h/--n_w")
            kw = dict(n_seg=n_seg, n_C=n_c, emb_dim=int(emb),
                      n_input=n_input, n_h=n_h, n_w=n_w)
            if key == "convtsnclassifier":
                return encoders.ConvTSNClassifier(
                    n_output=int(_find(variables, "W_o").shape[1]), **kw)
            return encoders.ConvTSN(**kw)
        lstm_kernel = _find(variables, "fw/lstm_cell/kernel"
                            if key == "convbirtsn" else "lstm_cell/kernel")
        units = int(lstm_kernel.shape[1]) // 4
        emb = 2 * units if key == "convbirtsn" else units
        if key == "convlstm":
            return encoders.ConvLSTM(max_time=max_time, n_C=n_c,
                                     emb_dim=emb, n_input=n_input,
                                     n_h=n_h, n_w=n_w)
        cls = (encoders.ConvBiRTSN if key == "convbirtsn"
               else encoders.ConvRTSN)
        return cls(n_seg=n_seg, n_C=n_c, emb_dim=emb, n_input=n_input,
                   n_h=n_h, n_w=n_w)
    if key == "sae":
        n_input, emb = _find(variables, "W_1").shape
        return encoders.SAE(n_input=int(n_input), emb_dim=int(emb))
    if key == "seq2seqtsn":
        n_input, emb = _find(variables, "W_encode").shape
        return encoders.Seq2seqTSN(n_seg=n_seg, n_input=int(n_input),
                                   emb_dim=int(emb))
    if key in ("pairsim", "pairsim2", "pddm"):
        w = _find(variables, "W_u" if key == "pddm" else "W_pairwise")
        n_input = int(w.shape[1])  # output dim == n_input in every variant
        cls = {"pairsim": heads.PairSim, "pairsim2": heads.PairSim2,
               "pddm": heads.PDDM}[key]
        return cls(n_input=n_input)
    if key in ("outputlayer", "cublayer"):
        n_in, n_out = _find(variables, "W").shape
        cls = (encoders.OutputLayer if key == "outputlayer"
               else encoders.CUBLayer)
        return cls(n_input=int(n_in), n_output=int(n_out))
    raise ValueError(f"unknown model {model!r}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="tools.import_tf1", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="TF1 .ckpt prefix (or .npz with TF1 variable names)")
    p.add_argument("--model", required=True,
                   help="port model to import into: tsn rtsn convtsn "
                        "convrtsn convbirtsn convlstm convtsnclassifier "
                        "sae seq2seqtsn pairsim pairsim2 pddm "
                        "outputlayer cublayer")
    p.add_argument("--output", default="",
                   help="output checkpoint file (required unless "
                        "--print_vars)")
    p.add_argument("--n_seg", type=int, default=3)
    p.add_argument("--n_h", type=int, default=8)
    p.add_argument("--n_w", type=int, default=8)
    p.add_argument("--max_time", type=int, default=90,
                   help="ConvLSTM max_time (no trace in param shapes)")
    p.add_argument("--scope", default="",
                   help="variable-name prefix to select and strip before "
                        "mapping (mirrors eval's --variable_name).  The "
                        "reference flagship saves BOTH branches in one "
                        "checkpoint (multimodal_model.py:178-217: "
                        "modality_sensors/RTSN/..., modality_segment/"
                        "RTSN/...), which makes every suffix ambiguous; "
                        "--scope modality_sensors picks one branch")
    p.add_argument("--print_vars", action="store_true",
                   help="list checkpoint variables and exit")
    cfg = p.parse_args(argv)

    variables = read_tf1_checkpoint(cfg.ckpt)
    if cfg.scope:
        prefix = cfg.scope.rstrip("/") + "/"
        scoped = {name[len(prefix):]: val for name, val in variables.items()
                  if name.startswith(prefix)}
        if not scoped:
            p.error(f"--scope {cfg.scope!r} matches no variable; "
                    f"prefixes present: "
                    f"{sorted({n.split('/')[0] for n in variables})}")
        variables = scoped
    if cfg.print_vars:
        for name in sorted(variables):
            print(f"{name}  {tuple(variables[name].shape)}")
        return
    if not cfg.output:
        p.error("--output is required unless --print_vars")

    module = _build(cfg.model, variables, cfg.n_seg, cfg.n_h, cfg.n_w,
                    cfg.max_time)
    module.load_state_dict(convert_tf1_variables(cfg.model, variables,
                                                 module))
    n = sum(p.numel() for p in module.parameters())
    save_checkpoint(cfg.output, module, None, 0)
    print(f"imported {cfg.model} ({n:,} params) from {cfg.ckpt} "
          f"-> {cfg.output}")


if __name__ == "__main__":
    main()
