#!/usr/bin/env python3
"""``PipelinedBackbone`` across cards against the single-stage forward,
on a host with two or more NVIDIA GPUs.

    python3 scripts/pipeline_cards.py [STAGES ...]      (default: 2 4)

Builds the Inception-ResNet-v2 trunk at full width on ``cuda:0`` through
``slim_backbone``, grafted from ``chip_smoke.py``'s seed-made slim
checkpoint (random weights, every variable set), and embeds 32 seeded
uint8 frames at 720 x 1280 (the Honda camera's) with it: the single-stage
reference.  Then, for each stage count S, a ``PipelinedBackbone`` over
``devices=None`` (``cuda:0`` .. ``cuda:S-1``: each stage's units on its
own card, the hand-off a copy on the producing stage's stream ordered by
an event), microbatch 8, the resize in stage 0, and checks:

* each stage's parameters lie on its own card;
* the output is within ``chip_smoke.PIPE_RTOL`` of the single stage's
  (the largest element difference over the largest magnitude);
* asking for more stages than visible cards raises ValueError.

TF32 is off, as ``chip_smoke.py`` sets it.  Prints one JSON line a stage
count (stage ranges, the difference, ms a batch of 32 and frames a second
beside the single stage's, CUDA events around whole calls, readback
included) and the cards' name and power limit; exits 1 on a failed check.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from multimodal_similarity_tpu_torch.models import N_PIPELINE_UNITS
    from multimodal_similarity_tpu_torch.parallel import (
        INCEPTION_RESNET_V2_UNIT_COSTS, PipelinedBackbone)
    from multimodal_similarity_tpu_torch.preprocess.features import (
        make_preprocess, slim_backbone)

    stages = [int(a) for a in argv] or [2, 4]
    n_cards = torch.cuda.device_count()
    if n_cards < max(stages):
        print(f"pipeline_cards: {max(stages)} stages need as many cards, "
              f"{n_cards} visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    with tempfile.TemporaryDirectory(dir=HERE) as d:
        npz = os.path.join(d, "irv2_slim.npz")
        cs.fake_slim_npz(npz)
        embed = slim_backbone("inception_resnet_v2", npz, device="cuda:0")
    frames = cs.seeded_frames(cs.FEAT_BATCH, 22)
    single = embed(frames)
    single_ms = cs.call_ms(lambda: embed(frames), iters=cs.FEAT_TIMED,
                           warmup=1)
    kw = dict(n_units=N_PIPELINE_UNITS, input_shape=cs.FRAME_HW + (3,),
              microbatch=cs.PIPE_MICROBATCH,
              unit_costs=INCEPTION_RESNET_V2_UNIT_COSTS,
              preprocess=make_preprocess(299), input_dtype=torch.uint8)
    failed = []
    for n in stages:
        pipe = PipelinedBackbone(embed.model, n_stages=n, **kw)
        placed = [{str(p.device) for p in st.parameters()}
                  for st in pipe.stages]
        want = [{f"cuda:{s}"} for s in range(n)]
        got = pipe(frames).transpose(0, 2, 3, 1)
        err = cs.rel_delta(got, single)
        ms = cs.call_ms(lambda: pipe(frames), iters=cs.FEAT_TIMED,
                        warmup=1)
        out = {"stages": n, "stage_ranges": pipe.stage_ranges,
               "stage_params": pipe.stage_parameter_counts(),
               "placed": [sorted(p) for p in placed], "vs_single": err,
               "ms_per_batch": ms,
               "frames_per_s": cs.FEAT_BATCH / (ms / 1e3),
               "single_ms_per_batch": single_ms,
               "single_frames_per_s": cs.FEAT_BATCH / (single_ms / 1e3)}
        print(f"[pipeline_cards] {json.dumps(out)}", flush=True)
        if placed != want:
            failed.append(f"{n} stages placed on {placed}")
        if not (err <= cs.PIPE_RTOL and got.shape == single.shape):
            failed.append(f"{n} stages differ from one by {err:.3g}")
        del pipe
        torch.cuda.empty_cache()
    try:
        PipelinedBackbone(embed.model, n_stages=n_cards + 1, **kw)
        failed.append(f"{n_cards + 1} stages on {n_cards} cards did not "
                      "raise")
    except ValueError as e:
        if "are visible" not in str(e):
            failed.append(f"devices=None raised another error: {e}")
    print(f"[pipeline_cards] {n_cards} cards: {card}", flush=True)
    for msg in failed:
        print(f"pipeline_cards: {msg}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
