"""ELAN annotation parsing -> frame-level labels -> RLE segment pickles.

Reference: preprocess/parse_annotation.py:16-140 — per session, read the
event tier of the .eaf file (pympi), map annotation names to ids, write a
frame-label vector at 3 fps (second -> frame x3, +-3 s annotation noise is
accepted), dropping 'park' events and events shorter than 5 frames; then
run-length encode to {'label', 's', 'G'} and pickle as
<session>_<label_type>.pkl.  pympi is optional: when absent, a stdlib
XML reader covers the time-aligned event tiers this pipeline consumes.

The port's copy of the JAX package's ``preprocess/annotations.py``, with
one change (ROADMAP deviation D7): where the tier holds a
``REF_ANNOTATION`` or no ``ALIGNABLE_ANNOTATION`` at all, the minimal
reader raises ValueError naming pympi-ling, where the JAX reader returns
no events and so an all-background label vector.
"""

from __future__ import annotations

import glob
import os
import pickle
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the two annotation tiers of interest (reference :101-108)
TIER_STIMULI = "被動的駕駛行為 Operation_Stimuli-driven"
TIER_GOAL = "主動的駕駛行為 Operation_Goal-oriented"


def convert_seg(seg: np.ndarray) -> Tuple[List[int], List[int]]:
    """Frame labels -> (segment starts s [m+1], segment labels G [m])
    (reference :16-39)."""
    n = seg.shape[0]
    s = [0]
    g = [int(seg[0])]
    for i in range(1, n):
        if seg[i] != seg[i - 1]:
            s.append(i)
            g.append(int(seg[i]))
    s.append(n)
    return s, g


def annotations_to_frame_labels(
    annotations: Sequence[Tuple[float, float, str]],
    n_frames: int,
    label_dict: Dict[str, int],
    fps: int = 3,
    min_frames: int = 5,
) -> np.ndarray:
    """(start_ms, end_ms, name) tuples -> [n_frames] int labels.

    Reproduces the reference event filters: empty names and '... park'
    events dropped, events shorter than ``min_frames`` dropped, new names
    appended to ``label_dict`` in first-seen order, partial overlaps
    clipped (reference :64-97)."""
    label = np.zeros((n_frames,), dtype="int32")
    for start_ms, end_ms, raw_name in annotations:
        name = raw_name.strip()
        if name == "":
            continue
        if name.split(" ")[-1] == "park":
            continue
        if name not in label_dict:
            label_dict[name] = len(label_dict.keys())
        start = int(np.round(start_ms / 1000.0)) * fps
        end = int(np.round(end_ms / 1000.0)) * fps
        if end - start < min_frames:
            continue
        if start >= 0 and end < n_frames:
            label[start:end + 1] = label_dict[name]
        elif start < n_frames and end > 0:
            start = max(start, 0)
            end = min(n_frames - 1, end)
            label[start:end + 1] = label_dict[name]
    return label


def _parse_eaf_minimal(eaf_path: str, tier: str):
    """Dependency-free ELAN reader for the subset the Honda annotations
    use: time-aligned (ALIGNABLE_ANNOTATION) events on a named tier.  EAF
    is plain XML — TIME_ORDER/TIME_SLOT ids carry the milliseconds,
    annotations reference a start and end slot.  Document order is
    preserved (it determines label_dict first-seen ids and which event
    wins an overlap, reference parse_annotation.py:66-97)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(eaf_path).getroot()
    times = {ts.get("TIME_SLOT_ID"): int(ts.get("TIME_VALUE"))
             for ts in root.iter("TIME_SLOT")
             if ts.get("TIME_VALUE") is not None}
    out = []
    found = False
    for t in root.iter("TIER"):
        if t.get("TIER_ID") != tier:
            continue
        found = True
        if next(t.iter("REF_ANNOTATION"), None) is not None:
            # symbolic annotations take their times from a parent tier,
            # which this subset does not follow
            raise ValueError(
                f"tier {tier!r} in {eaf_path!r} holds REF_ANNOTATIONs; "
                "this file needs the full ELAN reader — install "
                "pympi-ling")
        for ann in t.iter("ALIGNABLE_ANNOTATION"):
            val = ann.find("ANNOTATION_VALUE")
            refs = (ann.get("TIME_SLOT_REF1"), ann.get("TIME_SLOT_REF2"))
            if any(r not in times for r in refs):
                # legal ELAN allows value-less TIME_SLOTs (partially
                # aligned / subdivided tiers); that is beyond this
                # stdlib subset — say so instead of a bare KeyError
                raise ValueError(
                    f"annotation {ann.get('ANNOTATION_ID')!r} in "
                    f"{eaf_path!r} references TIME_SLOT(s) without a "
                    f"TIME_VALUE ({refs}); this file needs the full "
                    "ELAN reader — install pympi-ling")
            out.append((times[refs[0]], times[refs[1]],
                        val.text if val is not None and val.text else ""))
    if not found:
        raise KeyError(f"tier {tier!r} not present in {eaf_path!r}")
    if not out:
        # an empty list would label every frame background without a word
        raise ValueError(
            f"tier {tier!r} in {eaf_path!r} holds no time-aligned "
            "annotation; this file needs the full ELAN reader — install "
            "pympi-ling")
    return out


def parse_eaf(eaf_path: str, tier: str):
    """Read one tier of an ELAN file -> [(start_ms, end_ms, name)].

    Uses pympi when installed (it handles every EAF variant); otherwise
    falls back to the stdlib reader above, which covers the time-aligned
    event tiers this pipeline consumes."""
    try:
        import pympi
    except ImportError:
        return _parse_eaf_minimal(eaf_path, tier)
    eafob = pympi.Elan.Eaf(eaf_path)
    return [(a[0], a[1], a[2]) for a in
            eafob.get_annotation_data_for_tier(tier)]


def parse_sessions(eaf_glob_template: str, feature_dir: str, label_dir: str,
                   tier: str = TIER_STIMULI,
                   label_type: str = "stimuli") -> Dict[int, str]:
    """Batch parse: for every <session>_sensors.npy, find the session .eaf
    (template with {session} placeholder), write
    <label_dir>/<session>_<label_type>.pkl, return the num->label map."""
    os.makedirs(label_dir, exist_ok=True)
    label_dict: Dict[str, int] = {"background": 0}
    for fin in sorted(glob.glob(os.path.join(feature_dir,
                                             "*_sensors.npy"))):
        session_id = os.path.basename(fin).split("_")[0]
        n = np.load(fin, mmap_mode="r").shape[0]
        matches = glob.glob(eaf_glob_template.format(session=session_id))
        if not matches:
            print(f"no annotation for {session_id}, skipping")
            continue
        ann = parse_eaf(matches[0], tier)
        label = annotations_to_frame_labels(ann, n, label_dict)
        s, g = convert_seg(label)
        with open(os.path.join(label_dir,
                               f"{session_id}_{label_type}.pkl"),
                  "wb") as f:
            pickle.dump({"label": label, "s": s, "G": g}, f)
    return {v: k for k, v in label_dict.items()}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--eaf_template", required=True,
                   help="glob with {session}, e.g. '/data/EAF/{session}*.eaf'")
    p.add_argument("--feature_root", required=True)
    p.add_argument("--label_root", required=True)
    p.add_argument("--tier", default="stimuli",
                   choices=("stimuli", "goal"))
    args = p.parse_args(argv)
    tier = TIER_STIMULI if args.tier == "stimuli" else TIER_GOAL
    num2label = parse_sessions(args.eaf_template, args.feature_root,
                               args.label_root, tier, args.tier)
    print(num2label)


if __name__ == "__main__":
    main(sys.argv[1:])
