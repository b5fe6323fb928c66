"""A seeded Honda-layout directory, written at a cell's set-up.

``write(root, config, seed, device)`` makes every session's frame labels
on the host (``numpy.random.RandomState``) and its features on the device
(one ``torch.Generator``): a frame of an event is its class centre plus
unit-normal noise, per modality.  Layout: ``features/<session><suffix>``
(``.npy`` for the resnet maps, ``_sensors_normalized.npy``,
``_seg_sp.npy``), ``labels/<session>_goal.pkl`` ({"label", "s", "G"}) and
the ``{all,train,val,test}_session.txt`` lists.  Every event has
``frames_per_event`` frames and a raw label in 1..10."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

SUFFIX = {"resnet": ".npy", "sensors": "_sensors_normalized.npy",
          "segment": "_seg_sp.npy"}
DTYPES = {"float16": torch.float16, "float32": torch.float32}


def modality_dims(config: dict) -> dict:
    return {"resnet": (config["n_h"], config["n_w"], config["n_input"]),
            "sensors": (config["sensors_dim"],),
            "segment": (config["segment_dim"],)}


def write(root: str, config: dict, seed: int, device) -> int:
    """The directory for ``config`` under ``root``; returns the bytes
    written."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = modality_dims(config)
    dtypes = {"resnet": DTYPES[config["resnet_file_dtype"]],
              "sensors": torch.float32, "segment": torch.float32}
    centres = {m: torch.randn((11,) + d, generator=gen, device=device)
               for m, d in dims.items()}
    length = config["frames_per_event"]
    splits = {"train": [f"2018{i:08d}"
                        for i in range(config["train_sessions"])],
              "val": [f"2019{i:08d}" for i in range(config["val_sessions"])]}
    events = {"train": config["events_per_session"],
              "val": config["val_events"]}
    for sub in ("features", "labels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    written = 0
    for split, sessions in splits.items():
        for sess in sessions:
            raw = rng.randint(1, 11, size=events[split])
            frame_labels = np.repeat(raw, length)
            lab = torch.from_numpy(frame_labels).to(device)
            for m, d in dims.items():
                x = centres[m][lab] + torch.randn(
                    (len(frame_labels),) + d, generator=gen, device=device)
                arr = x.to(dtypes[m]).cpu().numpy()
                np.save(os.path.join(root, "features", sess + SUFFIX[m]),
                        arr)
                written += arr.nbytes
                del x, arr
            with open(os.path.join(root, "labels", f"{sess}_goal.pkl"),
                      "wb") as f:
                pickle.dump({"label": frame_labels,
                             "s": np.arange(0, len(frame_labels) + 1,
                                            length),
                             "G": raw}, f)
    for split, ids in (("all", splits["train"] + splits["val"]),
                       ("train", splits["train"]), ("val", splits["val"]),
                       ("test", splits["val"])):
        with open(os.path.join(root, f"{split}_session.txt"), "w") as f:
            f.write("\n".join(ids))
    return written
