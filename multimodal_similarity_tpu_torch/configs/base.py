"""Experiment configuration.

Dataclass mirrors of the reference's argparse hierarchy (same flag names,
same defaults, same derived fields as the JAX package's ``configs/base.py``),
so every experiment script translates flag for flag.  Flags whose feature is
not ported yet are still parsed; the trainers raise ``NotImplementedError``
when one is set.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union


def load_session_list(path: str) -> List[str]:
    with open(path, "r") as fin:
        text = fin.read().strip()
    # an empty file means no sessions: ''.split('\n') would yield ['']
    return text.split("\n") if text else []


def _resolve_sessions(value: Union[str, List[str]], data_root: str,
                      default_file: str) -> List[str]:
    """'all' -> DATA_ROOT/<default_file>; '*.txt' -> that file; else CSV."""
    if isinstance(value, list):
        return value
    if value == "all":
        path = os.path.join(data_root, default_file)
        return load_session_list(path) if os.path.exists(path) else []
    if value.endswith(".txt"):
        return load_session_list(os.path.join(data_root, value))
    return value.split(",")


@dataclass
class BaseConfig:
    name: str = "debug"
    silent_mode: bool = False
    seed: int = 12345
    ROOT: str = "./"
    DATA_ROOT: str = "./data/"

    all_session: Union[str, List[str]] = "all"
    train_session: Union[str, List[str]] = "all"
    val_session: Union[str, List[str]] = "all"
    test_session: Union[str, List[str]] = "all"

    # derived in resolve()
    feature_root: str = ""
    label_root: str = ""
    result_root: str = ""
    tfrecords_root: str = ""
    MAX_LENGTH_FRAMES: int = 90
    feat_dict: Dict[str, int] = field(
        default_factory=lambda: {"resnet": 98304, "sensors": 8})
    context_dict: Dict[str, str] = field(
        default_factory=lambda: {"label": "int", "length": "int"})
    feat_dim: Dict[str, Tuple[int, ...]] = field(
        default_factory=lambda: {"resnet": (8, 8, 1536), "sensors": (8,),
                                 "segment": (357,)})

    def resolve(self) -> "BaseConfig":
        # derived from DATA_ROOT; an explicitly constructed value is kept
        for attr, sub in (("feature_root", "features/"),
                          ("label_root", "labels/"),
                          ("result_root", "results/"),
                          ("tfrecords_root", "tfrecords2/")):
            if not getattr(self, attr):
                setattr(self, attr, os.path.join(self.DATA_ROOT, sub))
        for attr, fname in (("all_session", "all_session.txt"),
                            ("train_session", "train_session.txt"),
                            ("val_session", "val_session.txt"),
                            ("test_session", "test_session.txt")):
            setattr(self, attr, _resolve_sessions(
                getattr(self, attr), self.DATA_ROOT, fname))
        if isinstance(getattr(self, "feat", None), str) and "," in self.feat:
            self.feat = self.feat.split(",")
        if getattr(self, "int8_features", False) and \
                getattr(self, "bf16_features", False):
            raise ValueError("--int8_features and --bf16_features are "
                             "mutually exclusive")
        if getattr(self, "steps_per_dispatch", 1) > 1 and \
                not getattr(self, "device_cache", False):
            raise ValueError("--steps_per_dispatch > 1 requires "
                             "--device_cache")
        return self

    # ---- CLI ----------------------------------------------------------

    @classmethod
    def _add_args(cls, p: argparse.ArgumentParser) -> None:
        p.add_argument("--name", type=str, default="debug")
        p.add_argument("--silent_mode", action="store_true")
        p.add_argument("--seed", type=int, default=12345)
        p.add_argument("--ROOT", type=str, default="./")
        p.add_argument("--DATA_ROOT", type=str, default="./data/")
        for flag in ("all_session", "train_session", "val_session",
                     "test_session"):
            p.add_argument(f"--{flag}", type=str, default="all")

    @classmethod
    def parse(cls, argv: Optional[Sequence[str]] = None):
        p = argparse.ArgumentParser()
        cls._add_args(p)
        args = p.parse_args(argv)
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in vars(args).items() if k in known})
        return cfg.resolve()


@dataclass
class TrainConfig(BaseConfig):
    model_path: Optional[str] = None
    sensors_path: Optional[str] = None
    segment_path: Optional[str] = None
    feat: Union[str, List[str]] = "resnet"
    network: str = "tsn"
    metric: str = "squaredeuclidean"
    normalized: bool = True
    reverse: bool = False
    no_soft: bool = False
    no_joint: bool = False
    weighted: bool = False

    label_num: int = 93
    task: str = "supervised"

    num_threads: int = 2
    batch_size: int = 4
    max_epochs: int = 5
    sess_per_batch: int = 3
    event_per_batch: int = 1000
    triplet_per_batch: int = 100
    num_negative: int = 3
    num_seg: int = 3
    emb_dim: int = 256
    n_h: int = 8
    n_w: int = 8
    n_C: int = 20
    n_input: int = 1536
    triplet_select: str = "random"
    multimodal_select: str = "random"
    alpha: float = 0.2
    lambda_l2: float = 0.0
    lambda_ver: float = 0.0
    lambda_multimodal: float = 0.0
    keep_prob: float = 1.0
    negative_epochs: int = 0
    multimodal_epochs: int = 0

    learning_rate: float = 0.05
    static_epochs: int = 1000
    optimizer: str = "ADAM"
    label_type: str = "goal"
    loss: str = "triplet"
    device_mining: bool = False
    bf16_features: bool = False
    int8_features: bool = False
    multihost: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    device_cache: bool = False
    device_cache_gb: float = 6.0
    model_parallel: int = 0
    steps_per_dispatch: int = 1
    # step metrics are read back from the device every N steps; every step
    # is still logged (utils/logging.DeferredStepLogs)
    log_flush_every: int = 32
    watchdog_secs: float = 0.0
    profile_dir: str = ""
    profile_steps: int = 5

    @classmethod
    def _add_args(cls, p: argparse.ArgumentParser) -> None:
        super()._add_args(p)
        p.add_argument("--model_path", type=str, default=None)
        p.add_argument("--sensors_path", type=str, default=None)
        p.add_argument("--segment_path", type=str, default=None)
        p.add_argument("--feat", type=str, default="resnet")
        p.add_argument("--network", type=str, default="tsn")
        p.add_argument("--metric", type=str, default="squaredeuclidean")
        p.add_argument("--no_normalized", dest="normalized",
                       action="store_false")
        p.set_defaults(normalized=True)
        p.add_argument("--reverse", action="store_true")
        p.add_argument("--no_soft", action="store_true")
        p.add_argument("--no_joint", action="store_true")
        p.add_argument("--weighted", action="store_true")
        p.add_argument("--label_num", type=int, default=93)
        p.add_argument("--task", type=str, default="supervised")
        p.add_argument("--num_threads", type=int, default=2)
        p.add_argument("--batch_size", type=int, default=4)
        p.add_argument("--max_epochs", type=int, default=5)
        p.add_argument("--sess_per_batch", type=int, default=3)
        p.add_argument("--event_per_batch", type=int, default=1000)
        p.add_argument("--triplet_per_batch", type=int, default=100)
        p.add_argument("--num_negative", type=int, default=3)
        p.add_argument("--num_seg", type=int, default=3)
        p.add_argument("--emb_dim", type=int, default=256)
        p.add_argument("--n_h", type=int, default=8)
        p.add_argument("--n_w", type=int, default=8)
        p.add_argument("--n_C", type=int, default=20)
        p.add_argument("--n_input", type=int, default=1536)
        p.add_argument("--triplet_select", type=str, default="random")
        p.add_argument("--multimodal_select", type=str, default="random")
        p.add_argument("--device_mining", action="store_true")
        p.add_argument("--bf16_features", action="store_true")
        p.add_argument("--int8_features", action="store_true")
        p.add_argument("--multihost", action="store_true")
        p.add_argument("--coordinator_address", type=str, default="")
        p.add_argument("--num_processes", type=int, default=0)
        p.add_argument("--process_id", type=int, default=-1)
        p.add_argument("--device_cache", action="store_true")
        p.add_argument("--device_cache_gb", type=float, default=6.0)
        p.add_argument("--model_parallel", type=int, default=0)
        p.add_argument("--steps_per_dispatch", type=int, default=1)
        p.add_argument("--log_flush_every", type=int, default=32,
                       help="read step metrics back from the device every "
                            "N steps (every step is still logged; "
                            "1 = synchronous)")
        p.add_argument("--watchdog_secs", type=float, default=0.0)
        p.add_argument("--profile_dir", type=str, default="")
        p.add_argument("--profile_steps", type=int, default=5)
        p.add_argument("--alpha", type=float, default=0.2)
        p.add_argument("--lambda_l2", type=float, default=0.0)
        p.add_argument("--lambda_ver", type=float, default=0.0)
        p.add_argument("--lambda_multimodal", type=float, default=0.0)
        p.add_argument("--keep_prob", type=float, default=1.0)
        p.add_argument("--negative_epochs", type=int, default=0)
        p.add_argument("--multimodal_epochs", type=int, default=0)
        p.add_argument("--learning_rate", type=float, default=0.05)
        p.add_argument("--static_epochs", type=int, default=1000)
        p.add_argument("--optimizer", type=str, default="ADAM")
        p.add_argument("--label_type", type=str, default="goal")
        p.add_argument("--loss", type=str, default="triplet")


@dataclass
class EvalConfig(BaseConfig):
    """The evaluation CLIs' flags (the JAX ``EvalConfig``'s, same
    defaults), plus ``--device`` (default ``cuda``)."""
    model_path: Optional[str] = None
    sensors_path: Optional[str] = None
    variable_name: str = ""
    feat: Union[str, List[str]] = "resnet"
    network: str = "tsn"
    preprocess_func: str = "mean"
    use_output: bool = False
    transfer: bool = True
    num_seg: int = 3
    emb_dim: int = 256
    batch_size: int = 4
    n_h: int = 8
    n_w: int = 8
    n_C: int = 20
    n_input: int = 1536
    label_type: str = "goal"
    normalized: bool = True
    reverse: bool = False
    device: Optional[str] = None

    @classmethod
    def _add_args(cls, p: argparse.ArgumentParser) -> None:
        super()._add_args(p)
        p.add_argument("--model_path", type=str, default=None)
        p.add_argument("--sensors_path", type=str, default=None)
        p.add_argument("--variable_name", type=str, default="")
        p.add_argument("--feat", type=str, default="resnet")
        p.add_argument("--network", type=str, default="tsn")
        p.add_argument("--preprocess_func", type=str, default="mean")
        p.add_argument("--use_output", action="store_true")
        p.add_argument("--no_transfer", dest="transfer", action="store_false")
        p.set_defaults(transfer=True)
        p.add_argument("--num_seg", type=int, default=3)
        p.add_argument("--emb_dim", type=int, default=256)
        p.add_argument("--batch_size", type=int, default=4)
        p.add_argument("--n_h", type=int, default=8)
        p.add_argument("--n_w", type=int, default=8)
        p.add_argument("--n_C", type=int, default=20)
        p.add_argument("--n_input", type=int, default=1536)
        p.add_argument("--label_type", type=str, default="goal")
        p.add_argument("--no_normalized", dest="normalized",
                       action="store_false")
        p.set_defaults(normalized=True)
        p.add_argument("--reverse", action="store_true")
        p.add_argument("--device", type=str, default=None)


def write_configure_to_file(cfg, result_dir: str) -> None:
    """Config snapshot to <result_dir>/config.txt."""
    with open(os.path.join(result_dir, "config.txt"), "w") as fout:
        for key, value in sorted(vars(cfg).items()):
            fout.write("%s: %s\n" % (key, str(value)))
