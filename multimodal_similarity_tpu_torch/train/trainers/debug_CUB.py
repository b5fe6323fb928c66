"""Debug harness for the end-to-end CUB trainer: ``base_CUB`` with
``debug=True`` (2 epochs), the reference's smoke harness
(``scripts/CUB_tensorflow.sh``).

Run:  python -m multimodal_similarity_tpu_torch.train.trainers.debug_CUB --DATA_ROOT <dir> ...
(``--device cpu`` runs on the CPU, the default is ``cuda``; ``--crop``
as ``base_CUB``'s, default 224.)
"""

from __future__ import annotations

import sys

from multimodal_similarity_tpu_torch.configs import TrainConfig
from multimodal_similarity_tpu_torch.train.trainers.base_CUB import (
    parse_cli, train as _train)


def train(cfg: TrainConfig, **kw):
    return _train(cfg, debug=True, **kw)


def main(argv=None):
    """The trainer CLI: ``base_CUB``'s (``parse_cli``)."""
    args, cfg = parse_cli(argv)
    train(cfg, crop=args.crop, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
