"""Config system: dataclass mirrors of the reference argparse hierarchy."""

from multimodal_similarity_tpu_torch.configs.base import (
    BaseConfig,
    EvalConfig,
    TrainConfig,
    load_session_list,
    write_configure_to_file,
)

__all__ = ["BaseConfig", "EvalConfig", "TrainConfig", "load_session_list",
           "write_configure_to_file"]
