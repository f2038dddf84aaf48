from tpusparse_torch.utils.config import (
    Config,
    cdiv,
    get_config,
    resolve_device,
    round_up,
    set_config,
)

__all__ = ["Config", "cdiv", "get_config", "resolve_device", "round_up", "set_config"]
