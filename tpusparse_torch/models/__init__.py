from tpusparse_torch.models.mlp import (
    MnistNet,
    make_train_state,
    nll_loss,
    train_epoch,
    train_step,
)

__all__ = ["MnistNet", "make_train_state", "nll_loss", "train_epoch", "train_step"]
