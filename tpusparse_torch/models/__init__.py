from tpusparse_torch.models.bert import (
    BertAttentionLayer,
    BertEncoder,
    bert_loss,
    bert_train_step,
)
from tpusparse_torch.models.mlp import (
    MnistNet,
    make_train_state,
    nll_loss,
    train_epoch,
    train_step,
)

__all__ = [
    "BertAttentionLayer",
    "BertEncoder",
    "MnistNet",
    "bert_loss",
    "bert_train_step",
    "make_train_state",
    "nll_loss",
    "train_epoch",
    "train_step",
]
