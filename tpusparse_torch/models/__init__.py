from tpusparse_torch.models.bert import (
    BertAttentionLayer,
    BertEncoder,
    bert_loss,
    bert_train_step,
)
from tpusparse_torch.models.gpt import GPTBlock, GPTDecoder, generate
from tpusparse_torch.models.mlp import (
    MnistNet,
    make_train_state,
    nll_loss,
    train_epoch,
    train_step,
)
from tpusparse_torch.models.serving import QuantizedGPT, quantize_gpt

__all__ = [
    "BertAttentionLayer",
    "BertEncoder",
    "GPTBlock",
    "GPTDecoder",
    "MnistNet",
    "QuantizedGPT",
    "bert_loss",
    "bert_train_step",
    "generate",
    "make_train_state",
    "nll_loss",
    "quantize_gpt",
    "train_epoch",
    "train_step",
]
