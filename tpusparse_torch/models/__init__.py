from tpusparse_torch.models.bert import (
    BertAttentionLayer,
    BertEncoder,
    bert_loss,
    bert_train_step,
)
from tpusparse_torch.models.appnp import APPNP, appnp_propagate
from tpusparse_torch.models.gat import GAT, GATLayer, add_self_loops
from tpusparse_torch.models.gcn import (
    GCN,
    GCNLayer,
    normalized_adjacency,
    random_graph,
    two_cluster_graph,
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
    "APPNP",
    "BertAttentionLayer",
    "BertEncoder",
    "GAT",
    "GATLayer",
    "GCN",
    "GCNLayer",
    "GPTBlock",
    "GPTDecoder",
    "MnistNet",
    "QuantizedGPT",
    "add_self_loops",
    "appnp_propagate",
    "bert_loss",
    "bert_train_step",
    "generate",
    "make_train_state",
    "nll_loss",
    "normalized_adjacency",
    "quantize_gpt",
    "random_graph",
    "train_epoch",
    "train_step",
    "two_cluster_graph",
]
