from tpusparse_torch.models.mlp import MnistNet, nll_loss

__all__ = ["MnistNet", "nll_loss"]
