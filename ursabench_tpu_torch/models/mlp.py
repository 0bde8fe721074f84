"""Three-layer MLPs (MLP200/400/600MNIST) and the dropout twin.

Counterpart of ``ursabench_tpu/models/mlp.py``: the input is flattened to
``input_dim`` features, then Dense, [dropout,] ReLU, Dense, [dropout,]
ReLU, Dense, with torch's default initialisation. The twin applies dropout
before each ReLU and keeps it active in eval mode (the reference calls
``F.dropout`` with its default ``training=True``). ``dtype`` is flax's
compute dtype (``models/common.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import MNIST_TEST, MNIST_TRAIN
from ..nn.init import torch_linear_
from .common import Dropout, Linear, ModelCfg, register


class MLP(nn.Module):
    def __init__(self, hidden_size: int, input_dim: int, num_classes: int,
                 dropout: float = 0.0, dtype=None):
        super().__init__()
        self.input_dim, self.num_classes, self.dtype = input_dim, num_classes, dtype
        self.fc1 = Linear(input_dim, hidden_size, dtype)
        self.drop1 = Dropout(dropout, always=True) if dropout > 0 else None
        self.fc2 = Linear(hidden_size, hidden_size, dtype)
        self.drop2 = Dropout(dropout, always=True) if dropout > 0 else None
        self.fc3 = Linear(hidden_size, num_classes, dtype)

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's initialisation, drawn from ``gen``."""
        for m in (self.fc1, self.fc2, self.fc3):
            torch_linear_(m.weight, m.bias, gen)

    def forward(self, x):
        x = self.fc1(x.reshape(-1, self.input_dim))
        if self.drop1 is not None:
            x = self.drop1(x)
        x = self.fc2(F.relu(x))
        if self.drop2 is not None:
            x = self.drop2(x)
        return self.fc3(F.relu(x))


def _cfg(name: str, hidden: int, dropout: float = 0.0) -> ModelCfg:
    return register(
        ModelCfg(
            name=name,
            make=lambda num_classes, **kw: MLP(num_classes=num_classes, **kw),
            transform_train=MNIST_TRAIN,
            transform_test=MNIST_TEST,
            kwargs={"hidden_size": hidden, "input_dim": 784, "dropout": dropout},
        )
    )


MLP200MNIST = _cfg("MLP200MNIST", 200)
MLP400MNIST = _cfg("MLP400MNIST", 400)
MLP600MNIST = _cfg("MLP600MNIST", 600)
MLP200MNIST_dropout = _cfg("MLP200MNIST_dropout", 200, dropout=0.2)
