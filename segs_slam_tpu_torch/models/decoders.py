"""Neural-Gaussian decoder MLPs as an nn.Module.

Port of segs_slam_tpu/models/decoders.py. Architectures are the reference's
torch::nn::Sequential stacks (reference: src/gaussian_model.cpp:62-98):

  opacity:    Linear(F+3[+1] -> F) . ReLU . Linear(F -> K)       . Tanh
  cov:        Linear(F+3[+1] -> F) . ReLU . Linear(F -> 7K)
  color:      Linear(F+3[+1]+A -> F) . ReLU . Linear(F -> 3K)    . Sigmoid
  appearance: Linear(7 -> A)            (pose -> appearance code)
  feat_bank:  Linear(4 -> F) . ReLU . Linear(F -> 3) . Softmax   (optional)

Submodule names mirror the JAX parameter dict (`opacity.l1`, `cov.l2`, ...,
`appearance`, and the registered-but-unused `embedding.table`), so
io/convert.py maps one onto the other name by name. Initialisation is
torch.nn.Linear's U(+-1/sqrt(fan_in)) for weights and biases, drawn from an
explicit generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from segs_slam_tpu_torch.models.config import ModelConfig


def _linear(d_in: int, d_out: int, generator, device) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out,
                             device="cpu" if device is None else device)
    bound = 1.0 / math.sqrt(d_in)
    with torch.no_grad():
        for p in (lin.weight, lin.bias):
            p.uniform_(-bound, bound, generator=generator)
    return lin


class Mlp2(nn.Module):
    """Linear . ReLU . Linear (the output activation is applied by the
    Decoders method that owns the MLP)."""

    def __init__(self, d_in, d_hidden, d_out, generator=None, device=None):
        super().__init__()
        self.l1 = _linear(d_in, d_hidden, generator, device)
        self.l2 = _linear(d_hidden, d_out, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.l2(torch.relu(self.l1(x)))


class Table(nn.Module):
    """The reference's per-keyframe appearance Embedding: registered in the
    optimizer but never read by the live renderer (decoders.py of the JAX
    package); kept so that parameter layouts convert one to one."""

    def __init__(self, rows, cols, generator=None, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(rows, cols, device=device))
        with torch.no_grad():
            self.table.normal_(generator=generator)


class Decoders(nn.Module):
    """The decoder MLPs for `config`, initialised from `generator` (a
    generator seeded with 0 on `device` when none is given)."""

    def __init__(self, config: ModelConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.config = config
        f, k = config.feat_dim, config.n_offsets
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        g, dev = generator, device
        self.opacity = Mlp2(config.opacity_in, f, k, g, dev)
        self.cov = Mlp2(config.cov_in, f, 7 * k, g, dev)
        self.color = Mlp2(config.color_in, f, 3 * k, g, dev)
        if config.appearance_dim > 0:
            self.appearance = _linear(7, config.appearance_dim, g, dev)
            self.embedding = Table(config.embedding_dim,
                                   config.appearance_dim, g, dev)
        if config.use_feat_bank:
            self.feat_bank = Mlp2(4, f, 3, g, dev)

    def decode_opacity(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.opacity(x))

    def decode_cov(self, x: torch.Tensor) -> torch.Tensor:
        return self.cov(x)

    def decode_color(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.color(x))

    def decode_appearance(self, pose7: torch.Tensor) -> torch.Tensor:
        return self.appearance(pose7)

    def decode_feat_bank(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.feat_bank(x), dim=-1)
