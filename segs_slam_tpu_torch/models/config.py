"""Model configuration (anchor + decoder hyperparameters).

Field-for-field the knobs of GaussianModelParams the live system consumes
(reference: include/gaussian_parameters.h:22-305 and the cfg yamls under
cfg/gaussian_mapper/). Coarse-anchor duplicates are intentionally dropped:
`use_coarse_anchor` is false in every shipped config, and the coarse render
path lives only in the dead file `gaussian_renderer copy.cpp`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    feat_dim: int = 32
    n_offsets: int = 10
    voxel_size: float = 0.001
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    use_feat_bank: bool = False
    appearance_dim: int = 32
    ratio: int = 1
    add_opacity_dist: bool = False
    add_cov_dist: bool = False
    add_color_dist: bool = False
    embedding_dim: int = 179  # legacy per-keyframe table (see decoders.py)

    # Fixed-capacity anchor buffer (static-shape replacement for the
    # reference's dynamic tensor reallocation).
    capacity: int = 2**16

    @property
    def opacity_in(self) -> int:
        return self.feat_dim + 3 + (1 if self.add_opacity_dist else 0)

    @property
    def cov_in(self) -> int:
        return self.feat_dim + 3 + (1 if self.add_cov_dist else 0)

    @property
    def color_in(self) -> int:
        return self.feat_dim + 3 + (1 if self.add_color_dist else 0) + self.appearance_dim
