from gaussiangrasper_torch.models.gaussian_field import GaussianParams, init_random
from gaussiangrasper_torch.models.model import GaussianSplatConfig

__all__ = ["GaussianParams", "init_random", "GaussianSplatConfig"]
