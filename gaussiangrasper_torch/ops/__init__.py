from gaussiangrasper_torch.ops.projection import project_gaussians, ProjectedGaussians
from gaussiangrasper_torch.ops.rasterize import rasterize, RasterizeConfig

__all__ = ["project_gaussians", "ProjectedGaussians", "rasterize", "RasterizeConfig"]
