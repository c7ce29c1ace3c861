from gaussiangrasper_torch.core.transforms import normalize, quat_to_rotmat, random_quats
from gaussiangrasper_torch.core.cameras import Camera, view_matrix
from gaussiangrasper_torch.core import sh

__all__ = ["normalize", "quat_to_rotmat", "random_quats", "Camera", "view_matrix", "sh"]
