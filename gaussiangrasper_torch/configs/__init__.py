from gaussiangrasper_torch.configs.methods import get_method

__all__ = ["get_method"]
