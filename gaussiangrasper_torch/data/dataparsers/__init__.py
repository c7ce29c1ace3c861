from gaussiangrasper_torch.data.dataparsers.base import DataparserOutputs
from gaussiangrasper_torch.data.dataparsers.colmap import ColmapDataParser
from gaussiangrasper_torch.data.dataparsers.transforms_json import TransformsJsonParser

__all__ = ["DataparserOutputs", "ColmapDataParser", "TransformsJsonParser"]
