from repro_torch.models.config import ModelConfig, ShapeCell, SHAPE_CELLS
from repro_torch.models import layers, ssm, blocks, lm

__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "layers", "ssm",
           "blocks", "lm"]
