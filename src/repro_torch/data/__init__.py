"""Data for the port (see ``data.pipeline``)."""
from repro_torch.data.pipeline import (SyntheticClassificationDataset,
                                       SyntheticLMDataset)

__all__ = ["SyntheticClassificationDataset", "SyntheticLMDataset"]
