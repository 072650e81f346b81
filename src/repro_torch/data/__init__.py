"""Data for the port (see ``data.pipeline``)."""
from repro_torch.data.pipeline import (DataProducerError,
                                       StragglerTolerantLoader,
                                       SyntheticClassificationDataset,
                                       SyntheticLMDataset)

__all__ = ["DataProducerError", "StragglerTolerantLoader",
           "SyntheticClassificationDataset", "SyntheticLMDataset"]
