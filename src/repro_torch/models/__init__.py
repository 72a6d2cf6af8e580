"""The LM substrate's dense serving path (the reference's `repro.models`)."""

from repro_torch.models.registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
