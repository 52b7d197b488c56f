from repro_torch.models.api import ModelFns, build_model

__all__ = ["ModelFns", "build_model"]
