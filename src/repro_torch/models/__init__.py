from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
