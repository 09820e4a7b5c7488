from repro_torch.data import synthetic

__all__ = ["synthetic"]
