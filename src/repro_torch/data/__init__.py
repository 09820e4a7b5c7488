from repro_torch.data import pipeline, synthetic

__all__ = ["pipeline", "synthetic"]
