from repro_torch.views.manager import ManagedView, ViewManager

__all__ = ["ManagedView", "ViewManager"]
