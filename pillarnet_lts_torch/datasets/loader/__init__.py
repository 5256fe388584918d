from .build_loader import DataLoader

__all__ = ["DataLoader"]
