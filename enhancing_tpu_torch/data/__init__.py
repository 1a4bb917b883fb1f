from .base import DataLoader, DataModuleFromConfig, Dataset
from .fake import FakeImages

__all__ = ["DataLoader", "DataModuleFromConfig", "Dataset", "FakeImages"]
