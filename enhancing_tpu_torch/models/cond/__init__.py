from .dummycond import ClassCond, DummyCond
from .vqcond import VQCond, VQSegmentation

__all__ = ["DummyCond", "ClassCond", "VQCond", "VQSegmentation"]
