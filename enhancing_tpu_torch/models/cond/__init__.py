from .clipcond import ClipImageCond, ClipTextCond
from .dummycond import ClassCond, DummyCond, TextCond
from .vqcond import VQCond, VQSegmentation

__all__ = ["DummyCond", "TextCond", "ClassCond", "ClipTextCond",
           "ClipImageCond", "VQCond", "VQSegmentation"]
