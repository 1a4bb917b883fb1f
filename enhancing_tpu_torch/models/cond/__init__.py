from .dummycond import ClassCond, DummyCond

__all__ = ["DummyCond", "ClassCond"]
