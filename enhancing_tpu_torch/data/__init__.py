from .base import DataLoader, DataModuleFromConfig, Dataset
from .cc3m import CC3MTrain, CC3MValidation
from .coco import CocoTrain, CocoValidation
from .fake import FakeImages
from .textimage import TextImageTrain, TextImageValidation

__all__ = ["DataLoader", "DataModuleFromConfig", "Dataset", "FakeImages",
           "TextImageTrain", "TextImageValidation", "CC3MTrain",
           "CC3MValidation", "CocoTrain", "CocoValidation"]
