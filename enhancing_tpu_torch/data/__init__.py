from .base import DataLoader, DataModuleFromConfig, Dataset
from .cc3m import CC3MTrain, CC3MValidation
from .classimage import ClassImageTrain, ClassImageValidation
from .coco import CocoTrain, CocoValidation
from .fake import FakeImages
from .imagenet import ImageNetTrain, ImageNetValidation
from .inatural import INaturalistTrain, INaturalistValidation
from .lsun import LSUNTrain, LSUNValidation
from .srimage import SRImageTrain, SRImageValidation
from .textimage import TextImageTrain, TextImageValidation

__all__ = ["DataLoader", "DataModuleFromConfig", "Dataset", "FakeImages",
           "TextImageTrain", "TextImageValidation", "CC3MTrain",
           "CC3MValidation", "CocoTrain", "CocoValidation",
           "ClassImageTrain", "ClassImageValidation", "ImageNetTrain",
           "ImageNetValidation", "INaturalistTrain",
           "INaturalistValidation", "LSUNTrain", "LSUNValidation",
           "SRImageTrain", "SRImageValidation"]
