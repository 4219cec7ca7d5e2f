# the dataset modules import PIL: ``build_dataloader`` imports them lazily
from .loader import DataLoader, build_dataloader  # noqa: F401
