from .sorter import KWaySorter  # noqa: F401
