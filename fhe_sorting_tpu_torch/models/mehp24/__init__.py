from .sort import Mehp24Sort  # noqa: F401
