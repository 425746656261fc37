"""Named render configurations."""
from . import presets  # noqa: F401
