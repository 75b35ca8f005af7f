"""Task factories of the port."""

from .image import create_downsampling_tasks
