"""The port's tasks; importing this package registers them."""

from .image import DownsampleTask, TransferTask, downsample_and_upload
