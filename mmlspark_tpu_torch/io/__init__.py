"""IO layer of the port (the port of `mmlspark_tpu/io/`): binary-file,
image, remote and SQL ingestion (reference L2: readers/)."""

from mmlspark_tpu_torch.io.files import (iter_binary_files, list_files,
                                         read_binary_files)
from mmlspark_tpu_torch.io.image_reader import (decode_bytes, read_images,
                                                read_images_iter)
from mmlspark_tpu_torch.io.sql import iter_sql, read_sql

__all__ = ["list_files", "iter_binary_files", "read_binary_files",
           "read_images", "read_images_iter", "decode_bytes",
           "read_sql", "iter_sql"]
