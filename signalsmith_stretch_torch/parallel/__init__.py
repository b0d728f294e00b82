from . import distributed  # noqa: F401
from .batch import batch_render, make_mesh, shard_batch  # noqa: F401
from .timechunk import stretch_long  # noqa: F401
