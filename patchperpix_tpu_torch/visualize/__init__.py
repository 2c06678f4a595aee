from .instances import visualize_instances  # noqa: F401
from .patches import visualize_patches  # noqa: F401
