from .ppp import PPPConfig, PPPModel, apply_activations  # noqa: F401
