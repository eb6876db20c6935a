from .spaces import FunctionSpace  # noqa: F401
