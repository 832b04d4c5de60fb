"""pygorder ``gorder.exceptions`` (exceptions.pyi: AnalysisError,
WriteError, ConfigError, APIError)."""

from ..errors import (  # noqa: F401
    AnalysisError,
    ConfigError,
    GorderError,
    WriteError,
)

#: pygorder's catch-all for API misuse; our taxonomy root serves the role
APIError = GorderError

__all__ = ["AnalysisError", "WriteError", "ConfigError", "APIError"]
