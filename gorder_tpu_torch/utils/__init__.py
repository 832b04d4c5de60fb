from .timers import PhaseTimers, timers  # noqa: F401

__all__ = ["PhaseTimers", "timers"]
