"""The RQ backend: ``TorchBackend`` and the six result types.

There is no registry and no router here: callers construct
``TorchBackend(device)`` (the card by default, the CPU when asked).
"""

from .base import (Backend, RQ1Result, RQ2ChangePointsResult, RQ2TrendsResult,
                   RQ3Result, RQ4aTrendResult, RQ4bTrendsResult)
from .torch_backend import TorchBackend

__all__ = ["Backend", "RQ1Result", "RQ2ChangePointsResult", "RQ2TrendsResult",
           "RQ3Result", "RQ4aTrendResult", "RQ4bTrendsResult", "TorchBackend"]
