"""Training visualization (counterpart of ``bigdl_tpu/visualization``; the
reference's ``$DL/visualization``): ``TrainSummary`` / ``ValidationSummary``
writing TensorBoard event files with the in-repo writer."""

from .summary import Summary, TrainSummary, ValidationSummary
from .tb import EventWriter, read_events

__all__ = ["TrainSummary", "ValidationSummary", "Summary", "EventWriter", "read_events"]
