"""Neural mask models: per-bucket CDAEs or LSTMs assembled into the 4-target Unmix."""

from .cdae import NB_TARGETS, SlicedCDAE
from .lstm import SlicedLSTM
from .unmix import Unmix

__all__ = ["NB_TARGETS", "SlicedCDAE", "SlicedLSTM", "Unmix"]
