"""Neural mask model: per-bucket CDAEs assembled into the 4-target Unmix."""

from .cdae import NB_TARGETS, SlicedCDAE
from .unmix import Unmix

__all__ = ["NB_TARGETS", "SlicedCDAE", "Unmix"]
