"""Cross-cutting utilities: constants, phases, seeding."""

from gasfm.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT
from gasfm.utils.phases import Phases

__all__ = ["MIN_N_POINTS_PER_VIEW", "MIN_N_VIEWS_PER_POINT", "Phases"]
