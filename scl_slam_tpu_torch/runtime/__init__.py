from .fleet import FleetMapper
from .mapper import Mapper
from .state import MapperState, make_state, state_from_numpy, state_to_numpy

__all__ = [
    "FleetMapper", "Mapper", "MapperState", "make_state", "state_from_numpy",
    "state_to_numpy",
]
