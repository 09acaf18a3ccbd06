from . import factors, rotation_init, solver
from .factors import FactorGraph, add_between, add_prior, make_graph

__all__ = ["factors", "rotation_init", "solver", "FactorGraph", "make_graph",
           "add_between", "add_prior"]
