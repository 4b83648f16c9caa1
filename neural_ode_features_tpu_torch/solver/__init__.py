from ..tableau import ADAPTIVE_TABLEAUS, DOPRI5
from .adams import adams_odeint
from .adjoint import AdjointStats, check_adjoint_options, odeint_adjoint
from .dense import DenseSolution, odeint_dense
from .event import EventSolution, odeint_event
from .event_adjoint import odeint_event_adjoint
from .fixed_grid import FIXED_GRID_METHODS, fixed_grid_odeint
from .odeint import SOLVERS, odeint
from .runge_kutta import SolveStats, adaptive_odeint

__all__ = ["SOLVERS", "odeint", "SolveStats", "adaptive_odeint",
           "adams_odeint", "ADAPTIVE_TABLEAUS", "DOPRI5", "odeint_adjoint",
           "AdjointStats", "check_adjoint_options", "odeint_dense",
           "DenseSolution", "odeint_event", "odeint_event_adjoint",
           "EventSolution", "fixed_grid_odeint", "FIXED_GRID_METHODS"]
