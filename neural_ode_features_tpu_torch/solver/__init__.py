from .adjoint import AdjointStats, check_adjoint_options, odeint_adjoint
from .dense import DenseSolution, odeint_dense
from .fixed_grid import FIXED_GRID_METHODS, fixed_grid_odeint
from .odeint import SOLVERS, odeint
from .runge_kutta import SolveStats, adaptive_odeint
from .tableau import ADAPTIVE_TABLEAUS, DOPRI5

__all__ = ["SOLVERS", "odeint", "SolveStats", "adaptive_odeint",
           "ADAPTIVE_TABLEAUS", "DOPRI5", "odeint_adjoint", "AdjointStats",
           "check_adjoint_options", "odeint_dense", "DenseSolution",
           "fixed_grid_odeint", "FIXED_GRID_METHODS"]
