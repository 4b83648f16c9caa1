from .odeint import SOLVERS, odeint
from .runge_kutta import SolveStats, adaptive_odeint
from .tableau import ADAPTIVE_TABLEAUS, DOPRI5

__all__ = ["SOLVERS", "odeint", "SolveStats", "adaptive_odeint",
           "ADAPTIVE_TABLEAUS", "DOPRI5"]
